"""Where a train step's time goes: the three parts of ``make_train_step``
timed apart, and one whole step traced for the device's busy share.

    python3 tools/lm_train_profile.py [--arch qwen3-1.7b] [--batch 8]
                                      [--seq 128] [--grad-accum 2]
                                      [--reduced] [--device cpu]

Builds ``--arch`` (full width unless ``--reduced``) from a seeded init and
its AdamW state, warms up with two steps on the token stream, then, on the
next steps' batches:

* times the step's parts on the host clock, each between two device
  synchronisations (``accumulate_grads``, the global norm and clip,
  ``adamw_update``), three steps, and the whole step as
  ``make_train_step`` runs it, three steps;
* traces one whole step with ``torch.profiler`` and reports the device's
  busy time (the union of its kernels' intervals), the step's wall time
  under the trace, the idle share, the kernel launches and the ten
  kernels that take the most device time.

Prints one JSON line, with the card's ``nvidia-smi`` name and power
limit.  Runs on the card unless ``--device cpu`` (then the trace has no
device time and only the host times mean anything).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _card() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0]


def _busy_ms(intervals) -> float:
    """The union of (start, end) microsecond intervals, in ms."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--grad-accum", type=int, default=2)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch._device import resolve_device
    from repro_torch.configs.registry import get_config, reduced_config
    from repro_torch.data.tokens import TokenStream
    from repro_torch.models import transformer as tf
    from repro_torch.train.optimizer import adamw_init, adamw_update
    from repro_torch.train.train_step import (
        TrainState, accumulate_grads, clip_by_global_norm, make_train_step)

    dev = resolve_device(args.device)
    cfg = (reduced_config if args.reduced else get_config)(args.arch)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    model = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    state = TrainState(params=model, opt=adamw_init(model))
    stream = TokenStream(cfg.vocab_size, args.batch, args.seq, seed=0)
    step_fn = make_train_step(cfg, args.grad_accum, args.lr)
    step = 0
    for _ in range(2):  # warm-up
        state, _ = step_fn(state, stream.batch_at(step, device=dev))
        step += 1
    sync()

    parts = {"accumulate_grads": [], "norm_and_clip": [], "adamw_update": []}
    for _ in range(3):
        data = stream.batch_at(step, device=dev)
        step += 1
        sync()
        t = time.perf_counter()
        grads, _ = accumulate_grads(state.params, cfg, data, args.grad_accum)
        sync()
        parts["accumulate_grads"].append(time.perf_counter() - t)
        t = time.perf_counter()
        clip_by_global_norm(grads)
        sync()
        parts["norm_and_clip"].append(time.perf_counter() - t)
        t = time.perf_counter()
        _, state.opt, _ = adamw_update(grads, state.opt, state.params,
                                       base_lr=args.lr)
        sync()
        parts["adamw_update"].append(time.perf_counter() - t)
        del grads
    whole = []
    for _ in range(3):
        data = stream.batch_at(step, device=dev)
        step += 1
        sync()
        t = time.perf_counter()
        state, metrics = step_fn(state, data)
        metrics["loss"].item()
        whole.append(time.perf_counter() - t)

    data = stream.batch_at(step, device=dev)
    sync()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        t = time.perf_counter()
        state, metrics = step_fn(state, data)
        metrics["loss"].item()
        traced_ms = (time.perf_counter() - t) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = _busy_ms((e.time_range.start, e.time_range.end) for e in kernels)
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    n_params = sum(p.numel() for p in state.params.parameters())
    print(json.dumps({
        "card": _card() if cuda else None, "device": str(dev),
        "arch": args.arch, "reduced": args.reduced, "params": n_params,
        "batch": args.batch, "seq": args.seq, "grad_accum": args.grad_accum,
        "part_ms": {k: [x * 1e3 for x in v] for k, v in parts.items()},
        "part_ms_mean": {k: float(np.mean(v)) * 1e3
                         for k, v in parts.items()},
        "step_ms": [x * 1e3 for x in whole],
        "traced_step_ms": traced_ms,
        "device_busy_ms": busy if cuda else None,
        "device_idle_share": (1.0 - busy / traced_ms) if cuda else None,
        "kernel_launches": len(kernels),
        "top_kernels_ms": top}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
