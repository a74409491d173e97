"""The training loop (counterpart of ``repro.launch.train``): the host mesh,
checkpoint/restart and straggler accounting around the train step.

  python -m repro_torch.launch.train --arch qwen3-1.7b --steps 50 \
      --batch 8 --seq 128 --ckpt-dir ckpt            # on the card
  python -m repro_torch.launch.train --arch qwen3-1.7b --steps 4 \
      --device cpu                                   # plain PyTorch, CPU

Fault tolerance, as in ``repro``:
  * auto-resume from the newest committed checkpoint in ``--ckpt-dir``,
    the token stream resumed at the step it had reached;
  * periodic atomic checkpoints (parameters, optimizer, stream state) and
    one at the end;
  * a step slower than ``deadline_x`` times the rolling median of the last
    50 is counted as a straggler (accounting only).

Training runs on one device.  A mesh of more than one raises: the
param/opt shardings over ("data", "model") exist
(:mod:`repro_torch.launch.sharding`) and size a mesh in the dry run, but
no step runs partitioned over several cards yet.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs.registry import get_config, reduced_config
from repro_torch.data.tokens import TokenStream
from repro_torch.launch.mesh import DeviceMesh, _devices, _mesh
from repro_torch.models import transformer as tf
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import adamw_init
from repro_torch.train.train_step import TrainState, make_train_step


def make_host_mesh(devices=None) -> DeviceMesh:
    """Best-effort ("data", "model") mesh over ``devices`` (default: every
    CUDA device; raises without one): a model axis of 4 or 2 where the
    count is a multiple of it and at least twice it, as ``repro`` shapes
    its host mesh."""
    devs = _devices(devices)
    n = len(devs)
    model = 1
    for cand in (4, 2):
        if n % cand == 0 and n >= cand * 2:
            model = cand
            break
    return _mesh((n // model, model), ("data", "model"), devs)


def train(arch: str, steps: int, batch: int, seq: int, ckpt_dir: str | None,
          reduced: bool = True, ckpt_every: int = 20, lr: float = 3e-4,
          grad_accum: int = 1, deadline_x: float = 3.0, log_every: int = 10,
          seed: int = 0, device=None) -> dict:
    """Train ``arch`` for ``steps`` steps (resuming from ``ckpt_dir``'s
    newest step) on ``device``: CUDA unless ``device="cpu"``; with no
    device, the host mesh over every CUDA device, which must be one.

    Returns {final_loss, first_loss, stragglers, steps_run} and the run's
    ``losses`` and ``step_s`` (seconds a step, host clock around a step
    whose metrics were read back)."""
    cfg = reduced_config(arch) if reduced else get_config(arch)
    dev = resolve_device(device)  # raises without CUDA unless asked
    mesh = make_host_mesh(None if device is None else [dev])
    if mesh.size > 1:
        raise NotImplementedError(
            f"a {tuple(mesh.shape.values())} mesh: training over several "
            f"cards is not built yet (ROADMAP Queue 1 item 4); pass device= "
            f"to train on one device")
    return _train_inner(cfg, mesh.flat[0], steps, batch, seq, ckpt_dir,
                        ckpt_every, lr, grad_accum, deadline_x, log_every,
                        seed)


def _train_inner(cfg, dev, steps, batch, seq, ckpt_dir, ckpt_every, lr,
                 grad_accum, deadline_x, log_every, seed) -> dict:
    stream = TokenStream(vocab_size=cfg.vocab_size, batch=batch, seq_len=seq,
                         seed=seed)
    step_fn = make_train_step(cfg, grad_accum=grad_accum, base_lr=lr)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = tf.init_params(cfg, gen, device=dev)
    state = TrainState(params=params, opt=adamw_init(params))

    start = 0
    if ckpt_dir and ckpt.latest_steps(ckpt_dir):
        state, start, sstate = ckpt.restore(ckpt_dir, state, device=dev)
        stream, start = TokenStream.resume(stream, sstate)
        print(f"[resume] restored step {start} from {ckpt_dir}")

    durations: list[float] = []
    stragglers = 0
    history = []
    for step in range(start, steps):
        t0 = time.perf_counter()
        data = stream.batch_at(step, device=dev)
        state, metrics = step_fn(state, data)
        loss, gnorm, rate = torch.stack(
            [metrics["loss"], metrics["grad_norm"], metrics["lr"]]).tolist()
        dt = time.perf_counter() - t0
        durations.append(dt)
        med = float(np.median(durations[-50:]))
        if len(durations) > 5 and dt > deadline_x * med:
            stragglers += 1
            print(f"[straggler] step {step}: {dt:.2f}s vs median {med:.2f}s")
        if step % log_every == 0 or step == steps - 1:
            print(f"step {step:5d} loss {loss:.4f} gnorm {gnorm:.3f} "
                  f"lr {rate:.2e} {dt:.2f}s")
        history.append(loss)
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            path = ckpt.save(ckpt_dir, step + 1, state,
                             stream_state=stream.state(step + 1))
            print(f"[ckpt] wrote {path}")

    if ckpt_dir:
        ckpt.save(ckpt_dir, steps, state, stream_state=stream.state(steps))
    return {"final_loss": history[-1] if history else None,
            "first_loss": history[0] if history else None,
            "stragglers": stragglers, "steps_run": len(history),
            "losses": history, "step_s": durations}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--full", action="store_true",
                    help="use the full (non-reduced) config")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain PyTorch path; default: the "
                         "CUDA device")
    args = ap.parse_args(argv)
    out = train(args.arch, args.steps, args.batch, args.seq, args.ckpt_dir,
                reduced=not args.full, ckpt_every=args.ckpt_every,
                lr=args.lr, grad_accum=args.grad_accum, seed=args.seed,
                device=args.device)
    print(json.dumps({k: out[k] for k in ("final_loss", "first_loss",
                                          "stragglers", "steps_run")}))


if __name__ == "__main__":
    main()
