"""Time a checkout's n64 plan execution and its kernel wrappers' host time.

    python3 tools/signature_times.py [--src DIR] [--reps N]

Builds chip_smoke.py's n64 batch (4096 graphs) on the card and times
``make_topo_plan(dim=1, method="both", repack="on")``'s ``execute_info``
on it, ``reps`` runs on the device-synchronised host clock after two
warm-up runs, first with tracing off and then with it on
(``obs.configure(enabled=True)``); then the
host time a call of the ``domination``, ``kcore_peel`` and
``clustering_coefficients`` wrappers at the same batch
(``chip_smoke.host_ms_per_call``), where the kernel spans and the launch
counters sit.  ``--src`` (default: this checkout's ``src``) names the
``repro_torch`` package to time, so that one process per tree compares two
commits on one card.  Prints one JSON line, then the card's
``nvidia-smi`` name and power limit.  Needs a CUDA device; exits 2 without
one.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("signature_times.py: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import repro_torch
    from repro_torch import obs
    from repro_torch.core.api import make_topo_plan
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    g = cs.n64_batch(dev)
    plan = make_topo_plan(dim=1, method="both", repack="on", **cs.N64_CAPS)

    def totals() -> list[float]:
        for _ in range(2):
            plan.execute_info(g)
        out = []
        for _ in range(args.reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plan.execute_info(g)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    row = {"package": str(Path(repro_torch.__file__).resolve().parent),
           "graphs": g.batch, "reps": args.reps}
    runs = {"off": totals()}
    obs.configure(enabled=True)
    try:
        runs["on"] = totals()
    finally:
        obs.configure(enabled=False)
        obs.clear_trace()
    for mode, ms in runs.items():
        row[f"tracing_{mode}"] = {"median_ms": statistics.median(ms),
                                  "min_ms": min(ms),
                                  "mean_ms": statistics.fmean(ms),
                                  "runs_ms": ms}
    adj, mask = g.adj.contiguous(), g.mask.contiguous()
    row["wrapper_host_ms"] = {
        "domination": cs.host_ms_per_call(lambda: ops.domination(adj, mask)),
        "kcore_peel": cs.host_ms_per_call(
            lambda: ops.kcore_peel(adj, mask, 2, sweeps=0)),
        "clustering_coefficients": cs.host_ms_per_call(
            lambda: ops.clustering_coefficients(adj, mask))}
    print(json.dumps(row), flush=True)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
