"""Time a checkout's gf2_reduce kernel at the main path's recorded inputs.

    python3 tools/gf2_times.py [--src DIR]

Builds chip_smoke.py's n64 and n320 batches on the card, drives
``make_topo_plan(dim=1, method="both", repack="on")`` on each with
chip_smoke's recorder installed, and prints one JSON line per batch with
chip_smoke's gf2 row (``_time_gf2``: between events, device and host time,
steps, the chain floor) at the largest input the plan gave the kernel.
``--src`` (default: this checkout's ``src``) names the ``repro_torch``
package to time, so that one process per tree compares two commits on one
card with the same timers.  Needs a CUDA device; exits 2 without one.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("gf2_times.py: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import repro_torch
    from repro_torch.core.api import make_topo_plan

    dev = torch.device("cuda")
    recorder = cs.Recorder()
    originals = recorder.install()
    try:
        for phase, batch, caps in (
                ("signature_n64", cs.n64_batch, cs.N64_CAPS),
                ("signature_n320", cs.n320_batch, cs.N320_CAPS)):
            plan = make_topo_plan(dim=1, method="both", repack="on", **caps)
            cs._drive(recorder, phase, plan.execute_info, batch(dev))
            row = cs._time_gf2(*recorder.inputs[(phase, "gf2_reduce")][1])
            row.update(phase=phase, package=str(Path(
                repro_torch.__file__).resolve().parent))
            print(json.dumps(row), flush=True)
    finally:
        cs.Recorder.uninstall(originals)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
