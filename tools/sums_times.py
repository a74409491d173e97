"""Time a checkout's Sinkhorn pair-sum, Sinkhorn LSE and Hamming kernels.

    python3 tools/sums_times.py [--src DIR]

Builds chip_smoke.py's n64 and n320 batches on the card, drives their
Diagrams through the Sinkhorn path as chip_smoke's ``sinkhorn_n64``
(blocked) and ``sinkhorn_full_n320`` phases do, with chip_smoke's recorder
installed, and prints one JSON line per phase and kernel with chip_smoke's
row (between events, device and host time, bound, layout, ptxas) at the
largest input the phase gave the kernel.  Then the Hamming scan at 256
queries of 128 bits against 4096, 65,536 and 262,144 rows (the shapes of
chip_smoke's ``sharded_index_n64``, ``sharded_index_n65536`` and
``hamming_large``; the scan does the same work whatever the bits).
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
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("sums_times.py: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import repro_torch
    from repro_torch.core.api import make_topo_plan
    from repro_torch.kernels.hamming import as_int32_words, pack_codes_u32
    from repro_torch.metrics import compare
    from repro_torch.metrics.testing import hamming_operands

    dev = torch.device("cuda")
    package = str(Path(repro_torch.__file__).resolve().parent)

    def emit(row, phase):
        row.update(phase=phase, package=package)
        print(json.dumps(row), flush=True)

    recorder = cs.Recorder()
    originals = recorder.install()
    try:
        for phase, batch, caps, kw in (
                ("sinkhorn_n64", cs.n64_batch, cs.N64_CAPS,
                 dict(metric="sinkhorn", impl="blocked")),
                ("sinkhorn_full_n320", cs.n320_batch, cs.N320_CAPS,
                 cs.SK_FULL)):
            plan = make_topo_plan(dim=1, method="both", repack="on", **caps)
            d = plan.execute(batch(dev))
            d1 = cs._rows(d, slice(0, None, 2))
            d2 = cs._rows(d, slice(1, None, 2))
            cs._drive(recorder, phase, lambda: compare(d1, d2, **kw))
            for row in cs.kernel_rows(recorder, phase,
                                      only=("sinkhorn_pair_sum",
                                            "sinkhorn_lse")):
                emit(row, phase)
    finally:
        cs.Recorder.uninstall(originals)
    for n in (4096, 65536, 262144):
        cq, cd, mq = (as_int32_words(pack_codes_u32(a)).to(dev)
                      for a in hamming_operands(np.random.default_rng(7), 256,
                                                n, 16, "probe"))
        emit(cs._time_hamming(cq, mq, cd), f"hamming_{n}")
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
