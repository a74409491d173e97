"""The benchmark of the PyTorch and CUDA port: one run of one cell.

    python3 tdabench/run.py --workload W --seed N --seconds S --trace 0|1

Set-up (the cell's data, the kernels from the build cache under
``build/``, the plan, warm-up calls) is timed as
``setup_s`` from the start of this process; then the window calls the plan
back to back for ``--seconds`` (``--trace 1``: the traffic mix's traced
calls under the profiler); then the kept outputs are checked against the
plain reference.  The last line of standard output is the result, one JSON
object; the numbers compared, each beside its limit, are the last lines of
standard error.  Without a CUDA device it exits 2 and prints no result;
with JAX or the JAX package loaded once the window has closed, 3.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="judge the control in the program's place (the "
                         "reference with PrunIT's filtration condition "
                         "dropped): a sound check reads it not correct")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from tdabench import harness

    _, cell, _, _ = harness.cell_spec(ROOT, args.workload)
    import torch

    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell["chips"]):
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"tdabench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); this machine has {have}", file=sys.stderr)
        return 2
    result = harness.run(ROOT, args.workload, args.seed, args.seconds,
                         bool(args.trace), "cuda", T0, control=args.control)
    foreign = harness.foreign_modules()
    if foreign:
        print(f"tdabench: the run loaded {foreign}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['rule']} {c['limit']})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
