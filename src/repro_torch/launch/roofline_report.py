"""Tables from the dry-run JSON cells (counterpart of
``repro.launch.roofline_report``).

  PYTHONPATH=src python -m repro_torch.launch.roofline_report \
      --dryrun build/dryrun --roofline build/roofline

``--dryrun`` holds ``python -m repro_torch.launch.dryrun --all`` cells,
``--roofline`` ``--all --xcost`` cells (``--out-dir`` of each run).  The LM
cells were counted on the production mesh over meta devices, and their
terms use one NVIDIA H100's peaks (``launch/roofline.py``); the tda_ego
cells ran on the machine's own devices.
"""
from __future__ import annotations

import argparse
import glob
import json
import os


def load_cells(d: str, suffix: str) -> dict:
    out = {}
    for f in sorted(glob.glob(os.path.join(d, f"*__{suffix}.json"))):
        with open(f) as fh:
            j = json.load(fh)
        out[(j["arch"], j["shape"])] = j
    return out


def fmt_s(x) -> str:
    if x is None:
        return "-"
    if x >= 0.1:
        return f"{x:.2f}"
    if x >= 1e-3:
        return f"{x*1e3:.1f}m"
    return f"{x*1e6:.0f}u"


def dryrun_table(cells: dict) -> str:
    rows = ["| arch | shape | chips | peak GiB/dev | collectives (count) | compile s |",
            "|---|---|---|---|---|---|"]
    for (a, s), j in sorted(cells.items()):
        if "skipped" in j:
            rows.append(f"| {a} | {s} | - | - | SKIP: {j['skipped'][:60]} | - |")
            continue
        peak = j["memory"].get("peak_bytes") or 0
        colls = j["roofline"]["collectives"]
        cstr = " ".join(f"{k}:{int(v['count'])}" for k, v in sorted(colls.items()))
        rows.append(
            f"| {a} | {s} | {j['chips']} | {peak/2**30:.2f} | {cstr} "
            f"| {j['compile_s']} |")
    return "\n".join(rows)


def roofline_table(cells: dict) -> str:
    rows = ["| arch | shape | compute s | memory s | collective s | dominant "
            "| model GFLOP/dev | useful-flop ratio | roofline frac |",
            "|---|---|---|---|---|---|---|---|---|"]
    for (a, s), j in sorted(cells.items()):
        if "skipped" in j:
            rows.append(f"| {a} | {s} | - | - | - | SKIP | - | - | - |")
            continue
        r = j["roofline"]
        mf = r.get("model_flops_per_device", 0) / 1e9
        rows.append(
            f"| {a} | {s} | {fmt_s(r['compute_s'])} | {fmt_s(r['memory_s'])} "
            f"| {fmt_s(r['collective_s'])} | **{r['dominant']}** "
            f"| {mf:.0f} | {r.get('useful_flop_ratio', 0):.2f} "
            f"| {r.get('roofline_fraction', 0):.3f} |")
    return "\n".join(rows)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun", default="build/dryrun")
    ap.add_argument("--roofline", default="build/roofline")
    args = ap.parse_args(argv)

    print("## Dry-run (production mesh over meta devices; memory fit, "
          "counted FLOPs and bytes)\n")
    print("### single-pod (16x16)\n")
    print(dryrun_table(load_cells(args.dryrun, "1pod")))
    print("\n### multi-pod (2x16x16)\n")
    print(dryrun_table(load_cells(args.dryrun, "2pod")))
    if os.path.isdir(args.roofline):
        print("\n## Roofline on one NVIDIA H100 (depth-probe counts, "
              "single-pod)\n")
        print(roofline_table(load_cells(args.roofline, "1pod")))


if __name__ == "__main__":
    main()
