"""TopoScope trace report: top-k self-time table with cost-cell labels
(the port's copy of ``repro.obs.report``).

``python -m repro_torch.obs report <trace.json>`` aggregates a Chrome-trace
file produced by :func:`repro_torch.obs.export_chrome_trace` into per-span
self-time (span duration minus enclosed child spans, computed per
thread from the interval nesting), then attaches the roofline cost cells
of the card (``perfgate/cost_cells.py``) to kernel spans — so a live trace
and a benchmark row speak one vocabulary.

Kernel spans carry their shape as a ``B32_N128``-style token string in
``args["shape"]``; the mapping below turns a span name into the
cost-model benchmark prefix ``cost_cells.attribute`` expects.  It is
``repro``'s, so ``kernels.hamming_scan`` and
``kernels.auction_lap_collapsed`` stay unmapped.

A kernel span times the host wrapper around an asynchronous launch (as
``repro``'s do under dispatch), not the device's time.
"""
from __future__ import annotations

import json
from typing import Optional

# span name -> perfgate cost-model benchmark prefix
KERNEL_CELLS = {
    "kernels.pairwise_l1": "kernel_pairwise_gram",
    "kernels.domination": "kernel_domination",
    "kernels.kcore_peel": "kernel_kcore",
    "kernels.common_neighbors": "kernel_common_neighbors",
    "kernels.auction_lap": "kernel_auction_lap",
    "kernels.sinkhorn_lse": "kernel_sinkhorn_lse",
    "kernels.sinkhorn_pair_sum": "kernel_sinkhorn_lse",
    "kernels.gf2_reduce": "kernel_gf2_reduce",
    "kernels.gf2_reduce_batch": "kernel_gf2_reduce",
}


def load_trace(path: str) -> list[dict]:
    """Read ``traceEvents`` from a Chrome-trace JSON file (accepts both
    the object form and a bare event array)."""
    with open(path) as fh:
        doc = json.load(fh)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    return [e for e in events if e.get("ph") == "X"]


def self_times(events: list[dict]) -> list[tuple[dict, float]]:
    """[(event, self_us)] — duration minus time covered by child spans.

    Children are recovered from interval nesting per (pid, tid): events
    sorted by (ts, -dur) visit parents before their children, and a span
    whose start is past the top of the open stack closes everything it
    does not nest inside.
    """
    out: list[tuple[dict, float]] = []
    by_thread: dict[tuple, list[dict]] = {}
    for e in events:
        by_thread.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    for evs in by_thread.values():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack: list[list] = []  # [event, self_us]
        for e in evs:
            while stack and e["ts"] >= stack[-1][0]["ts"] + stack[-1][0]["dur"]:
                out.append((stack[-1][0], max(stack[-1][1], 0.0)))
                stack.pop()
            if stack:
                stack[-1][1] -= e["dur"]
            stack.append([e, e["dur"]])
        while stack:
            out.append((stack[-1][0], max(stack[-1][1], 0.0)))
            stack.pop()
    return out


def aggregate(events: list[dict]) -> list[dict]:
    """Per (name, shape) rows: calls, total/self time, cost cell."""
    rows: dict[tuple[str, str], dict] = {}
    for e, self_us in self_times(events):
        shape = str(e.get("args", {}).get("shape", ""))
        key = (e["name"], shape)
        row = rows.get(key)
        if row is None:
            row = rows[key] = {
                "span": e["name"], "shape": shape, "calls": 0,
                "total_us": 0.0, "self_us": 0.0,
            }
        row["calls"] += 1
        row["total_us"] += e["dur"]
        row["self_us"] += self_us
    for row in rows.values():
        row["cost_cell"] = cost_cell_for(row["span"], row["shape"])
    return sorted(rows.values(), key=lambda r: -r["self_us"])


def cost_cell_for(span_name: str, shape: str) -> Optional[dict]:
    """Roofline cost cell for a kernel span (None for non-kernel spans)."""
    bench = KERNEL_CELLS.get(span_name)
    if bench is None:
        return None
    # lazy import: keeps repro_torch.obs importable without perfgate
    from repro_torch.perfgate.cost_cells import attribute
    return attribute("obs", bench, shape or "")


def format_report(events: list[dict], top: int = 15) -> str:
    """Human-readable top-k self-time table over a trace."""
    if not events:
        return "(empty trace)"
    rows = aggregate(events)
    wall_us = (max(e["ts"] + e["dur"] for e in events)
               - min(e["ts"] for e in events))
    total_self = sum(r["self_us"] for r in rows) or 1.0
    lines = [
        f"trace: {len(events)} spans, {len(rows)} distinct, "
        f"wall {wall_us / 1e6:.3f}s",
        f"{'span':<28} {'shape':<14} {'calls':>6} {'total_s':>9} "
        f"{'self_s':>9} {'self%':>6}  cost cell",
        "-" * 100,
    ]
    for row in rows[:top]:
        cell = row["cost_cell"]
        cell_s = ""
        if cell is not None:
            cell_s = f"{cell['cell']} [{cell['bound']}]"
        lines.append(
            f"{row['span']:<28} {row['shape']:<14} {row['calls']:>6d} "
            f"{row['total_us'] / 1e6:>9.4f} {row['self_us'] / 1e6:>9.4f} "
            f"{100.0 * row['self_us'] / total_self:>5.1f}%  {cell_s}")
    if len(rows) > top:
        rest = sum(r["self_us"] for r in rows[top:])
        lines.append(f"... {len(rows) - top} more rows "
                     f"({rest / 1e6:.4f}s self)")
    return "\n".join(lines)


def report(path: str, top: int = 15) -> str:
    return format_report(load_trace(path), top=top)
