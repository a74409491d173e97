"""Cost-cell attribution on the card (the port's ``repro.perfgate.
cost_cells``).

A benchmark row or a trace span names a kernel family and carries its shape
as tokens (``B32_N128``, ``G128_D512``, ``B64_M32``, ``S512``).  Each family
has a model of the bytes it must move and the operations it must do, by
unit, as functions of those tokens: the counts ``chip_smoke.py`` makes for
its kernel rows (``kcore_cost``, ``domination_cost`` and ``gf2_cost`` are
those counts, which the dry run's launch bounds use too), on the peaks of
:mod:`repro_torch.launch.roofline`.  Where
``PERF.md`` §6 counts work that depends on the data (the weighted Sinkhorn
pairs, the auction's scans, the GF(2) chase's steps, the live edges of a
common-neighbors Gram, the k-core sweeps), the model here counts what the
shape alone fixes, and its cell label says so ("shape-only").  Rows without
a model fall back to the subsystem that owns them, so every row still names
a layer.
"""
from __future__ import annotations

import re
from typing import Callable

from repro_torch.launch.roofline import roofline_terms

# shape tokens: a capital letter immediately followed by digits, delimited
# by "_" (B32_N128, G64_D256, S512_...)
_TOKEN_RE = re.compile(r"(?:^|_)([A-Z])(\d+)(?=_|$)")

# lane operations of one auction row (or column) scan over M slots: M
# subtractions and two max passes (chip_smoke.AUCTION_SCAN_OPS)
_AUCTION_SCAN_OPS = 3
# (lane, MUFU) work of one weighted pair of the Sinkhorn LSE
# (chip_smoke.SK_LSE_WORK)
_SK_LSE_WORK = (26, 2)


def parse_shape(metric: str) -> dict[str, int]:
    """{"B": 32, "N": 128} from a metric name like ``B32_N128_jnp_s``."""
    return {m.group(1): int(m.group(2))
            for m in _TOKEN_RE.finditer(metric)}


def _words(n: int) -> int:
    return max(-(-n // 32), 1)


def kcore_cost(b: int, n: int, sweeps: int) -> tuple[float, dict]:
    """(bytes, ops by unit) of a ``kcore_peel`` launch over a (B, N, N)
    batch that runs ``sweeps`` sweeps: one read of adj and alive and one
    write of alive; an AND and a popcount and an add a word a sweep."""
    return (b * n * n + 2.0 * b * n,
            {"lane": 3.0 * sweeps * b * n * _words(n)})


def domination_cost(b: int, n: int) -> tuple[float, dict]:
    """(bytes, ops by unit) of a ``domination`` launch: one read of adj and
    mask, one write of the (B, N, N) output, and the Gram's B·N²·(N+1)
    int8 operations (its N(N+1)/2 distinct inner products a graph, an FMA
    as two) on the tensor cores."""
    return 2.0 * b * n * n + b * n, {"int8_tc": float(b) * n * n * (n + 1)}


def gf2_cost(blocks) -> tuple[float, dict]:
    """(bytes, ops by unit) of a ``gf2_reduce`` launch over ``blocks``,
    each ``(G, S, W, R, steps)`` with ``steps`` the chase's steps summed
    over the block's matrices (one past the last nonzero column plus the
    additions): each block's int32 words read and written, owner and
    positive written, and a low and an XOR of W words a step."""
    moved = sum(2 * g * s * w * 4 + g * r * 4 + g * s
                for g, s, w, r, _ in blocks)
    return moved, {"lane": sum(2.0 * w * steps
                               for _, _, w, _, steps in blocks)}


def _pairwise_l1(s):
    g, d = s["G"], s["D"]
    return 4.0 * (2 * g * d + g * g), {"lane": 2.0 * g * g * d}


def _domination(s):
    return domination_cost(s["B"], s["N"])


def _kcore(s):
    return kcore_cost(s["B"], s["N"], 1)


def _common_neighbors(s):
    b, n = s["B"], s["N"]
    return b * n * n + 9.0 * b * n, {}


def _auction_lap(s):
    b, m = s["B"], s["M"]
    return (4.0 * b * m * m + 4.0 * b * m + 9.0 * b,
            {"lane": float(_AUCTION_SCAN_OPS) * m * b * m})


def _auction_collapsed(s):
    b, k = s["B"], s["K"]
    return (4.0 * b * k * k + 14.0 * b * k + 9.0 * b,
            {"lane": float(_AUCTION_SCAN_OPS) * k * b * k})


def _sinkhorn(b, m):
    visited = float(b) * m * m
    lane, mufu = _SK_LSE_WORK
    return (4.0 * (9 * b * m + b),
            {"lane": lane * visited, "mufu": mufu * visited})


def _gf2(s):
    b, cols = s.get("B", 1), s["S"]
    words = s["C"] if "C" in s else cols * _words(cols)
    return b * (8.0 * words + cols), {"lane": 2.0 * b * words}


def _hamming(s):
    q, n, w = s["Q"], s["N"], s["W"]
    return (4.0 * (2 * q * w + n * w + q * n),
            {"lane": 3.0 * q * n * w, "mufu": float(q * n * w)})


_L1_CELL = "pairwise_l1 f32 L1 Gram (2 lane ops a term)"
_SK_CELL = ("sinkhorn_lse online-LSE half-update, cost on the fly "
            "(shape-only: N = M, every pair weighted)")

# benchmark-name prefix -> (cell label, shape -> (bytes, ops by unit)).
# Shapes may be partial; a model raises KeyError on a missing token
# (caught -> subsystem fallback).
_MODELS: dict[str, tuple[str, Callable[[dict], tuple[float, dict]]]] = {
    "kernel_pairwise_gram": (_L1_CELL, _pairwise_l1),
    "metrics_gram": (_L1_CELL, _pairwise_l1),
    "kernel_domination": (
        "domination int8 tensor-core Gram of closed neighborhoods",
        _domination),
    "kernel_kcore": (
        "kcore_peel bit-packed degree sweep (shape-only: one sweep)",
        _kcore),
    "kernel_common_neighbors": (
        "common_neighbors int8 tensor-core Gram (shape-only: the row-sum "
        "epilogue's bytes, the live edges' operations not counted)",
        _common_neighbors),
    "kernel_auction_lap": (
        "auction_lap segment-scan rounds (shape-only: one scan a row)",
        _auction_lap),
    "kernel_auction_collapsed": (
        "auction_lap_collapsed forward/reverse rounds (shape-only: one "
        "scan a row)", _auction_collapsed),
    "kernel_sinkhorn_lse": (_SK_CELL, lambda s: _sinkhorn(s["B"], s["M"])),
    "kernel_gf2_reduce": (
        "gf2_reduce packed GF(2) pivot chase (shape-only: one step a "
        "column, no additions)", _gf2),
    "kernel_hamming": (
        "hamming_scan masked XOR + popcount over packed codes", _hamming),
    "metrics_blocked_sinkhorn": (_SK_CELL, lambda s: _sinkhorn(1, s["S"])),
}

# benchmark-name prefix -> subsystem cell for unmodeled rows
_SUBSYSTEMS: tuple[tuple[str, str], ...] = (
    ("metrics_rerank", "TopoIndex two-stage retrieval (LSH coarse → "
                       "auction exact re-rank)"),
    ("metrics_serve_two_stage", "SimilarityServe drain (coarse top-k → "
                                "batched auction compare)"),
    ("metrics_drift", "TopoStream drift scoring through the metric "
                      "registry"),
    ("metrics_exact_w", "MetricEngine exact_w (auction-LAP on augmented "
                        "clouds)"),
    ("metrics_auction_parity", "MetricEngine exact_w (auction-LAP on "
                               "augmented clouds)"),
    ("metrics", "MetricEngine distance path (compare/pairwise)"),
    ("serve", "TopoServe drain (bucketed reduce→persist plan execution)"),
    ("stream", "TopoStream verdict + gathered recompute"),
    ("ego_decay", "ReductionEngine two-phase reduce→repack→persist"),
    ("coral_heavy", "ReductionEngine two-phase reduce→repack→persist"),
    ("reduction", "ReductionEngine two-phase reduce→repack→persist"),
    ("fig2", "persistence-kernel clustering (Gram + kernel kmeans)"),
    ("kernel", "CUDA kernel microbench"),
)


def attribute(suite: str, benchmark: str, metric: str) -> dict:
    """Cost cell for one row.

    Returns ``{"cell", "bound", "modeled", "shape"}`` plus, for modeled
    kernels, the roofline terms on the card: ``flops`` (the operations of
    every unit summed), ``ops`` (by unit), ``bytes``, ``compute_s``,
    ``memory_s`` and ``bound_s`` (the larger); ``bound`` is ``"compute"``
    or ``"memory"``.
    """
    shape = parse_shape(metric)
    for prefix, (cell, model) in _MODELS.items():
        if benchmark.startswith(prefix):
            try:
                nbytes, ops = model(shape)
            except KeyError:
                break  # metric name carries no shape tokens -> subsystem
            terms = roofline_terms(nbytes, ops)
            return {
                "cell": cell,
                "bound": terms["dominant"],
                "modeled": True,
                "flops": float(sum(ops.values())),
                "ops": terms["ops"],
                "bytes": float(nbytes),
                "compute_s": terms["compute_s"],
                "memory_s": terms["memory_s"],
                "bound_s": terms["bound_s"],
                "shape": shape,
            }
    for prefix, cell in _SUBSYSTEMS:
        if benchmark.startswith(prefix):
            return {"cell": cell, "bound": "unmodeled", "modeled": False,
                    "shape": shape}
    return {"cell": f"{suite}/{benchmark}", "bound": "unmodeled",
            "modeled": False, "shape": shape}
