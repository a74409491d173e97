"""The yardstick of the kernels' roofline shares: the card's peaks and the
bytes and operations each hand-written kernel of the main path must spend
on its inputs.

A frozen copy of ``repro_torch.launch.roofline``'s peaks and of
``repro_torch.perfgate.cost_cells``' ``kcore_cost``, ``domination_cost``
and ``gf2_cost``, so that a later change to the program cannot move the
yardstick it is measured by.  Each count is of the work the function needs
for its inputs, whatever kernel computes it; where that depends on the data
it counts what the shape alone fixes, so a bound is never above the least
time the work could take and a share never above 100%.
"""
from __future__ import annotations

# H100 SXM (NVIDIA data sheet): HBM3 bytes/s; one 32-bit instruction a
# CUDA-core lane a clock (132 SMs x 128 lanes x 1.98 GHz); dense int8
# tensor-core operations (an FMA counts as two)
HBM_BYTES_PER_S = 3.35e12
LANE_OPS_PER_S = 33.5e12
INT8_TC_OPS_PER_S = 1979e12
PEAK_OPS_PER_S = {"lane": LANE_OPS_PER_S, "int8_tc": INT8_TC_OPS_PER_S}


def bound_s(nbytes: float, ops: dict[str, float]) -> float:
    """The least time of a call: the larger of its bytes over HBM and, on
    each unit, its operations over the unit's peak."""
    return max([nbytes / HBM_BYTES_PER_S]
               + [n / PEAK_OPS_PER_S[u] for u, n in ops.items()])


def words(n: int) -> int:
    return max(-(-n // 32), 1)


def kcore_peel(b: int, n: int) -> tuple[float, dict]:
    """A k-core fixpoint over a (B, N, N) bool batch: adj and alive read
    once, alive written once; one sweep's AND, popcount and add a word (the
    sweeps the data needs beyond the first are not counted)."""
    return b * n * n + 2.0 * b * n, {"lane": 3.0 * b * n * words(n)}


def domination(b: int, n: int) -> tuple[float, dict]:
    """The (B, N, N) domination matrix: adj and mask read, the matrix
    written; the closed neighbourhoods' Gram, B·N²·(N+1) int8 operations,
    on the tensor cores."""
    return 2.0 * b * n * n + b * n, {"int8_tc": float(b) * n * n * (n + 1)}


def gf2_reduce(g: int, cols: int, packed_words: int) -> tuple[float, dict]:
    """One launch over G matrices of ``cols`` columns in all, holding
    ``packed_words`` int32 words a matrix (Σ_d S_d·W_d): every word read
    and written, a positive flag a column written, and a low and an XOR of
    a column's words for one step a column (the chase's further steps and
    the owner vector's bytes, a few percent, are not counted)."""
    return (8.0 * g * packed_words + g * cols,
            {"lane": 2.0 * g * packed_words})


# the device names of the port's hand-written kernels (csrc/*.cu), matched
# as substrings of the profiler's kernel names
HAND_WRITTEN = ("kcore_peel_kernel", "domination_gram_kernel",
                "gf2_reduce_kernel", "common_neighbors_gram_kernel",
                "pairwise_l1_kernel", "pairwise_l1_small_kernel",
                "sinkhorn_lse_kernel", "sinkhorn_pair_sum_kernel",
                "auction_lap_kernel", "auction_collapsed_kernel",
                "hamming_scan_regs_kernel", "hamming_scan_chunked_kernel")

# kernel -> (device name, the program's span names, the count from a span's
# shape tokens)
KERNELS = {
    "kcore_peel": ("kcore_peel_kernel", ("kcore_peel",),
                   lambda t: kcore_peel(t["B"], t["N"])),
    "domination": ("domination_gram_kernel", ("domination",),
                   lambda t: domination(t["B"], t["N"])),
    "gf2_reduce": ("gf2_reduce_kernel", ("gf2_reduce_batch", "gf2_reduce"),
                   lambda t: gf2_reduce(t["B"], t["S"], t["C"])),
}


def share(ctx, kernel: str):
    """100 x the launches' least time over the kernel's device time in the
    traced window, or None where the kernel did not run, a span lacks the
    tokens its count needs, or the trace holds another number of launches
    than the program counted."""
    p = ctx.profile
    if not p or not p["device_s"]:
        return None
    dev_name, span_names, cost = KERNELS[kernel]
    hits = [n for n in p["device_s"] if dev_name in n]
    launches = sum(p["device_n"][n] for n in hits)
    if not launches or launches != ctx.counters.get(kernel, -1):
        return None
    shapes = [t for s in span_names for t in ctx.spans.get(s, [])
              if t.get("B", 0) and t.get("N", t.get("S", 0))]
    try:
        least = sum(bound_s(*cost(t)) for t in shapes)
    except KeyError:
        return None
    if len(shapes) != launches:
        return None
    return 100.0 * least / sum(p["device_s"][n] for n in hits)
