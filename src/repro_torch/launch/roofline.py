"""Roofline terms on one NVIDIA H100 (the port's counterpart of the cost
half of ``repro.launch.roofline``).

The peaks below are the figures every bound in ``PERF.md`` §6 and
``chip_smoke.py``'s ``kernels`` line uses: the least time a function could
take is the larger of the bytes it must move over the HBM rate and, for
each unit its operations run on, those operations over that unit's peak.
Count each input byte read once and each output byte written once; where
the work depends on the data, count what the data needs.

``repro``'s parsing of collectives and bytes out of compiled HLO is not
ported: it reads XLA dry-run artifacts, which the port does not make.
"""
from __future__ import annotations

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, and one 32-bit
# instruction per CUDA-core lane per clock (132 SMs x 128 lanes x 1.98 GHz;
# the data sheet's 67 TFLOP/s f32 counts an FMA as two), the rate of the
# kernels' integer word ops and non-FMA f32 ops
HBM_BYTES_PER_S = 3.35e12
LANE_OPS_PER_S = 33.5e12
# the multi-function units (ex2, lg2, rcp): 16 per SM per clock on Hopper;
# popcounts run at the same rate
MUFU_OPS_PER_S = 16 * 132 * 1.98e9
# int8 tensor-core operations a second, dense (an FMA counts as two)
INT8_TC_OPS_PER_S = 1979e12

# unit name -> operations a second; the keys ``roofline_terms`` takes
PEAK_OPS_PER_S = {"lane": LANE_OPS_PER_S, "mufu": MUFU_OPS_PER_S,
                  "int8_tc": INT8_TC_OPS_PER_S}


def roofline_terms(bytes_accessed: float, ops: dict[str, float]) -> dict:
    """The roofline of one call: ``bytes_accessed`` over HBM, and ``ops``
    (operations by unit: ``"lane"``, ``"mufu"``, ``"int8_tc"``) over each
    unit's peak.

    Returns ``memory_s``, ``compute_s`` (the slowest unit's time),
    ``unit_s`` (each unit's), ``compute_unit``, ``dominant``
    (``"memory"`` or ``"compute"``; memory on a tie) and ``bound_s``, the
    larger of the two terms.
    """
    unknown = set(ops) - set(PEAK_OPS_PER_S)
    if unknown:
        raise ValueError(f"unknown units {sorted(unknown)}; want some of "
                         f"{sorted(PEAK_OPS_PER_S)}")
    memory_s = bytes_accessed / HBM_BYTES_PER_S
    unit_s = {u: n / PEAK_OPS_PER_S[u] for u, n in ops.items()}
    compute_unit = max(unit_s, key=unit_s.get) if unit_s else None
    compute_s = unit_s[compute_unit] if unit_s else 0.0
    dominant = "memory" if memory_s >= compute_s else "compute"
    return {"memory_s": memory_s, "compute_s": compute_s, "unit_s": unit_s,
            "compute_unit": compute_unit, "dominant": dominant,
            "bound_s": max(memory_s, compute_s),
            "bytes": float(bytes_accessed),
            "ops": {u: float(n) for u, n in ops.items()}}


def bound_ms(bytes_accessed: float,
             ops: dict[str, float]) -> tuple[float, str]:
    """The least time in ms and what bounds it, ``"bytes"`` or
    ``"operations"`` (any unit): the form of ``chip_smoke.py``'s kernel
    rows."""
    t = roofline_terms(bytes_accessed, ops)
    return (t["bound_s"] * 1e3,
            "bytes" if t["dominant"] == "memory" else "operations")

# dense bf16 tensor-core FLOP/s (H100 SXM data sheet, no sparsity; an FMA
# counts as two): the denominator of a train step's model-FLOP share,
# 6 · parameters · tokens / step seconds
BF16_TC_FLOPS_PER_S = 989.4e12


def model_flop_share(n_params: int, tokens: int, step_s: float) -> float:
    """The share of the card's dense bf16 peak that a train step's model
    FLOPs (6 · parameters · tokens: forward and backward, no
    recomputation) take over ``step_s`` seconds."""
    return 6.0 * n_params * tokens / step_s / BF16_TC_FLOPS_PER_S
