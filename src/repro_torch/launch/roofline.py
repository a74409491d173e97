"""Roofline terms on one NVIDIA H100 (counterpart of
``repro.launch.roofline``), in two forms.

The kernel form (``roofline_terms``, ``bound_ms``) is what every bound in
``PERF.md`` §6 and ``chip_smoke.py``'s ``kernels`` line uses: the least
time a function could take is the larger of the bytes it must move over
the HBM rate and, for each unit its operations run on, those operations
over that unit's peak.  Count each input byte read once and each output
byte written once; where the work depends on the data, count what the data
needs.

The step form (``count_step``, ``step_roofline_terms``, ``model_flops_for``)
is the dry run's.  ``repro`` reads FLOPs and bytes from XLA's
``cost_analysis()`` and parses collectives and the "mover" ops out of the
compiled HLO text.  Eager PyTorch compiles nothing, so ``count_step`` runs
the step once (on meta tensors it allocates and computes nothing) and
counts the aten ops it dispatches instead: FLOPs by
``torch.utils.flop_counter.FlopCounterMode``, bytes by a dispatch mode
(every op that is not a view, operands and results: eager PyTorch's own
unfused traffic; and ``repro``'s fusion rule over aten ops: twice the
result bytes of the ops that are not pointwise), and copies between
distinct devices, which stand in for the collectives of a partitioned
program.
"""
from __future__ import annotations

from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

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


# dense f32 FLOP/s on the CUDA cores (one FMA a lane a clock, counted as two;
# the data sheet's 67 TFLOP/s): the rate of an f32 matmul, which runs
# without TF32 (``torch.backends.cuda.matmul.allow_tf32`` is off by default)
F32_FLOPS_PER_S = 2 * LANE_OPS_PER_S
# the card's memory (data sheet: 80 GB of HBM3), for the dry run's fit check
HBM_CAPACITY_BYTES = 80e9
# a copy between two devices of the one-process mesh goes over the host
# link: PCIe Gen5 x16, 64 GB/s a direction (data sheet)
HOST_LINK_BYTES_PER_S = 64e9

# ops that return a view or an alias in all but name, and ops that only
# allocate: they move no bytes
_NO_BYTES = {"aten::_unsafe_view", "aten::lift_fresh", "aten::empty",
             "aten::empty_like", "aten::empty_strided", "aten::new_empty",
             "aten::new_empty_strided"}


def _tensor_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class _ByteCounter(TorchDispatchMode):
    """Bytes of every aten op dispatched under it (see ``count_step``)."""

    def __init__(self):
        super().__init__()
        self.accessed = 0
        self.movers = 0
        self.ops = 0
        self.transfers = defaultdict(
            lambda: {"count": 0, "bytes": 0.0, "traffic": 0.0})

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        if func.is_view or func._schema.name in _NO_BYTES:
            return out
        result = _tensor_bytes(out)
        self.accessed += _tensor_bytes((args, kwargs)) + result
        if torch.Tag.pointwise not in func.tags:
            self.movers += 2 * result
        src = dst = None
        if func is torch.ops.aten._to_copy.default:
            src, dst = args[0], out
        elif func is torch.ops.aten.copy_.default:
            src, dst = args[1], args[0]
        if src is not None and src.device != dst.device:
            rec = self.transfers["transfer"]
            rec["count"] += 1
            rec["bytes"] += _tensor_bytes(src)
            rec["traffic"] += _tensor_bytes(src)
        return out


def count_step(fn, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` once and count what it dispatched.

    Returns ``flops`` (``FlopCounterMode``: matmuls, convolutions and
    attention, an FMA as two), ``bytes_accessed`` (operand and result
    bytes of every aten op that is not a view or an allocation),
    ``fusion_adjusted_bytes`` (twice the result bytes of the ops that are
    not tagged pointwise: ``repro``'s movers rule), ``collectives``
    (``{"transfer": {"count", "bytes", "traffic"}}`` for copies between
    distinct devices; empty when there were none), ``aten_ops`` and
    ``out``, what ``fn`` returned.  On meta tensors nothing is computed, so
    a step of any size counts in the time its Python takes.  Work done
    outside aten (the ctypes kernels) is not seen.
    """
    bc = _ByteCounter()
    with FlopCounterMode(display=False) as fc, bc:
        out = fn(*args, **kwargs)
    return {"flops": float(fc.get_total_flops()),
            "bytes_accessed": float(bc.accessed),
            "fusion_adjusted_bytes": float(bc.movers),
            "collectives": {k: dict(v) for k, v in bc.transfers.items()},
            "aten_ops": bc.ops, "out": out}


def step_roofline_terms(flops: float, bytes_accessed: float,
                        collectives: dict, model_flops_global: float = 0.0,
                        chips: int = 256) -> dict:
    """``repro``'s roofline terms of one step on one device, on the card:
    compute over the dense bf16 tensor-core peak, memory over HBM, and
    ``collective_s`` the transfers' traffic over the host link.  With
    nothing transferred ``collective_s`` is ``None`` and ``dominant`` is
    chosen from compute and memory only."""
    coll_traffic = sum(v["traffic"] for v in collectives.values())
    compute_s = flops / BF16_TC_FLOPS_PER_S
    memory_s = bytes_accessed / HBM_BYTES_PER_S
    collective_s = (coll_traffic / HOST_LINK_BYTES_PER_S if coll_traffic
                    else None)
    terms = {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "hlo_flops_per_device": flops,
        "hlo_bytes_per_device": bytes_accessed,
        "collective_traffic_per_device": coll_traffic,
        "collectives": collectives,
    }
    cands = [("compute", compute_s), ("memory", memory_s)]
    if collective_s is not None:
        cands.append(("collective", collective_s))
    dom = max(cands, key=lambda kv: kv[1])
    terms["dominant"] = dom[0]
    terms["bound_s"] = dom[1]
    if model_flops_global:
        terms["model_flops_global"] = model_flops_global
        terms["model_flops_per_device"] = model_flops_global / chips
        terms["useful_flop_ratio"] = (
            model_flops_global / chips / flops if flops else 0.0
        )
        # roofline fraction: useful model FLOP/s achieved at the bound
        terms["roofline_fraction"] = (
            (model_flops_global / chips / BF16_TC_FLOPS_PER_S) / dom[1]
            if dom[1] > 0 else 0.0
        )
    return terms


def model_flops_for(cfg, shape_cfg) -> float:
    """MODEL_FLOPS: 6·N·D train, 2·N_active·D inference (global, per step)."""
    n_active = cfg.active_param_count()
    if shape_cfg.kind == "train":
        tokens = shape_cfg.global_batch * shape_cfg.seq_len
        return 6.0 * n_active * tokens
    if shape_cfg.kind == "prefill":
        tokens = shape_cfg.global_batch * shape_cfg.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape_cfg.global_batch
