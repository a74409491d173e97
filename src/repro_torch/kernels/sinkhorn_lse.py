"""Blocked Sinkhorn reductions: the CUDA kernels ``csrc/sinkhorn_lse.cu``.

Replaces ``repro/kernels/sinkhorn_lse.py::sinkhorn_lse_pallas`` and
``::sinkhorn_pair_sum_pallas``.  The plain versions are
:func:`repro_torch.kernels.ref.sinkhorn_lse_ref` and
:func:`repro_torch.kernels.ref.sinkhorn_pair_sum_ref`.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

_LSE_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_PAIR_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
                  + [ctypes.c_void_p])


class PackedColumns(NamedTuple):
    """One side's columns of nonzero weight, packed in column order per
    batch item (:func:`pack_columns`).  ``index`` (B, N) int32: entry t <
    ``count[b]`` is the t-th column whose log weight is not -inf, the rest
    the other columns; ``count`` (B,) int32; ``planes`` (B, 3, N) and
    ``logw`` (B, N) float32: the planes and log weights gathered through
    ``index``."""
    index: torch.Tensor
    count: torch.Tensor
    planes: torch.Tensor
    logw: torch.Tensor


def pack_columns(yp: torch.Tensor, logw: torch.Tensor) -> PackedColumns:
    """Pack the columns of (B, 3, N) planes ``yp`` whose (B, N) log weight
    ``logw`` is not -inf (the only ones that reach an LSE), in column order.

    Plain PyTorch, padded to N so the host never waits on the device.  A
    Sinkhorn call packs each side once and passes the pack to every launch
    with the same log weights.
    """
    weighted = logw != float("-inf")
    order = torch.argsort((~weighted).to(torch.uint8), dim=-1, stable=True)
    planes = yp.gather(-1, order[:, None, :].expand(-1, 3, -1))
    return PackedColumns(order.to(torch.int32),
                         weighted.sum(-1, dtype=torch.int32),
                         planes.contiguous(), logw.gather(-1, order))


def sinkhorn_lse_cuda(xp: torch.Tensor, yp: torch.Tensor, dual: torch.Tensor,
                      logw: torch.Tensor, e_t: torch.Tensor,
                      packed: PackedColumns | None = None) -> torch.Tensor:
    """Launch the kernel: out[b, i] = LSE_j(logw_j + (dual_j - c_ij) / e_b).

    xp (B, 3, M), yp (B, 3, N), dual and logw (B, N), e_t (B, 1): float32,
    contiguous on one CUDA device -> (B, M) float32.  ``packed``: the
    :func:`pack_columns` of ``yp`` and ``logw``, which the kernel reads in
    their place (``None``: packed here).
    """
    b, _, m = xp.shape
    n = yp.shape[-1]
    out = torch.empty((b, m), dtype=torch.float32, device=xp.device)
    if b == 0 or m == 0:
        return out
    if packed is None:
        packed = pack_columns(yp, logw)
    fn = _build.function("sinkhorn_lse", "sinkhorn_lse_launch", _LSE_ARGTYPES)
    err = fn(xp.data_ptr(), packed.planes.data_ptr(),
             packed.index.data_ptr(), packed.count.data_ptr(),
             dual.data_ptr(), packed.logw.data_ptr(), e_t.data_ptr(),
             out.data_ptr(), b, m, n,
             torch.cuda.current_stream(xp.device).cuda_stream)
    if err:
        raise RuntimeError(f"sinkhorn_lse launch failed: CUDA error {err}")
    return out


def sinkhorn_pair_sum_cuda(xp: torch.Tensor, yp: torch.Tensor,
                           f: torch.Tensor, g: torch.Tensor,
                           log_a: torch.Tensor, log_b: torch.Tensor,
                           e_t: torch.Tensor, mode: str) -> torch.Tensor:
    """Launch the pair-sum kernel and its in-order sum of the CTA partials.

    Shapes as :func:`repro_torch.kernels.ref.sinkhorn_pair_sum_ref`;
    ``mode`` is ``"plan"`` or ``"cost"`` -> (B,) float32.
    """
    b, _, m = xp.shape
    n = yp.shape[-1]
    out = torch.empty((b,), dtype=torch.float32, device=xp.device)
    if b == 0:
        return out
    rows = _build.function("sinkhorn_lse", "sinkhorn_rows_per_cta", [])()
    parts = -(-m // rows)  # one partial sum per CTA
    partial = torch.empty((b, max(parts, 1)), dtype=torch.float32,
                          device=xp.device)
    fn = _build.function("sinkhorn_lse", "sinkhorn_pair_sum_launch",
                         _PAIR_ARGTYPES)
    err = fn(xp.data_ptr(), yp.data_ptr(), f.data_ptr(), g.data_ptr(),
             log_a.data_ptr(), log_b.data_ptr(), e_t.data_ptr(),
             partial.data_ptr(), out.data_ptr(), b, m, n,
             int(mode == "plan"),
             torch.cuda.current_stream(xp.device).cuda_stream)
    if err:
        raise RuntimeError(f"sinkhorn_pair_sum launch failed: CUDA error "
                           f"{err}")
    return out
