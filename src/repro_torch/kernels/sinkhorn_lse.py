"""Blocked Sinkhorn reductions: the CUDA kernels ``csrc/sinkhorn_lse.cu``.

Replaces ``repro/kernels/sinkhorn_lse.py::sinkhorn_lse_pallas`` and
``::sinkhorn_pair_sum_pallas``.  The plain versions are
:func:`repro_torch.kernels.ref.sinkhorn_lse_ref` and
:func:`repro_torch.kernels.ref.sinkhorn_pair_sum_ref`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_LSE_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_PAIR_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
                  + [ctypes.c_void_p])


def sinkhorn_lse_cuda(xp: torch.Tensor, yp: torch.Tensor, dual: torch.Tensor,
                      logw: torch.Tensor, e_t: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: out[b, i] = LSE_j(logw_j + (dual_j - c_ij) / e_b).

    xp (B, 3, M), yp (B, 3, N), dual and logw (B, N), e_t (B, 1): float32,
    contiguous on one CUDA device -> (B, M) float32.
    """
    b, _, m = xp.shape
    n = yp.shape[-1]
    out = torch.empty((b, m), dtype=torch.float32, device=xp.device)
    if b == 0 or m == 0:
        return out
    fn = _build.function("sinkhorn_lse", "sinkhorn_lse_launch", _LSE_ARGTYPES)
    err = fn(xp.data_ptr(), yp.data_ptr(), dual.data_ptr(), logw.data_ptr(),
             e_t.data_ptr(), out.data_ptr(), b, m, n,
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
