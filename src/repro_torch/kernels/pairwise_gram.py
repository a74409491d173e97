"""Pairwise-L1 Gram matrix: the CUDA kernel ``csrc/pairwise_l1.cu``.

Replaces ``repro/kernels/pairwise_gram.py::pairwise_l1_pallas``.  The plain
version is :func:`repro_torch.kernels.ref.pairwise_l1_ref` (re-exported
here as ``reference``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import pairwise_l1_ref as reference

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def pairwise_l1_cuda(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: gram[i, j] = sum_d |x[i, d] - y[j, d]|.

    x (M, D) and y (N, D) float32, contiguous on one CUDA device ->
    (M, N) float32.
    """
    m, d = x.shape
    n = y.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return out
    fn = _build.function("pairwise_l1", "pairwise_l1_launch", _ARGTYPES)
    err = fn(x.data_ptr(), y.data_ptr(), out.data_ptr(), m, n, d,
             torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"pairwise_l1 launch failed: CUDA error {err}")
    return out
