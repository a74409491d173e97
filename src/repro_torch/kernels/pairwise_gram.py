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
    (M, N) float32.  The host work is kept to what a launch needs: at
    fig2's 72 x 72 the wrapper's host time, not the kernel, sets the pace
    of back-to-back launches.
    """
    m, d = x.shape
    n = y.shape[0]
    out = x.new_empty((m, n))
    if m == 0 or n == 0:
        return out
    fn = _build.function("pairwise_l1", "pairwise_l1_launch", _ARGTYPES)
    err = fn(x.data_ptr(), y.data_ptr(), out.data_ptr(), m, n, d,
             _build.stream_handle(x.device))
    if err:
        raise RuntimeError(f"pairwise_l1 launch failed: CUDA error {err}")
    return out


def small_grid(m: int, n: int) -> bool:
    """True when an (M, N) launch takes the small-grid layout (16 x 16
    output tiles, D chunks spread over the CTA), as the source decides."""
    return bool(_build.function("pairwise_l1", "pairwise_l1_small_grid",
                                [ctypes.c_int] * 2)(m, n))
