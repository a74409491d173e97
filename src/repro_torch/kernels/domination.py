"""Dominated-vertex matrix: the CUDA kernel ``csrc/domination.cu``.

Replaces ``repro/kernels/domination.py::domination_pallas``.  The plain
version is :func:`repro_torch.kernels.ref.domination_ref` (re-exported here
as ``reference``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import domination_ref as reference

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p]


def domination_cuda(adj: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: dom[b, u, v] = "v dominates u".

    adj (B, N, N) bool, mask (B, N) bool, both contiguous on one CUDA
    device -> (B, N, N) bool.
    """
    b, n = mask.shape
    out = torch.empty_like(adj)
    if b == 0 or n == 0:
        return out
    w = (n + 31) // 32
    scratch = torch.empty((b, n, w), dtype=torch.int32, device=adj.device)
    fn = _build.function("domination", "domination_launch", _ARGTYPES)
    err = fn(adj.data_ptr(), mask.data_ptr(), out.data_ptr(),
             scratch.data_ptr(), b, n,
             torch.cuda.current_stream(adj.device).cuda_stream)
    if err:
        raise RuntimeError(f"domination launch failed: CUDA error {err}")
    return out
