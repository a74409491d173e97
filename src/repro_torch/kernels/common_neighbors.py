"""Common-neighbor counts on edges: the CUDA kernel
``csrc/common_neighbors.cu``.

Replaces ``repro/kernels/common_neighbors.py::common_neighbors_pallas``.
The plain version is :func:`repro_torch.kernels.ref.common_neighbors_ref`
(re-exported here as ``reference``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import common_neighbors_ref as reference

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]


def common_neighbors_cuda(adj: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: cn[b, u, v] = A[u, v] * |N(u) ∩ N(v)|.

    adj (B, N, N) bool, contiguous on a CUDA device -> (B, N, N) int32.
    """
    b, n, _ = adj.shape
    out = torch.empty((b, n, n), dtype=torch.int32, device=adj.device)
    if b == 0 or n == 0:
        return out
    scratch = torch.empty((b, n, (n + 31) // 32), dtype=torch.int32,
                          device=adj.device)
    fn = _build.function("common_neighbors", "common_neighbors_launch",
                         _ARGTYPES)
    err = fn(adj.data_ptr(), out.data_ptr(), scratch.data_ptr(), b, n,
             torch.cuda.current_stream(adj.device).cuda_stream)
    if err:
        raise RuntimeError(f"common_neighbors launch failed: CUDA error {err}")
    return out
