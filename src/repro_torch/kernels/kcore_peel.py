"""k-core peel sweep: the CUDA kernel ``csrc/kcore_peel.cu`` and its wrapper.

Replaces ``repro/kernels/kcore_peel.py::kcore_peel_pallas``.  The plain
version is :func:`repro_torch.kernels.ref.kcore_peel_ref` (re-exported here
as ``reference``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, tuning
from repro_torch.kernels.ref import kcore_peel_ref as reference

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def kcore_peel_cuda(adj: torch.Tensor, alive: torch.Tensor, k: int,
                    sweeps: int = 1) -> torch.Tensor:
    """Launch the peel kernel: ``sweeps`` Jacobi sweeps, 0 = to the fixpoint.

    adj (B, N, N) bool, alive (B, N) bool, both contiguous on one CUDA
    device -> (B, N) bool.
    """
    b, n = alive.shape
    out = torch.empty_like(alive)
    if b == 0 or n == 0:
        return out
    w = (n + 31) // 32
    # packed rows that do not fit in shared memory live here
    scratch = torch.empty((b, w, n), dtype=torch.int32, device=adj.device)
    cap = tuning.resolve_tiles("kcore_peel", adj.device)["max_threads"]
    threads = max(32, min(int(cap) // 32, w) * 32)
    fn = _build.function("kcore_peel", "kcore_peel_launch", _ARGTYPES)
    err = fn(adj.data_ptr(), alive.data_ptr(), out.data_ptr(),
             scratch.data_ptr(), b, n, int(k), int(sweeps), threads,
             torch.cuda.current_stream(adj.device).cuda_stream)
    if err:
        raise RuntimeError(f"kcore_peel launch failed: CUDA error {err}")
    return out
