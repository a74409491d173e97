"""k-core peel sweep: the CUDA kernel ``csrc/kcore_peel.cu`` and its wrapper.

Replaces ``repro/kernels/kcore_peel.py::kcore_peel_pallas``.  The plain
version is :func:`repro_torch.kernels.ref.kcore_peel_ref` (re-exported here
as ``reference``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import kcore_peel_ref as reference

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_SCRATCH_ARGTYPES = [ctypes.c_int] * 3

# the portable thread-block cluster size
MAX_CLUSTER = 8


def cluster_size(batch: int, n: int, sm_count: int) -> int:
    """CTAs per graph (a thread-block cluster) for a (batch, n, n) launch.

    Doubles from 1 while the batch's CTAs would still fit the SMs once each
    and every CTA keeps at least one 32-vertex word: 1 when the batch alone
    fills the SMs (4096 n64 graphs, 256 of 320 on 132 SMs), 8 for Table 1's
    16 graphs of 1024.
    """
    words = (n + 31) // 32
    c = 1
    while (c < MAX_CLUSTER and batch * 2 * c <= sm_count
           and 2 * c <= words):
        c *= 2
    return c


def scratch_words(batch: int, n: int, cluster: int) -> int:
    """int32 words of global scratch a (batch, n, n) launch at ``cluster``
    CTAs per graph needs: 0 when every CTA's packed rows fit in shared
    memory (the source decides, from the card's shared-memory limit)."""
    return _build.function("kcore_peel", "kcore_peel_scratch_words",
                           _SCRATCH_ARGTYPES, ctypes.c_longlong)(
                               batch, n, cluster)


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
    c = cluster_size(b, n, torch.cuda.get_device_properties(
        adj.device).multi_processor_count)
    words = scratch_words(b, n, c)
    # packed rows that do not fit in shared memory live here
    scratch = (torch.empty(words, dtype=torch.int32, device=adj.device)
               if words else None)
    fn = _build.function("kcore_peel", "kcore_peel_launch", _ARGTYPES)
    err = fn(adj.data_ptr(), alive.data_ptr(), out.data_ptr(),
             scratch.data_ptr() if words else None, b, n, int(k),
             int(sweeps), c, _build.stream_handle(adj.device))
    if err:
        raise RuntimeError(f"kcore_peel launch failed: CUDA error {err} "
                           f"(cluster of {c} CTAs per graph)")
    return out
