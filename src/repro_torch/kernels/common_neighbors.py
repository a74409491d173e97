"""Common-neighbor counts on edges, and the clustering coefficients' row
sums: the CUDA kernel ``csrc/common_neighbors.cu``.

Replaces ``repro/kernels/common_neighbors.py::common_neighbors_pallas``
(and, in :func:`common_neighbors_rowsums_cuda`, the sums
``repro/kernels/ops.py::clustering_coefficients`` takes of it).  The plain
versions are :func:`repro_torch.kernels.ref.common_neighbors_ref`
(re-exported here as ``reference``) and
:func:`repro_torch.kernels.ref.common_neighbors_rowsums_ref`.  In one
launch the kernel sums on the int8 tensor cores G[u,v] = sum_w A[u,w]
A[v,w] over rows of A, which is taken to be symmetric, and either writes
cn[u,v] = A[u,v] G[u,v] or, with the live mask m in the A side, reduces
it to tri2[u] = sum_v A[u,v] m[u] m[v] G[u,v] and deg[u] = m[u] sum_w
A[u,w] m[w]; :func:`layout` sizes its launch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import domination as dm
from repro_torch.kernels.ref import common_neighbors_ref as reference

_CN_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_SUMS_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                  + [ctypes.c_void_p])

# the kernel's constants (csrc/common_neighbors.cu); the rest are
# csrc/domination.cu's (kernels/domination.py)
OUT_PAD = 8  # int32 past every staged output row of the counts
# the most vertices whose row sums fit int32: tri2[u] is N sums of at
# most N products (N^2 < 2^31; without self-loops deg (deg - 1) would do)
SUMS_MAX_N = 46340


def smem_bytes(n: int, gpc: int, sums: bool) -> int:
    """Shared-memory bytes of a launch (``common_neighbors_smem_bytes`` in
    the source computes the same): the graph mapping's two group buffers
    of rows and masks, then the group's int32 counts or, with ``sums``,
    its tri2 and deg; the tile mapping's ring, which the counts reuse, or
    the ring, the two tiles' sums and the graph's mask."""
    np_ = dm.padded(n)
    if np_ <= dm.GRAPH_MAX_NP:
        tail = 8 * gpc * np_ if sums else 4 * gpc * np_ * (np_ + OUT_PAD)
        return 2 * gpc * np_ * (np_ + dm.PAD + 1) + tail
    ring = dm.STAGES * 2 * dm.TILE * (dm.CHUNK + dm.PAD)
    return ring + 8 * dm.TILE + np_ if sums else ring


def layout(batch: int, n: int, sm_count: int, sums: bool = False
           ) -> dm.Layout:
    """The work mapping of a (batch, n, n) launch on a card of ``sm_count``
    SMs: :func:`repro_torch.kernels.domination.layout`'s (whole graphs a
    persistent CTA at padded N <= 128, one CTA per unordered pair of
    128 x 128 tiles above), with this kernel's shared memory for the cn
    epilogue or, with ``sums``, the fused one, whose int32 row sums
    bound N by :data:`SUMS_MAX_N`."""
    if sums and n > SUMS_MAX_N:
        raise ValueError(f"common_neighbors: the row sums overflow int32 "
                         f"past N = {SUMS_MAX_N}, at (B, N) = ({batch}, {n})")
    np_ = dm.padded(n)
    if np_ <= dm.GRAPH_MAX_NP:
        lay = dm.layout(batch, n, sm_count)
    else:  # domination's tile mapping, whose shared memory grows with N
        tiles = -(-np_ // dm.TILE)
        lay = dm.Layout("tile", dm.TILE, 1, batch * tiles * (tiles + 1) // 2,
                        0)
    smem = smem_bytes(n, lay.graphs_per_cta, sums)
    if smem > dm.SMEM_MAX:
        raise ValueError(f"common_neighbors: the {lay.mapping} mapping needs "
                         f"{smem} B of shared memory at (B, N) = "
                         f"({batch}, {n})")
    return lay._replace(smem_bytes=smem)


def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def common_neighbors_cuda(adj: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: cn[b, u, v] = A[u, v] * |N(u) ∩ N(v)|.

    adj (B, N, N) bool, symmetric, contiguous on a CUDA device -> (B, N, N)
    int32.
    """
    b, n, _ = adj.shape
    out = torch.empty((b, n, n), dtype=torch.int32, device=adj.device)
    if b == 0 or n == 0:
        return out
    dev = adj.device
    lay = layout(b, n, _sm_count(dev))
    fn = _build.function("common_neighbors", "common_neighbors_launch",
                         _CN_ARGTYPES)
    err = fn(adj.data_ptr(), out.data_ptr(), b, n, lay.graphs_per_cta,
             lay.ctas, lay.smem_bytes, _build.stream_handle(dev))
    if err:
        raise RuntimeError(f"common_neighbors launch failed: CUDA error {err} "
                           f"({lay})")
    return out


def common_neighbors_rowsums_cuda(adj: torch.Tensor, mask: torch.Tensor
                                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel's fused clustering epilogue: with A' = adj
    restricted to live vertices, tri2[b, u] = sum_v A'[u, v] |N'(u) ∩
    N'(v)| (twice the triangles through u) and deg[b, u] = sum_v A'[u, v].

    adj (B, N, N) bool, symmetric, mask (B, N) bool, both contiguous on one
    CUDA device -> (tri2, deg), (B, N) int32 each.  No (B, N, N) tensor is
    written.
    """
    b, n = mask.shape
    dev = adj.device
    if b == 0 or n == 0:
        empty = torch.empty((b, n), dtype=torch.int32, device=dev)
        return empty, empty.clone()
    lay = layout(b, n, _sm_count(dev), sums=True)
    # the tile mapping adds each CTA's sums into tri2
    tri2 = (torch.zeros if lay.mapping == "tile" else torch.empty)(
        (b, n), dtype=torch.int32, device=dev)
    deg = torch.empty((b, n), dtype=torch.int32, device=dev)
    fn = _build.function("common_neighbors", "common_neighbors_rowsums_launch",
                         _SUMS_ARGTYPES)
    err = fn(adj.data_ptr(), mask.data_ptr(), tri2.data_ptr(), deg.data_ptr(),
             b, n, lay.graphs_per_cta, lay.ctas, lay.smem_bytes,
             _build.stream_handle(dev))
    if err:
        raise RuntimeError(f"common_neighbors (row sums) launch failed: CUDA "
                           f"error {err} ({lay})")
    return tri2, deg
