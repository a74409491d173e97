"""Dominated-vertex matrix: the CUDA kernel ``csrc/domination.cu``.

Replaces ``repro/kernels/domination.py::domination_pallas``.  The plain
version is :func:`repro_torch.kernels.ref.domination_ref` (re-exported here
as ``reference``).  In one launch the kernel sums on the int8 tensor cores
G[u,v] = sum_w (A'[u,w] m[w]) A'[v,w] and d[u] = sum_w A'[u,w] m[w], with
A' the adjacency with its diagonal set and m the mask, and v dominates u
where G[u,v] == d[u], u != v and both are live; :func:`layout` sizes its
launch.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import domination_ref as reference

_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
             + [ctypes.c_void_p])

# the kernel's constants (csrc/domination.cu)
WARPS = 8          # a CTA of 8 warps, one 32 x 64 warp tile each at a time
TILE = 128         # u or v tile of the tile mapping
GRAPH_MAX_NP = 128  # the graph mapping's largest padded N
CHUNK = 128        # K bytes a ring stage holds (tile mapping)
STAGES = 3
PAD = 16           # bytes past every staged or output row
SMEM_MAX = 232448  # 227 KB, a block's shared-memory limit on sm_90
DOUBLE_MAX = 113 * 1024  # the most for two CTAs to share an SM
RESIDENT = 2       # CTAs an SM holds (__launch_bounds__(256, 2))


class Layout(NamedTuple):
    """A launch's work mapping: ``mapping`` "graph" (persistent CTAs, each
    staging groups of ``graphs_per_cta`` whole graphs, two groups at a
    time) or "tile" (a CTA streams one (u tile, v tile) pair's rows through
    a ring); ``tile`` is the side of a u or v tile; ``ctas`` and
    ``smem_bytes`` size the launch."""
    mapping: str
    tile: int
    graphs_per_cta: int
    ctas: int
    smem_bytes: int


def padded(n: int) -> int:
    """N rounded up to 32: the K the Gram runs over."""
    return -(-n // 32) * 32


def warp_tiles(rows: int, cols: int) -> int:
    """32 x 64 warp tiles that cover a rows x cols tile (multiples of 32)."""
    return (rows // 32) * -(-cols // 64)


def smem_bytes(n: int, gpc: int) -> int:
    """Shared-memory bytes of a launch (``domination_smem_bytes`` in the
    source computes the same)."""
    np_ = padded(n)
    if np_ <= GRAPH_MAX_NP:
        return 2 * gpc * np_ * (np_ + PAD + 1) + gpc * np_ * (np_ + PAD)
    ring = STAGES * 2 * TILE * (CHUNK + PAD)
    return max(ring, 2 * TILE * (TILE + PAD)) + 4 * TILE + np_


def layout(batch: int, n: int, sm_count: int) -> Layout:
    """The work mapping of a (batch, n, n) launch on a card of ``sm_count``
    SMs.

    The graph mapping at padded N <= 128, where one tile covers a graph: a
    group holds as many graphs as fill a CTA's 8 warps with 32 x 64 warp
    tiles (8 at N <= 32, 4 at N <= 64), halved while the batch would give
    fewer groups than SMs, and the CTAs are persistent, two an SM at most.
    Above 128 the tile mapping: one CTA per unordered pair of 128 x 128
    tiles.
    """
    np_ = padded(n)
    if np_ <= GRAPH_MAX_NP:
        gpc, per = 1, warp_tiles(np_, np_)
        while 2 * gpc * per <= WARPS:
            gpc *= 2
        while gpc > 1 and -(-batch // gpc) < sm_count:
            gpc //= 2
        return Layout("graph", np_, gpc,
                      min(-(-batch // gpc), RESIDENT * sm_count),
                      smem_bytes(n, gpc))
    tiles = -(-np_ // TILE)
    smem = smem_bytes(n, 1)
    if smem > SMEM_MAX:
        raise ValueError(f"domination: the tile mapping needs {smem} B of "
                         f"shared memory at N = {n}")
    return Layout("tile", TILE, 1, batch * tiles * (tiles + 1) // 2, smem)


def domination_cuda(adj: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: dom[b, u, v] = "v dominates u".

    adj (B, N, N) bool, mask (B, N) bool, both contiguous on one CUDA
    device -> (B, N, N) bool.
    """
    b, n = mask.shape
    out = torch.empty_like(adj)
    if b == 0 or n == 0:
        return out
    dev = adj.device
    lay = layout(b, n, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    fn = _build.function("domination", "domination_launch", _ARGTYPES)
    err = fn(adj.data_ptr(), mask.data_ptr(), out.data_ptr(), b, n,
             lay.graphs_per_cta, lay.ctas, lay.smem_bytes,
             _build.stream_handle(dev))
    if err:
        raise RuntimeError(f"domination launch failed: CUDA error {err} "
                           f"({lay})")
    return out
