"""Bit-packed GF(2) reduction: the CUDA kernel ``csrc/gf2_reduce.cu``.

Replaces both ``repro/kernels/gf2_reduce.py::gf2_reduce_pallas`` and
``::gf2_reduce_batch_pallas``: one launch reduces every (graph, dimension
block) pair.  The plain version is
:func:`repro_torch.kernels.ref.gf2_reduce_ref` (re-exported here as
``reference``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import gf2_reduce_ref as reference

MAX_BLOCKS = 4
_PTRS = ctypes.c_void_p * MAX_BLOCKS
_INTS = ctypes.c_int * MAX_BLOCKS
_ARGTYPES = [ctypes.c_int, ctypes.c_int, _PTRS, _PTRS, _PTRS, _PTRS,
             _INTS, _INTS, _INTS, ctypes.c_void_p]


def gf2_reduce_cuda(blocks, n_rows):
    """Reduce ``blocks[d]`` (G, S_d, W_d) int32 with ``n_rows[d]`` rows each.

    All blocks share the graph count G and one CUDA device, and are
    contiguous.  Returns one ``(reduced, owner (G, R_d) int32, positive
    (G, S_d) bool)`` triple per block, from a single launch.
    """
    if not 1 <= len(blocks) <= MAX_BLOCKS:
        raise ValueError(f"1..{MAX_BLOCKS} blocks per launch, got {len(blocks)}")
    g = blocks[0].shape[0]
    dev = blocks[0].device
    outs = [(torch.empty_like(b),
             torch.empty((g, int(r)), dtype=torch.int32, device=dev),
             torch.empty((g, b.shape[1]), dtype=torch.bool, device=dev))
            for b, r in zip(blocks, n_rows)]
    if g == 0:
        return outs
    nb = len(blocks)
    pad = [0] * (MAX_BLOCKS - nb)
    fn = _build.function("gf2_reduce", "gf2_reduce_launch", _ARGTYPES)
    err = fn(nb, g,
             _PTRS(*[b.data_ptr() for b in blocks], *pad),
             _PTRS(*[o[0].data_ptr() for o in outs], *pad),
             _PTRS(*[o[1].data_ptr() for o in outs], *pad),
             _PTRS(*[o[2].data_ptr() for o in outs], *pad),
             _INTS(*[b.shape[1] for b in blocks], *pad),
             _INTS(*[b.shape[2] for b in blocks], *pad),
             _INTS(*[int(r) for r in n_rows], *pad),
             torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"gf2_reduce launch failed: CUDA error {err}")
    return outs
