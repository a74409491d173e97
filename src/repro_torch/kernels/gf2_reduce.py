"""Bit-packed GF(2) reduction: the CUDA kernel ``csrc/gf2_reduce.cu``.

Replaces both ``repro/kernels/gf2_reduce.py::gf2_reduce_pallas`` and
``::gf2_reduce_batch_pallas``: one launch reduces every (graph, dimension
block) pair.  The plain version is
:func:`repro_torch.kernels.ref.gf2_reduce_ref` (re-exported here as
``reference``).  Each matrix's chase stops at its last nonzero column; a
pivot table indexed by row holds the reduced columns, and the working
column sits in registers; :func:`layout` sizes each block's part of the
launch.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import gf2_reduce_ref as reference

MAX_BLOCKS = 4
_ARGTYPES = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
_ARGS = ctypes.c_longlong * (10 * MAX_BLOCKS)

# the kernel's constants (csrc/gf2_reduce.cu)
THREADS = 128        # a CTA's threads
KINDS = ("thread", "segment", "warp", "global")
SMEM_MAX = 232448    # 227 KB, a block's shared-memory limit on sm_90


class Layout(NamedTuple):
    """A block's part of the launch: ``kind`` "thread" (W <= 4: one thread
    chases a matrix, one matrix a warp), "segment" (8, 16 or 32 lanes a
    matrix, W <= lanes), "warp" (a warp a matrix, W > 32, the working
    column in shared memory) or "global" (a warp a matrix, in place in the
    output, past a CTA's shared memory); ``lanes`` the threads a matrix
    takes; ``matrices_per_cta``, ``ctas`` and ``smem_bytes`` size it."""
    kind: str
    lanes: int
    matrices_per_cta: int
    ctas: int
    smem_bytes: int


def _ceil4(x: int) -> int:
    return -(-x // 4) * 4


def smem_bytes(kind: str, mpc: int, s: int, w: int, r: int) -> int:
    """Shared-memory bytes of one CTA (``gf2_reduce_smem_bytes`` in the
    source computes the same): one past each matrix's last nonzero column,
    the staged columns, and per matrix the pivot table (R + 1 rows of 4
    words, of W words, or none: the owner vector is the table), owner (R +
    1 ints) and positive (S bytes, padded to words).  The global layout
    keeps only the first."""
    if kind == "global":
        return 4 * _ceil4(mpc)
    table = {"thread": 4, "segment": w, "warp": 0}[kind]
    return 4 * (_ceil4(mpc) + _ceil4(mpc * s * w) + mpc * (r + 1) * (table + 1)
                + mpc * _ceil4(s) // 4)


@functools.lru_cache(maxsize=256)
def layout(g: int, s: int, w: int, r: int, sm_count: int) -> Layout:
    """The layout of a (G, S, W) block with R rows on a card of
    ``sm_count`` SMs.

    By W: one thread up to 4 words (the column one 16-byte register quad;
    one matrix a warp, so no two chases share a warp's instructions), a
    segment of 8, 16 or 32 lanes up to 32 words, a warp with the column in
    memory above.  Matrices a CTA: as few as spread the block over the SMs
    (ceil(G / SMs)), at most one a segment or warp, and as many as the 227
    KB of shared memory take.  A matrix that does not fit alone takes the
    global layout.
    """
    if w <= 4:
        kind, lanes = "thread", 32
    elif w <= 32:
        kind, lanes = "segment", 8 if w <= 8 else 16 if w <= 16 else 32
    else:
        kind, lanes = "warp", 32
    if smem_bytes(kind, 1, s, w, r) > SMEM_MAX:
        kind, lanes = "global", 32
    mpc = max(1, min(THREADS // lanes, -(-g // sm_count)))
    while mpc > 1 and smem_bytes(kind, mpc, s, w, r) > SMEM_MAX:
        mpc -= 1
    return Layout(kind, lanes, mpc, -(-g // mpc),
                  smem_bytes(kind, mpc, s, w, r))


@functools.lru_cache(maxsize=16)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=256)
def _plan(g: int, shapes: tuple, sms: int):
    """What a launch over blocks of these (S, W, R) shapes needs besides
    the pointers: the int32 words (each block's reduced matrix, then its
    owner rows, each region 16-byte aligned) and bool bytes (positive) of
    the outputs, each output's (size, stride, offset) in them, and each
    block's layout and launch arguments S, W, R, kind, lanes, matrices a
    CTA."""
    words, flags, views, lays, consts = 0, 0, [], [], []
    for s, w, r in shapes:
        red = ((g, s, w), (s * w, w, 1), words)
        words += _ceil4(g * s * w)
        own = ((g, r), (r, 1), words)
        words += _ceil4(g * r)
        views.append((red, own, ((g, s), (s, 1), flags)))
        flags += g * s
        lay = layout(g, s, w, r, sms)
        lays.append(lay)
        consts.append((s, w, r, KINDS.index(lay.kind), lay.lanes,
                       lay.matrices_per_cta))
    return words, flags, views, lays, consts


def gf2_reduce_cuda(blocks, n_rows):
    """Reduce ``blocks[d]`` (G, S_d, W_d) int32 with ``n_rows[d]`` rows each.

    All blocks share the graph count G and one CUDA device, and are
    contiguous.  Returns one ``(reduced, owner (G, R_d) int32, positive
    (G, S_d) bool)`` triple per block, from a single launch; the outputs
    are views of one int32 and one bool allocation.
    """
    nb = len(blocks)
    if not 1 <= nb <= MAX_BLOCKS:
        raise ValueError(f"1..{MAX_BLOCKS} blocks per launch, got {nb}")
    g = blocks[0].shape[0]
    dev = blocks[0].device
    words, flags, views, lays, consts = _plan(
        g, tuple((b.shape[1], b.shape[2], int(r))
                 for b, r in zip(blocks, n_rows)), _sm_count(dev.index))
    buf = torch.empty(words, dtype=torch.int32, device=dev)
    pos = torch.empty(flags, dtype=torch.bool, device=dev)
    outs = [(buf.as_strided(*red), buf.as_strided(*own), pos.as_strided(*flg))
            for red, own, flg in views]
    if g == 0:
        return outs
    base, pbase = buf.data_ptr(), pos.data_ptr()
    args = _ARGS()
    for d, (b, (red, own, flg)) in enumerate(zip(blocks, views)):
        args[10 * d:10 * d + 10] = (b.data_ptr(), base + 4 * red[2],
                                    base + 4 * own[2], pbase + flg[2],
                                    *consts[d])
    fn = _build.function("gf2_reduce", "gf2_reduce_launch", _ARGTYPES)
    err = fn(nb, g, args, _build.stream_handle(dev))
    if err:
        raise RuntimeError(f"gf2_reduce launch failed: CUDA error {err} "
                           f"({lays})")
    return outs
