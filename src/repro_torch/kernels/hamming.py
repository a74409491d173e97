"""Masked Hamming distances over packed LSH codes: the CUDA kernel
``csrc/hamming.cu``.

Replaces ``repro/kernels/hamming.py::hamming_scan_pallas``.  The plain
version is :func:`repro_torch.kernels.ref.hamming_scan_ref` (re-exported
here as ``reference``).

Codes travel as 32-bit words.  Torch has no popcount, and on the CPU its
``uint32`` has no shifts, so on the torch side the words are ``int32``
tensors that hold the same bit patterns (bit 31 is the sign bit).  A
thread of the kernel owns 4 consecutive corpus rows and writes each
query's 4 distances as one 16-byte store; up to 8 words a code the rows
sit in registers; :func:`layout` sizes the launch.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import hamming_scan_ref as reference  # noqa: F401

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]

# the kernel's constants (csrc/hamming.cu)
THREADS = 128        # a CTA's threads
ROWS_PER_THREAD = 4  # consecutive corpus rows a thread owns
TILE_N = THREADS * ROWS_PER_THREAD  # corpus rows a CTA, 512
MAX_REG_WORDS = 8    # the register path's widest code (lsh_bits <= 256)
QUERY_GROUP = 4      # queries a CTA of the register path
CHUNK_GROUP = 16     # queries a CTA of the chunked path


class Layout(NamedTuple):
    """A launch: ``path`` "registers" (W <= 8: a thread's rows in
    registers, the CTA's query words staged once) or "chunked" (8 words a
    step); ``query_group`` queries a CTA; ``query_groups`` x ``row_blocks``
    CTAs of 512 corpus rows, ``ctas`` in all."""
    path: str
    query_group: int
    query_groups: int
    row_blocks: int
    ctas: int


@functools.lru_cache(maxsize=256)
def layout(q: int, n: int, w: int, sm_count: int) -> Layout:
    """The launch of a (Q, W) x (N, W) scan on a card of ``sm_count`` SMs.

    The register path up to 8 words a code, 4 queries a CTA (on the card,
    NVIDIA H100, groups of 4 wrote the index's 256 x 65,536 and 256 x
    262,144 outputs faster than groups of 8, 16, 32 or 64), halved while
    the grid would have fewer CTAs than SMs (a 4-shard mesh's 1024-row
    scans); wider codes take the chunked path, 16 queries a CTA.
    """
    row_blocks = max(1, -(-n // TILE_N))
    if w > MAX_REG_WORDS:
        path, group = "chunked", CHUNK_GROUP
    else:
        path, group = "registers", max(1, min(QUERY_GROUP, q))
        while group > 1 and -(-q // group) * row_blocks < sm_count:
            group = -(-group // 2)
    groups = max(1, -(-q // group))
    return Layout(path, group, groups, row_blocks, groups * row_blocks)


def pack_codes_u32(codes_u8: np.ndarray) -> np.ndarray:
    """(B, n_bytes) uint8 packed codes -> (B, W) uint32 words (host side).

    Pads the byte axis to a multiple of 4 with zeros before the view, so
    any ``lsh_bits`` multiple of 8 maps onto whole words; both sides of a
    scan must come through here so the (platform-endian) byte -> word layout
    cancels out of every XOR.
    """
    codes_u8 = np.ascontiguousarray(codes_u8, dtype=np.uint8)
    b, nbytes = codes_u8.shape
    pad = (-nbytes) % 4
    if pad:
        codes_u8 = np.concatenate(
            [codes_u8, np.zeros((b, pad), np.uint8)], axis=1)
    return codes_u8.view(np.uint32)


def as_int32_words(words) -> torch.Tensor:
    """uint32 words (numpy or torch) -> an int32 tensor of the same bits.

    A numpy array gives a CPU tensor; a torch tensor keeps its device.
    """
    if isinstance(words, torch.Tensor):
        if words.dtype not in (torch.uint32, torch.int32):
            raise TypeError(f"want uint32 or int32 words, got {words.dtype}")
        return words.contiguous().view(torch.int32)
    words = np.ascontiguousarray(words)
    if words.dtype not in (np.uint32, np.int32):
        raise TypeError(f"want uint32 or int32 words, got {words.dtype}")
    return torch.from_numpy(words.view(np.int32))


def hamming_scan_cuda(codes_q: torch.Tensor, mask_q: torch.Tensor,
                      codes_db: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: dist[i, j] = sum_w popc((q[i, w] ^ c[j, w]) & m[i, w]).

    codes_q and mask_q (Q, W), codes_db (N, W): int32 bit patterns,
    contiguous on one CUDA device -> (Q, N) int32.
    """
    nq, w = codes_q.shape
    n = codes_db.shape[0]
    out = torch.empty((nq, n), dtype=torch.int32, device=codes_q.device)
    if nq == 0 or n == 0:
        return out
    dev = codes_q.device
    lay = layout(nq, n, w, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    fn = _build.function("hamming", "hamming_scan_launch", _ARGTYPES)
    err = fn(codes_q.data_ptr(), mask_q.data_ptr(), codes_db.data_ptr(),
             out.data_ptr(), nq, n, w, lay.query_group,
             _build.stream_handle(dev))
    if err:
        raise RuntimeError(f"hamming_scan launch failed: CUDA error {err} "
                           f"({lay})")
    return out
