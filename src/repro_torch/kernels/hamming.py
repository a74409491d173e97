"""Masked Hamming distances over packed LSH codes: the CUDA kernel
``csrc/hamming.cu``.

Replaces ``repro/kernels/hamming.py::hamming_scan_pallas``.  The plain
version is :func:`repro_torch.kernels.ref.hamming_scan_ref` (re-exported
here as ``reference``).

Codes travel as 32-bit words.  Torch has no popcount, and on the CPU its
``uint32`` has no shifts, so on the torch side the words are ``int32``
tensors that hold the same bit patterns (bit 31 is the sign bit).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import hamming_scan_ref as reference  # noqa: F401

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


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
    fn = _build.function("hamming", "hamming_scan_launch", _ARGTYPES)
    err = fn(codes_q.data_ptr(), mask_q.data_ptr(), codes_db.data_ptr(),
             out.data_ptr(), nq, n, w,
             torch.cuda.current_stream(codes_q.device).cuda_stream)
    if err:
        raise RuntimeError(f"hamming_scan launch failed: CUDA error {err}")
    return out
