"""Blocked Sinkhorn reductions: the CUDA kernels ``csrc/sinkhorn_lse.cu``.

Replaces ``repro/kernels/sinkhorn_lse.py::sinkhorn_lse_pallas`` and
``::sinkhorn_pair_sum_pallas``.  The plain versions are
:func:`repro_torch.kernels.ref.sinkhorn_lse_ref` and
:func:`repro_torch.kernels.ref.sinkhorn_pair_sum_ref`.  The pair sum is one
launch: each CTA compacts its rows and the item's columns of finite log
weight into shared memory, spreads their pairs over all its threads, and
sums in a fixed order; :func:`layout` sizes the launch.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

_LSE_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_PAIR_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
                  + [ctypes.c_void_p])

# the kernels' constants (csrc/sinkhorn_lse.cu)
PAIR_THREADS = (64, 128, 256, 512)  # the pair sum's CTA sizes
PAIR_SLOTS = 8             # slots a thread scans per compaction step
PAIR_MIN_SHARE = 32        # the fewest rows layout gives a CTA of the pair sum


class PairLayout(NamedTuple):
    """The pair sum's launch: ``ctas_per_item`` CTAs of ``threads``
    threads an item, each owning ``rows_per_cta`` consecutive rows (the
    last may own fewer); a shared-memory stage holds ``stage`` compacted
    rows and as many columns; ``ctas`` in all."""
    threads: int
    ctas_per_item: int
    rows_per_cta: int
    stage: int
    ctas: int


@functools.lru_cache(maxsize=256)
def layout(b: int, m: int, n: int, sm_count: int) -> PairLayout:
    """The pair sum's launch for (B, 3, M) rows and (B, 3, N) columns on a
    card of ``sm_count`` SMs.

    One CTA an item once B > SMs / 2, where the batch alone fills the
    card; below that SMs // B CTAs an item, splitting its rows, but never
    fewer than ``PAIR_MIN_SHARE`` rows a CTA.  Threads: the
    fewest of 64, 128, 256, 512 whose compaction step (8 slots a thread)
    covers both a CTA's rows and the N columns, else 512; a stage holds
    twice the threads.
    """
    per = max(1, sm_count // max(b, 1))
    per = min(per, max(1, -(-m // PAIR_MIN_SHARE)))
    share = max(1, -(-m // per))
    per = max(1, -(-m // share))
    span = max(share, n)
    threads = next((t for t in PAIR_THREADS if t * PAIR_SLOTS >= span),
                   PAIR_THREADS[-1])
    return PairLayout(threads, per, share, 2 * threads, b * per)


# per (device, stream): the pair sum's per-item tickets, zero between
# launches (each launch's last CTA of an item resets its own)
_tickets: dict[tuple[int, int], torch.Tensor] = {}


def _ticket_counters(device: torch.device, stream: int,
                     b: int) -> torch.Tensor:
    key = (device.index, stream)
    t = _tickets.get(key)
    if t is None or t.numel() < b:
        t = _tickets[key] = torch.zeros(max(b, 4096), dtype=torch.int32,
                                        device=device)
    return t


class PackedColumns(NamedTuple):
    """One side's columns of nonzero weight, packed in column order per
    batch item (:func:`pack_columns`).  ``index`` (B, N) int32: entry t <
    ``count[b]`` is the t-th column whose log weight is not -inf, the rest
    the other columns; ``count`` (B,) int32; ``planes`` (B, 3, N) and
    ``logw`` (B, N) float32: the planes and log weights gathered through
    ``index``."""
    index: torch.Tensor
    count: torch.Tensor
    planes: torch.Tensor
    logw: torch.Tensor


def pack_columns(yp: torch.Tensor, logw: torch.Tensor) -> PackedColumns:
    """Pack the columns of (B, 3, N) planes ``yp`` whose (B, N) log weight
    ``logw`` is not -inf (the only ones that reach an LSE), in column order.

    Plain PyTorch, padded to N so the host never waits on the device.  A
    Sinkhorn call packs each side once and passes the pack to every launch
    with the same log weights.
    """
    weighted = logw != float("-inf")
    order = torch.argsort((~weighted).to(torch.uint8), dim=-1, stable=True)
    planes = yp.gather(-1, order[:, None, :].expand(-1, 3, -1))
    return PackedColumns(order.to(torch.int32),
                         weighted.sum(-1, dtype=torch.int32),
                         planes.contiguous(), logw.gather(-1, order))


def sinkhorn_lse_cuda(xp: torch.Tensor, yp: torch.Tensor, dual: torch.Tensor,
                      logw: torch.Tensor, e_t: torch.Tensor,
                      packed: PackedColumns | None = None) -> torch.Tensor:
    """Launch the kernel: out[b, i] = LSE_j(logw_j + (dual_j - c_ij) / e_b).

    xp (B, 3, M), yp (B, 3, N), dual and logw (B, N), e_t (B, 1): float32,
    contiguous on one CUDA device -> (B, M) float32.  ``packed``: the
    :func:`pack_columns` of ``yp`` and ``logw``, which the kernel reads in
    their place (``None``: packed here).
    """
    b, _, m = xp.shape
    n = yp.shape[-1]
    out = torch.empty((b, m), dtype=torch.float32, device=xp.device)
    if b == 0 or m == 0:
        return out
    if packed is None:
        packed = pack_columns(yp, logw)
    fn = _build.function("sinkhorn_lse", "sinkhorn_lse_launch", _LSE_ARGTYPES)
    err = fn(xp.data_ptr(), packed.planes.data_ptr(),
             packed.index.data_ptr(), packed.count.data_ptr(),
             dual.data_ptr(), packed.logw.data_ptr(), e_t.data_ptr(),
             out.data_ptr(), b, m, n, _build.stream_handle(xp.device))
    if err:
        raise RuntimeError(f"sinkhorn_lse launch failed: CUDA error {err}")
    return out


def sinkhorn_pair_sum_cuda(xp: torch.Tensor, yp: torch.Tensor,
                           f: torch.Tensor, g: torch.Tensor,
                           log_a: torch.Tensor, log_b: torch.Tensor,
                           e_t: torch.Tensor, mode: str) -> torch.Tensor:
    """Launch the pair-sum kernel, one launch in the :func:`layout` of its
    shape.

    Shapes as :func:`repro_torch.kernels.ref.sinkhorn_pair_sum_ref`;
    ``mode`` is ``"plan"`` or ``"cost"`` -> (B,) float32.  With no rows
    the sums are zeros and nothing is launched.
    """
    b, _, m = xp.shape
    n = yp.shape[-1]
    dev = xp.device
    if b == 0 or m == 0:
        return torch.zeros((b,), dtype=torch.float32, device=dev)
    out = torch.empty((b,), dtype=torch.float32, device=dev)
    lay = layout(b, m, n, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    stream = _build.stream_handle(dev)
    partial = ticket = None
    if lay.ctas_per_item > 1:
        partial = torch.empty((lay.ctas,), dtype=torch.float32, device=dev)
        ticket = _ticket_counters(dev, stream, b)
    fn = _build.function("sinkhorn_lse", "sinkhorn_pair_sum_launch",
                         _PAIR_ARGTYPES)
    err = fn(xp.data_ptr(), yp.data_ptr(), f.data_ptr(), g.data_ptr(),
             log_a.data_ptr(), log_b.data_ptr(), e_t.data_ptr(),
             None if partial is None else partial.data_ptr(),
             None if ticket is None else ticket.data_ptr(),
             out.data_ptr(), b, m, n, int(mode == "plan"), lay.threads,
             lay.ctas_per_item, lay.rows_per_cta, stream)
    if err:
        raise RuntimeError(f"sinkhorn_pair_sum launch failed: CUDA error "
                           f"{err} ({lay})")
    return out
