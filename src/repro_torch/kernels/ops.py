"""Public kernel wrappers: check the inputs, then run kernel or plain version.

A wrapper takes the tensors' device as the choice: for CPU tensors it runs
the plain PyTorch version (:mod:`repro_torch.kernels.ref`); for CUDA tensors
it launches the hand-written kernel, or raises.  There is no fallback from
one to the other.  Each launch adds one to
``repro_torch.counters.KERNEL_LAUNCHES[name]``.
"""
from __future__ import annotations

import torch

from repro_torch import counters
from repro_torch.kernels import ref
from repro_torch.kernels.common_neighbors import common_neighbors_cuda
from repro_torch.kernels.domination import domination_cuda
from repro_torch.kernels.gf2_reduce import MAX_BLOCKS, gf2_reduce_cuda
from repro_torch.kernels.kcore_peel import kcore_peel_cuda
from repro_torch.kernels.pairwise_gram import pairwise_l1_cuda
from repro_torch.kernels.sinkhorn_lse import (
    sinkhorn_lse_cuda, sinkhorn_pair_sum_cuda)


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: want dtype {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: want shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _route(device: torch.device, kernel: str) -> bool:
    """True for the kernel (CUDA), False for the plain version (CPU)."""
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise RuntimeError(f"{kernel}: no kernel or plain version for {device}")


def kcore_peel(adj: torch.Tensor, alive: torch.Tensor, k: int,
               sweeps: int = 1) -> torch.Tensor:
    """``sweeps`` k-core peel sweeps over a (B, N, N) batch; 0 = fixpoint.

    On CUDA the whole fixpoint runs inside one launch, one CTA per graph.
    """
    b, n = alive.shape
    _check("kcore_peel adj", adj, torch.bool, (b, n, n), alive.device)
    _check("kcore_peel alive", alive, torch.bool, (b, n), alive.device)
    if sweeps < 0:
        raise ValueError(f"sweeps must be >= 0, got {sweeps}")
    if _route(alive.device, "kcore_peel"):
        out = kcore_peel_cuda(adj, alive, k, sweeps)
        if b and n:
            counters.KERNEL_LAUNCHES["kcore_peel"] += 1
        return out
    s = 0
    while sweeps == 0 or s < sweeps:
        new = ref.kcore_peel_ref(adj, alive, k)
        s += 1
        changed = bool((new != alive).any())
        alive = new
        if not changed:
            break
    return alive


def domination(adj: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(B, N, N) bool dom[b, u, v] = "v dominates u" (closed neighborhoods)."""
    b, n = mask.shape
    _check("domination adj", adj, torch.bool, (b, n, n), mask.device)
    _check("domination mask", mask, torch.bool, (b, n), mask.device)
    if _route(mask.device, "domination"):
        out = domination_cuda(adj, mask)
        if b and n:
            counters.KERNEL_LAUNCHES["domination"] += 1
        return out
    return ref.domination_ref(adj, mask)


def gf2_reduce_blocks(blocks, n_rows):
    """Reduce (G, S_d, W_d) int32 packed blocks, all in one launch on CUDA.

    Returns a list of ``(reduced, owner (G, R_d) int32, positive (G, S_d)
    bool)``, one per block; ``n_rows[d]`` = R_d sizes the owner vector.
    """
    blocks = list(blocks)
    n_rows = [int(r) for r in n_rows]
    if not blocks or len(blocks) != len(n_rows) or len(blocks) > MAX_BLOCKS:
        raise ValueError(f"want 1..{MAX_BLOCKS} blocks with one row count "
                         f"each, got {len(blocks)} and {len(n_rows)}")
    g = blocks[0].shape[0]
    dev = blocks[0].device
    for d, (b, r) in enumerate(zip(blocks, n_rows)):
        if b.dim() != 3:
            raise ValueError(f"gf2 block {d}: want (G, S, W), got {tuple(b.shape)}")
        _check(f"gf2 block {d}", b, torch.int32, (g, *b.shape[1:]), dev)
        if r > 32 * b.shape[2]:
            raise ValueError(f"gf2 block {d}: {r} rows exceed {b.shape[2]} "
                             f"words")
    if _route(dev, "gf2_reduce"):
        outs = gf2_reduce_cuda(blocks, n_rows)
        if g:
            counters.KERNEL_LAUNCHES["gf2_reduce"] += 1
        return outs
    return [ref.gf2_reduce_ref(b, r) for b, r in zip(blocks, n_rows)]


def gf2_reduce_batch(b: torch.Tensor, n_rows: int | None = None):
    """Reduce a (B, S, W) packed batch -> (reduced, owner (B, R), positive)."""
    r = b.shape[1] if n_rows is None else n_rows
    return gf2_reduce_blocks([b], [r])[0]


def gf2_reduce(b: torch.Tensor, n_rows: int | None = None):
    """Reduce one (S, W) packed matrix -> (reduced, owner (R,), positive (S,)).

    The batch form with B = 1.
    """
    if b.dim() != 2:
        raise ValueError(f"gf2_reduce: want (S, W), got {tuple(b.shape)}")
    red, owner, positive = gf2_reduce_batch(b[None], n_rows)
    return red[0], owner[0], positive[0]


def common_neighbors(adj: torch.Tensor) -> torch.Tensor:
    """(B, N, N) int32 common-neighbor counts restricted to edges."""
    if adj.dim() != 3:
        raise ValueError(f"common_neighbors: want (B, N, N), got "
                         f"{tuple(adj.shape)}")
    b, n, _ = adj.shape
    _check("common_neighbors adj", adj, torch.bool, (b, n, n), adj.device)
    if _route(adj.device, "common_neighbors"):
        out = common_neighbors_cuda(adj)
        if b and n:
            counters.KERNEL_LAUNCHES["common_neighbors"] += 1
        return out
    return ref.common_neighbors_ref(adj)


def clustering_coefficients(adj: torch.Tensor,
                            mask: torch.Tensor) -> torch.Tensor:
    """(B, N) f32 local clustering coefficients via common_neighbors.

    The adjacency is restricted to live vertices first, so padding rows
    (and vertices of degree < 2) give 0, never NaN.
    """
    b, n = mask.shape
    _check("clustering_coefficients mask", mask, torch.bool, (b, n),
           adj.device)
    adj = adj & mask[:, None, :] & mask[:, :, None]
    tri2 = common_neighbors(adj).sum(-1)  # 2 * triangles through u
    deg = adj.sum(-1).to(torch.float32)
    denom = deg * (deg - 1.0)
    cc = torch.where(denom > 0, tri2.to(torch.float32) / denom, 0.0)
    return torch.where(mask, cc, 0.0)


def pairwise_l1(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(M, D) x (N, D) f32 -> (M, N) pairwise-L1 Gram matrix."""
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[1]:
        raise ValueError(f"pairwise_l1: want (M, D) and (N, D), got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    (m, d), n = x.shape, y.shape[0]
    _check("pairwise_l1 x", x, torch.float32, (m, d), x.device)
    _check("pairwise_l1 y", y, torch.float32, (n, d), x.device)
    if _route(x.device, "pairwise_l1"):
        out = pairwise_l1_cuda(x, y)
        if m and n:
            counters.KERNEL_LAUNCHES["pairwise_l1"] += 1
        return out
    return ref.pairwise_l1_ref(x, y)


def _check_planes(name, xp, yp, *, rows, cols, e_t):
    """Shapes (B, M) and (B, N) of the Sinkhorn kernels' operands."""
    if xp.dim() != 3 or yp.dim() != 3:
        raise ValueError(f"{name}: want (B, 3, M) and (B, 3, N) planes, got "
                         f"{tuple(xp.shape)} and {tuple(yp.shape)}")
    (b, _, m), n, dev = xp.shape, yp.shape[-1], xp.device
    _check(f"{name} xp", xp, torch.float32, (b, 3, m), dev)
    _check(f"{name} yp", yp, torch.float32, (b, 3, n), dev)
    for i, t in enumerate(rows):
        _check(f"{name} row operand {i}", t, torch.float32, (b, m), dev)
    for i, t in enumerate(cols):
        _check(f"{name} column operand {i}", t, torch.float32, (b, n), dev)
    _check(f"{name} e_t", e_t, torch.float32, (b, 1), dev)
    return b, m, n


def sinkhorn_lse(xp: torch.Tensor, yp: torch.Tensor, dual: torch.Tensor,
                 logw: torch.Tensor, e_t: torch.Tensor) -> torch.Tensor:
    """(B, M) blocked Sinkhorn half-update, the cost built on the fly:
    ``out[b, i] = LSE_j(logw_j + (dual_j - c_ij) / e_b)``.

    xp (B, 3, M) and yp (B, 3, N) coordinate planes, dual and logw (B, N),
    e_t (B, 1), all float32 and contiguous.
    """
    b, m, n = _check_planes("sinkhorn_lse", xp, yp, rows=(),
                            cols=(dual, logw), e_t=e_t)
    if _route(xp.device, "sinkhorn_lse"):
        out = sinkhorn_lse_cuda(xp, yp, dual, logw, e_t)
        if b and m:
            counters.KERNEL_LAUNCHES["sinkhorn_lse"] += 1
        return out
    return ref.sinkhorn_lse_ref(xp, yp, dual, logw, e_t)


def sinkhorn_pair_sum(xp: torch.Tensor, yp: torch.Tensor, f: torch.Tensor,
                      g: torch.Tensor, log_a: torch.Tensor,
                      log_b: torch.Tensor, e_t: torch.Tensor,
                      mode: str = "plan") -> torch.Tensor:
    """(B,) masked pair sum over the cost built on the fly: <P, C>
    (``mode="plan"``) or the sum of c (``mode="cost"``) over the pairs whose
    log weights are both finite.

    f and log_a (B, M), g and log_b (B, N), e_t (B, 1); ``f``, ``g`` and
    ``e_t`` are not read in ``"cost"`` mode but are checked all the same.
    """
    if mode not in ("plan", "cost"):
        raise ValueError(f"unknown pair-sum mode {mode!r}")
    b, m, n = _check_planes("sinkhorn_pair_sum", xp, yp, rows=(f, log_a),
                            cols=(g, log_b), e_t=e_t)
    if _route(xp.device, "sinkhorn_pair_sum"):
        out = sinkhorn_pair_sum_cuda(xp, yp, f, g, log_a, log_b, e_t, mode)
        if b and m:  # with no rows the sums are zeroed, nothing launched
            counters.KERNEL_LAUNCHES["sinkhorn_pair_sum"] += 1
        return out
    return ref.sinkhorn_pair_sum_ref(xp, yp, f, g, log_a, log_b, e_t, mode)
