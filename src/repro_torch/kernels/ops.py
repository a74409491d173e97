"""Public kernel wrappers: check the inputs, then run kernel or plain version.

A wrapper takes the tensors' device as the choice: for CPU tensors it runs
the plain PyTorch version (:mod:`repro_torch.kernels.ref`); for CUDA tensors
it launches the hand-written kernel, or raises.  There is no fallback from
one to the other.  Each launch adds one to
``repro_torch.counters.KERNEL_LAUNCHES[name]`` and to the ``kernels.calls``
counter of :mod:`repro_torch.obs` (label ``kernel``), at the same site.
These wrappers run eagerly, so ``kernels.calls`` counts launches one to one;
``repro``'s counter of that name counts its wrappers' calls, at trace time
under ``jit``.

Each wrapper runs its kernel or plain version inside
``obs.span("kernels.<name>", shape=...)``, with ``repro``'s span name and
shape-token string (``B{b}_N{n}``, ``S{s}``, ``G{max}_D{d}``, ...), so a
trace of either package reads the same rows in
``python -m repro_torch.obs report``.  On CUDA a span times the host
wrapper around an asynchronous launch, not the device's time.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import counters, obs
from repro_torch._device import resolve_device
from repro_torch.kernels import ref
from repro_torch.kernels.auction_lap import (
    DEFAULT_EPS0, DEFAULT_EPS_FACTOR, auction_lap_collapsed_cuda,
    auction_lap_cuda, default_max_rounds, eps_ladder)
from repro_torch.kernels.common_neighbors import (
    common_neighbors_cuda, common_neighbors_rowsums_cuda)
from repro_torch.kernels.domination import domination_cuda
from repro_torch.kernels.gf2_reduce import MAX_BLOCKS, gf2_reduce_cuda
from repro_torch.kernels.hamming import (
    as_int32_words, hamming_scan_cuda, pack_codes_u32)
from repro_torch.kernels.kcore_peel import kcore_peel_cuda
from repro_torch.kernels.pairwise_gram import pairwise_l1_cuda
from repro_torch.kernels.sinkhorn_lse import (
    PackedColumns, pack_columns, sinkhorn_lse_cuda, sinkhorn_pair_sum_cuda)


# Launches by kernel (always on).  The help text is repro's, so both
# registries export one series.
_KCALLS = obs.counter(
    "kernels.calls",
    help="Pallas kernel wrapper invocations (trace-time under jit)")


def _launched(kernel: str, label: str | None = None) -> None:
    """Count one launch of ``kernel`` (``label``: the wrapper's name in
    ``kernels.calls``, where it differs)."""
    counters.KERNEL_LAUNCHES[kernel] += 1
    _KCALLS.inc(kernel=label or kernel)


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

    On CUDA the whole fixpoint runs inside one launch, a thread-block
    cluster of 1-8 CTAs per graph.
    """
    b, n = alive.shape
    _check("kcore_peel adj", adj, torch.bool, (b, n, n), alive.device)
    _check("kcore_peel alive", alive, torch.bool, (b, n), alive.device)
    if sweeps < 0:
        raise ValueError(f"sweeps must be >= 0, got {sweeps}")
    with obs.span("kernels.kcore_peel", shape=f"B{b}_N{n}"):
        if _route(alive.device, "kcore_peel"):
            out = kcore_peel_cuda(adj, alive, k, sweeps)
            if b and n:
                _launched("kcore_peel")
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
    with obs.span("kernels.domination", shape=f"B{b}_N{n}"):
        if _route(mask.device, "domination"):
            out = domination_cuda(adj, mask)
            if b and n:
                _launched("domination")
            return out
        return ref.domination_ref(adj, mask)


def _gf2_checked(blocks, n_rows):
    """The blocks and row counts as lists, checked."""
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
    return blocks, n_rows


def _gf2_run(blocks, n_rows, name: str, shape: str):
    """One launch (or the plain version) over checked blocks, in the span
    ``kernels.<name>``."""
    with obs.span(f"kernels.{name}", shape=shape):
        if _route(blocks[0].device, "gf2_reduce"):
            outs = gf2_reduce_cuda(blocks, n_rows)
            if blocks[0].shape[0]:
                _launched("gf2_reduce", name)
            return outs
        return [ref.gf2_reduce_ref(b, r) for b, r in zip(blocks, n_rows)]


def gf2_reduce_blocks(blocks, n_rows):
    """Reduce (G, S_d, W_d) int32 packed blocks, all in one launch on CUDA.

    Returns a list of ``(reduced, owner (G, R_d) int32, positive (G, S_d)
    bool)``, one per block; ``n_rows[d]`` = R_d sizes the owner vector.
    The launch's span is ``kernels.gf2_reduce_batch``: ``B{G}_S{S}`` for
    one block, as ``repro``'s batch wrapper; for several, S is the blocks'
    columns summed and a ``C`` token their packed words a matrix,
    ``Σ_d S_d W_d``.
    """
    blocks, n_rows = _gf2_checked(blocks, n_rows)
    g = blocks[0].shape[0]
    cols = sum(b.shape[1] for b in blocks)
    shape = f"B{g}_S{cols}"
    if len(blocks) > 1:
        shape += f"_C{sum(b.shape[1] * b.shape[2] for b in blocks)}"
    return _gf2_run(blocks, n_rows, "gf2_reduce_batch", shape)


def gf2_reduce_batch(b: torch.Tensor, n_rows: int | None = None):
    """Reduce a (B, S, W) packed batch -> (reduced, owner (B, R), positive)."""
    r = b.shape[1] if n_rows is None else n_rows
    return gf2_reduce_blocks([b], [r])[0]


def gf2_reduce(b: torch.Tensor, n_rows: int | None = None):
    """Reduce one (S, W) packed matrix -> (reduced, owner (R,), positive (S,)).

    The batch form with B = 1, in the span ``kernels.gf2_reduce``.
    """
    if b.dim() != 2:
        raise ValueError(f"gf2_reduce: want (S, W), got {tuple(b.shape)}")
    blocks, n_rows = _gf2_checked(
        [b[None]], [b.shape[0] if n_rows is None else n_rows])
    (red, owner, positive), = _gf2_run(blocks, n_rows, "gf2_reduce",
                                       f"S{b.shape[0]}")
    return red[0], owner[0], positive[0]


def common_neighbors(adj: torch.Tensor) -> torch.Tensor:
    """(B, N, N) int32 common-neighbor counts restricted to edges."""
    if adj.dim() != 3:
        raise ValueError(f"common_neighbors: want (B, N, N), got "
                         f"{tuple(adj.shape)}")
    b, n, _ = adj.shape
    _check("common_neighbors adj", adj, torch.bool, (b, n, n), adj.device)
    with obs.span("kernels.common_neighbors", shape=f"B{b}_N{n}"):
        if _route(adj.device, "common_neighbors"):
            out = common_neighbors_cuda(adj)
            if b and n:
                _launched("common_neighbors")
            return out
        return ref.common_neighbors_ref(adj)


def clustering_coefficients(adj: torch.Tensor,
                            mask: torch.Tensor) -> torch.Tensor:
    """(B, N) f32 local clustering coefficients via common_neighbors.

    The adjacency is restricted to live vertices first, so padding rows
    (and vertices of degree < 2) give 0, never NaN.  On CUDA one launch of
    the common-neighbors kernel's fused epilogue gives the row sums (adj
    taken to be symmetric); nothing of size (B, N, N) is written.  Either
    way the span is ``common_neighbors``' (``repro``'s reaches that
    wrapper).
    """
    b, n = mask.shape
    _check("clustering_coefficients mask", mask, torch.bool, (b, n),
           adj.device)
    if _route(adj.device, "common_neighbors"):
        adj = adj.contiguous()
        _check("clustering_coefficients adj", adj, torch.bool, (b, n, n),
               adj.device)
        with obs.span("kernels.common_neighbors", shape=f"B{b}_N{n}"):
            tri2, deg = common_neighbors_rowsums_cuda(adj, mask)
            if b and n:
                _launched("common_neighbors")
    else:
        adj = adj & mask[:, None, :] & mask[:, :, None]
        tri2 = common_neighbors(adj).sum(-1)  # 2 * triangles through u
        deg = adj.sum(-1)
    return clustering_from_sums(tri2, deg, mask)


def clustering_from_sums(tri2: torch.Tensor, deg: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
    """(B, N) f32 coefficients tri2 / (deg (deg - 1)) of live vertices of
    degree >= 2, else 0, from the integer row sums (twice the triangles
    through each vertex, and its degree)."""
    deg = deg.to(torch.float32)
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
    with obs.span("kernels.pairwise_l1", shape=f"G{max(m, n)}_D{d}"):
        if _route(x.device, "pairwise_l1"):
            out = pairwise_l1_cuda(x, y)
            if m and n:
                _launched("pairwise_l1")
            return out
        return ref.pairwise_l1_ref(x, y)


def _code_words(codes, device: torch.device) -> torch.Tensor:
    """Packed codes as (B, W) int32 words: a tensor of uint32 or int32 words
    as it is; a numpy array of uint8 packed bytes (the TopoIndex storage
    layout, zero-padded to whole words), uint32 or int32 words on
    ``device``."""
    if isinstance(codes, torch.Tensor):
        return as_int32_words(codes)
    codes = np.asarray(codes)
    if codes.dtype == np.uint8:
        codes = pack_codes_u32(codes)
    return as_int32_words(codes).to(device)


def hamming_scan(codes_q, codes_db, mask_q=None,
                 device=None) -> torch.Tensor:
    """(Q, N) int32 masked Hamming distances over packed LSH codes.

    Codes come as numpy uint8 packed bytes (the TopoIndex storage layout),
    or as uint32 words or int32 bit patterns, numpy or torch.  ``mask_q`` (packed like ``codes_q``) clears query
    bits from the distance, the multi-probe LSH trick; ``None`` means all
    ones.  Tensors keep their device; numpy inputs go to ``device``, which
    defaults to the device of a tensor argument, else to CUDA.
    """
    if device is not None:
        dev = torch.device(device)
    else:
        given = [a for a in (codes_q, codes_db, mask_q)
                 if isinstance(a, torch.Tensor)]
        dev = given[0].device if given else resolve_device(None)
    cq = _code_words(codes_q, dev)
    cd = _code_words(codes_db, dev)
    mq = (torch.full(cq.shape, -1, dtype=torch.int32, device=dev)
          if mask_q is None else _code_words(mask_q, dev))
    if cq.dim() != 2 or cd.dim() != 2 or cq.shape[1] != cd.shape[1]:
        raise ValueError(f"hamming_scan: want (Q, W) and (N, W) codes, got "
                         f"{tuple(cq.shape)} and {tuple(cd.shape)}")
    (q, w), n = cq.shape, cd.shape[0]
    _check("hamming_scan codes_q", cq, torch.int32, (q, w), dev)
    _check("hamming_scan mask_q", mq, torch.int32, (q, w), dev)
    _check("hamming_scan codes_db", cd, torch.int32, (n, w), dev)
    with obs.span("kernels.hamming_scan", shape=f"Q{q}_N{n}_W{w}"):
        if _route(dev, "hamming_scan"):
            out = hamming_scan_cuda(cq, mq, cd)
            if q and n:
                _launched("hamming_scan")
            return out
        return ref.hamming_scan_ref(cq, mq, cd)


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
                 logw: torch.Tensor, e_t: torch.Tensor,
                 packed: PackedColumns | None = None) -> torch.Tensor:
    """(B, M) blocked Sinkhorn half-update, the cost built on the fly:
    ``out[b, i] = LSE_j(logw_j + (dual_j - c_ij) / e_b)``.

    xp (B, 3, M) and yp (B, 3, N) coordinate planes, dual and logw (B, N),
    e_t (B, 1), all float32 and contiguous.  ``packed``, optional: the
    :func:`pack_columns` of ``yp`` and ``logw``, made once and passed to
    every call with the same planes and log weights; it is read in their
    place (on the CPU, the plain version runs on the packed columns).
    """
    b, m, n = _check_planes("sinkhorn_lse", xp, yp, rows=(),
                            cols=(dual, logw), e_t=e_t)
    if packed is not None and (
            not isinstance(packed, PackedColumns)
            or packed.index.shape != (b, n)
            or packed.index.device != xp.device):
        raise ValueError(f"sinkhorn_lse: packed must be the pack_columns of "
                         f"the ({b}, 3, {n}) planes on {xp.device}")
    with obs.span("kernels.sinkhorn_lse", shape=f"B{b}_M{m}"):
        if _route(xp.device, "sinkhorn_lse"):
            out = sinkhorn_lse_cuda(xp, yp, dual, logw, e_t, packed)
            if b and m:
                _launched("sinkhorn_lse")
            return out
        if packed is None:
            return ref.sinkhorn_lse_ref(xp, yp, dual, logw, e_t)
        return ref.sinkhorn_lse_ref(xp, packed.planes,
                                    dual.gather(-1, packed.index.long()),
                                    packed.logw, e_t)


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
    with obs.span("kernels.sinkhorn_pair_sum", shape=f"B{b}_M{m}"):
        if _route(xp.device, "sinkhorn_pair_sum"):
            out = sinkhorn_pair_sum_cuda(xp, yp, f, g, log_a, log_b, e_t,
                                         mode)
            if b and m:  # with no rows the sums are zeroed, nothing launched
                _launched("sinkhorn_pair_sum")
            return out
        return ref.sinkhorn_pair_sum_ref(xp, yp, f, g, log_a, log_b, e_t,
                                         mode)


# the widest problem the auction kernels take: their per-slot state must fit
# in one block's shared memory; the registry reaches M = 512 (the expanded
# form at n_points = 256)
AUCTION_MAX_M = 2048
# The collapsed wrapper's forward/reverse phase ratio: reverse rounds only
# once no person is free, the value repro's ops wrapper resolves on the CPU
# (results/TUNED_tiles.json).  repro's untuned default, 8, forces a reverse
# round every 8 rounds; on the DD rung's diagrams it leaves pairs
# unconverged, with distances off the Hungarian W2, and takes more rounds
# (chip_smoke.py, phase exact_n320, "rev_every_8").
AUCTION_REV_EVERY = 0


def _check_auction(name: str, cost: torch.Tensor, n_scales: int,
                   max_rounds: int | None) -> tuple[int, int, int]:
    if cost.dim() != 3 or cost.shape[1] != cost.shape[2]:
        raise ValueError(f"{name}: want (B, M, M) costs, got "
                         f"{tuple(cost.shape)}")
    b, m, _ = cost.shape
    _check(f"{name} cost", cost, torch.float32, (b, m, m), cost.device)
    if m > AUCTION_MAX_M:
        raise ValueError(f"{name}: M = {m} exceeds AUCTION_MAX_M = "
                         f"{AUCTION_MAX_M}")
    if n_scales < 1:
        raise ValueError(f"{name}: n_scales must be >= 1, got {n_scales}")
    rounds = default_max_rounds(m) if max_rounds is None else int(max_rounds)
    if rounds < 0:
        raise ValueError(f"{name}: max_rounds must be >= 0, got {rounds}")
    return b, m, rounds


def auction_lap(cost: torch.Tensor, n_scales: int = 10,
                max_rounds: int | None = None):
    """Batched ε-scaled auction assignment: (B, M, M) f32 costs ->
    ``(assign (B, M) int32, total (B,) f32, converged (B,) bool, rounds (B,)
    int32)``; see :mod:`repro_torch.kernels.auction_lap` for the contract.

    On CUDA one launch solves the whole batch: a warp per problem at
    M <= 32, a CTA per problem above.
    """
    b, m, rounds = _check_auction("auction_lap", cost, n_scales, max_rounds)
    with obs.span("kernels.auction_lap", shape=f"B{b}_M{m}"):
        if _route(cost.device, "auction_lap"):
            ladder = eps_ladder(DEFAULT_EPS0, DEFAULT_EPS_FACTOR, n_scales,
                                cost.device)
            out = auction_lap_cuda(cost, ladder, rounds)
            if b and m:
                _launched("auction_lap")
            return out
        return ref.auction_lap_ref(cost, n_scales=n_scales,
                                   max_rounds=rounds)


def auction_lap_collapsed(cbar: torch.Tensor, keep1: torch.Tensor,
                          keep2: torch.Tensor,
                          price0: torch.Tensor | None = None,
                          n_scales: int = 10, max_rounds: int | None = None,
                          rev_every: int = AUCTION_REV_EVERY):
    """Batched collapsed forward/reverse auction: (B, K, K) f32 reduced
    costs, (B, K) bool valid-slot masks and an optional (B, K) f32 warm
    start (``None``: zeros) -> ``(p2o (B, K) int32, total (B,) f32,
    converged (B,) bool, rounds (B,) int32, price (B, K) f32)``.

    ``rev_every`` > 0 forces a reverse round every that many rounds while
    free persons remain; 0 (``AUCTION_REV_EVERY``) runs reverse rounds only
    once none are left.
    """
    b, k, rounds = _check_auction("auction_lap_collapsed", cbar, n_scales,
                                  max_rounds)
    dev = cbar.device
    _check("auction_lap_collapsed keep1", keep1, torch.bool, (b, k), dev)
    _check("auction_lap_collapsed keep2", keep2, torch.bool, (b, k), dev)
    if price0 is None:
        price0 = torch.zeros((b, k), dtype=torch.float32, device=dev)
    _check("auction_lap_collapsed price0", price0, torch.float32, (b, k), dev)
    if rev_every < 0:
        raise ValueError(f"rev_every must be >= 0, got {rev_every}")
    with obs.span("kernels.auction_lap_collapsed", shape=f"B{b}_K{k}"):
        if _route(dev, "auction_lap_collapsed"):
            ladder = eps_ladder(DEFAULT_EPS0, DEFAULT_EPS_FACTOR, n_scales,
                                dev)
            out = auction_lap_collapsed_cuda(cbar, keep1, keep2, price0,
                                             ladder, rounds, int(rev_every))
            if b and k:
                _launched("auction_lap_collapsed")
            return out
        return ref.auction_lap_collapsed_ref(
            cbar, keep1, keep2, price0, n_scales=n_scales, max_rounds=rounds,
            rev_every=int(rev_every))
