"""Batched auction solvers for the assignment problem: the plain PyTorch
versions and the launchers of the CUDA kernels ``csrc/auction_lap.cu``.

Replaces ``repro/kernels/auction_lap.py::auction_lap_pallas`` (the
ε-scaled Jacobi auction on (B, M, M) costs) and
``::auction_lap_collapsed_pallas`` (the reservoir-collapsed forward/reverse
auction on (B, K, K) reduced costs with one OUT pseudo-object).  The plain
solvers here are ``repro``'s ``auction_solve`` and
``auction_solve_collapsed`` with the batch written out: every lane runs its
own ε ladder and its own data-dependent round loop, and a lane that has
finished a scale keeps its state frozen while the others go on, exactly as
``jax.vmap`` of a ``lax.while_loop`` does.  So the assignments, prices,
round counts and convergence flags of a lane equal ``repro``'s bit for bit;
the totals are f32 sums whose order may differ.

The contract (``repro``'s): costs are normalized by their per-problem
maximum, the ladder anneals ``eps0 * eps_factor ** -s`` over ``n_scales``
rungs with at most ``max_rounds`` rounds each, the reported matching is the
finest converged scale's (the last scale's when none converged),
``converged`` says that one of the two finest scales converged, ``rounds``
sums the rounds of all scales and ``price`` is the final state's.  A warm
collapsed lane (any positive start price on a valid slot) runs every scale
at the finest ε.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

DEFAULT_EPS0 = 0.25
DEFAULT_EPS_FACTOR = 5.0
DEFAULT_N_SCALES = 10
DEFAULT_REV_EVERY = 8

# collapsed-assignment code for "person matched to the collapsed diagonal
# reservoir" (the OUT pseudo-object); -1 keeps meaning "free"
OUT = -2

NEG_INF = float("-inf")


def default_max_rounds(m: int) -> int:
    """Per-scale bidding-round cap, shared by the kernels and the plain
    solvers so their fallback behaviour is identical."""
    return 64 + 32 * m


def eps_ladder(eps0: float, eps_factor: float, n_scales: int,
               device=None) -> torch.Tensor:
    """(n_scales,) float32 ``eps0 * eps_factor ** -arange(n_scales)``.

    Computed in float32 with torch's ``pow``, which gives ``jnp``'s bits;
    the kernels take this tensor rather than raising powers themselves.
    """
    s = torch.arange(n_scales, dtype=torch.float32, device=device)
    return eps0 * torch.pow(torch.tensor(eps_factor, dtype=torch.float32,
                                         device=device), -s)


def _second_max(v: torch.Tensor, j_star: torch.Tensor, dim: int):
    """Max of ``v`` along ``dim`` with the ``j_star`` entry left out."""
    idx = torch.arange(v.shape[dim], device=v.device)
    shape = [1] * v.dim()
    shape[dim] = -1
    hit = idx.view(shape) == j_star.unsqueeze(dim)
    return torch.where(hit, NEG_INF, v).amax(dim)


def _owners(p2o: torch.Tensor) -> torch.Tensor:
    """(B, M) object -> its owner (the person i with p2o[i] == j), or -1."""
    m = p2o.shape[-1]
    idx = torch.arange(m, device=p2o.device)
    hit = p2o[:, :, None] == idx[None, None, :]           # (B, person, obj)
    return torch.where(hit, idx[None, :, None], -1).amax(1).to(torch.int32)


def _won(has: torch.Tensor, winner: torch.Tensor) -> torch.Tensor:
    """(B, person) the object each person won this round, or -1."""
    m = has.shape[-1]
    idx = torch.arange(m, device=has.device)
    hit = has[:, None, :] & (winner[:, None, :] == idx[None, :, None])
    return torch.where(hit, idx[None, None, :], -1).amax(-1)


def _lost(has: torch.Tensor, o2p: torch.Tensor) -> torch.Tensor:
    """(B, person) whether an object the person owns was re-auctioned."""
    m = has.shape[-1]
    idx = torch.arange(m, device=has.device)
    return (has[:, None, :] & (o2p[:, None, :] == idx[None, :, None])).any(-1)


def _bids(bid_ok, j_star, bid):
    """Each object's best bid and its bidder (ties to the lowest person)."""
    m = bid.shape[-1]
    idx = torch.arange(m, device=bid.device)
    bids = torch.where(bid_ok[:, :, None]
                       & (j_star[:, :, None] == idx[None, None, :]),
                       bid[:, :, None], NEG_INF)          # (B, person, obj)
    return bids.amax(1), bids.argmax(1)


def bid_round(a, price, p2o, o2p, eps):
    """One synchronous (Jacobi) forward round on a (B, M, M) batch.

    ``a`` is the benefit −cost; every free person bids its best value plus
    ε over its second best; each object with bids goes to the highest
    bidder (ties to the lowest person), evicting its previous owner.
    Returns ``(price, p2o, o2p, bidders)``, the last the (B,) count of
    persons that scanned their row.
    """
    free = p2o < 0
    v = a - price[:, None, :]
    j_star = v.argmax(-1)  # as jnp.argmax: the first maximum, 0 if all -inf
    v1 = v.amax(-1)
    v2 = _second_max(v, j_star, -1)
    v2 = torch.where(torch.isfinite(v2), v2, v1)  # M == 1
    aj = a.gather(-1, j_star[..., None])[..., 0]
    bid = aj - v2 + eps
    best, winner = _bids(free, j_star, bid)
    has = best > NEG_INF
    price = torch.where(has, best, price)
    p2o = torch.where(_lost(has, o2p), -1, p2o)
    o2p = torch.where(has, winner.to(torch.int32), o2p)
    won = _won(has, winner)
    p2o = torch.where(won >= 0, won.to(torch.int32), p2o)
    return price, p2o, o2p, free.sum(-1)


def _normalized(cost, valid=None):
    """``-(cost / c_scale)`` per problem (``-inf`` off ``valid``)."""
    if valid is None:
        c_scale = cost.abs().amax((-1, -2)).clamp(min=1e-30)
        return -(cost / c_scale[:, None, None])
    c_scale = torch.where(valid, cost.abs(), 0.0).amax((-1, -2))
    c_scale = c_scale.clamp(min=1e-30)
    return torch.where(valid, -(cost / c_scale[:, None, None]), NEG_INF)


def _report(p2o_s, conv_s):
    """The finest converged scale's p2o (the last scale's if none did),
    and whether one of the two finest scales converged."""
    conv = torch.stack(conv_s, -1)                        # (B, n_scales)
    p2o_all = torch.stack(p2o_s, 1)                       # (B, n, M)
    n = conv.shape[-1]
    last = n - 1 - conv.flip(-1).to(torch.int8).argmax(-1)
    last = torch.where(conv.any(-1), last, n - 1)
    p2o = p2o_all.gather(1, last[:, None, None].expand(
        -1, 1, p2o_all.shape[-1]))[:, 0]
    return p2o, conv[:, -2:].any(-1)


def auction_solve_counted(cost, eps0: float = DEFAULT_EPS0,
                          eps_factor: float = DEFAULT_EPS_FACTOR,
                          n_scales: int = DEFAULT_N_SCALES,
                          max_rounds: int | None = None):
    """:func:`auction_solve` plus the (B,) count of row scans it made.

    A row scan is one person's pass over its M values: each bidder once a
    round, and every row at each scale's reset.  A roofline bound counts
    them.
    """
    b, m, _ = cost.shape
    if max_rounds is None:
        max_rounds = default_max_rounds(m)
    dev = cost.device
    cost = cost.to(torch.float32)
    a = _normalized(cost)
    ladder = eps_ladder(eps0, eps_factor, n_scales, dev)
    idx = torch.arange(m, device=dev)
    price = torch.zeros((b, m), dtype=torch.float32, device=dev)
    p2o = torch.full((b, m), -1, dtype=torch.int32, device=dev)
    rounds = torch.zeros(b, dtype=torch.int32, device=dev)
    scans = torch.zeros(b, dtype=torch.int64, device=dev)
    p2o_s, conv_s = [], []
    for s in range(n_scales):
        eps = ladder[s]
        # partial reset (ε-CS): keep assignments still within eps of each
        # person's best value at the new scale
        v = a - price[:, None, :]
        best = v.amax(-1)
        mine = v.gather(-1, p2o.clamp(min=0).long()[..., None])[..., 0]
        keep = (p2o >= 0) & (mine >= best - eps)
        p2o = torch.where(keep, p2o, -1)
        o2p = _owners(p2o)
        scans += m
        it = torch.zeros(b, dtype=torch.int32, device=dev)
        stalled = torch.zeros(b, dtype=torch.bool, device=dev)
        while True:
            run = (p2o < 0).any(-1) & (it < max_rounds) & ~stalled
            if not bool(run.any()):
                break
            price2, p2o2, o2p2, bidders = bid_round(a, price, p2o, o2p, eps)
            same = (price2 == price).all(-1)
            r = run[:, None]
            price = torch.where(r, price2, price)
            p2o = torch.where(r, p2o2, p2o)
            o2p = torch.where(r, o2p2, o2p)
            stalled = torch.where(run, same, stalled)
            scans += torch.where(run, bidders, 0)
            it += run.to(torch.int32)
        rounds += it
        p2o_s.append(p2o)
        conv_s.append((p2o >= 0).all(-1))
    p2o, converged = _report(p2o_s, conv_s)
    # deterministic completion of any still-free rows: k-th free person
    # takes the k-th free object, so a permutation always returns
    owned = ((p2o[:, :, None] == idx[None, None, :])
             & (p2o >= 0)[:, :, None]).any(1)
    free_p, free_o = p2o < 0, ~owned
    rank_p = free_p.to(torch.int32).cumsum(-1) - 1
    rank_o = free_o.to(torch.int32).cumsum(-1) - 1
    match = (free_p[:, :, None] & free_o[:, None, :]
             & (rank_p[:, :, None] == rank_o[:, None, :]))
    fill = torch.where(match, idx[None, None, :], -1).amax(-1)
    assign = torch.where(free_p, fill.to(torch.int32), p2o)
    total = cost.gather(-1, assign.long()[..., None])[..., 0].sum(-1)
    return assign, total, converged, rounds, scans


def auction_solve(cost, eps0: float = DEFAULT_EPS0,
                  eps_factor: float = DEFAULT_EPS_FACTOR,
                  n_scales: int = DEFAULT_N_SCALES,
                  max_rounds: int | None = None):
    """ε-scaled Jacobi auction on a (B, M, M) batch of cost matrices.

    Returns ``(assign (B, M) int32, total (B,) f32, converged (B,) bool,
    rounds (B,) int32)``: ``assign`` is always a permutation (rows left free
    by an unconverged solve are paired with the free columns in index
    order) and ``total`` the sum of the unnormalized costs it picks.
    """
    return auction_solve_counted(cost, eps0, eps_factor, n_scales,
                                 max_rounds)[:4]


# ----------------------------------------------------------- collapsed form

def collapsed_bid_round(a, price, pi, p2o, o2p, eps):
    """One synchronous forward round of the collapsed auction.

    ``a``: (B, K, K) benefit −reduced cost, ``-inf`` at invalid pairs;
    ``pi``: person profits; ``p2o`` in {OUT, -1 = free, j}.  A free person
    whose best real value is at most 0 takes OUT (value 0, unlimited
    capacity); the rest bid best over second best (OUT folded into the
    second best) plus ε.  Returns ``(price, pi, p2o, o2p, bidders)``.
    """
    free = p2o == -1
    v = a - price[:, None, :]
    j_star = v.argmax(-1)
    v1 = v.amax(-1)
    v2 = _second_max(v, j_star, -1)
    v2o = torch.clamp(v2, min=0.0)      # second-best option including OUT
    take_out = free & (v1 <= 0.0)
    bid_ok = free & (v1 > 0.0)
    aj = a.gather(-1, j_star[..., None])[..., 0]
    bid = aj - v2o + eps
    best, winner = _bids(bid_ok, j_star, bid)
    has = best > NEG_INF
    price = torch.where(has, best, price)
    p2o = torch.where(_lost(has, o2p), -1, p2o)
    o2p = torch.where(has, winner.to(torch.int32), o2p)
    won = _won(has, winner)
    p2o = torch.where(won >= 0, won.to(torch.int32), p2o)
    pi = torch.where(won >= 0, v2o - eps, pi)
    pi = torch.where(take_out, 0.0, pi)
    p2o = torch.where(take_out, OUT, p2o)
    return price, pi, p2o, o2p, free.sum(-1)


def collapsed_reverse_round(a, price, pi, p2o, o2p, keep2, eps):
    """One synchronous reverse round: unowned objects priced above 0 bid.

    Each bidder finds its best person through the profits (``b1 = max_i
    a[i, j] - pi[i]``): below ε it drops out (price 0); otherwise it
    undercuts to ``max(0, b2 - ε)`` and offers that person the raised
    profit.  A person accepts its best offer (ties to the lowest object)
    and releases its previous object with the price intact.  Returns
    ``(price, pi, p2o, o2p, bidders)``.
    """
    k = a.shape[-1]
    idx = torch.arange(k, device=a.device)
    bidder = keep2 & (o2p < 0) & (price > 0.0)
    w = a - pi[:, :, None]                                # (B, person, obj)
    i_star = w.argmax(1)
    b1 = w.amax(1)
    b2 = _second_max(w, i_star, 1)
    drop = bidder & (b1 < eps)
    active = bidder & (b1 >= eps)
    p_new = torch.clamp(b2 - eps, min=0.0)
    offer = a.gather(1, i_star[:, None, :])[:, 0, :] - p_new
    offers = torch.where(active[:, None, :]
                         & (i_star[:, None, :] == idx[None, :, None]),
                         offer[:, None, :], NEG_INF)      # (B, person, obj)
    best_off = offers.amax(-1)
    j_win = offers.argmax(-1)
    got = best_off > NEG_INF
    # accepted persons release their old object (an owned object is never
    # a bidder, so freed and taken are disjoint)
    freed = (got[:, :, None] & (p2o[:, :, None] == idx[None, None, :])).any(1)
    won_obj = got[:, :, None] & (j_win[:, :, None] == idx[None, None, :])
    taken = won_obj.any(1)
    new_owner = torch.where(won_obj, idx[None, :, None], -1).amax(1)
    o2p = torch.where(freed, -1, o2p)
    o2p = torch.where(taken, new_owner.to(torch.int32), o2p)
    price = torch.where(taken, p_new, torch.where(drop, 0.0, price))
    p2o = torch.where(got, j_win.to(torch.int32), p2o)
    pi = torch.where(got, best_off, pi)
    return price, pi, p2o, o2p, bidder.sum(-1)


def auction_solve_collapsed_counted(cbar, keep1, keep2, price0=None,
                                    eps0: float = DEFAULT_EPS0,
                                    eps_factor: float = DEFAULT_EPS_FACTOR,
                                    n_scales: int = DEFAULT_N_SCALES,
                                    max_rounds: int | None = None,
                                    rev_every: int = DEFAULT_REV_EVERY):
    """:func:`auction_solve_collapsed` plus the (B,) count of row and
    column scans it made (each bidder once a round, every row at the start
    and at each scale's reset)."""
    b, k, _ = cbar.shape
    if max_rounds is None:
        max_rounds = default_max_rounds(k)
    rev_every = int(rev_every)
    dev = cbar.device
    cbar = cbar.to(torch.float32)
    keep1, keep2 = keep1.to(torch.bool), keep2.to(torch.bool)
    valid = keep1[:, :, None] & keep2[:, None, :]
    a = _normalized(cbar, valid)
    idx = torch.arange(k, device=dev)
    ladder = eps_ladder(eps0, eps_factor, n_scales, dev)
    if price0 is None:
        price = torch.zeros((b, k), dtype=torch.float32, device=dev)
    else:
        price = torch.where(keep2, torch.clamp(price0.to(torch.float32),
                                               min=0.0), 0.0)
    # a warm lane runs every scale at the finest ε
    warm = (price > 0.0).any(-1)
    pi = torch.clamp((a - price[:, None, :]).amax(-1), min=0.0)
    p2o = torch.where(keep1, -1, OUT).to(torch.int32)
    o2p = torch.full((b, k), -1, dtype=torch.int32, device=dev)
    rounds = torch.zeros(b, dtype=torch.int32, device=dev)
    scans = torch.full((b,), k, dtype=torch.int64, device=dev)
    p2o_s, conv_s = [], []

    def pending(price, p2o, o2p):
        free_any = (p2o == -1).any(-1)
        stale_any = (keep2 & (o2p < 0) & (price > 0.0)).any(-1)
        return free_any, stale_any

    for s in range(n_scales):
        eps = torch.where(warm, ladder[-1], ladder[s])[:, None]  # (B, 1)
        # ε-CS partial reset: persons keep their slot (real object or OUT)
        # while it is within eps of their best option at the new scale
        v = a - price[:, None, :]
        best = torch.clamp(v.amax(-1), min=0.0)
        mine = torch.where(
            p2o >= 0, v.gather(-1, p2o.clamp(min=0).long()[..., None])[..., 0],
            0.0)                                     # OUT is worth exactly 0
        keep = (p2o != -1) & (mine >= best - eps)
        keep = keep | ~keep1
        p2o = torch.where(keep, p2o, -1)
        o2p = _owners(p2o)
        scans += k
        it = torch.zeros(b, dtype=torch.int32, device=dev)
        stalled = torch.zeros(b, dtype=torch.bool, device=dev)
        prev = (torch.full_like(price, -1.0), torch.full_like(pi, -1.0),
                torch.full_like(p2o, -3))
        while True:
            free_any, stale_any = pending(price, p2o, o2p)
            run = (free_any | stale_any) & (it < max_rounds) & ~stalled
            if not bool(run.any()):
                break
            if rev_every > 0:
                periodic = (it % rev_every) == (rev_every - 1)
            else:
                periodic = torch.zeros_like(run)
            do_rev = stale_any & (~free_any | periodic)
            state = (price, pi, p2o, o2p, torch.zeros_like(it))
            fwd = (collapsed_bid_round(a, price, pi, p2o, o2p, eps)
                   if bool((run & ~do_rev).any()) else state)
            rev = (collapsed_reverse_round(a, price, pi, p2o, o2p, keep2, eps)
                   if bool((run & do_rev).any()) else state)
            r = do_rev[:, None]
            price2, pi2, p2o2, o2p2 = (torch.where(r, x, y) for x, y
                                       in zip(rev[:4], fwd[:4]))
            bidders = torch.where(do_rev, rev[4], fwd[4])
            # two livelock exits: an unchanged state (increments below f32
            # resolution), and a state equal to the one two rounds back (a
            # forced forward/reverse interleave ping-ponging an object)
            same1 = ((price2 == price).all(-1) & (pi2 == pi).all(-1)
                     & (p2o2 == p2o).all(-1))
            same2 = ((price2 == prev[0]).all(-1) & (pi2 == prev[1]).all(-1)
                     & (p2o2 == prev[2]).all(-1))
            rr = run[:, None]
            prev = tuple(torch.where(rr, x, y)
                         for x, y in zip((price, pi, p2o), prev))
            price = torch.where(rr, price2, price)
            pi = torch.where(rr, pi2, pi)
            p2o = torch.where(rr, p2o2, p2o)
            o2p = torch.where(rr, o2p2, o2p)
            stalled = torch.where(run, same1 | same2, stalled)
            scans += torch.where(run, bidders, 0)
            it += run.to(torch.int32)
        rounds += it
        free_any, stale_any = pending(price, p2o, o2p)
        p2o_s.append(p2o)
        conv_s.append(~free_any & ~stale_any)
    p2o, converged = _report(p2o_s, conv_s)
    # a person still free (nothing converged) stays at -1: the matching is
    # feasible, just not certified optimal (converged=False)
    matched = p2o >= 0
    picked = cbar.gather(-1, p2o.clamp(min=0).long()[..., None])[..., 0]
    total = torch.where(matched, picked, 0.0).sum(-1)
    return p2o, total, converged, rounds, price, scans


def auction_solve_collapsed(cbar, keep1, keep2, price0=None,
                            eps0: float = DEFAULT_EPS0,
                            eps_factor: float = DEFAULT_EPS_FACTOR,
                            n_scales: int = DEFAULT_N_SCALES,
                            max_rounds: int | None = None,
                            rev_every: int = DEFAULT_REV_EVERY):
    """ε-scaled combined forward/reverse auction on a (B, K, K) batch of
    reduced costs with valid-slot masks ``keep1``/``keep2`` (B, K).

    ``price0`` (B, K) warm-starts the object prices in max-normalized units
    (any nonnegative vector is safe; a nonzero one skips the ε ladder).
    ``rev_every`` > 0 forces a reverse round every that many rounds while
    free persons remain.  Returns ``(p2o (B, K) int32, total (B,) f32,
    converged (B,) bool, rounds (B,) int32, price (B, K) f32)`` with
    ``p2o[i]`` in {OUT, -1, j} and ``total`` the sum of ``cbar`` over the
    matched pairs.
    """
    return auction_solve_collapsed_counted(
        cbar, keep1, keep2, price0, eps0, eps_factor, n_scales, max_rounds,
        rev_every)[:5]


def expand_collapsed_assignment(p2o):
    """(..., K) collapsed assignment -> (..., 2K) expanded row assignment.

    Rows 0..K-1 are the real D1 slots, rows K..2K-1 the reservoirs (the
    ``metrics/exact.py::augmented_cost`` convention).  A person at OUT (or
    free, or invalid) pairs with its own reservoir column K+i; a real
    column nobody owns pairs with its own reservoir row K+j; the reservoir
    rows of owned columns pair with the reservoir columns of matched
    persons in index order.  ``repro``'s form also takes the two masks,
    which it does not read.
    """
    k = p2o.shape[-1]
    idx = torch.arange(k, device=p2o.device)
    matched = p2o >= 0
    top = torch.where(matched, p2o.to(torch.int64), k + idx)
    owned = (matched[..., :, None]
             & (p2o[..., :, None] == idx)).any(-2)
    rank_r = owned.to(torch.int64).cumsum(-1) - 1
    rank_c = matched.to(torch.int64).cumsum(-1) - 1
    pair = (owned[..., :, None] & matched[..., None, :]
            & (rank_r[..., :, None] == rank_c[..., None, :]))
    fill = torch.where(pair, k + idx, -1).amax(-1)
    bottom = torch.where(owned, fill, idx)
    return torch.cat([top, bottom], -1).to(torch.int32)


# ------------------------------------------------------------ CUDA launchers

_LAP_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                 + [ctypes.c_void_p])
_COLLAPSED_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])


def _scratch(b: int, m: int, collapsed: bool, device) -> torch.Tensor:
    """Global-memory scratch for the normalized costs of problems too large
    for shared memory (an empty tensor when they fit)."""
    fits = _build.function("auction_lap", "auction_fits_shared",
                           [ctypes.c_int, ctypes.c_int])(m, int(collapsed))
    n = 0 if fits else b * m * (m | 1)
    return torch.empty((n,), dtype=torch.float32, device=device)


def auction_lap_cuda(cost: torch.Tensor, ladder: torch.Tensor,
                     max_rounds: int):
    """Launch the expanded auction: one CTA per (M, M) problem.

    ``cost`` (B, M, M) float32 and ``ladder`` (n_scales,) float32, both
    contiguous on one CUDA device.  Returns ``(assign, total, converged,
    rounds)`` as :func:`auction_solve`.
    """
    b, m, _ = cost.shape
    dev = cost.device
    assign = torch.empty((b, m), dtype=torch.int32, device=dev)
    total = torch.empty((b,), dtype=torch.float32, device=dev)
    conv = torch.empty((b,), dtype=torch.bool, device=dev)
    rounds = torch.empty((b,), dtype=torch.int32, device=dev)
    if b == 0:
        return assign, total, conv, rounds
    scratch = _scratch(b, m, False, dev)
    fn = _build.function("auction_lap", "auction_lap_launch", _LAP_ARGTYPES)
    err = fn(cost.data_ptr(), ladder.data_ptr(), scratch.data_ptr(),
             assign.data_ptr(), total.data_ptr(), conv.data_ptr(),
             rounds.data_ptr(), b, m, ladder.numel(), max_rounds,
             torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"auction_lap launch failed: CUDA error {err}")
    return assign, total, conv, rounds


def auction_lap_collapsed_cuda(cbar: torch.Tensor, keep1: torch.Tensor,
                               keep2: torch.Tensor, price0: torch.Tensor,
                               ladder: torch.Tensor, max_rounds: int,
                               rev_every: int):
    """Launch the collapsed forward/reverse auction: one warp per problem
    at K <= 32 (four to a CTA), one CTA per problem above.

    ``cbar`` (B, K, K) and ``price0`` (B, K) float32, ``keep1``/``keep2``
    (B, K) bool, ``ladder`` (n_scales,) float32, all contiguous on one CUDA
    device.  Returns ``(p2o, total, converged, rounds, price)`` as
    :func:`auction_solve_collapsed`.
    """
    b, k, _ = cbar.shape
    dev = cbar.device
    p2o = torch.empty((b, k), dtype=torch.int32, device=dev)
    total = torch.empty((b,), dtype=torch.float32, device=dev)
    conv = torch.empty((b,), dtype=torch.bool, device=dev)
    rounds = torch.empty((b,), dtype=torch.int32, device=dev)
    price = torch.empty((b, k), dtype=torch.float32, device=dev)
    if b == 0:
        return p2o, total, conv, rounds, price
    scratch = _scratch(b, k, True, dev)
    fn = _build.function("auction_lap", "auction_lap_collapsed_launch",
                         _COLLAPSED_ARGTYPES)
    err = fn(cbar.data_ptr(), keep1.data_ptr(), keep2.data_ptr(),
             price0.data_ptr(), ladder.data_ptr(), scratch.data_ptr(),
             p2o.data_ptr(), total.data_ptr(), conv.data_ptr(),
             rounds.data_ptr(), price.data_ptr(), b, k, ladder.numel(),
             max_rounds, rev_every,
             torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"auction_lap_collapsed launch failed: CUDA error "
                           f"{err}")
    return p2o, total, conv, rounds, price
