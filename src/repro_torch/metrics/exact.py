"""Exact q-Wasserstein and bottleneck distances by batched auction (the
port of ``repro.metrics.exact``).

``reference.wasserstein_exact`` solves the diagonal-augmented assignment
problem on the host, one small pair at a time.  Here both diagrams are
compacted to the shared fixed-width top-persistence cloud
(``distances.compact_top_k``) and every pair's matching is solved at once
by the auction kernels (``kernels/auction_lap.py``), over any leading pair
axes.  Two equivalent layouts, chosen by ``collapse``:

* ``"off"``: the expanded (2K)² matrix, points of D1 then diagonal
  reservoir slots as rows, the same for D2 as columns; a point against a
  reservoir costs its distance to the diagonal (**q), two reservoirs cost
  nothing.  The identical reservoir rows tie-fight for ~1.3k rounds a pair.
* ``"on"`` (default): the reservoir block folded into one multi-unit OUT
  slot, leaving the K×K reduced cost ``cbar = pp - diag1 - diag2`` for the
  collapsed forward/reverse auction, ~30 rounds a pair, with price vectors
  in and out for warm starts (``compare_info``).

One deliberate difference from ``repro``: on the collapsed path ``repro``
forms ``W^q`` as ``base + Σ cbar`` in float32, which cancels (a
self-distance of 0.015625 on ``repro``'s seed-14 test diagram, where the
Hungarian oracle gives 0).  The port sums ``W^q`` from the costs of the
expanded matching the solver returned instead: the point-to-point costs of
the matched pairs, the diagonal costs of the valid points of D1 left
unmatched and of the valid points of D2 nobody matched, in float64, cast to
float32 once.  Identical diagrams match every point to itself at a cost of
exactly 0, so the self-distance is exactly 0.

The costs repeat the floats of ``repro``'s jitted cost functions: XLA
contracts ``db*db + de*de`` into a fused multiply-add (``fma(db, db,
de*de)``, formed here in float64 from exact products and rounded once, as
is the L∞ q = 2 reduced cost's ``root*root - diag1``) and turns the
division by √2 into a multiplication by its float32 reciprocal.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.persistence import Diagrams
from repro_torch.kernels import ops
from repro_torch.metrics.distances import compact_top_k

GROUNDS = ("l2", "linf")
COLLAPSE_MODES = ("on", "off")

# float32 1/sqrt(2), as XLA folds the division by jnp.sqrt(2.0)
_INV_SQRT2 = float(np.float32(1.0) / np.sqrt(np.float32(2.0)))


def _pow(x: torch.Tensor, q: float) -> torch.Tensor:
    """``x ** q`` as ``jnp`` lowers it: integer powers 1 and 2 exactly."""
    if q == 1.0:
        return x
    if q == 2.0:
        return x * x
    return x ** q


def cloud_costs(b1, e1, keep1, b2, e2, keep2, q: float = 2.0,
                ground: str = "l2"):
    """The three cost surfaces of the augmented problem, entries **q.

    Returns ``(pp, diag1, diag2)``: point-to-point costs (..., K, K) and
    each side's point-to-diagonal costs (..., K), zeroed at invalid slots.
    """
    if ground not in GROUNDS:
        raise ValueError(f"unknown ground metric {ground!r}; want {GROUNDS}")
    db = b1[..., :, None] - b2[..., None, :]
    de = e1[..., :, None] - e2[..., None, :]
    if ground == "l2":
        dd = db.to(torch.float64)
        dsq = (dd * dd + (de * de).to(torch.float64)).to(torch.float32)
        pp = dsq if q == 2.0 else dsq ** (q / 2.0)
        diag1 = _pow((e1 - b1) * _INV_SQRT2, q)
        diag2 = _pow((e2 - b2) * _INV_SQRT2, q)
    else:
        pp = _pow(torch.maximum(db.abs(), de.abs()), q)
        diag1 = _pow((e1 - b1) * 0.5, q)
        diag2 = _pow((e2 - b2) * 0.5, q)
    diag1 = torch.where(keep1, diag1, 0.0)
    diag2 = torch.where(keep2, diag2, 0.0)
    return pp, diag1, diag2


def augmented_cost(b1, e1, keep1, b2, e2, keep2, q: float = 2.0,
                   ground: str = "l2"):
    """Batched (..., 2K, 2K) diagonal-augmented assignment costs, entries
    **q (the ``collapse="off"`` layout): invalid slots act as extra
    reservoirs, free against other reservoirs and invalid slots."""
    k = b1.shape[-1]
    pp, diag1, diag2 = cloud_costs(b1, e1, keep1, b2, e2, keep2, q=q,
                                   ground=ground)
    lead = pp.shape[:-2]
    pad = torch.nn.functional.pad
    rp = pad(torch.broadcast_to(keep1, lead + (k,)), (0, k))
    cp = pad(torch.broadcast_to(keep2, lead + (k,)), (0, k))
    d1 = pad(torch.broadcast_to(diag1, lead + (k,)), (0, k))
    d2 = pad(torch.broadcast_to(diag2, lead + (k,)), (0, k))
    pp_full = pad(pp, (0, k, 0, k))
    return torch.where(
        rp[..., :, None] & cp[..., None, :], pp_full,
        torch.where(rp[..., :, None], d1[..., :, None],
                    torch.where(cp[..., None, :], d2[..., None, :], 0.0)))


def _reduced(b1, e1, b2, e2, pp, diag1, diag2, q, ground):
    """``cbar = pp - diag1[i] - diag2[j]`` in ``repro``'s jitted floats: for
    the L∞ ground at q = 2, XLA contracts ``root * root - diag1`` (``pp =
    root²``) into one fused multiply-add."""
    if ground == "linf" and q == 2.0:
        root = torch.maximum((b1[..., :, None] - b2[..., None, :]).abs(),
                             (e1[..., :, None] - e2[..., None, :]).abs())
        root = root.to(torch.float64)
        first = (root * root - diag1.to(torch.float64)[..., :, None]).to(
            torch.float32)
    else:
        first = pp - diag1[..., :, None]
    return first - diag2[..., None, :]


def collapsed_cost(b1, e1, keep1, b2, e2, keep2, q: float = 2.0,
                   ground: str = "l2"):
    """Reservoir-collapsed reduced costs ``(cbar (..., K, K), base (...,))``:
    ``cbar[i, j] = pp[i, j] - diag1[i] - diag2[j]`` and ``base = Σ diag1 +
    Σ diag2``, so ``W_q^q = base + min over partial matchings Σ cbar``."""
    pp, diag1, diag2 = cloud_costs(b1, e1, keep1, b2, e2, keep2, q=q,
                                   ground=ground)
    cbar = _reduced(b1, e1, b2, e2, pp, diag1, diag2, q, ground)
    base = diag1.sum(-1) + diag2.sum(-1)
    return cbar, base


def _resolve_collapse(collapse: str | None) -> str:
    mode = "on" if collapse is None else collapse
    if mode not in COLLAPSE_MODES:
        raise ValueError(
            f"unknown collapse mode {mode!r}; want {COLLAPSE_MODES}")
    return mode


def _flat(x: torch.Tensor, lead: tuple, tail: tuple) -> torch.Tensor:
    """``x`` broadcast to ``lead + tail`` as a contiguous (-1, *tail)."""
    return torch.broadcast_to(x, lead + tail).reshape((-1,) + tail) \
        .contiguous()


def matched_cost(pp, diag1, diag2, keep1, keep2, p2o) -> torch.Tensor:
    """(B,) float32 ``W^q`` of a collapsed matching, summed in float64.

    ``pp`` (B, K, K), ``diag1``/``diag2``/``keep1``/``keep2``/``p2o`` (B, K):
    the point-to-point costs of the matched pairs, plus the diagonal costs
    of the valid points of D1 left unmatched (at OUT, or free) and of the
    valid points of D2 that no one matched.
    """
    k = p2o.shape[-1]
    matched = p2o >= 0
    picked = pp.gather(-1, p2o.clamp(min=0).long()[..., None])[..., 0]
    owned = (matched[:, :, None]
             & (p2o[:, :, None] == torch.arange(k, device=p2o.device))
             ).any(1)
    wq = (torch.where(matched, picked.double(), 0.0).sum(-1)
          + torch.where(keep1 & ~matched, diag1.double(), 0.0).sum(-1)
          + torch.where(keep2 & ~owned, diag2.double(), 0.0).sum(-1))
    return wq.to(torch.float32)


def exact_w_full(d1: Diagrams, d2: Diagrams, k: int = 1, q: float = 2.0,
                 ground: str = "l2", cap: float = 64.0, n_points: int = 16,
                 n_scales: int = 10, collapse: str | None = None,
                 prices: torch.Tensor | None = None):
    """``exact_w`` plus solver diagnostics and warm-startable prices.

    Returns ``(w, converged, rounds, prices_out)``.  On the collapsed path
    (``collapse`` ``None`` or ``"on"``) ``prices`` is an optional
    ``lead + (n_points,)`` warm start in the solver's max-normalized units
    (any nonnegative vector is safe, a good one is fast) and
    ``prices_out`` the final price vector per pair.  The expanded path
    (``"off"``) ignores ``prices`` and returns zeros.
    """
    mode = _resolve_collapse(collapse)
    b1, e1, k1 = compact_top_k(d1, k, n_points, cap)
    b2, e2, k2 = compact_top_k(d2, k, n_points, cap)
    pp, diag1, diag2 = cloud_costs(b1, e1, k1, b2, e2, k2, q=q, ground=ground)
    lead = tuple(pp.shape[:-2])
    dev = pp.device
    kk = (n_points,)
    if mode == "off":
        cost = augmented_cost(b1, e1, k1, b2, e2, k2, q=q, ground=ground)
        flat = cost.reshape((-1,) + cost.shape[-2:]).contiguous()
        _, total, conv, rounds = ops.auction_lap(flat, n_scales=n_scales)
        w = total.clamp(min=0.0) ** (1.0 / q)
        return (w.reshape(lead), conv.reshape(lead), rounds.reshape(lead),
                torch.zeros(lead + kk, dtype=torch.float32, device=dev))
    cbar = _reduced(b1, e1, b2, e2, pp, diag1, diag2, q, ground)
    k1f, k2f = _flat(k1, lead, kk), _flat(k2, lead, kk)
    if prices is not None:
        prices = _flat(torch.as_tensor(prices, dtype=torch.float32,
                                       device=dev), lead, kk)
    p2o, _, conv, rounds, price = ops.auction_lap_collapsed(
        _flat(cbar, lead, kk * 2), k1f, k2f, prices, n_scales=n_scales)
    wq = matched_cost(_flat(pp, lead, kk * 2), _flat(diag1, lead, kk),
                      _flat(diag2, lead, kk), k1f, k2f, p2o)
    w = wq.clamp(min=0.0) ** (1.0 / q)
    return (w.reshape(lead), conv.reshape(lead), rounds.reshape(lead),
            price.reshape(lead + kk))


def exact_w_info(d1: Diagrams, d2: Diagrams, k: int = 1, q: float = 2.0,
                 ground: str = "l2", cap: float = 64.0, n_points: int = 16,
                 n_scales: int = 10, collapse: str | None = None):
    """``exact_w`` plus per-pair diagnostics ``(w, converged, rounds)``:
    whether the matching came from one of the two finest ε rungs, and the
    total bidding rounds."""
    w, conv, rounds, _ = exact_w_full(d1, d2, k=k, q=q, ground=ground,
                                      cap=cap, n_points=n_points,
                                      n_scales=n_scales, collapse=collapse)
    return w, conv, rounds


def exact_w(d1: Diagrams, d2: Diagrams, k: int = 1, q: float = 2.0,
            ground: str = "l2", cap: float = 64.0, n_points: int = 16,
            n_scales: int = 10, collapse: str | None = None) -> torch.Tensor:
    """Exact q-Wasserstein between dim-``k`` diagrams (batched auction).

    The batched equivalent of ``reference.wasserstein_exact(q, ground)``,
    exact up to the top-``n_points`` compaction.  Pairs are aligned
    row-wise over any leading axes; returns ``(...,)`` distances.
    """
    w, _, _ = exact_w_info(d1, d2, k=k, q=q, ground=ground, cap=cap,
                           n_points=n_points, n_scales=n_scales,
                           collapse=collapse)
    return w


def bottleneck_approx(d1: Diagrams, d2: Diagrams, k: int = 1,
                      cap: float = 64.0, n_points: int = 16,
                      n_iters: int = 24) -> torch.Tensor:
    """Bottleneck distance by threshold bisection over batched 0/1
    collapsed auction feasibility solves.

    ``t`` is feasible iff ``Σ out1 + Σ out2 + min matching of (pp > t) -
    out1 - out2`` is 0, with ``out = diag > t`` per valid slot; ``n_iters``
    midpoint probes bound the answer within ``max_cost · 2^-n_iters`` of
    the exact bottleneck of the compacted clouds.  An unconverged probe
    counts as infeasible, which can only push the answer up.
    """
    b1, e1, k1 = compact_top_k(d1, k, n_points, cap)
    b2, e2, k2 = compact_top_k(d2, k, n_points, cap)
    pp, diag1, diag2 = cloud_costs(b1, e1, k1, b2, e2, k2, q=1.0,
                                   ground="linf")
    lead = tuple(pp.shape[:-2])
    kk = (n_points,)
    ppf = _flat(pp, lead, kk * 2)
    d1f, d2f = _flat(diag1, lead, kk), _flat(diag2, lead, kk)
    k1f, k2f = _flat(k1, lead, kk), _flat(k2, lead, kk)
    validf = k1f[:, :, None] & k2f[:, None, :]
    hi = torch.maximum(torch.where(validf, ppf, 0.0).amax((-1, -2)),
                       torch.maximum(d1f.amax(-1), d2f.amax(-1)))
    lo = torch.zeros_like(hi)
    # the 0/1 feasibility read (< 0.5 violations) is sound only while the
    # auction's K·ε_final suboptimality stays below half a unit cost
    n_scales = max(4, int(math.ceil(math.log(4.0 * n_points)
                                    / math.log(5.0))) + 1)
    for _ in range(n_iters):
        t = (lo + hi) / 2.0
        out1 = torch.where(k1f & (d1f > t[:, None]), 1.0, 0.0)
        out2 = torch.where(k2f & (d2f > t[:, None]), 1.0, 0.0)
        c01 = torch.where(ppf > t[:, None, None], 1.0, 0.0)
        cbar01 = c01 - out1[:, :, None] - out2[:, None, :]
        base01 = out1.sum(-1) + out2.sum(-1)
        _, red, conv, _, _ = ops.auction_lap_collapsed(
            cbar01, k1f, k2f, None, n_scales=n_scales)
        feasible = (base01 + red < 0.5) & conv
        lo = torch.where(feasible, lo, t)
        hi = torch.where(feasible, t, hi)
    return hi.reshape(lead)
