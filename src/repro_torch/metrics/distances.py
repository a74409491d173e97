"""Sliced-Wasserstein distances and embeddings on the Diagrams layout
(the sliced-Wasserstein half of ``repro.metrics.distances``).

Every function is masked arithmetic over (..., S) Diagrams tensors on their
device; leading batch axes broadcast.  Conventions, as in ``repro``:

* **Per dimension.**  Each distance takes a homology dimension ``k`` and
  selects ``valid & (dim == k)`` rows.
* **Essential classes.**  ``death = +inf`` rows are capped at ``cap``
  (``Diagrams.finite_points``).
* **Masking.**  Invalid rows are inert: two Diagrams that differ only in
  padding have distance exactly 0.

``sinkhorn_w2`` and its blocked operators are not here yet: they come with
the metric-engine slice of the port, beside the ``sinkhorn_lse`` kernels.

The direction grid's ``cos``/``sin`` are computed on the host in float64 and
rounded once, so every device gets the same grid; XLA's float32
``cos``/``sin`` can differ from it in the last bit.  Tie order follows
``lax.top_k``: where persistences tie, the lower row comes first.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch._device import resolve_device
from repro_torch.core.persistence import Diagrams


def direction_grid(n_dirs: int, device=None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos φ, sin φ) for ``n_dirs`` directions on the half-circle.

    Midpoint grid φ_m = -π/2 + π (m + ½)/M in float32 (as ``repro`` forms
    it), whose cosine and sine are taken in float64 and rounded to float32.
    """
    dev = resolve_device(device)
    pi = np.float32(np.pi)
    phi = (np.float32(-np.pi / 2)
           + pi * (np.arange(n_dirs, dtype=np.float32) + np.float32(0.5))
           / np.float32(n_dirs)).astype(np.float64)
    return (torch.from_numpy(np.cos(phi).astype(np.float32)).to(dev),
            torch.from_numpy(np.sin(phi).astype(np.float32)).to(dev))


def masked_points(d: Diagrams, k: int, cap: float):
    """Sanitized ``(birth, death, sel)`` of the dim-``k`` sub-diagram:
    birth/death are 0 outside ``sel`` and death is capped at ``cap``."""
    sel = d.valid & (d.dim == k)
    birth, death = d.finite_points(cap)
    return torch.where(sel, birth, 0.0), torch.where(sel, death, 0.0), sel


def compact_top_k(d: Diagrams, k: int, n_points: int, cap: float):
    """``masked_points`` compacted to exactly ``n_points`` slots by
    persistence: ``(birth, death, keep)`` of width ``n_points``.

    Exact when the dim-``k`` sub-diagram has at most ``n_points`` points;
    beyond that the lowest-persistence points are dropped, and among equal
    persistences the lower row is kept (``lax.top_k``'s order, reproduced by
    a stable descending sort).  Absent slots are 0 with ``keep=False``.
    """
    b, e, sel = masked_points(d, k, cap)
    s = b.shape[-1]
    if s < n_points:  # tiny diagram tensors: pad rows up to the slot count
        pad = (0, n_points - s)
        return F.pad(b, pad), F.pad(e, pad), F.pad(sel, pad)
    if s == n_points:
        return b, e, sel
    pers = torch.where(sel, e - b, float("-inf"))
    top_pers, top_idx = torch.sort(pers, dim=-1, descending=True, stable=True)
    top_pers, top_idx = top_pers[..., :n_points], top_idx[..., :n_points]
    keep = torch.isfinite(top_pers)
    tb = torch.where(keep, b.gather(-1, top_idx), 0.0)
    te = torch.where(keep, e.gather(-1, top_idx), 0.0)
    return tb, te, keep


def _project(b, e, cos, sin):
    """(..., M, P) projections of points and their diagonal images."""
    pt = b[..., None, :] * cos[:, None] + e[..., None, :] * sin[:, None]
    dg = ((b + e) / 2.0)[..., None, :] * (cos + sin)[:, None]
    return pt, dg


def sliced_wasserstein(d1: Diagrams, d2: Diagrams, k: int = 1,
                       n_dirs: int = 32, cap: float = 64.0) -> torch.Tensor:
    """Sliced-Wasserstein distance between dim-``k`` diagrams (batched).

    Pairs are aligned row-wise over leading axes; returns ``(...,)``.  For
    each direction the two projected multisets are ``P1 ∪ Δ(P2)`` and
    ``P2 ∪ Δ(P1)``; 1-D W1 is the L1 distance of the sorted sequences
    (padding sorts to an aligned +inf tail and is dropped by rank), and the
    result is the direction average, summed in float64.
    """
    cos, sin = direction_grid(n_dirs, d1.birth.device)
    b1, e1, sel1 = masked_points(d1, k, cap)
    b2, e2, sel2 = masked_points(d2, k, cap)

    pt1, dg1 = _project(b1, e1, cos, sin)
    pt2, dg2 = _project(b2, e2, cos, sin)

    def entries(pt, sel, odg, osel):
        # own points, then the other diagram's diagonal projections
        pt = torch.where(sel[..., None, :], pt, float("inf"))
        odg = torch.where(osel[..., None, :], odg, float("inf"))
        return torch.sort(torch.cat([pt, odg], dim=-1), dim=-1).values

    v1 = entries(pt1, sel1, dg2, sel2)
    v2 = entries(pt2, sel2, dg1, sel1)
    cnt = (sel1.sum(-1) + sel2.sum(-1))[..., None, None]
    rank = torch.arange(v1.shape[-1], device=v1.device)
    diff = torch.where(rank < cnt, (v1 - v2).abs(), 0.0)  # inf-inf dropped
    return diff.double().sum((-1, -2)).to(torch.float32) / n_dirs


def sw_embedding(d: Diagrams, k: int = 1, n_points: int = 16,
                 n_dirs: int = 16, cap: float = 64.0) -> torch.Tensor:
    """Pair-independent sliced projection embedding:
    ``(..., n_dirs * 2 * n_points)`` float32.

    The top ``n_points`` rows by persistence are kept; per direction each
    kept point contributes its projection and its own diagonal projection,
    absent slots sit at 0, entries are sorted per direction and scaled by
    ``1/n_dirs``, so the L1 distance between two embeddings
    (:func:`repro_torch.kernels.ops.pairwise_l1`) is the direction-averaged
    1-D W1 of the anchored multisets: the TopoIndex metric.
    """
    tb, te, keep = compact_top_k(d, k, n_points, cap)
    cos, sin = direction_grid(n_dirs, tb.device)
    pt, dg = _project(tb, te, cos, sin)
    pt = torch.where(keep[..., None, :], pt, 0.0)
    dg = torch.where(keep[..., None, :], dg, 0.0)
    emb = torch.sort(torch.cat([pt, dg], dim=-1), dim=-1).values / n_dirs
    return emb.reshape(emb.shape[:-2] + (n_dirs * 2 * n_points,))
