"""Persistence-diagram distances on the Diagrams layout: the port of
``repro.metrics.distances`` (sliced Wasserstein and entropic Sinkhorn-W2).

Every function is masked arithmetic over (..., S) Diagrams tensors on their
device; leading batch axes broadcast.  Conventions, as in ``repro``:

* **Per dimension.**  Each distance takes a homology dimension ``k`` and
  selects ``valid & (dim == k)`` rows.
* **Essential classes.**  ``death = +inf`` rows are capped at ``cap``
  (``Diagrams.finite_points``).
* **Masking.**  Invalid rows are inert: two Diagrams that differ only in
  padding have distance exactly 0.

``sinkhorn_w2`` runs its Sinkhorn updates either on a materialized cost
matrix (``impl="dense"``, plain PyTorch) or through the blocked kernels
``ops.sinkhorn_lse`` / ``ops.sinkhorn_pair_sum`` (``impl="blocked"``),
which rebuild the cost on the fly: hand-written CUDA on the card, their
plain versions on the CPU.

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
from repro_torch.kernels import ops as kops


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


def _diag_free_cost(x, y, xd, yd):
    """(..., M, N) squared-Euclidean cost, diagonal<->diagonal pairs free.

    ``xd``/``yd`` flag the diagonal-image slots of each cloud: moving mass
    along the diagonal costs nothing.
    """
    c = ((x[..., :, None, :] - y[..., None, :, :]) ** 2).sum(-1)
    return torch.where(xd[:, None] & yd[None, :], 0.0, c)


def _lse(z, dim):
    """``m + log sum exp(z - m)`` along ``dim``; all-masked rows give -inf.

    The blocked kernel reproduces this tile by tile: when the cloud fits
    one tile the two run the same algebra in the same order.
    """
    m = z.amax(dim, keepdim=True)
    s = torch.exp(z - m).sum(dim)
    m = m.squeeze(dim)
    return torch.where(torch.isfinite(m), m + torch.log(s), float("-inf"))


class _DenseSinkhornOps:
    """Sinkhorn update primitives on a materialized (..., M, N) cost."""

    def __init__(self, c):
        self.c = c

    def lse_cols(self, dual, logw, e_t):
        """(..., M): row i gets LSE_j(logw_j + (dual_j - c_ij) / e)."""
        z = logw[..., None, :] + (dual[..., None, :] - self.c) / e_t[..., None]
        return _lse(z, -1)

    def lse_rows(self, dual, logw, e_t):
        """(..., N): the same reduction over the x side."""
        z = logw[..., :, None] + (dual[..., :, None] - self.c) / e_t[..., None]
        return _lse(z, -2)

    def plan_cost(self, f, g, log_a, log_b, e_t):
        """<P, C> of the final potentials over the valid pairs."""
        log_p = (log_a[..., :, None] + log_b[..., None, :]
                 + (f[..., :, None] + g[..., None, :] - self.c)
                 / e_t[..., None])
        pair = (torch.isfinite(log_a)[..., :, None]
                & torch.isfinite(log_b)[..., None, :])
        return torch.where(pair, torch.exp(log_p) * self.c, 0.0).sum((-1, -2))

    def masked_cost_sum(self, log_a, log_b):
        """Sum of the cost over the valid pairs (the eps scale statistic)."""
        pair = (torch.isfinite(log_a)[..., :, None]
                & torch.isfinite(log_b)[..., None, :])
        return torch.where(pair, self.c, 0.0).sum((-1, -2))


class _BlockedSinkhornOps:
    """Sinkhorn update primitives with the cost rebuilt on the fly by the
    blocked kernels: no (M, N) cost matrix exists.  Takes (B, M, 2) clouds
    with one leading batch axis.  Each side's weighted columns are packed
    once per log-weight tensor (``kops.pack_columns``): a Sinkhorn call
    passes the same ``log_a`` and ``log_b`` to every half-update."""

    def __init__(self, x, y, xd, yd):
        self.xp = _cloud_planes(x, xd)
        self.yp = _cloud_planes(y, yd)
        self._packed = {}  # side -> (log weights, their pack)

    def _pack(self, side, planes, logw):
        hit = self._packed.get(side)
        if hit is None or hit[0] is not logw:
            hit = self._packed[side] = (logw, kops.pack_columns(planes, logw))
        return hit[1]

    def lse_cols(self, dual, logw, e_t):
        return kops.sinkhorn_lse(self.xp, self.yp, dual, logw, e_t,
                                 packed=self._pack("y", self.yp, logw))

    def lse_rows(self, dual, logw, e_t):
        return kops.sinkhorn_lse(self.yp, self.xp, dual, logw, e_t,
                                 packed=self._pack("x", self.xp, logw))

    def plan_cost(self, f, g, log_a, log_b, e_t):
        return kops.sinkhorn_pair_sum(self.xp, self.yp, f, g, log_a, log_b,
                                      e_t, mode="plan")

    def masked_cost_sum(self, log_a, log_b):
        one = torch.ones(log_a.shape[:-1] + (1,), dtype=torch.float32,
                         device=log_a.device)
        return kops.sinkhorn_pair_sum(self.xp, self.yp,
                                      torch.zeros_like(log_a),
                                      torch.zeros_like(log_b), log_a, log_b,
                                      one, mode="cost")


def _cloud_planes(pts, dflag):
    """(..., M, 2) cloud and (M,) diagonal flags -> (..., 3, M) coordinate
    planes (a new, contiguous tensor): birth, death, diagonal flag.

    ``repro`` stacks five more zero planes, the TPU's sublane padding; the
    kernels read only these three.
    """
    b, d = pts[..., 0], pts[..., 1]
    f = dflag.to(torch.float32).expand(b.shape)
    return torch.stack([b, d, f], dim=-2)


def _entropic_plan_cost(pair_ops, xv, yv, scale, eps, n_iters, n_scales):
    """<P, C> of log-domain Sinkhorn under eps-scaling (masked uniform mass).

    ``n_scales`` stages anneal geometrically from ``eps * 2^(n_scales-1)``
    down to ``eps`` (relative to the per-pair cost ``scale``), each running
    ``n_iters`` iterations from the previous stage's potentials.  The loops
    run on the host and never wait for the device.
    """
    nx = xv.sum(-1).to(torch.float32).clamp(min=1.0)[..., None]
    ny = yv.sum(-1).to(torch.float32).clamp(min=1.0)[..., None]
    log_a = torch.where(xv, -torch.log(nx), float("-inf"))
    log_b = torch.where(yv, -torch.log(ny), float("-inf"))
    f, g = torch.zeros_like(log_a), torch.zeros_like(log_b)
    for stage in range(n_scales - 1, -1, -1):
        # float32 eps times an exact power of two, as repro's ladder; a
        # Python float that float32 holds exactly, so no host copy
        e_t = scale * float(np.float32(eps) * np.float32(2.0 ** stage))
        for _ in range(n_iters):
            f = -e_t * pair_ops.lse_cols(g, log_b, e_t)
            f = torch.where(xv, f, 0.0)
            g = -e_t * pair_ops.lse_rows(f, log_a, e_t)
            g = torch.where(yv, g, 0.0)
    return pair_ops.plan_cost(f, g, log_a, log_b, eps * scale)


def sinkhorn_w2(d1: Diagrams, d2: Diagrams, k: int = 1, cap: float = 64.0,
                eps: float = 1e-2, n_iters: int = 50,
                n_scales: int = 6, n_points: int | None = 32,
                impl: str = "dense", tile: int = 128) -> torch.Tensor:
    """Debiased entropic 2-Wasserstein between dim-``k`` diagrams (batched).

    Squared-Euclidean OT between the diagonal-augmented clouds
    ``X = P1 ∪ Δ(P2)`` and ``Y = P2 ∪ Δ(P1)`` (uniform mass, diagonal<->
    diagonal transport free), each OT value from log-domain Sinkhorn under
    eps-scaling; the estimate is the Sinkhorn divergence
    ``OT(X,Y) - OT(X,X)/2 - OT(Y,Y)/2``, so self-distance is exactly 0.
    Returns ``sqrt(divergence * (n1 + n2))``, shape ``(...,)``.

    ``n_points`` compacts each cloud to its top points by persistence
    (``compact_top_k``); ``None`` runs on the full (2S)-slot tensor.
    ``impl="dense"`` materializes the three cost matrices;
    ``impl="blocked"`` rebuilds the cost on the fly in the
    ``sinkhorn_lse`` / ``sinkhorn_pair_sum`` kernels, so memory stays
    O(M + N) per pair.  ``tile`` is kept so that the parameter set equals
    ``repro``'s; it does not change the port's result (the CUDA kernels
    have one compiled tile, the plain versions none).
    """
    del tile  # one compiled tile; see the docstring
    if impl not in ("dense", "blocked"):
        raise ValueError(f"unknown sinkhorn impl {impl!r}; "
                         "want 'dense' or 'blocked'")
    if n_points is not None:
        b1, e1, sel1 = compact_top_k(d1, k, n_points, cap)
        b2, e2, sel2 = compact_top_k(d2, k, n_points, cap)
    else:
        b1, e1, sel1 = masked_points(d1, k, cap)
        b2, e2, sel2 = masked_points(d2, k, cap)
    mid1, mid2 = (b1 + e1) / 2.0, (b2 + e2) / 2.0

    # clouds (..., 2S, 2): the first S slots points, the last S diagonal images
    x = torch.cat([torch.stack([b1, e1], -1), torch.stack([mid2, mid2], -1)],
                  dim=-2)
    y = torch.cat([torch.stack([b2, e2], -1), torch.stack([mid1, mid1], -1)],
                  dim=-2)
    xv = torch.cat([sel1, sel2], dim=-1)
    yv = torch.cat([sel2, sel1], dim=-1)
    s1, s2 = sel1.shape[-1], sel2.shape[-1]
    slots = torch.arange(s1 + s2, device=x.device)
    xd, yd = slots >= s1, slots >= s2  # diagonal-image slots of each cloud

    lead = x.shape[:-2]
    if impl == "dense":
        ops_xy = _DenseSinkhornOps(_diag_free_cost(x, y, xd, yd))
        ops_xx = _DenseSinkhornOps(_diag_free_cost(x, x, xd, xd))
        ops_yy = _DenseSinkhornOps(_diag_free_cost(y, y, yd, yd))
    else:
        # the kernels take one leading batch axis: flatten to (B, ...)
        def fl(a):
            return a.reshape((-1,) + tuple(a.shape[len(lead):]))

        x, y, xv, yv, sel1, sel2 = map(fl, (x, y, xv, yv, sel1, sel2))
        ops_xy = _BlockedSinkhornOps(x, y, xd, yd)
        ops_xx = _BlockedSinkhornOps(x, x, xd, xd)
        ops_yy = _BlockedSinkhornOps(y, y, yd, yd)

    n = (sel1.sum(-1) + sel2.sum(-1)).to(torch.float32)
    nz = n.clamp(min=1.0)

    def log0(v):
        return torch.where(v, 0.0, float("-inf"))

    # eps relative to the mean inter-cloud cost, so one setting spans
    # filtrations
    scale = ops_xy.masked_cost_sum(log0(xv), log0(yv)) / (nz ** 2)
    scale = scale.clamp(min=1e-6)[..., None]

    def ot(ops, av, bv):
        return _entropic_plan_cost(ops, av, bv, scale, eps, n_iters,
                                   n_scales)

    div = (ot(ops_xy, xv, yv) - 0.5 * ot(ops_xx, xv, xv)
           - 0.5 * ot(ops_yy, yv, yv))
    w2sq = div * n  # undo the uniform 1/(n1+n2) mass normalization
    out = torch.where(n > 0, torch.sqrt(w2sq.clamp(min=0.0)), 0.0)
    return out.reshape(lead)
