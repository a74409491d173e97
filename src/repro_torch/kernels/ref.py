"""Plain PyTorch versions of the CUDA kernels.

Each function computes exactly what its kernel computes, batched over the
leading axis, and mirrors ``repro.kernels.ref`` /
``repro.core.persistence_jax.reduce_packed``.  The wrappers in
:mod:`repro_torch.kernels.ops` run these for CPU tensors; on the card they
serve only as the yardstick the kernels are held against.

Packed GF(2) columns are ``int32`` bit patterns (32 rows per word, row r at
bit ``r % 32`` of word ``r // 32``).  Bit 31 is then the sign bit, so the
highest-set-bit search here works on the unsigned value widened to int64 and
never compares or shifts the signed word.
"""
from __future__ import annotations

import torch

WORD = 32


def kcore_peel_ref(adj: torch.Tensor, alive: torch.Tensor, k) -> torch.Tensor:
    """One Jacobi peel sweep: ``alive & (deg_within_alive >= k)``.

    adj (B, N, N) bool, alive (B, N) bool -> (B, N) bool.
    """
    deg = torch.einsum("buw,bw->bu", adj.float(), alive.float())
    return alive & (deg >= float(k))


def domination_ref(adj: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """dom[b, u, v] = "v dominates u" (closed neighborhoods, u != v).

    adj (B, N, N) bool, mask (B, N) bool -> (B, N, N) bool.  The violation
    count is an f32 product of 0/1 matrices, exact below 2^24.
    """
    n = adj.shape[-1]
    eye = torch.eye(n, dtype=torch.bool, device=adj.device)
    live = mask[..., None, :] & mask[..., :, None]
    nc = (adj | eye) & live & mask[..., :, None]
    not_ncv = (~nc).float() * mask[..., None, :].float()
    viol = torch.einsum("buw,bvw->buv", nc.float(), not_ncv)
    return (viol == 0) & ~eye & live


def common_neighbors_ref(adj: torch.Tensor) -> torch.Tensor:
    """cn[b, u, v] = |N(u) ∩ N(v)| on edges: ``(A @ A) ⊙ A`` as int32.

    adj (B, N, N) bool -> (B, N, N) int32.  The product is an f32 product of
    0/1 matrices, exact below 2^24 in full float32 (torch's default for
    matrix products; TF32 would round it).
    """
    a = adj.float()
    return (torch.bmm(a, a) * a).to(torch.int32)


# elements of the (rows, N, D) broadcast that pairwise_l1_ref materializes
# at a time (256 MiB of float32)
L1_CHUNK = 1 << 26


def pairwise_l1_ref(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """gram[i, j] = sum_d |x[i, d] - y[j, d]|: (M, D) x (N, D) -> (M, N) f32.

    Materializes the broadcast difference ``L1_CHUNK`` elements at a time,
    so the plain version fits in memory at the index's shapes.
    """
    x = x.float()
    y = y.float()
    m, d = x.shape
    n = y.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    rows = max(1, L1_CHUNK // max(n * d, 1))
    for i in range(0, m, rows):
        out[i:i + rows] = (x[i:i + rows, None, :] - y[None]).abs().sum(-1)
    return out


def low(cols: torch.Tensor) -> torch.Tensor:
    """(G, W) int32 packed columns -> (G,) int64 highest set row, or -1."""
    w = cols.shape[-1]
    nz = cols != 0
    widx = (w - 1) - nz.flip(-1).to(torch.int32).argmax(-1)
    word = cols.gather(-1, widx[:, None]).squeeze(-1).to(torch.int64)
    word = word & 0xFFFFFFFF  # the unsigned value of the bit pattern
    bit = torch.frexp(word.to(torch.float64)).exponent.to(torch.int64) - 1
    return torch.where(nz.any(-1), widx * WORD + bit, -1)


def gf2_reduce_counted(b: torch.Tensor, n_rows: int | None = None):
    """:func:`gf2_reduce_ref` plus the number of column additions per matrix.

    The additions are the data-dependent work of the pivot chase; a
    roofline bound counts them.
    """
    g, s, w = b.shape
    r = s if n_rows is None else int(n_rows)
    dev = b.device
    m = b.clone()
    owner = torch.full((g, r + 1), -1, dtype=torch.int32, device=dev)
    positive = torch.ones((g, s), dtype=torch.bool, device=dev)
    adds = torch.zeros(g, dtype=torch.int64, device=dev)
    rows = torch.arange(g, device=dev)
    # columns past the last nonzero one in every matrix reduce to zero
    nz = (b != 0).any(-1).any(0).nonzero()
    s_eff = int(nz[-1]) + 1 if nz.numel() else 0
    for j in range(s_eff):
        col = m[:, j].clone()
        done = torch.zeros(g, dtype=torch.bool, device=dev)
        claimed = torch.full((g,), -1, dtype=torch.int64, device=dev)
        while True:
            lo = low(col)
            active = ~done & (lo >= 0)
            piv = owner.gather(1, lo.clamp(min=0)[:, None]).squeeze(1)
            claim = active & (piv < 0)
            xor = active & (piv >= 0)
            claimed = torch.where(claim, lo, claimed)
            done = done | ~active | claim
            if not bool(xor.any()):
                break
            adds += xor
            pc = m[rows, piv.clamp(min=0).long()]
            col = torch.where(xor[:, None], col ^ pc, col)
        m[:, j] = col
        ok = claimed >= 0
        owner.scatter_(1, torch.where(ok, claimed, r)[:, None],
                       torch.full((g, 1), j, dtype=torch.int32, device=dev))
        positive[:, j] = ~ok
    return m, owner[:, :r], positive, adds


def gf2_reduce_ref(b: torch.Tensor, n_rows: int | None = None):
    """Standard persistence reduction of (G, S, W) int32 packed matrices.

    Returns ``(reduced (G,S,W) int32, owner (G,R) int32, positive (G,S)
    bool)``: owner[i] is the column whose reduced low is row i, or -1;
    positive[j] says column j reduced to zero.  R = ``n_rows`` (default S).
    Columns are processed in order and each pivot chase runs for all G
    matrices at once until every one has claimed a row or emptied.
    """
    m, owner, positive, _ = gf2_reduce_counted(b, n_rows)
    return m, owner, positive


# ------------------------------------------------------------ Sinkhorn
# Cloud planes are (B, 3, M) float32: plane 0 birth, plane 1 death, plane 2
# the diagonal-slot flag (repro's (B, 8, M) layout without its five zero
# planes of TPU sublane padding).  Validity is carried by the -inf slots of
# the log weights.

# elements of the (rows, M, N) cost and exponent blocks that the Sinkhorn
# plain versions materialize at a time (256 MiB of float32 each)
SINKHORN_CHUNK = 1 << 26


def sinkhorn_cost(xp: torch.Tensor, yp: torch.Tensor) -> torch.Tensor:
    """(B, M, N) squared-Euclidean cost between two plane sets, with
    diagonal<->diagonal pairs free: ``(xb - yb)^2 + (xd - yd)^2``."""
    xb, xd, xf = xp[:, 0], xp[:, 1], xp[:, 2]
    yb, yd, yf = yp[:, 0], yp[:, 1], yp[:, 2]
    c = (xb[:, :, None] - yb[:, None, :]).square_()
    c += (xd[:, :, None] - yd[:, None, :]).square_()
    return c.masked_fill_((xf[:, :, None] > 0) & (yf[:, None, :] > 0), 0.0)


def _batch_rows(xp: torch.Tensor, yp: torch.Tensor) -> int:
    m, n = xp.shape[-1], yp.shape[-1]
    return max(1, SINKHORN_CHUNK // max(m * n, 1))


def sinkhorn_lse_ref(xp: torch.Tensor, yp: torch.Tensor, dual: torch.Tensor,
                     logw: torch.Tensor, e_t: torch.Tensor) -> torch.Tensor:
    """(B, M) rows ``LSE_j(logw_j + (dual_j - c_ij) / e)``.

    xp (B, 3, M), yp (B, 3, N), dual and logw (B, N), e_t (B, 1), all
    float32.  A row whose every ``logw_j`` is -inf gives -inf.  The cost
    and exponents are materialized ``SINKHORN_CHUNK`` elements at a time
    and updated in place (``dual - c`` as ``-c + dual``, the same float).
    """
    b, m = xp.shape[0], xp.shape[-1]
    out = torch.empty((b, m), dtype=torch.float32, device=xp.device)
    rows = _batch_rows(xp, yp)
    for i in range(0, b, rows):
        s = slice(i, i + rows)
        z = sinkhorn_cost(xp[s], yp[s]).neg_().add_(dual[s, None, :])
        z = z.div_(e_t[s, :, None]).add_(logw[s, None, :])
        mx = z.amax(-1, keepdim=True)
        tot = z.sub_(mx).exp_().sum(-1)
        mx = mx.squeeze(-1)
        out[s] = torch.where(torch.isfinite(mx), mx + torch.log(tot),
                             float("-inf"))
    return out


def sinkhorn_pair_sum_ref(xp: torch.Tensor, yp: torch.Tensor, f: torch.Tensor,
                          g: torch.Tensor, log_a: torch.Tensor,
                          log_b: torch.Tensor, e_t: torch.Tensor,
                          mode: str = "plan") -> torch.Tensor:
    """(B,) masked sum over the pairs whose log weights are both finite.

    ``mode="plan"``: ``exp(log_a_i + log_b_j + (f_i + g_j - c_ij) / e) *
    c_ij`` (the transport cost <P, C>); ``mode="cost"``: ``c_ij`` (``f``,
    ``g`` and ``e_t`` unused).  xp (B, 3, M), yp (B, 3, N); f and log_a
    (B, M); g and log_b (B, N); e_t (B, 1).
    """
    if mode not in ("plan", "cost"):
        raise ValueError(f"unknown pair-sum mode {mode!r}")
    b = xp.shape[0]
    out = torch.empty((b,), dtype=torch.float32, device=xp.device)
    rows = _batch_rows(xp, yp)
    for i in range(0, b, rows):
        s = slice(i, i + rows)
        c = sinkhorn_cost(xp[s], yp[s])
        la, lb = log_a[s, :, None], log_b[s, None, :]
        unpaired = ~(torch.isfinite(la) & torch.isfinite(lb))
        if mode == "plan":
            z = (f[s, :, None] + g[s, None, :]).sub_(c).div_(e_t[s, :, None])
            c = z.add_(la + lb).exp_().mul_(c)
        out[s] = c.masked_fill_(unpaired, 0.0).sum((-1, -2))
    return out
