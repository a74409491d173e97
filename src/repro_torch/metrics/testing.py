"""Synthetic Diagrams generators for tests and checks (the port of
``repro.metrics.testing``), and seeded operands for the Sinkhorn, auction
and Hamming kernels.

Every draw comes from a numpy ``Generator`` in the same order as in
``repro``, so the same ``rng`` gives the same arrays in both packages: NaN
birth/death on invalid rows, ``dim = -1`` padding, points scattered into
arbitrary rows.  The Diagrams land on ``device`` (CUDA unless the caller
passes ``device="cpu"``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.convert import diagrams_from_numpy
from repro_torch.core.persistence import Diagrams
from repro_torch.metrics.reference import cap_points


def _random_arrays(rng: np.random.Generator, s: int, n: int | None,
                   essential: int, k: int, scatter: bool):
    n = int(rng.integers(0, 9)) if n is None else n
    b = np.full(s, np.nan, np.float32)
    d = np.full(s, np.nan, np.float32)
    dim = np.full(s, -1, np.int32)
    val = np.zeros(s, bool)
    bs = rng.uniform(0, 8, n).astype(np.float32)
    ds = bs + rng.uniform(0.2, 6, n).astype(np.float32)
    ds[:essential] = np.inf
    idx = rng.permutation(s)[:n] if scatter else np.arange(n)
    b[idx], d[idx], dim[idx], val[idx] = bs, ds, k, True
    return b, d, dim, val


def random_diagram(rng: np.random.Generator, s: int = 12,
                   n: int | None = None, essential: int = 0, k: int = 1,
                   scatter: bool = True, device=None) -> Diagrams:
    """A random dim-``k`` Diagrams tensor of size ``s`` with ``n`` points.

    ``essential`` of the points get ``death = +inf``; ``scatter`` places
    points in random rows instead of the leading slots.  ``n`` defaults to
    uniform 0..8.
    """
    return diagrams_from_numpy(*_random_arrays(rng, s, n, essential, k,
                                               scatter), device=device)


def seed_diagram_arrays(rng: np.random.Generator, n_seeds: int, s: int):
    """Seed diagrams as numpy arrays ``(birth, death, dim, valid)``, each
    ``(n_seeds, s)``: the raw material for :func:`noisy_copies`."""
    sb = np.full((n_seeds, s), np.nan, np.float32)
    sd = np.full((n_seeds, s), np.nan, np.float32)
    dims = np.full((n_seeds, s), -1, np.int32)
    val = np.zeros((n_seeds, s), bool)
    for j in range(n_seeds):
        sb[j], sd[j], dims[j], val[j] = _random_arrays(
            rng, s, int(rng.integers(3, 8)), 0, 1, True)
    return sb, sd, dims, val


def noisy_copies(seeds, rng: np.random.Generator, n: int,
                 sigma_lo: float, sigma_hi: float, device=None) -> Diagrams:
    """(n,) Diagrams batch of noisy seed copies (retrieval corpora).

    Cycles through the seeds with per-copy noise graded uniformly in
    ``[sigma_lo, sigma_hi]``; deaths are clamped to ``birth + 1e-3`` so
    persistence stays positive.
    """
    sb, sd, dims, val = seeds
    n_seeds, s = sb.shape
    rep = np.arange(n) % n_seeds
    sigma = (sigma_lo + (sigma_hi - sigma_lo)
             * rng.random(n)).astype(np.float32)[:, None]
    b = sb[rep] + rng.normal(0, 1, (n, s)).astype(np.float32) * sigma
    d = sd[rep] + rng.normal(0, 1, (n, s)).astype(np.float32) * sigma
    d = np.maximum(d, b + 1e-3)
    return diagrams_from_numpy(b, d, dims[rep], val[rep], device=device)


def diagram_points(d: Diagrams, k: int = 1, cap: float = 64.0):
    """Host-side ``[(birth, death)]`` of one diagram's dim-``k`` rows, with
    the ``cap`` convention: the bridge to :mod:`repro_torch.metrics.reference`.
    """
    b, dd = d.birth.cpu().numpy(), d.death.cpu().numpy()
    sel = d.valid.cpu().numpy() & (d.dim.cpu().numpy() == k)
    return cap_points(list(zip(b[sel], dd[sel])), cap)


# (B, M, N, valid slots of batch item 0) for the Sinkhorn kernel checks:
# N past one 128-column tile and not a multiple of it, M = 1, a batch item
# with 0 or 1 valid slots, the n64 clouds (at the n64 batch) and the n320
# full tensor's clouds
SINKHORN_CASES = ((3, 37, 150, 0), (2, 1, 5, 1), (4, 64, 64, 1),
                  (2, 130, 257, 7), (2048, 64, 64, 3), (2, 3200, 3200, 40),
                  (2, 3200, 3200, 0), (2, 3200, 3200, 1),
                  (2, 3200, 3200, 128), (2, 3200, 3200, 129))


def sinkhorn_operands(rng: np.random.Generator, b: int, m: int, n: int,
                      v0: int, device=None) -> dict[str, torch.Tensor]:
    """Operands of the Sinkhorn kernels, float32 on ``device``.

    ``xp`` (B, 3, M) and ``yp`` (B, 3, N): coordinate planes of random
    points, the upper half of the slots flagged diagonal.  Potentials ``f``
    (B, M) and ``g`` (B, N) are nonpositive, so every pair is dual feasible
    (f_i + g_j <= 0 <= c_ij) and a plan entry stays at most 1 for any eps;
    potentials of either sign overflow ``exp`` at small eps, and inf * 0 on
    a diagonal pair is NaN in any implementation.  Log weights ``log_a``
    (B, M) and ``log_b`` (B, N): ``-log(count)`` on valid slots and ``-inf``
    on random holes (batch item 0 has ``v0`` valid slots on each side: 0 =
    all masked).  Per-item ``e_t`` (B, 1).
    """
    def planes(k):
        xb = rng.uniform(0, 8, (b, k)).astype(np.float32)
        xd = xb + rng.uniform(0.2, 6, (b, k)).astype(np.float32)
        flag = np.broadcast_to(np.arange(k) >= k // 2, (b, k))
        return np.stack([xb, xd, flag.astype(np.float32)], axis=1)

    def log_weights(k):
        v = rng.random((b, k)) < 0.6
        v[0] = np.arange(k) < v0
        cnt = np.maximum(v.sum(-1, keepdims=True), 1).astype(np.float32)
        return np.where(v, -np.log(cnt), -np.inf)

    arrays = dict(xp=planes(m), yp=planes(n),
                  f=-np.abs(rng.normal(0, 0.2, (b, m))),
                  g=-np.abs(rng.normal(0, 0.2, (b, n))), log_a=log_weights(m),
                  log_b=log_weights(n), e_t=rng.uniform(0.005, 1.0, (b, 1)))
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.asarray(v, np.float32)).to(dev)
            for k, v in arrays.items()}


# (kind, B, M, operand options, solver options) of the auction kernel
# checks.  "expanded" cases go to auction_lap, "collapsed" and "warm" ones
# to auction_lap_collapsed.  M = 1, 2, around one warp and 128; one shape
# past shared memory for each kernel; all-zero costs (every option ties);
# all-invalid masks (0 rounds); a warm start; rev_every 0, 2 and 8; the
# f32 stall regression of repro's tests (eps0 1e-12, factor 1, one scale,
# costs of order 1e6); max_rounds 1 (no scale converges); B = 1 and 4096.
AUCTION_CASES = (
    ("expanded", 4, 1, {}, {}),
    ("expanded", 4, 2, {}, {}),
    ("expanded", 3, 31, {}, {}),
    ("expanded", 3, 33, {}, {}),
    ("expanded", 2, 128, {}, {}),
    ("expanded", 2, 256, {}, {}),
    ("expanded", 3, 16, {"zero": True}, {}),
    ("expanded", 4, 24, {}, {"max_rounds": 1}),
    ("expanded", 1, 32, {}, {}),
    ("expanded", 4096, 8, {}, {}),
    ("collapsed", 4, 1, {}, {}),
    ("collapsed", 4, 2, {}, {}),
    ("collapsed", 3, 31, {}, {}),
    ("collapsed", 3, 33, {}, {}),
    ("collapsed", 2, 128, {}, {}),
    ("collapsed", 2, 300, {}, {}),
    ("collapsed", 3, 16, {"zero": True}, {}),
    ("collapsed", 3, 16, {"invalid": True}, {}),
    ("warm", 6, 16, {}, {}),
    ("collapsed", 8, 16, {}, {"rev_every": 0}),
    ("collapsed", 8, 16, {}, {"rev_every": 2}),
    ("collapsed", 8, 16, {}, {"rev_every": 8}),
    ("collapsed", 4, 8, {"scale": 1e6},
     {"eps0": 1e-12, "eps_factor": 1.0, "n_scales": 1}),
    ("collapsed", 4, 16, {}, {"max_rounds": 1}),
    ("collapsed", 1, 16, {}, {}),
    ("collapsed", 4096, 16, {}, {}),
    # the collapsed kernel's layouts: a warp per problem, four to a CTA, at
    # K <= 32 (batches off the multiples of 4; neighbours that stop at very
    # different rounds: empty problems beside full ones, warm lanes beside
    # cold ones, a round cap of 1), a CTA per problem above; ±0 ties
    ("collapsed", 6, 16, {}, {}),
    ("collapsed", 7, 32, {}, {}),
    ("collapsed", 6, 16, {"mixed": True}, {}),
    ("collapsed", 5, 32, {"mixed": True}, {}),
    ("warm", 5, 32, {}, {}),
    ("collapsed", 6, 16, {}, {"max_rounds": 1}),
    ("collapsed", 3, 64, {}, {}),
    ("collapsed", 3, 65, {}, {}),
    ("collapsed", 4, 8, {"signed_zero": True}, {}),
    ("collapsed", 4, 16, {"signed_zero": True}, {}),
    ("collapsed", 3, 64, {"signed_zero": True}, {}),
    ("collapsed", 3, 64, {"mixed": True}, {"rev_every": 2}),
    # the expanded kernel's layouts: a warp per problem, four to a CTA, at
    # M <= 32 (batches off the multiples of 4; all-zero problems beside
    # random ones, a round cap of 1), a CTA per problem above (512 threads
    # at B <= 264 on 132 SMs, 256 at B = 300), around the shared-memory
    # budget (229-231, the last shared M of 235 and the first global one,
    # 236); ±0 ties
    ("expanded", 5, 16, {}, {}),
    ("expanded", 6, 16, {}, {}),
    ("expanded", 7, 16, {}, {}),
    ("expanded", 5, 32, {}, {}),
    ("expanded", 6, 32, {}, {}),
    ("expanded", 7, 32, {}, {}),
    ("expanded", 6, 16, {"mixed": True}, {}),
    ("expanded", 5, 32, {"mixed": True}, {}),
    ("expanded", 6, 16, {}, {"max_rounds": 1}),
    ("expanded", 3, 64, {}, {}),
    ("expanded", 3, 65, {}, {}),
    ("expanded", 300, 40, {}, {}),
    ("expanded", 3, 64, {"mixed": True}, {}),
    ("expanded", 1, 229, {}, {}),
    ("expanded", 1, 230, {}, {}),
    ("expanded", 1, 231, {}, {}),
    ("expanded", 1, 235, {}, {}),
    ("expanded", 1, 236, {}, {}),
    ("expanded", 4, 8, {"signed_zero": True}, {}),
    ("expanded", 4, 16, {"signed_zero": True}, {}),
    ("expanded", 3, 64, {"signed_zero": True}, {}),
)


def auction_operands(rng: np.random.Generator, b: int, m: int, kind: str,
                     device=None, zero: bool = False, invalid: bool = False,
                     scale: float = 1.0, mixed: bool = False,
                     signed_zero: bool = False) -> dict[str, torch.Tensor]:
    """Operands of the auction kernels, on ``device``.

    ``kind="expanded"``: ``cost`` (B, M, M) float32 uniform in [0, 5).
    ``"collapsed"``: reduced costs ``cbar`` (B, M, M) uniform in [-3, 3),
    valid-slot masks ``keep1``/``keep2`` (B, M) with 70% of the slots set
    (all of them in batch item 0), and a zero ``price0``.  ``"warm"``: the
    same with a nonnegative ``price0`` on random valid slots of the odd
    batch items.  ``zero`` zeroes the costs, ``invalid`` clears every mask,
    ``scale`` multiplies the costs, ``mixed`` clears the masks of the odd
    batch items (problems that end at once beside full ones; expanded:
    zeroes their costs, problems of ties everywhere that stop at other
    rounds than their random neighbours) and
    ``signed_zero`` draws every cost from {-0, +0, ±1, 2} (ties, ±0 among
    them, in every row and column).
    """
    if kind not in ("expanded", "collapsed", "warm"):
        raise ValueError(f"unknown auction operand kind {kind!r}")
    if kind == "expanded":
        arrays = dict(cost=rng.uniform(0, 5, (b, m, m)))
        if mixed:
            arrays["cost"][1::2] = 0.0
    else:
        keep1 = rng.random((b, m)) < 0.7
        keep2 = rng.random((b, m)) < 0.7
        keep1[0] = keep2[0] = True
        if invalid:
            keep1[:] = keep2[:] = False
        if mixed:
            keep1[1::2] = keep2[1::2] = False
        price0 = np.zeros((b, m))
        if kind == "warm":
            hot = keep2 & (rng.random((b, m)) < 0.5)
            hot[0::2] = False
            price0 = np.where(hot, rng.uniform(0, 2, (b, m)), 0.0)
        arrays = dict(cost=rng.uniform(-3, 3, (b, m, m)), keep1=keep1,
                      keep2=keep2, price0=price0)
    arrays["cost"] = arrays["cost"] * (0.0 if zero else scale)
    if signed_zero:
        arrays["cost"] = rng.choice(np.array([-0.0, 0.0, 1.0, -1.0, 2.0]),
                                    arrays["cost"].shape)
    if kind != "expanded":
        arrays["cbar"] = arrays.pop("cost")
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.asarray(
        v, bool if v.dtype == bool else np.float32)).to(dev)
        for k, v in arrays.items()}


def auction_case(case, device=None):
    """Operands and full solver options of one ``AUCTION_CASES`` entry,
    seeded from its shape: ``(operands, options)``, the options with
    ``eps0``, ``eps_factor``, ``n_scales``, ``max_rounds`` (and
    ``rev_every`` for the collapsed kinds) all set."""
    from repro_torch.kernels import auction_lap as al

    kind, b, m, opts, solver = case
    seed = (b * 7919 + m * 31 + len(opts) + 3 * len(solver)) % (2 ** 32)
    t = auction_operands(np.random.default_rng(seed), b, m, kind, device,
                         **opts)
    full = dict(eps0=al.DEFAULT_EPS0, eps_factor=al.DEFAULT_EPS_FACTOR,
                n_scales=al.DEFAULT_N_SCALES,
                max_rounds=al.default_max_rounds(m))
    if kind != "expanded":
        full["rev_every"] = al.DEFAULT_REV_EVERY
    full.update(solver)
    return t, full


def solve_auction_case(case, device=None, kernel: bool = False):
    """One ``AUCTION_CASES`` entry through the CUDA launcher (``kernel``,
    on a CUDA ``device``) or the plain solver: the solver's outputs."""
    from repro_torch.kernels import auction_lap as al

    t, o = auction_case(case, device)
    if kernel:
        ladder = al.eps_ladder(o["eps0"], o["eps_factor"], o["n_scales"],
                               t["cbar" if "cbar" in t else "cost"].device)
        if case[0] == "expanded":
            return al.auction_lap_cuda(t["cost"], ladder, o["max_rounds"])
        return al.auction_lap_collapsed_cuda(
            t["cbar"], t["keep1"], t["keep2"], t["price0"], ladder,
            o["max_rounds"], o["rev_every"])
    if case[0] == "expanded":
        return al.auction_solve(t["cost"], **o)
    return al.auction_solve_collapsed(t["cbar"], t["keep1"], t["keep2"],
                                      t["price0"], **o)


# totals are f32 sums of the same M terms in two orders; each order errs by
# at most (M - 1) * 2^-24 * sum |term|
AUCTION_TOTAL_TOLERANCE = "M * 2^-23 * sum_i |cost[i, assign[i]]| + 1e-30"


def auction_agreement(got, want, cost) -> tuple[int, float, bool]:
    """Compare two auction solvers' outputs on the same (B, M, M) costs.

    Every output but the totals must be equal (``torch.equal``); returns
    ``(number of outputs that differ, largest |total difference|, whether
    every total is within AUCTION_TOTAL_TOLERANCE)``, the totals compared
    on the host.
    """
    differ = sum(not torch.equal(g.cpu(), w.cpu())
                 for i, (g, w) in enumerate(zip(got, want)) if i != 1)
    assign = want[0].cpu().long()
    m = cost.shape[-1]
    picked = cost.cpu().gather(-1, assign.clamp(min=0)[..., None])[..., 0]
    mag = torch.where(assign >= 0, picked.abs(), 0.0).sum(-1)
    err = (got[1].cpu() - want[1].cpu()).abs()
    ok = bool((err <= m * 2.0 ** -23 * mag + 1e-30).all())
    return differ, float(err.max()) if err.numel() else 0.0, ok


# (Q, N, code bytes, mask) for the Hamming kernel checks: W = 1..5 words
# (byte counts short of a whole word are zero-padded), N = 1, Q and N off
# the multiples of 8 and 128, all-ones masks and multi-probe masks; the last
# is the index's 256 queries of 128 bits against 4096 rows
HAMMING_CASES = ((1, 1, 4, "ones"), (3, 1, 7, "probe"), (7, 129, 12, "probe"),
                 (13, 300, 16, "ones"), (9, 257, 20, "probe"),
                 (20, 1000, 10, "probe"), (256, 4096, 16, "probe"))


def hamming_operands(rng: np.random.Generator, q: int, n: int, nbytes: int,
                     mask: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """uint8 packed codes ``(Q, nbytes)`` and ``(N, nbytes)`` and the query
    mask ``(Q, nbytes)``: uniform random bytes (so about half the words
    have bit 31 set), the first corpus rows copies of the queries (distance
    0) or their complements; the mask all ones (``"ones"``) or, per query,
    1 to 3 random bits cleared (``"probe"``, the multi-probe masks).  The
    first query's first word has bit 31 set (the top bit of byte 3).
    """
    codes_q = rng.integers(0, 256, (q, nbytes), dtype=np.uint8)
    if nbytes >= 4:
        codes_q[0, 3] |= 0x80
    codes_db = rng.integers(0, 256, (n, nbytes), dtype=np.uint8)
    k = min(q, n)
    codes_db[:k] = codes_q[:k]
    codes_db[k:2 * k] = ~codes_q[:min(k, n - k)]
    keep = np.ones((q, nbytes * 8), bool)
    if mask == "probe":
        for i in range(q):
            t = int(rng.integers(1, 4))
            keep[i, rng.choice(nbytes * 8, t, replace=False)] = False
    return codes_q, codes_db, np.packbits(keep, axis=-1)
