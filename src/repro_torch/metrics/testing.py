"""Synthetic Diagrams generators for tests and checks (the port of
``repro.metrics.testing``), and seeded operands for the Sinkhorn kernels.

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
                  (2, 130, 257, 7), (2048, 64, 64, 3), (2, 3200, 3200, 40))


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
