"""Host-side exact diagram-distance oracles (NumPy / pure Python).

The port's own copy of ``repro.metrics.reference``, so that the port and
its chip check need nothing of ``repro``.  Parity targets for
``repro_torch.metrics`` — small diagrams only (the assignment solvers are
O(n³)).  Diagrams are plain point lists ``[(birth, death), ...]`` with
``death`` possibly ``inf``; ``cap_points`` applies the same essential-class
capping convention the batched code uses (``Diagrams.finite_points``), and
``repro_torch.metrics.testing.diagram_points`` is the bridge from the
fixed-size tensor layout.

* ``sw_dense`` — the sliced-Wasserstein distance on the identical direction
  grid as ``distances.sliced_wasserstein`` (midpoint quadrature over the
  half-circle, diagonal augmentation by the other diagram's projections),
  computed in float64 on dense point lists.  Rtol-1e-5 oracle.
* ``wasserstein_exact`` — exact q-Wasserstein with Euclidean ground metric
  via min-cost perfect matching on the standard diagonal-augmented
  (n1+n2)² cost matrix (each side padded with diagonal reservoir slots,
  reservoir↔reservoir free).  Uses ``scipy.optimize.linear_sum_assignment``
  when available, else the built-in Hungarian solver (they are
  cross-checked in tests).
* ``bottleneck_exact`` — exact bottleneck distance (L∞ ground metric):
  binary search over the candidate cost set with an augmenting-path
  bipartite feasibility matching.
"""
from __future__ import annotations

import numpy as np


def cap_points(pts, cap: float) -> list[tuple[float, float]]:
    """Apply the essential-class convention: death = min(death, cap)."""
    return [(float(b), float(min(d, cap))) for (b, d) in pts]


# ---------------------------------------------------------------------------
# dense sliced-Wasserstein (same quadrature as the batched implementation)
# ---------------------------------------------------------------------------

def sw_dense(pts1, pts2, n_dirs: int = 32) -> float:
    """Sliced-Wasserstein on the fixed direction grid, dense float64."""
    p1 = np.asarray(pts1, np.float64).reshape(-1, 2)
    p2 = np.asarray(pts2, np.float64).reshape(-1, 2)
    phi = -np.pi / 2 + np.pi * (np.arange(n_dirs) + 0.5) / n_dirs
    theta = np.stack([np.cos(phi), np.sin(phi)], axis=-1)  # (M, 2)
    diag = lambda p: np.repeat((p[:, :1] + p[:, 1:]) / 2.0, 2, axis=1)
    total = 0.0
    for t in theta:
        v1 = np.sort(np.concatenate([p1 @ t, diag(p2) @ t]))
        v2 = np.sort(np.concatenate([p2 @ t, diag(p1) @ t]))
        total += float(np.abs(v1 - v2).sum())
    return total / n_dirs


# ---------------------------------------------------------------------------
# exact q-Wasserstein (min-cost perfect matching, Euclidean ground metric)
# ---------------------------------------------------------------------------

def _assignment_cost(cost: np.ndarray) -> float:
    try:
        from scipy.optimize import linear_sum_assignment

        r, c = linear_sum_assignment(cost)
        return float(cost[r, c].sum())
    except ImportError:  # pragma: no cover - exercised via hungarian_cost
        return hungarian_cost(cost)


def hungarian_cost(cost: np.ndarray) -> float:
    """Min-cost perfect matching total, dependency-free (O(n³))."""
    n = cost.shape[0]
    if n == 0:
        return 0.0
    inf = float("inf")
    u = [0.0] * (n + 1)
    v = [0.0] * (n + 1)
    p = [0] * (n + 1)
    way = [0] * (n + 1)
    for i in range(1, n + 1):
        p[0] = i
        j0 = 0
        minv = [inf] * (n + 1)
        used = [False] * (n + 1)
        while True:
            used[j0] = True
            i0, delta, j1 = p[j0], inf, 0
            for j in range(1, n + 1):
                if not used[j]:
                    cur = cost[i0 - 1][j - 1] - u[i0] - v[j]
                    if cur < minv[j]:
                        minv[j] = cur
                        way[j] = j0
                    if minv[j] < delta:
                        delta, j1 = minv[j], j
            for j in range(n + 1):
                if used[j]:
                    u[p[j]] += delta
                    v[j] -= delta
                else:
                    minv[j] -= delta
            j0 = j1
            if p[j0] == 0:
                break
        while j0:
            j1 = way[j0]
            p[j0] = p[j1]
            j0 = j1
    return float(sum(cost[p[j] - 1][j - 1] for j in range(1, n + 1)))


def _augmented_cost(pts1, pts2, q: float, ground: str) -> np.ndarray:
    """(n1+n2)² diagonal-augmented cost matrix, entries already **^q.

    Rows: points of D1 then n2 diagonal reservoir slots; columns: points of
    D2 then n1 reservoir slots.  Point↔reservoir costs the point's distance
    to the diagonal; reservoir↔reservoir is free.
    """
    p1 = np.asarray(pts1, np.float64).reshape(-1, 2)
    p2 = np.asarray(pts2, np.float64).reshape(-1, 2)
    n1, n2 = len(p1), len(p2)
    m = n1 + n2
    c = np.zeros((m, m))
    if ground == "l2":
        dist = lambda a, b: np.hypot(a[0] - b[0], a[1] - b[1])
        diag = lambda a: (a[1] - a[0]) / np.sqrt(2.0)
    elif ground == "linf":
        dist = lambda a, b: max(abs(a[0] - b[0]), abs(a[1] - b[1]))
        diag = lambda a: (a[1] - a[0]) / 2.0
    else:
        raise ValueError(f"unknown ground metric {ground!r}")
    for i in range(n1):
        for j in range(n2):
            c[i, j] = dist(p1[i], p2[j]) ** q
        c[i, n2:] = diag(p1[i]) ** q
    for j in range(n2):
        c[n1:, j] = diag(p2[j]) ** q
    return c


def wasserstein_exact(pts1, pts2, q: float = 2.0, ground: str = "l2") -> float:
    """Exact q-Wasserstein diagram distance, ``(min matching Σ cost^q)^(1/q)``."""
    if len(pts1) == 0 and len(pts2) == 0:
        return 0.0
    total = _assignment_cost(_augmented_cost(pts1, pts2, q, ground))
    return float(max(total, 0.0) ** (1.0 / q))


# ---------------------------------------------------------------------------
# exact bottleneck (binary search + bipartite feasibility matching)
# ---------------------------------------------------------------------------

def _feasible(c: np.ndarray, t: float) -> bool:
    """Perfect matching using only edges of cost <= t (augmenting paths)."""
    m = c.shape[0]
    adj = c <= t + 1e-12
    match = np.full(m, -1, dtype=np.int64)

    def augment(i, seen):
        for j in range(m):
            if adj[i, j] and not seen[j]:
                seen[j] = True
                if match[j] < 0 or augment(match[j], seen):
                    match[j] = i
                    return True
        return False

    for i in range(m):
        if not augment(i, np.zeros(m, dtype=bool)):
            return False
    return True


def bottleneck_exact(pts1, pts2) -> float:
    """Exact bottleneck distance (L∞ ground metric, diagonal matching)."""
    if len(pts1) == 0 and len(pts2) == 0:
        return 0.0
    c = _augmented_cost(pts1, pts2, q=1.0, ground="linf")
    cand = np.unique(c)
    lo, hi = 0, len(cand) - 1
    while lo < hi:
        mid = (lo + hi) // 2
        if _feasible(c, float(cand[mid])):
            hi = mid
        else:
            lo = mid + 1
    return float(cand[lo])
