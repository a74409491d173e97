"""Exact persistent-homology oracle (NumPy/pure Python; counterpart of
``repro.core.persistence_ref``).

Standard boundary-matrix column reduction over GF(2) on the sublevel clique
(flag) filtration of a vertex-filtered graph.  This is the ground truth used
to validate the paper's theorems (CoralTDA / PrunIT exactness) and the
port's bit-packed GF(2) path.

Conventions
-----------
* Filtering function f on vertices; a simplex enters at max f over vertices.
* Simplices ordered by (value, dim, lexicographic vertex tuple) — a valid
  filtration order (faces precede cofaces: a face has <= value and < dim).
* Diagrams are multisets of (birth, death) with death = +inf for essential
  classes; zero-persistence pairs (birth == death) are dropped, matching the
  usual convention (they are invisible in any diagram distance).
"""
from __future__ import annotations

import itertools
from collections import defaultdict

import numpy as np


def enumerate_cliques(adj: np.ndarray, mask: np.ndarray, max_size: int):
    """All cliques of size 1..max_size as sorted vertex tuples.

    Simple pivot-free Bron–Kerbosch-style expansion; fine for the small-N
    batched regime the oracle serves.
    """
    n = adj.shape[0]
    verts = [int(v) for v in range(n) if mask[v]]
    nbrs = {v: set(int(w) for w in np.nonzero(adj[v])[0] if mask[w]) for v in verts}
    out = [(v,) for v in verts]
    frontier = [(v,) for v in verts]
    for size in range(2, max_size + 1):
        nxt = []
        for c in frontier:
            last = c[-1]
            # extend with a common neighbor greater than last (canonical order)
            cand = set(w for w in nbrs[last] if w > last)
            for v in c[:-1]:
                cand &= nbrs[v]
            for w in sorted(cand):
                nxt.append(c + (w,))
        out.extend(nxt)
        frontier = nxt
        if not frontier:
            break
    return out


def sublevel_order(cliques, f, sublevel: bool = True):
    """Sort simplices into filtration order; returns (simplices, values)."""
    if sublevel:
        val = lambda c: max(float(f[v]) for v in c)
    else:
        val = lambda c: -min(float(f[v]) for v in c)
    order = sorted(cliques, key=lambda c: (val(c), len(c), c))
    values = [val(c) for c in order]
    return order, values


def reduce_boundary(simplices):
    """GF(2) column reduction.  Returns (pairs, essential) as simplex indices.

    pairs: list of (birth_idx, death_idx); essential: list of birth_idx.
    """
    index = {s: i for i, s in enumerate(simplices)}
    cols = []
    for s in simplices:
        if len(s) == 1:
            cols.append(frozenset())
            continue
        faces = [s[:j] + s[j + 1 :] for j in range(len(s))]
        cols.append(frozenset(index[fc] for fc in faces))
    cols = [set(c) for c in cols]
    pivot_of = {}
    pairs = []
    positive = set()
    for j in range(len(cols)):
        col = cols[j]
        while col:
            low = max(col)
            p = pivot_of.get(low)
            if p is None:
                pivot_of[low] = j
                pairs.append((low, j))
                break
            col ^= cols[p]
        else:
            positive.add(j)
    paired_births = {b for b, _ in pairs}
    essential = [j for j in positive if j not in paired_births]
    return pairs, essential


def persistence_diagrams(
    adj: np.ndarray,
    f: np.ndarray,
    mask: np.ndarray | None = None,
    max_dim: int = 1,
    sublevel: bool = True,
    keep_zero: bool = False,
):
    """Exact PD_0..PD_max_dim of the sublevel clique filtration.

    Returns dict: dim -> sorted list of (birth, death) (death may be inf).
    Needs cliques up to size max_dim + 2 (deaths of max_dim classes).
    """
    adj = np.asarray(adj, dtype=bool)
    n = adj.shape[0]
    if mask is None:
        mask = np.ones(n, dtype=bool)
    mask = np.asarray(mask, dtype=bool)
    f = np.asarray(f, dtype=np.float64)

    cliques = enumerate_cliques(adj, mask, max_dim + 2)
    simplices, values = sublevel_order(cliques, f, sublevel)
    pairs, essential = reduce_boundary(simplices)

    sign = 1.0 if sublevel else -1.0
    dgms = defaultdict(list)
    for b, d in pairs:
        dim = len(simplices[b]) - 1
        if dim > max_dim:
            continue
        birth, death = sign * values[b], sign * values[d]
        if keep_zero or birth != death:
            dgms[dim].append((birth, death))
    for b in essential:
        dim = len(simplices[b]) - 1
        if dim > max_dim:
            continue
        dgms[dim].append((sign * values[b], np.inf))
    return {k: sorted(v) for k, v in sorted(dgms.items())}


def diagrams_equal(d1, d2, max_dim: int | None = None, atol: float = 1e-9) -> bool:
    """Multiset equality of persistence diagrams up to max_dim."""
    dims = set(d1) | set(d2)
    if max_dim is not None:
        dims = {k for k in dims if k <= max_dim}
    for k in dims:
        a = sorted(d1.get(k, []))
        b = sorted(d2.get(k, []))
        if len(a) != len(b):
            return False
        for (b1, e1), (b2, e2) in zip(a, b):
            if abs(b1 - b2) > atol:
                return False
            if np.isinf(e1) != np.isinf(e2):
                return False
            if not np.isinf(e1) and abs(e1 - e2) > atol:
                return False
    return True


def betti_numbers(adj, f=None, mask=None, max_dim: int = 1):
    """Betti numbers of the full clique complex (count of essential classes)."""
    n = np.asarray(adj).shape[0]
    if f is None:
        f = np.zeros(n)
    dg = persistence_diagrams(adj, f, mask, max_dim=max_dim, keep_zero=False)
    return {
        k: sum(1 for (_, d) in dg.get(k, []) if np.isinf(d)) for k in range(max_dim + 1)
    }


def power_filtration_diagrams(adj, mask=None, max_dim: int = 1, keep_zero: bool = False):
    """PDs of the power filtration (paper Thm 10 setting).

    The power filtration G^1 ⊂ G^2 ⊂ … is the Vietoris–Rips filtration of the
    hop metric: a simplex enters at the max pairwise graph distance of its
    vertices (vertices enter at 0).  Only sensible for small connected graphs
    (the final complex is complete).
    """
    from repro_torch.core.filtration import graph_power_distances

    adj = np.asarray(adj, dtype=bool)
    n = adj.shape[0]
    if mask is None:
        mask = np.ones(n, dtype=bool)
    mask = np.asarray(mask, bool)
    dist = graph_power_distances(adj, mask)
    verts = [int(v) for v in range(n) if mask[v]]
    cliques = []
    for size in range(1, max_dim + 3):
        cliques.extend(itertools.combinations(verts, size))

    def val(c):
        if len(c) == 1:
            return 0.0
        return max(float(dist[u, v]) for u, v in itertools.combinations(c, 2))

    finite = [c for c in cliques if np.isfinite(val(c))]
    order = sorted(finite, key=lambda c: (val(c), len(c), c))
    values = [val(c) for c in order]
    pairs, essential = reduce_boundary(order)
    dgms = defaultdict(list)
    for b, d in pairs:
        dim = len(order[b]) - 1
        if dim > max_dim:
            continue
        if keep_zero or values[b] != values[d]:
            dgms[dim].append((values[b], values[d]))
    for b in essential:
        dim = len(order[b]) - 1
        if dim <= max_dim:
            dgms[dim].append((values[b], np.inf))
    return {k: sorted(v) for k, v in sorted(dgms.items())}


def simplex_count(adj, mask=None, max_dim: int = 2) -> int:
    """Number of simplices of dim <= max_dim in the clique complex."""
    adj = np.asarray(adj, dtype=bool)
    n = adj.shape[0]
    if mask is None:
        mask = np.ones(n, dtype=bool)
    return len(enumerate_cliques(adj, np.asarray(mask, bool), max_dim + 1))
