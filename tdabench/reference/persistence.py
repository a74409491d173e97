"""The plain reference: the persistence diagrams of one graph's clique
filtration, from the unreduced graph, in NumPy and Python.

It imports nothing of the program.  The filtration is the lower-star one of
a vertex function ``f``: a simplex enters at the largest ``f`` of its
vertices (``sublevel``), or, for a superlevel filtration, at the smallest,
with the order reversed.  PD_0 comes from the elder rule (union-find over
the edges in filtration order), PD_1 from the column reduction over GF(2)
of the triangles' boundaries, each column a Python integer whose bits are
its edges.  A diagram is the sorted list of its (birth, death) pairs,
death ``inf`` for an essential class; pairs of zero persistence are left
out.  Such a diagram does not depend on how ties in ``f`` are ordered, so
any order that puts faces first serves.
"""
from __future__ import annotations

import numpy as np

INF = float("inf")


def clique_filtration(adj: np.ndarray, mask: np.ndarray, f: np.ndarray,
                      sublevel: bool):
    """Vertices, edges and triangles of the live subgraph, each dimension
    sorted by entry value: ``(vertex values, edges, edge values,
    triangles, triangle values)`` with the values in the filtration's own
    direction (``-f`` for a superlevel filtration)."""
    live = np.flatnonzero(mask)
    a = np.asarray(adj, bool)[np.ix_(live, live)]
    fv = np.asarray(f, np.float64)[live]
    fv = fv if sublevel else -fv
    iu, iv = np.nonzero(np.triu(a, 1))
    e_val = np.maximum(fv[iu], fv[iv])
    eo = np.lexsort((iv, iu, e_val))
    iu, iv, e_val = iu[eo], iv[eo], e_val[eo]
    tris = []
    nbr = [set(np.flatnonzero(a[i]).tolist()) for i in range(a.shape[0])]
    for i, j in zip(iu.tolist(), iv.tolist()):
        for k in nbr[i] & nbr[j]:
            if k > j:
                tris.append((i, j, k))
    t = np.array(tris, np.int64).reshape(-1, 3)
    t_val = fv[t].max(axis=1) if len(t) else np.zeros(0)
    to = np.lexsort((t[:, 2], t[:, 1], t[:, 0], t_val))
    return fv, (iu, iv), e_val, t[to], t_val[to]


def diagrams(adj: np.ndarray, mask: np.ndarray, f: np.ndarray,
             sublevel: bool = True) -> dict[int, list]:
    """``{0: PD_0, 1: PD_1}`` of the live subgraph."""
    fv, (iu, iv), e_val, tris, t_val = clique_filtration(adj, mask, f,
                                                         sublevel)
    sign = 1.0 if sublevel else -1.0
    n = fv.shape[0]
    parent = list(range(n))

    def root(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    pd0, positive = [], []
    for e, (i, j) in enumerate(zip(iu.tolist(), iv.tolist())):
        ri, rj = root(i), root(j)
        if ri == rj:
            positive.append(e)
            continue
        # the younger component (later birth) dies
        if (fv[ri], ri) < (fv[rj], rj):
            ri, rj = rj, ri
        pd0.append((fv[ri], e_val[e]))
        parent[ri] = rj
    for v in range(n):
        if root(v) == v:
            pd0.append((fv[v], INF))

    edge_id = {(i, j): e for e, (i, j) in enumerate(zip(iu.tolist(),
                                                        iv.tolist()))}
    pivot_col: dict[int, int] = {}
    pd1 = []
    for c, (i, j, k) in enumerate(tris.tolist()):
        col = (1 << edge_id[(i, j)]) | (1 << edge_id[(i, k)]) \
            | (1 << edge_id[(j, k)])
        while col:
            low = col.bit_length() - 1
            other = pivot_col.get(low)
            if other is None:
                pivot_col[low] = col
                pd1.append((e_val[low], t_val[c]))
                break
            col ^= other
    for e in positive:
        if e not in pivot_col:
            pd1.append((e_val[e], INF))

    def signed(pairs):
        out = []
        for b, d in pairs:
            if b == d:
                continue
            out.append((sign * float(b), INF if d == INF else sign * float(d)))
        return sorted(out)

    return {0: signed(pd0), 1: signed(pd1)}


def dominated_pruned(adj: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """The mask after removing dominated vertices (``N[u]`` inside
    ``N[v]``) one at a time until none is left, whatever their ``f``.

    PrunIT's Theorem 7 removes ``u`` only where ``f`` lets it (``f(u) >=
    f(v)`` in a sublevel filtration); this drops that condition, the
    shortcut a faster reduction might take.  It keeps the homotopy type of
    the whole complex but not the filtration's diagrams: the control that
    a sound comparison has to fail.
    """
    a = np.asarray(adj, bool) & mask[:, None] & mask[None, :]
    m = np.asarray(mask, bool).copy()
    closed = a | np.eye(a.shape[0], dtype=bool)
    changed = True
    while changed:
        changed = False
        for u in np.flatnonzero(m):
            nu = closed[u] & m
            for v in np.flatnonzero(nu):
                if v != u and not (nu & ~closed[v]).any():
                    m[u] = False
                    changed = True
                    break
    return m
