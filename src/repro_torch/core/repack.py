"""Repack step of the two-phase plan (counterpart of ``repro.core.repack``).

Between the reduce phase and the persist phase: ``compact_batch`` moves each
graph's surviving vertices to the front of the padded axis,
``measure_counts`` counts vertices, edges and triangles of the reduced
graphs, and ``select_classes`` first-fits every graph into the smallest
:class:`ShapeClass` of a bounded ladder, so the GF(2) stage runs at reduced
size.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.graph import INF, GraphBatch


@dataclasses.dataclass(frozen=True, order=True)
class ShapeClass:
    """One persist-phase shape rung: padded order + simplex caps."""

    n_pad: int
    edge_cap: int
    tri_cap: int
    quad_cap: int = 0


def diagram_size(n: int, dim: int, edge_cap: int, tri_cap: int,
                 quad_cap: int = 0) -> int:
    """Rows of the Diagrams tensor a plan with these caps emits."""
    s = n + edge_cap
    if dim >= 1 and tri_cap:
        s += tri_cap
    if dim >= 2 and quad_cap:
        s += quad_cap
    return s


def compact_batch(g: GraphBatch) -> tuple[GraphBatch, torch.Tensor]:
    """Permute surviving vertices to the front of the padded axis.

    Returns ``(compacted, order)`` with ``order[b, i]`` the original index of
    compacted vertex ``i`` (live vertices first, original order kept).
    Persistence pairs are invariant under the relabelling.
    """
    order = torch.sort((~g.mask).to(torch.uint8), dim=-1,
                       stable=True).indices
    mask_c = g.mask.gather(1, order)
    f_c = torch.where(mask_c, g.f.gather(1, order), INF)
    bidx = torch.arange(g.batch, device=g.device)[:, None, None]
    adj_c = g.adj[bidx, order[:, :, None], order[:, None, :]]
    adj_c = adj_c & mask_c[:, None, :] & mask_c[:, :, None]
    return GraphBatch(adj=adj_c, mask=mask_c, f=f_c), order.to(torch.int32)


def measure_counts(g: GraphBatch, count_triangles: bool = True):
    """Per-graph (n_vertices, n_edges, n_triangles) of a (reduced) batch.

    Triangles are trace(A^3)/6: A^2 in f32 (entries <= N, exact), the rest
    summed in f64.
    """
    nv = g.n_vertices()
    ne = g.n_edges()
    if count_triangles:
        a = g.live_adj().float()
        nt = ((torch.bmm(a, a) * a).sum((-1, -2), dtype=torch.float64)
              / 6.0).to(torch.int32)
    else:
        nt = torch.zeros_like(nv)
    return nv, ne, nt


def _ceil_pow2(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length()


def default_ladder(n: int, edge_cap: int, tri_cap: int, quad_cap: int = 0,
                   min_n: int = 8) -> tuple[ShapeClass, ...]:
    """Power-of-two vertex rungs from ``min_n`` up to ``n``, caps scaled by
    the vertex fraction (rounded up to a power of two) and clamped by the
    input caps and the complete-graph counts; the top rung is the input
    shape.  Identical to ``repro.core.repack.default_ladder``.
    """
    n = int(n)
    rungs = []
    m = min_n
    while m < n:
        rungs.append(m)
        m *= 2
    classes = []
    for m in rungs:
        frac = m / n
        e = min(edge_cap, m * (m - 1) // 2,
                _ceil_pow2(max(m, int(edge_cap * frac))))
        if tri_cap:
            t = min(tri_cap, m * (m - 1) * (m - 2) // 6,
                    _ceil_pow2(max(m, int(tri_cap * frac))))
        else:
            t = 0
        classes.append(ShapeClass(n_pad=m, edge_cap=e, tri_cap=t,
                                  quad_cap=quad_cap))
    classes.append(ShapeClass(n_pad=n, edge_cap=edge_cap, tri_cap=tri_cap,
                              quad_cap=quad_cap))
    return tuple(classes)


def select_classes(ladder: tuple[ShapeClass, ...], nv, ne, nt) -> np.ndarray:
    """First-fit rung index per graph (host side); raises if none fits."""
    nv = np.asarray(nv)
    ne = np.asarray(ne)
    nt = np.asarray(nt)
    out = np.full(nv.shape, -1, np.int64)
    for i, c in enumerate(ladder):
        fit = ((out < 0) & (nv <= c.n_pad) & (ne <= c.edge_cap)
               & (nt <= c.tri_cap))
        out[fit] = i
    if (out < 0).any():
        bad = np.nonzero(out < 0)[0].tolist()
        raise ValueError(
            f"graphs {bad} fit no repack shape class (ladder top rung "
            f"{ladder[-1]}); custom ladders must cover the input shape")
    return out


def slice_to(g: GraphBatch, n_pad: int) -> GraphBatch:
    """Slice a compacted batch down to its first ``n_pad`` vertex slots."""
    return GraphBatch(adj=g.adj[:, :n_pad, :n_pad].contiguous(),
                      mask=g.mask[:, :n_pad].contiguous(),
                      f=g.f[:, :n_pad].contiguous())


@dataclasses.dataclass(frozen=True)
class RepackReport:
    """Host-side account of one two-phase execution's repack decisions."""

    ladder: tuple[ShapeClass, ...]
    class_index: np.ndarray   # (B,) rung index into ladder
    n_vertices: np.ndarray    # (B,) post-reduction counts
    n_edges: np.ndarray
    n_triangles: np.ndarray

    def shape_class(self, i: int) -> ShapeClass:
        """The persist rung graph ``i`` was repacked into."""
        return self.ladder[int(self.class_index[i])]

    def rung_histogram(self) -> dict[int, int]:
        """{rung n_pad: graph count} over the batch."""
        out: dict[int, int] = {}
        for ci in self.class_index.tolist():
            n = self.ladder[ci].n_pad
            out[n] = out.get(n, 0) + 1
        return out
