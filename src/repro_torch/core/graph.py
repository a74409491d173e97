"""Batched, padded graph representation (counterpart of ``repro.core.graph``).

A ``GraphBatch`` holds dense tensors: ``adj`` (B, N, N) bool, symmetric,
zero diagonal, zero outside ``mask``; ``mask`` (B, N) bool, True for real
vertices; ``f`` (B, N) float32 vertex filtering values, ``+inf`` on padding
so padded vertices never enter a sublevel filtration (superlevel code
negates ``f`` on live vertices only).  Functions that take a batch follow
its device; functions that build one run on CUDA unless given ``device``.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch._device import resolve_device

INF = float("inf")


@dataclasses.dataclass(frozen=True)
class GraphBatch:
    """A batch of padded undirected graphs (see the module docstring)."""

    adj: torch.Tensor
    mask: torch.Tensor
    f: torch.Tensor

    @property
    def batch(self) -> int:
        return self.adj.shape[0]

    @property
    def n(self) -> int:
        return self.adj.shape[1]

    @property
    def device(self) -> torch.device:
        return self.adj.device

    def live_adj(self) -> torch.Tensor:
        return self.adj & self.mask[:, None, :] & self.mask[:, :, None]

    def degrees(self) -> torch.Tensor:
        """(B, N) int32 degree of each live vertex (0 for padding)."""
        return self.live_adj().sum(-1, dtype=torch.int32)

    def n_vertices(self) -> torch.Tensor:
        return self.mask.sum(-1, dtype=torch.int32)

    def n_edges(self) -> torch.Tensor:
        return self.live_adj().sum((-1, -2), dtype=torch.int32) // 2

    def with_mask(self, new_mask: torch.Tensor) -> "GraphBatch":
        """Restrict the batch to ``new_mask`` (an induced-subgraph view).

        Filtering values are kept for the surviving vertices (paper
        Remark 1: f is not recomputed on the reduced graph).
        """
        new_mask = new_mask & self.mask
        adj = self.adj & new_mask[:, None, :] & new_mask[:, :, None]
        return GraphBatch(adj=adj, mask=new_mask,
                          f=torch.where(new_mask, self.f, INF))

    def index(self, idx: torch.Tensor) -> "GraphBatch":
        """The graphs ``idx`` (a 1-D index tensor on the batch's device)."""
        return GraphBatch(adj=self.adj[idx], mask=self.mask[idx],
                          f=self.f[idx])

    def to(self, device) -> "GraphBatch":
        return GraphBatch(adj=self.adj.to(device), mask=self.mask.to(device),
                          f=self.f.to(device))


def canonicalize(adj: torch.Tensor, mask: torch.Tensor,
                 f: torch.Tensor) -> GraphBatch:
    """Symmetrize, clear the diagonal, zero out padding, inf-pad f."""
    adj = adj.to(torch.bool)
    mask = mask.to(torch.bool)
    adj = adj | adj.transpose(-1, -2)
    n = adj.shape[-1]
    adj = adj & ~torch.eye(n, dtype=torch.bool, device=adj.device)
    adj = adj & mask[..., None, :] & mask[..., :, None]
    f = torch.where(mask, f.to(torch.float32), INF)
    return GraphBatch(adj=adj.contiguous(), mask=mask.contiguous(),
                      f=f.contiguous())


def from_edge_lists(
    edge_lists: Sequence[Sequence[tuple[int, int]]],
    n_vertices: Sequence[int],
    n_pad: int | None = None,
    f_values: Sequence[Sequence[float]] | None = None,
    device=None,
) -> GraphBatch:
    """Build a GraphBatch from python edge lists; f defaults to degree."""
    dev = resolve_device(device)
    b = len(edge_lists)
    n = n_pad or max(int(v) for v in n_vertices)
    adj = np.zeros((b, n, n), dtype=bool)
    mask = np.zeros((b, n), dtype=bool)
    f = np.full((b, n), np.inf, dtype=np.float32)
    for i, (edges, nv) in enumerate(zip(edge_lists, n_vertices)):
        mask[i, :nv] = True
        for (u, v) in edges:
            if u != v:
                adj[i, u, v] = adj[i, v, u] = True
        if f_values is not None:
            f[i, :nv] = np.asarray(f_values[i], dtype=np.float32)[:nv]
    if f_values is None:
        deg = adj.sum(-1).astype(np.float32)
        f = np.where(mask, deg, np.inf).astype(np.float32)
    return GraphBatch(adj=torch.from_numpy(adj).to(dev),
                      mask=torch.from_numpy(mask).to(dev),
                      f=torch.from_numpy(f).to(dev))


def from_networkx(graphs, n_pad: int | None = None, f_attr: str | None = None,
                  device=None) -> GraphBatch:
    """Build a GraphBatch from networkx graphs (vertices relabelled in
    sorted order); ``f_attr`` names a node attribute, default is degree.

    Only the graphs' ``nodes``/``edges`` views are read, so networkx itself
    is never imported here.
    """
    edge_lists, nvs, fvals = [], [], []
    for g in graphs:
        nodes = sorted(g.nodes())
        idx = {u: i for i, u in enumerate(nodes)}
        edge_lists.append([(idx[u], idx[v]) for (u, v) in g.edges()])
        nvs.append(len(nodes))
        if f_attr is not None:
            fvals.append([float(g.nodes[u][f_attr]) for u in nodes])
    return from_edge_lists(edge_lists, nvs, n_pad=n_pad,
                           f_values=fvals if f_attr else None, device=device)


def degree_filtration(g: GraphBatch) -> GraphBatch:
    """Replace f with the degree function computed on the current graph."""
    deg = g.degrees().to(torch.float32)
    return GraphBatch(adj=g.adj, mask=g.mask, f=torch.where(g.mask, deg, INF))
