"""CoralTDA: k-core reduction (counterpart of ``repro.core.kcore``).

Paper Theorem 2: ``PD_j(G, f) = PD_j(G^{k+1}, f)`` for every ``j >= k >= 1``,
so ``PD_k`` only needs the (k+1)-core.  The core is the fixpoint of the
Jacobi sweep ``alive <- alive & (A @ alive >= k)`` started from the vertex
mask.  On CUDA the whole fixpoint is one launch of the ``kcore_peel``
kernel (a cluster of CTAs per graph, looping until its own mask is
stable), so it needs no host sync per sweep; on the CPU the plain sweep is iterated.
"""
from __future__ import annotations

import torch

from repro_torch.core.graph import GraphBatch
from repro_torch.kernels import ops


def kcore_mask(adj: torch.Tensor, mask: torch.Tensor, k: int) -> torch.Tensor:
    """(B, N) bool mask of the k-core of every graph in the batch."""
    return ops.kcore_peel(adj.contiguous(), mask.contiguous(), int(k),
                          sweeps=0)


def kcore(g: GraphBatch, k: int) -> GraphBatch:
    """The k-core of every graph in the batch (as a masked view)."""
    return g.with_mask(kcore_mask(g.adj, g.mask, k))


def coral_reduce(g: GraphBatch, dim: int) -> GraphBatch:
    """CoralTDA reduction for ``PD_dim``: the (dim+1)-core.

    For dim == 0 the 1-core would drop isolated vertices, which carry PD_0
    classes, so the graph is returned unchanged.
    """
    if dim < 1:
        return g
    return kcore(g, dim + 1)


def coreness(adj: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(B, N) int32 core number of every vertex (0 for padding).

    Runs the k-core fixpoint for k = 1..N; analysis helper, not on the
    main path.
    """
    core = torch.zeros(mask.shape, dtype=torch.int32, device=mask.device)
    for k in range(1, adj.shape[-1] + 1):
        core = torch.where(kcore_mask(adj, mask, k), k, core)
    return core


def degeneracy(adj: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(B,) int32 degeneracy (max k with a non-empty k-core) of each graph."""
    return coreness(adj, mask).amax(-1)
