"""Strong collapse baseline (Boissonnat–Pritam), paper Remark 13 / Table 3
(counterpart of ``repro.core.strong_collapse``).

Strong collapse removes the dominated vertices of each flag complex of the
filtration separately (no f condition: inside one fixed complex any
dominated vertex may go), so it runs once per threshold where PrunIT runs
once on the graph.  It uses the same domination primitive as PrunIT's
rounds (``prunit.domination_matrix``: the ``domination`` kernel on CUDA).

``repro`` runs a ``while_loop`` per threshold under ``vmap``.  Here the
``(n_steps, B)`` subcomplexes are flattened into one batch and iterated to
their joint fixpoint: one domination launch a round for every threshold.
A lane whose mask is stable stays stable (the round is idempotent there),
so the masks are bitwise those of the per-threshold loops.
"""
from __future__ import annotations

import torch

from repro_torch.core.graph import GraphBatch
from repro_torch.core.prunit import domination_matrix


def collapse_mask(adj: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Fully strong-collapse a (B, N, N) batch (or one (N, N) graph) of
    fixed graphs: the surviving mask.  Each round is one domination call and
    one host sync."""
    if adj.dim() == 2:
        return collapse_mask(adj[None], mask[None])[0]
    n = adj.shape[-1]
    idx = torch.arange(n, device=adj.device)
    v_lt_u = idx[None, :] < idx[:, None]  # [u, v]: v < u
    m = mask
    while True:
        adj_m = adj & m[..., None, :] & m[..., :, None]
        dom = domination_matrix(adj_m, m)  # dom[u, v]: v dominates u
        removable_by = dom & (~dom.transpose(-1, -2) | v_lt_u)
        new = m & ~removable_by.any(-1)
        if not bool((new != m).any()):
            return new
        m = new


def strong_collapse_filtration_masks(
        g: GraphBatch, thresholds: torch.Tensor, n_steps: int,
        sublevel: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Collapse every sublevel (or superlevel) subcomplex G_i separately.

    Returns ``(sub_masks, collapsed_masks)``, each (n_steps, B, N) bool.
    """
    alpha = torch.as_tensor(thresholds, dtype=g.f.dtype,
                            device=g.device).reshape(-1, 1, 1)
    if alpha.shape[0] != n_steps:
        raise ValueError(f"{alpha.shape[0]} thresholds for n_steps={n_steps}")
    if sublevel:
        sub = g.mask & (g.f <= alpha)
    else:
        sub = g.mask & (g.f >= alpha)
    b, n = g.batch, g.n
    adj = (g.adj & sub[..., None, :] & sub[..., :, None]).reshape(-1, n, n)
    col = collapse_mask(adj, sub.reshape(-1, n))
    return sub, col.reshape(n_steps, b, n)
