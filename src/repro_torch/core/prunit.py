r"""PrunIT: dominated-vertex pruning (counterpart of ``repro.core.prunit``).

Paper Theorem 7: if ``u`` is dominated by ``v`` (``N[u] ⊆ N[v]``, closed
neighborhoods) and ``f(u) >= f(v)`` (sublevel; reversed for superlevel), then
``PD_k(G, f) = PD_k(G - {u}, f)`` for all k >= 0.

``viol[u, v] = |N[u] \ N[v]|`` and ``viol == 0`` iff v dominates u; on CUDA
the ``domination`` kernel computes the whole (B, N, N) matrix.  A round
removes every u with a witness v under the batch-removal rule

    remove u  ⟺  ∃v:  elig(u→v)  ∧  ( ¬elig(v→u)  ∨  v < u )

with ``elig(u→v) = dom(u by v) ∧ f-condition``, which is exact (see the
soundness argument in ``repro/core/prunit.py``).  Rounds repeat until the
mask stops changing; each round is one host sync.
"""
from __future__ import annotations

import torch

from repro_torch import counters
from repro_torch.core.graph import INF, GraphBatch
from repro_torch.core.kcore import coral_reduce
from repro_torch.kernels import ops


def domination_matrix(adj: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(B, N, N) bool D with D[u, v] = "v dominates u" (u != v, both live)."""
    return ops.domination(adj.contiguous(), mask.contiguous())


def eligibility_matrix(adj: torch.Tensor, mask: torch.Tensor, f: torch.Tensor,
                       sublevel: bool = True,
                       equal_only: bool = False) -> torch.Tensor:
    """(B, N, N) bool E with E[u, v] = "PrunIT may remove u with witness v".

    ``equal_only`` tightens the filtration condition to ``f(u) == f(v)``,
    the orientation-free case behind the ``strong_collapse`` pass.
    """
    dom = domination_matrix(adj, mask)
    fu, fv = f[..., :, None], f[..., None, :]
    if equal_only:
        f_ok = fu == fv
    elif sublevel:
        f_ok = fu >= fv
    else:
        f_ok = fu <= fv
    return dom & f_ok


def prune_round_mask(adj: torch.Tensor, mask: torch.Tensor, f: torch.Tensor,
                     sublevel: bool = True,
                     equal_only: bool = False) -> torch.Tensor:
    """One parallel PrunIT round: the mask of vertices that survive."""
    elig = eligibility_matrix(adj, mask, f, sublevel, equal_only)
    n = adj.shape[-1]
    idx = torch.arange(n, device=adj.device)
    v_lt_u = idx[None, :] < idx[:, None]  # [u, v]: v < u
    removable_by = elig & (~elig.transpose(-1, -2) | v_lt_u)
    return mask & ~removable_by.any(-1)


def prunit_mask(adj: torch.Tensor, mask: torch.Tensor, f: torch.Tensor,
                sublevel: bool = True, max_rounds: int | None = None,
                equal_only: bool = False) -> torch.Tensor:
    """Iterate parallel prune rounds to a fixed point; the surviving mask."""
    m = mask
    rounds = 0
    while max_rounds is None or rounds < max_rounds:
        adj_m = adj & m[..., None, :] & m[..., :, None]
        new = prune_round_mask(adj_m, m, torch.where(m, f, INF), sublevel,
                               equal_only=equal_only)
        rounds += 1
        counters.LOOP_ROUNDS["prune_rounds"] += 1
        changed = bool((new != m).any())
        m = new
        if not changed:
            break
    return m


def prunit(g: GraphBatch, sublevel: bool = True,
           max_rounds: int | None = None) -> GraphBatch:
    """PrunIT-reduce every graph in the batch (exact for all PD_k)."""
    return g.with_mask(prunit_mask(g.adj, g.mask, g.f, sublevel, max_rounds))


def prunit_then_coral(g: GraphBatch, dim: int,
                      sublevel: bool = True) -> GraphBatch:
    """Combined reduction of §5.1: PD_k(G) = PD_k((G')^{k+1})."""
    return coral_reduce(prunit(g, sublevel=sublevel), dim)
