"""Ego-network extraction, the paper's §6.2 OGB workload (counterpart of
``repro.data.ego``).

Given one large graph, the 1-hop ego net of every centre becomes one graph
of a padded GraphBatch, so per-vertex persistence diagrams are one batched
plan execution.  Ego ``c`` keeps its closed neighbourhood ``N[c]``, ranked
by (not a member, f, id) and compacted into the first ``n_pad`` slots; the
rank is shared by every ego up to the membership key, so it is one stable
sort of the host's (f, id) order and one stable sort a batch of centres.
"""
from __future__ import annotations

import torch

from repro_torch._device import resolve_device
from repro_torch.core.graph import INF, GraphBatch


def ego_batch(adj, f, n_pad: int, centers=None, device=None) -> GraphBatch:
    """Extract 1-hop ego nets.

    adj: (N, N) bool adjacency of the host graph.
    f:   (N,) float filtering values on the host graph (paper Remark 1: kept
         from the host graph, not recomputed per ego net).
    n_pad: per-ego padded order; an ego net larger than n_pad keeps the
         n_pad members of smallest (f, id).
    centers: (B,) vertex ids; default all vertices.
    device: where the batch is built; ``None`` means CUDA.
    """
    dev = resolve_device(device)
    adj = torch.as_tensor(adj, device=dev).to(torch.bool)
    f = torch.as_tensor(f, device=dev).to(torch.float32)
    n = adj.shape[0]
    if centers is None:
        centers = torch.arange(n, device=dev)
    else:
        centers = torch.as_tensor(centers, device=dev).long()
    member = (adj | torch.eye(n, dtype=torch.bool, device=dev))[centers]
    # lexsort by (not member, f, id): stable sorts in reverse key order;
    # ids come in ascending, so one stable sort of f gives (f, id)
    base = torch.sort(f, stable=True).indices
    not_member = (~member[:, base]).to(torch.uint8)
    order = base[torch.sort(not_member, dim=-1, stable=True).indices]
    sel = order[:, :n_pad]  # (B, n_pad) host ids
    sub_mask = member.gather(1, sel)
    sub_adj = (adj[sel[:, :, None], sel[:, None, :]]
               & sub_mask[:, :, None] & sub_mask[:, None, :])
    sub_f = torch.where(sub_mask, f[sel], INF)
    return GraphBatch(adj=sub_adj, mask=sub_mask, f=sub_f)


def ego_sizes(adj: torch.Tensor) -> torch.Tensor:
    """(N,) int32 closed-neighbourhood sizes (for picking n_pad or counting
    truncations); follows the tensor's device."""
    return 1 + adj.sum(-1, dtype=torch.int32)
