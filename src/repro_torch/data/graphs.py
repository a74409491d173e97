"""Synthetic graph generators, numpy-seeded (subset of
``repro.data.graphs``).

``repro``'s generators draw with ``jax.random``, so the same seed gives other
graphs here; tests that compare the packages make each graph once with numpy
and hand it to both.  Graphs are drawn on the host and moved to ``device``
(CUDA unless ``device="cpu"``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.graph import INF, GraphBatch, canonicalize


def erdos_renyi(seed, batch: int, n_pad: int, n_vertices, p,
                device=None) -> GraphBatch:
    """G(n, p); ``n_vertices``/``p`` may be scalars or (batch,) arrays.

    ``seed`` is anything ``np.random.default_rng`` takes (an int or a
    Generator)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    nv = np.broadcast_to(np.asarray(n_vertices), (batch,))
    p = np.broadcast_to(np.asarray(p, np.float32), (batch,))
    u = rng.random((batch, n_pad, n_pad), dtype=np.float32)
    adj = np.triu(u < p[:, None, None], 1)
    mask = np.arange(n_pad)[None, :] < nv[:, None]
    return canonicalize(torch.from_numpy(adj).to(dev),
                        torch.from_numpy(mask).to(dev),
                        torch.zeros((batch, n_pad), device=dev))


def attach_satellites(seed, g: GraphBatch, frac: float) -> GraphBatch:
    """Rewire the last ``frac`` of live vertices into degree-1 satellites.

    Each satellite loses its edges and attaches to one core vertex drawn
    with probability proportional to 1 + degree (the JAX version's
    ``categorical(log1p(deg))``); a satellite is then dominated by its hub.
    """
    if frac <= 0:
        return g
    rng = np.random.default_rng(seed)
    adj = g.adj.cpu().numpy()
    mask = g.mask.cpu().numpy()
    b, n = mask.shape
    nv = mask.sum(-1)
    n_sat = (nv.astype(np.float32) * frac).astype(np.int64)
    idx = np.arange(n)[None, :]
    is_sat = (idx >= (nv - n_sat)[:, None]) & mask
    core = mask & ~is_sat
    adj = adj & core[:, None, :] & core[:, :, None]
    w = np.where(core, 1.0 + adj.sum(-1), 0.0)
    cdf = np.cumsum(w, axis=-1)
    total = cdf[:, -1:]
    u = rng.random((b, n)) * total
    tgt = np.minimum((cdf[:, None, :] <= u[:, :, None]).sum(-1), n - 1)
    rows, cols = np.nonzero(is_sat & (total > 0))
    adj[rows, cols, tgt[rows, cols]] = True
    return canonicalize(torch.from_numpy(adj).to(g.device), g.mask, g.f)


def with_degree_filtration(g: GraphBatch) -> GraphBatch:
    """The paper's default filtering function: degree on the given graph."""
    deg = g.degrees().to(torch.float32)
    return GraphBatch(adj=g.adj, mask=g.mask, f=torch.where(g.mask, deg, INF))
