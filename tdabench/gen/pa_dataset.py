"""A graph-classification dataset of preferential-attachment graphs with
triangle closing (the Holme–Kim surrogate of ``repro_torch.data.graphs``),
matched to a dataset's published order and size.

``params``:

* ``graphs``, ``n_pad``: how many graphs, and the padded order.
* ``nv_log_mu``, ``nv_log_sigma``, ``nv_min``, ``nv_max``: the orders
  are the ``graphs`` quantiles ``(i + 1/2) / graphs`` of a lognormal,
  floored and clipped to [``nv_min``, ``nv_max``], in an order drawn from
  the seed.  So every seed has the same set of sizes.
* ``m``: each vertex draws ``m`` earlier vertices by degree + 1
  (:func:`common.ba_edges`).
* ``p_triangle``: then every pair of vertices two hops apart and not
  joined is joined with this probability (one draw a pair, hashed from the
  seed, so every device makes the same graph).

The filtering value is the vertex degree of the finished graph.
"""
from __future__ import annotations

from statistics import NormalDist

import numpy as np
import torch

from tdabench.gen.common import ba_edges, host_rng, uniform

INF = float("inf")
CHUNK = 128  # graphs closed at once: bounds the (chunk, N, N) products


def orders(params: dict, clip: bool = True) -> np.ndarray:
    """The sorted vertex counts every seed shares (``clip=False``: before
    the clip to [``nv_min``, ``nv_max``])."""
    b = int(params["graphs"])
    z = np.array([NormalDist().inv_cdf((i + 0.5) / b) for i in range(b)])
    nv = np.floor(np.exp(params["nv_log_mu"] + params["nv_log_sigma"] * z))
    if clip:
        nv = np.clip(nv, params["nv_min"], params["nv_max"])
    return nv.astype(np.int64)


def generate(params: dict, seed: int, device) -> dict:
    rng = host_rng(seed, "pa_dataset")
    n = int(params["n_pad"])
    nv = rng.permutation(orders(params))
    b = nv.shape[0]
    g, u, v = ba_edges(rng, nv, int(params["m"]), n)
    adj = torch.zeros((b, n, n), dtype=torch.bool, device=device)
    g, u, v = (torch.from_numpy(x).to(device) for x in (g, u, v))
    adj[g, u, v] = True
    adj[g, v, u] = True
    mask = (torch.arange(n, device=device)[None, :]
            < torch.from_numpy(nv).to(device)[:, None])
    idx = torch.arange(n, device=device, dtype=torch.int64)
    upper = idx[:, None] < idx[None, :]
    key = (idx[:, None] * n + idx[None, :])
    p = float(params["p_triangle"])
    for c0 in range(0, b, CHUNK):
        a = adj[c0:c0 + CHUNK]
        af = a.to(torch.float32)
        two_hop = (torch.bmm(af, af) > 0) & ~a & upper
        gid = torch.arange(c0, c0 + a.shape[0], device=device)
        draw = uniform(seed, 1, gid[:, None, None], key[None]) < p
        close = two_hop & draw
        adj[c0:c0 + CHUNK] = a | close | close.transpose(1, 2)
    deg = adj.sum(-1, dtype=torch.int32).to(torch.float32)
    return {"adj": adj, "mask": mask, "f": torch.where(mask, deg, INF)}


def fit_lognormal(graphs: int, mean: float, std: float) -> tuple:
    """``(nv_log_mu, nv_log_sigma)`` whose ``graphs`` orders, before the
    clip, have the given mean and standard deviation."""
    def unclipped(mu, sigma):
        return orders({"graphs": graphs, "nv_log_mu": mu,
                       "nv_log_sigma": sigma}, clip=False)

    def mu_for(sigma):
        lo, hi = 0.0, 12.0
        for _ in range(80):
            mid = 0.5 * (lo + hi)
            lo, hi = ((mid, hi) if unclipped(mid, sigma).mean() < mean
                      else (lo, mid))
        return 0.5 * (lo + hi)

    lo, hi = 0.01, 3.0
    for _ in range(80):
        mid = 0.5 * (lo + hi)
        lo, hi = ((mid, hi) if unclipped(mu_for(mid), mid).std() < std
                  else (lo, mid))
    sigma = 0.5 * (lo + hi)
    return mu_for(sigma), sigma
