"""The 1-hop ego nets of one host graph, every vertex a centre (the paper's
§6.2 per-vertex diagrams).

The host is a Holme–Kim graph: vertex ``t`` makes ``m`` edges; the first
goes to an earlier vertex drawn by degree + 1, and each further one, with
probability ``p_triad``, to a neighbour of the vertex the last one reached
(closing a triangle), else again by degree + 1.  ``params``:
``host_vertices``, ``m``, ``p_triad`` and ``n_pad``, the padded order of an
ego net.  The filtering value of a vertex is its degree in the host, kept
in every ego net (the paper's Remark 1).  Ego ``c`` keeps its closed
neighbourhood ranked by (f, id); one larger than ``n_pad`` keeps the
``n_pad`` members of smallest (f, id), as ``repro_torch.data.ego`` does.
The host is drawn on the host CPU from the seed; the ego nets are cut from
it on ``device``.
"""
from __future__ import annotations

import numpy as np
import torch

from tdabench.gen.common import host_rng

INF = float("inf")


def host_edges(rng: np.random.Generator, n: int, m: int,
               p_triad: float) -> np.ndarray:
    """(E, 2) int64 edges ``(t, earlier vertex)`` of the host."""
    draw, triad, pick = (rng.random((n, m)) for _ in range(3))
    nbrs: list[list[int]] = [[] for _ in range(n)]
    ends: list[int] = []
    edges = []
    for t in range(1, n):
        made: list[int] = []
        last = None
        for j in range(m):
            v = None
            if last is not None and triad[t, j] < p_triad:
                free = [w for w in nbrs[last] if w not in made]
                if free:
                    v = free[int(pick[t, j] * len(free))]
            if v is None:
                total = t + len(ends)
                r = min(int(draw[t, j] * total), total - 1)
                v = r if r < t else ends[r - t]
                if v in made:
                    continue
            made.append(v)
            last = v
        for v in made:
            nbrs[v].append(t)
            nbrs[t].append(v)
            ends += (t, v)
            edges.append((t, v))
    return np.array(edges, np.int64).reshape(-1, 2)


def ego_nets(adj: torch.Tensor, f: torch.Tensor, n_pad: int) -> dict:
    """Every vertex's ego net: ``adj`` (N, n_pad, n_pad), ``mask`` and
    ``f`` (N, n_pad), +inf on padding."""
    n = adj.shape[0]
    dev = adj.device
    ids = torch.arange(n, device=dev)
    # rank by (not a member, f, id): ids ascend, so one stable sort of f
    # gives the (f, id) order and one stable sort a row puts members first
    base = torch.sort(f, stable=True).indices
    outside = ~(adj[:, base] | (base[None, :] == ids[:, None]))
    sel = base[torch.sort(outside.to(torch.uint8), dim=-1,
                          stable=True).indices[:, :n_pad]]
    del outside
    live = adj[ids[:, None], sel] | (sel == ids[:, None])
    sub = (adj[sel[:, :, None], sel[:, None, :]] & live[:, :, None]
           & live[:, None, :])
    return {"adj": sub, "mask": live, "f": torch.where(live, f[sel], INF)}


def generate(params: dict, seed: int, device) -> dict:
    n = int(params["host_vertices"])
    e = torch.from_numpy(host_edges(host_rng(seed, "ego_nets.host"), n,
                                    int(params["m"]),
                                    float(params["p_triad"]))).to(device)
    adj = torch.zeros((n, n), dtype=torch.bool, device=device)
    adj[e[:, 0], e[:, 1]] = True
    adj[e[:, 1], e[:, 0]] = True
    f = adj.sum(-1, dtype=torch.int32).to(torch.float32)
    return ego_nets(adj, f, int(params["n_pad"]))
