"""Synthetic graph dataset generators, numpy-seeded (counterpart of
``repro.data.graphs``).

Each dataset of the paper is replaced by a surrogate generator matched on
its published statistics (graph count, average order and size, degree
structure), as in ``repro``.  ``repro``'s generators draw with
``jax.random``, so the same seed gives other graphs here; tests that compare
the packages make each graph once with numpy and hand it to both.  Graphs
are drawn on the host and moved to ``device`` (CUDA unless
``device="cpu"``).  ``seed`` is anything ``np.random.default_rng`` takes (an
int, a sequence of ints or a Generator).
"""
from __future__ import annotations

import dataclasses
import zlib

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.graph import INF, GraphBatch, canonicalize


def _batch(adj: np.ndarray, mask: np.ndarray, device) -> GraphBatch:
    """Canonical GraphBatch (f = 0 on live vertices) from numpy arrays."""
    dev = torch.device(device)
    return canonicalize(torch.from_numpy(np.ascontiguousarray(adj)).to(dev),
                        torch.from_numpy(np.ascontiguousarray(mask)).to(dev),
                        torch.zeros(mask.shape, device=dev))


def _prefix_mask(batch: int, n_pad: int, n_vertices) -> np.ndarray:
    nv = np.broadcast_to(np.asarray(n_vertices), (batch,))
    return np.arange(n_pad)[None, :] < nv[:, None]


def _draw(rng, weights: np.ndarray, count: int) -> np.ndarray:
    """(B, count) indices drawn with probability proportional to the
    (B, N) nonnegative ``weights`` (with replacement); rows whose weights
    sum to 0 draw index N - 1 (callers mask those rows out)."""
    cdf = np.cumsum(weights, axis=-1)
    u = rng.random((weights.shape[0], count)) * cdf[:, -1:]
    return np.minimum((cdf[:, None, :] <= u[:, :, None]).sum(-1),
                      weights.shape[1] - 1)


# ---------------------------------------------------------------------------
# primitive random-graph models (batched, padded)
# ---------------------------------------------------------------------------

def _er_adj(rng, batch, n_pad, n_vertices, p) -> np.ndarray:
    p = np.broadcast_to(np.asarray(p, np.float32), (batch,))
    u = rng.random((batch, n_pad, n_pad), dtype=np.float32)
    return np.triu(u < p[:, None, None], 1)


def erdos_renyi(seed, batch: int, n_pad: int, n_vertices, p,
                device=None) -> GraphBatch:
    """G(n, p); ``n_vertices``/``p`` may be scalars or (batch,) arrays."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    return _batch(_er_adj(rng, batch, n_pad, n_vertices, p),
                  _prefix_mask(batch, n_pad, n_vertices), dev)


def _ba_adj(rng, batch, n_pad, m) -> np.ndarray:
    adj = np.zeros((batch, n_pad, n_pad), bool)
    deg = np.zeros((batch, n_pad), np.float64)
    idx = np.arange(n_pad)
    rows = np.arange(batch)[:, None]
    for t in range(1, n_pad):
        # m targets among the vertices < t, drawn proportional to degree + 1
        tgt = _draw(rng, (deg + 1.0) * (idx < t), m)
        hot = np.zeros((batch, n_pad), bool)
        hot[rows, tgt] = True
        adj[:, t, :] |= hot
        adj[:, :, t] |= hot
        deg += hot
        deg[:, t] += hot.sum(-1)
    return adj


def barabasi_albert(seed, batch: int, n_pad: int, n_vertices, m: int,
                    device=None) -> GraphBatch:
    """Preferential attachment: vertex t attaches to ``m`` earlier vertices
    drawn by degree + 1 (with replacement, duplicates merge); masked out
    above ``n_vertices``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    return _batch(_ba_adj(rng, batch, n_pad, m),
                  _prefix_mask(batch, n_pad, n_vertices), dev)


def watts_strogatz(seed, batch: int, n_pad: int, n_vertices, k_ring: int,
                   p_rewire: float, device=None) -> GraphBatch:
    """Ring lattice + random rewiring (approximated as ring + ER overlay)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    nv = np.broadcast_to(np.asarray(n_vertices), (batch,))
    idx = np.arange(n_pad)
    # ring distances modulo the live vertex count of each graph
    nvc = np.maximum(nv, 1)[:, None, None]
    d = np.abs(idx[None, :, None] - idx[None, None, :])
    d = np.minimum(d, nvc - d)
    ring = (d >= 1) & (d <= k_ring // 2)
    drop = rng.random((batch, n_pad, n_pad), dtype=np.float32) < p_rewire
    drop = drop | drop.transpose(0, 2, 1)
    p_add = np.float32(p_rewire * k_ring) / np.maximum(nv, 2).astype(
        np.float32)[:, None, None]
    add = rng.random((batch, n_pad, n_pad), dtype=np.float32) < p_add
    return _batch((ring & ~drop) | add, _prefix_mask(batch, n_pad, nv), dev)


def powerlaw_cluster(seed, batch: int, n_pad: int, n_vertices, m: int,
                     p_triangle: float, device=None) -> GraphBatch:
    """Holme-Kim style: BA plus triangle-closing steps.

    Each two-hop pair (u, w) not already joined becomes an edge with
    probability ``p_triangle`` (kept only where both orientations drew it).
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    mask = _prefix_mask(batch, n_pad, n_vertices)
    adj = _ba_adj(rng, batch, n_pad, m)
    adj = adj | adj.transpose(0, 2, 1)
    adj &= mask[:, None, :] & mask[:, :, None]
    diag = np.arange(n_pad)
    adj[:, diag, diag] = False
    a = adj.astype(np.float32)
    two_hop = (a @ a > 0) & ~adj
    u = rng.random(adj.shape, dtype=np.float32)
    extra = two_hop & (u < p_triangle) & mask[:, None, :] & mask[:, :, None]
    extra = extra & extra.transpose(0, 2, 1)
    return _batch(adj | extra, mask, dev)


def _community_adj(rng, batch, n_pad, n_comm, p_in, p_out) -> np.ndarray:
    comm = rng.integers(0, n_comm, (batch, n_pad))
    same = comm[:, :, None] == comm[:, None, :]
    p_in = np.broadcast_to(np.asarray(p_in, np.float32), (batch,))
    p_out = np.broadcast_to(np.asarray(p_out, np.float32), (batch,))
    p = np.where(same, p_in[:, None, None], p_out[:, None, None])
    u = rng.random((batch, n_pad, n_pad), dtype=np.float32)
    return np.triu(u < p, 1)


def community_graph(seed, batch: int, n_pad: int, n_vertices, n_comm: int,
                    p_in: float, p_out: float, device=None) -> GraphBatch:
    """Planted-partition surrogate for the SNAP "com-*" networks."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    return _batch(_community_adj(rng, batch, n_pad, n_comm, p_in, p_out),
                  _prefix_mask(batch, n_pad, n_vertices), dev)


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
    total = w.sum(-1, keepdims=True)
    tgt = _draw(rng, w, n)
    rows, cols = np.nonzero(is_sat & (total > 0))
    adj[rows, cols, tgt[rows, cols]] = True
    return canonicalize(torch.from_numpy(adj).to(g.device), g.mask, g.f)


def with_degree_filtration(g: GraphBatch) -> GraphBatch:
    """The paper's default filtering function: degree on the given graph."""
    deg = g.degrees().to(torch.float32)
    return GraphBatch(adj=g.adj, mask=g.mask, f=torch.where(g.mask, deg, INF))


# ---------------------------------------------------------------------------
# dataset surrogates (paper Table 2 and Table 1)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    n_graphs: int      # the paper's NumGraphs (sampled down by callers)
    avg_nodes: float   # the paper's AvgNumNodes
    avg_edges: float   # the paper's AvgNumEdges
    family: str        # generator family
    n_pad: int         # padded order of the surrogate


def _spec(name, n_graphs, nodes, edges, family, n_pad):
    return DatasetSpec(name, n_graphs, nodes, edges, family, n_pad)


# Orders and sizes from the paper's appendix Table 2; n_pad covers the mean
# regime (huge-N datasets are subsampled: the layout is small-N, huge-B).
TABLE2 = {
    "DD":            _spec("DD", 1178, 284.3, 715.7, "powerlaw", 320),
    "DHFR":          _spec("DHFR", 467, 42.4, 44.5, "ws", 64),
    "ENZYMES":       _spec("ENZYMES", 600, 32.6, 62.1, "ws", 64),
    "FIRSTMM":       _spec("FIRSTMM", 41, 1377.3, 3074.1, "community", 256),
    "NCI1":          _spec("NCI1", 4110, 29.9, 32.3, "ws", 48),
    "OHSU":          _spec("OHSU", 79, 82.0, 199.7, "powerlaw", 128),
    "PROTEINS":      _spec("PROTEINS", 1113, 39.1, 72.8, "ws", 64),
    "REDDIT-BINARY": _spec("REDDIT-BINARY", 2000, 429.6, 497.8, "ba", 480),
    "SYNNEW":        _spec("SYNNEW", 300, 100.0, 196.3, "er", 128),
    "TWITTER":       _spec("TWITTER", 973, 83.5, 1817.0, "dense_ego", 128),
    "FACEBOOK":      _spec("FACEBOOK", 10, 403.9, 8823.4, "dense_ego", 448),
    "CORA":          _spec("CORA", 1, 2708.0, 5429.0, "ba", 512),
    "CITESEER":      _spec("CITESEER", 1, 3264.0, 4536.0, "ba", 512),
}

# SNAP large networks (paper Table 1): scaled surrogates with the published
# average degree; the satellite fraction encodes each network's low-degree
# tail.  name: (family, |V|, |E|, satellite_frac)
TABLE1 = {
    "com-youtube":      ("community", 1_134_890, 2_987_624, 0.55),
    "com-amazon":       ("community", 334_863, 925_872, 0.35),
    "com-dblp":         ("community", 317_080, 1_049_866, 0.65),
    "web-Stanford":     ("ba", 281_903, 1_992_636, 0.60),
    "emailEuAll":       ("dense_ego", 265_214, 364_481, 0.90),
    "soc-Epinions1":    ("ba", 75_879, 405_740, 0.50),
    "p2pGnutella31":    ("er", 62_586, 147_892, 0.40),
    "Brightkite_edges": ("community", 58_228, 214_078, 0.45),
    "Email-Enron":      ("community", 36_692, 183_831, 0.70),
    "CA-CondMat":       ("community", 23_133, 93_439, 0.60),
    "oregon1_010526":   ("ba", 11_174, 23_409, 0.55),
}


def _gen_family(family: str, rng, batch: int, n_pad: int, nv, avg_deg,
                device) -> GraphBatch:
    """Dispatch on the family string with degree matched to ``avg_deg``."""
    nv = np.broadcast_to(np.asarray(nv), (batch,))
    avg_deg = np.float32(avg_deg)
    half = max(1, int(round(float(avg_deg) / 2)))
    if family == "er":
        p = avg_deg / np.maximum(nv - 1, 1).astype(np.float32)
        return erdos_renyi(rng, batch, n_pad, nv, p, device=device)
    if family == "ba":
        return barabasi_albert(rng, batch, n_pad, nv, half, device=device)
    if family == "ws":
        return watts_strogatz(rng, batch, n_pad, nv, max(2, half * 2), 0.1,
                              device=device)
    if family == "powerlaw":
        return powerlaw_cluster(rng, batch, n_pad, nv, half, 0.3,
                                device=device)
    if family == "community":
        nvf = nv.astype(np.float32)
        p_in = np.minimum(avg_deg * np.float32(0.8)
                          / np.maximum(nvf / 8.0, 1.0), 0.9)
        p_out = avg_deg * np.float32(0.2) / np.maximum(nvf, 2.0)
        return community_graph(rng, batch, n_pad, nv, 8, p_in, p_out,
                               device=device)
    if family == "dense_ego":
        # hub-and-dense-core: ER core plus a hub set joined to everything
        p = np.minimum(2.0 * avg_deg / np.maximum(nv - 1, 1), 0.8)
        mask = _prefix_mask(batch, n_pad, nv)
        adj = _er_adj(rng, batch, n_pad, nv, p)
        hub = np.arange(n_pad)[None, :] < np.maximum(nv // 20, 1)[:, None]
        return _batch(adj | (hub[:, :, None] & mask[:, None, :]), mask,
                      device)
    raise ValueError(f"unknown family {family!r}")


def load_dataset(name: str, seed, batch: int | None = None,
                 degree_filtration: bool = True, device=None) -> GraphBatch:
    """A batch of surrogate graphs for a Table 2 dataset.

    The graphs depend on the int ``seed`` and on ``name`` only (``name``
    enters the seed through its CRC-32, which, unlike ``hash``, is the same
    in every process).
    """
    dev = resolve_device(device)
    spec = TABLE2[name]
    b = batch or min(spec.n_graphs, 64)
    rng = np.random.default_rng([int(seed), zlib.crc32(name.encode())])
    # graph orders: lognormal around the dataset mean, clipped to n_pad
    nv = np.exp(np.log(spec.avg_nodes) + 0.35 * rng.standard_normal(b))
    nv = np.clip(nv, 4, spec.n_pad).astype(np.int32)
    avg_deg = 2.0 * spec.avg_edges / spec.avg_nodes
    g = _gen_family(spec.family, rng, b, spec.n_pad, nv, avg_deg, dev)
    return with_degree_filtration(g) if degree_filtration else g


def load_large_network(name: str, seed, n_pad: int = 2048,
                       degree_filtration: bool = True,
                       device=None) -> GraphBatch:
    """One scaled surrogate (order ``n_pad``) of a Table 1 SNAP network."""
    dev = resolve_device(device)
    family, n_full, e_full, sat_frac = TABLE1[name]
    rng = np.random.default_rng(seed)
    # the core's mean degree is raised so that after rewiring the satellite
    # tail the overall mean degree still matches the published 2|E|/|V|
    avg_deg = 2.0 * e_full / n_full / max(1.0 - sat_frac, 0.1)
    g = _gen_family(family, rng, 1, n_pad, n_pad, avg_deg, dev)
    g = attach_satellites(rng, g, sat_frac)
    return with_degree_filtration(g) if degree_filtration else g
