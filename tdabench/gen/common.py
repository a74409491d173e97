"""Shared pieces of the generators: seeding, preferential attachment and a
counter-based uniform draw that gives the same numbers on every device.

Frozen with the benchmark: a later change to the program's own generators
(``repro_torch.data``) does not change the inputs a cell measures.
"""
from __future__ import annotations

import zlib

import numpy as np
import torch

_M32 = 0xFFFFFFFF


def host_rng(seed: int, name: str) -> np.random.Generator:
    """numpy Generator of ``seed`` (any whole number) and a stream name."""
    return np.random.default_rng([int(seed) % 2 ** 64,
                                  zlib.crc32(name.encode())])


def ba_edges(rng: np.random.Generator, n_vertices: np.ndarray, m: int,
             n_pad: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Preferential attachment on ``len(n_vertices)`` graphs at once.

    Vertex ``t`` of graph ``b`` (``1 <= t < n_vertices[b]``) draws ``m``
    earlier vertices with probability proportional to degree + 1, with
    replacement; repeated draws merge into one edge.  This is the model of
    ``repro_torch.data.graphs.barabasi_albert``: a draw of weight
    degree + 1 is a uniform draw over the ``t`` earlier vertices and the two
    ends of every earlier edge.  Returns ``(graph, u, v)`` int64 arrays,
    one entry an edge, ``v < u``.
    """
    nv = np.asarray(n_vertices, np.int64)
    b = nv.shape[0]
    ends = np.zeros((b, 2 * m * n_pad + 1), np.int64)
    n_ends = np.zeros(b, np.int64)
    rows = np.arange(b)
    out_g, out_u, out_v = [], [], []
    for t in range(1, n_pad):
        live = rows[t < nv]
        if live.size == 0:
            break
        total = t + n_ends[live]
        r = np.minimum((rng.random((live.size, m)) * total[:, None])
                       .astype(np.int64), total[:, None] - 1)
        pick = np.where(r < t, r,
                        ends[live[:, None], np.maximum(r - t, 0)])
        pick.sort(axis=1)
        fresh = np.ones(pick.shape, bool)
        fresh[:, 1:] = pick[:, 1:] != pick[:, :-1]
        gi, ci = np.nonzero(fresh)
        g, v = live[gi], pick[gi, ci]
        out_g.append(g)
        out_u.append(np.full(g.shape, t, np.int64))
        out_v.append(v)
        # both ends of every new edge join the draw list, in edge order
        k = np.bincount(gi, minlength=live.size)
        start = np.cumsum(k) - k
        slot = n_ends[g] + 2 * (np.arange(gi.size) - start[gi])
        ends[g, slot] = t
        ends[g, slot + 1] = v
        n_ends[live] += 2 * k
    return (np.concatenate(out_g), np.concatenate(out_u),
            np.concatenate(out_v))


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash on int64 tensors holding values < 2**32 (the
    products stay below 2**63, so no arithmetic wraps)."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x2C1B3C6D) & _M32
    return x ^ (x >> 16)


def uniform(seed: int, stream: int, *keys: torch.Tensor) -> torch.Tensor:
    """Uniform floats in [0, 1), float64, one for each position of the
    broadcast ``keys`` (int64 tensors of values < 2**32): a hash of the
    seed, the stream number and the keys, the same on every device."""
    s = int(seed) % 2 ** 64
    h = _mix32(torch.as_tensor((s & _M32) ^ (stream * 0x9E37 & _M32),
                               dtype=torch.int64, device=keys[0].device))
    h = _mix32(h ^ (s >> 32))
    for k in keys:
        h = _mix32(h ^ k)
    return h.to(torch.float64) / 2.0 ** 32
