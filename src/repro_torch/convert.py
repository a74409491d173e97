"""Carry state between ``repro`` and this package through numpy.

The system has no weights; its state is the ``GraphBatch`` going in, the
``DeltaBatch`` updates of a stream and the ``Diagrams`` coming out.  Both
packages take and give numpy arrays here, so neither imports the other.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.delta import DeltaBatch
from repro_torch.core.graph import GraphBatch
from repro_torch.core.persistence import Diagrams, diagrams_to_numpy  # noqa: F401


def graph_batch_from_numpy(adj, mask, f, device=None) -> GraphBatch:
    """A GraphBatch from (B,N,N) bool, (B,N) bool and (B,N) float32 arrays
    (e.g. ``np.asarray`` of a ``repro`` GraphBatch's fields)."""
    dev = resolve_device(device)
    return GraphBatch(
        adj=torch.from_numpy(np.array(adj, dtype=bool)).to(dev),
        mask=torch.from_numpy(np.array(mask, dtype=bool)).to(dev),
        f=torch.from_numpy(np.array(f, dtype=np.float32)).to(dev))


def graph_batch_to_numpy(g: GraphBatch) -> tuple[np.ndarray, ...]:
    """(adj, mask, f) as numpy arrays."""
    return tuple(t.detach().cpu().numpy() for t in (g.adj, g.mask, g.f))


def diagrams_from_numpy(birth, death, dim, valid, device=None) -> Diagrams:
    """Diagrams from (..., S) float32, float32, int32 and bool arrays
    (e.g. ``np.asarray`` of a ``repro`` Diagrams' fields)."""
    dev = resolve_device(device)
    return Diagrams(
        birth=torch.from_numpy(np.array(birth, dtype=np.float32)).to(dev),
        death=torch.from_numpy(np.array(death, dtype=np.float32)).to(dev),
        dim=torch.from_numpy(np.array(dim, dtype=np.int32)).to(dev),
        valid=torch.from_numpy(np.array(valid, dtype=bool)).to(dev))


def diagrams_arrays(d: Diagrams) -> dict[str, np.ndarray]:
    """{birth, death, dim, valid} as numpy arrays."""
    return {k: getattr(d, k).detach().cpu().numpy()
            for k in ("birth", "death", "dim", "valid")}


def delta_batch_from_numpy(edge_u, edge_v, edge_op, f_vertex, f_value,
                           drop_vertex, device=None) -> DeltaBatch:
    """A DeltaBatch from int32 endpoint, op, f-vertex and drop arrays and a
    float32 f-value array, one step (B, slots) or a stream (T, B, slots)
    (e.g. ``np.asarray`` of a ``repro`` DeltaBatch's fields)."""
    dev = resolve_device(device)
    ints = (np.array(x, dtype=np.int32)
            for x in (edge_u, edge_v, edge_op, f_vertex))
    eu, ev, eo, fv = (torch.from_numpy(x).to(dev) for x in ints)
    return DeltaBatch(
        edge_u=eu, edge_v=ev, edge_op=eo, f_vertex=fv,
        f_value=torch.from_numpy(np.array(f_value, dtype=np.float32)).to(dev),
        drop_vertex=torch.from_numpy(
            np.array(drop_vertex, dtype=np.int32)).to(dev))


def delta_batch_to_numpy(d: DeltaBatch) -> tuple[np.ndarray, ...]:
    """(edge_u, edge_v, edge_op, f_vertex, f_value, drop_vertex) as numpy
    arrays."""
    return tuple(getattr(d, k).detach().cpu().numpy()
                 for k in ("edge_u", "edge_v", "edge_op", "f_vertex",
                           "f_value", "drop_vertex"))
