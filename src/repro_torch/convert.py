"""Carry state between ``repro`` and this package through numpy.

The system has no weights; its state is the ``GraphBatch`` going in and the
``Diagrams`` coming out.  Both packages take and give numpy arrays here, so
neither imports the other.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
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


def diagrams_arrays(d: Diagrams) -> dict[str, np.ndarray]:
    """{birth, death, dim, valid} as numpy arrays."""
    return {k: getattr(d, k).detach().cpu().numpy()
            for k in ("birth", "death", "dim", "valid")}
