"""The comparison that decides ``correct``.

The window keeps, for a sample of its calls drawn from the seed, the
guaranteed dimensions' pairs of the checked rows, compacted on the device
after the call's time is taken.  Once the window has closed, the reference
computes the diagrams of the same graphs, unreduced, and every kept row is
compared with them: the multiset of (birth, death) pairs, exactly.  A row
also fails where it holds a valid pair of a dimension the plan does not
compute.
"""
from __future__ import annotations

import numpy as np
import torch


def keep_rows(d, positions, dims: tuple[int, ...], max_dim: int) -> dict:
    """The pairs of dimension ``dims`` in rows ``positions`` (a device
    index tensor, or None for every row) of Diagrams ``d``, on the host:
    ``row`` (index into ``positions``), ``dim``, ``birth``, ``death``, and
    ``stray``, the rows' valid pairs of another dimension than 0..max_dim."""
    birth, death, dim, valid = d.birth, d.death, d.dim, d.valid
    if positions is not None:
        birth, death, dim, valid = (x[positions] for x in
                                    (birth, death, dim, valid))
    want = torch.zeros_like(valid)
    for k in dims:
        want |= dim == k
    r, c = (valid & want).nonzero(as_tuple=True)
    stray = (valid & ((dim < 0) | (dim > max_dim))).sum()
    return {"row": r.cpu().numpy(), "dim": dim[r, c].cpu().numpy(),
            "birth": birth[r, c].cpu().numpy().astype(np.float64),
            "death": death[r, c].cpu().numpy().astype(np.float64),
            "stray": int(stray)}


def rows_wrong(kept: dict, graph_of_row: np.ndarray, reference: dict,
               dims: tuple[int, ...]) -> int:
    """Rows of one kept call whose pairs differ from ``reference``
    (``{graph id: {dim: sorted [(birth, death)]}}``); ``graph_of_row``
    maps a kept row to its graph id."""
    got: dict[int, dict[int, list]] = {}
    for r, k, b, e in zip(kept["row"].tolist(), kept["dim"].tolist(),
                          kept["birth"].tolist(), kept["death"].tolist()):
        got.setdefault(r, {}).setdefault(k, []).append((b, e))
    wrong = 0
    for r, gid in enumerate(graph_of_row.tolist()):
        mine = got.get(r, {})
        want = reference[gid]
        if any(sorted(mine.get(k, [])) != want.get(k, []) for k in dims):
            wrong += 1
    return wrong + kept["stray"]


def as_kept(diagrams: dict, graph_of_row: np.ndarray,
            dims: tuple[int, ...]) -> dict:
    """Kept rows, in :func:`keep_rows`' form, holding ``diagrams``
    (``{graph id: {dim: pairs}}``) of the graphs ``graph_of_row``: another
    computation's answers, put in the program's place."""
    rows = [(r, k, b, e) for r, gid in enumerate(graph_of_row.tolist())
            for k in dims for b, e in diagrams[gid].get(k, [])]
    r, k, b, e = (np.array(x) for x in zip(*rows)) if rows else (
        np.zeros(0, np.int64),) * 4
    return {"row": r.astype(np.int64), "dim": k.astype(np.int64),
            "birth": b.astype(np.float64), "death": e.astype(np.float64),
            "stray": 0}
