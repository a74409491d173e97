r"""Batched graph updates for dynamic-network streams (counterpart of
``repro.core.delta``).

A ``DeltaBatch`` carries, for every graph of a :class:`GraphBatch`, a fixed
number of *slots* of three update kinds:

* **edge ops** — insert / delete an undirected edge ``{u, v}``;
* **f ops** — overwrite the vertex filtration value ``f(w)``;
* **vertex drops** — deactivate a vertex (mask off; incident edges die).

Slots are static-capacity (padded with ``-1`` / ``EDGE_NOP``), so a whole
update stream is one stack of tensors with a leading time axis and
``apply_delta`` is a handful of scatters on the batch's device.

Semantics (enforced by ``apply_delta``; ``canonicalize_delta`` restores the
slot-level invariants of raw tensors):

* edges are undirected — ops are canonicalized to ``u < v`` and applied
  symmetrically; self loops and out-of-range endpoints are dropped as a
  pair (they neither touch adjacency nor activate an endpoint);
* a delete beats an insert of the same edge within one DeltaBatch;
* inserting an edge **activates** both endpoints; a newly activated vertex
  with no f op gets ``f = 0``;
* duplicate f ops on one vertex: the highest slot wins;
* vertex drops beat everything touching the dropped vertex;
* f is explicit stream state (paper Remark 1: the filtration is *not*
  recomputed on the updated graph).

Scatters of an invalid slot go to a sentinel row ``n`` of an ``N + 1``-wide
buffer that is sliced off; the f ops pick their winning slot by a
``scatter_reduce(..., "amax")`` of the slot index, which is deterministic on
CUDA where an ``index_put_`` with duplicate indices is not.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.graph import GraphBatch, canonicalize

EDGE_NOP = 0
EDGE_INSERT = 1
EDGE_DELETE = 2

_FIELDS = ("edge_u", "edge_v", "edge_op", "f_vertex", "f_value",
           "drop_vertex")


@dataclasses.dataclass(frozen=True)
class DeltaBatch:
    """One batched update step (or a stacked (T, B, ...) stream of steps).

    edge_u/edge_v: (B, E) int32 endpoints, ``-1`` for unused slots.
    edge_op:       (B, E) int32 in {EDGE_NOP, EDGE_INSERT, EDGE_DELETE}.
    f_vertex:      (B, F) int32 vertex ids (``-1`` unused).
    f_value:       (B, F) float32 new filtration values.
    drop_vertex:   (B, D) int32 vertex ids to deactivate (``-1`` unused).
    """

    edge_u: torch.Tensor
    edge_v: torch.Tensor
    edge_op: torch.Tensor
    f_vertex: torch.Tensor
    f_value: torch.Tensor
    drop_vertex: torch.Tensor

    @property
    def batch(self) -> int:
        return self.edge_u.shape[-2]

    @property
    def edge_slots(self) -> int:
        return self.edge_u.shape[-1]

    @property
    def f_slots(self) -> int:
        return self.f_vertex.shape[-1]

    @property
    def drop_slots(self) -> int:
        return self.drop_vertex.shape[-1]

    @property
    def steps(self) -> int:
        """Leading time axis length for stacked streams (1 for one step)."""
        return self.edge_u.shape[0] if self.edge_u.dim() == 3 else 1

    def map(self, fn) -> "DeltaBatch":
        """The DeltaBatch with ``fn`` applied to every field."""
        return DeltaBatch(*(fn(getattr(self, k)) for k in _FIELDS))

    def to(self, device) -> "DeltaBatch":
        return self.map(lambda x: x.to(device))

    def index(self, idx) -> "DeltaBatch":
        """The graphs ``idx`` of a single step (rows of the batch axis)."""
        return self.map(lambda x: x[..., idx, :])


def delta_step(d: DeltaBatch, t: int) -> DeltaBatch:
    """Slice step ``t`` out of a stacked (T, B, ...) DeltaBatch stream."""
    return d.map(lambda x: x[t])


def empty_delta(batch: int, edge_slots: int = 0, f_slots: int = 0,
                drop_slots: int = 0, device=None) -> DeltaBatch:
    """An all-padding DeltaBatch (a no-op step; a test fixture)."""
    dev = resolve_device(device)

    def ids(w):
        return torch.full((batch, w), -1, dtype=torch.int32, device=dev)

    return DeltaBatch(
        edge_u=ids(edge_slots), edge_v=ids(edge_slots),
        edge_op=torch.full((batch, edge_slots), EDGE_NOP, dtype=torch.int32,
                           device=dev),
        f_vertex=ids(f_slots),
        f_value=torch.zeros((batch, f_slots), dtype=torch.float32,
                            device=dev),
        drop_vertex=ids(drop_slots))


def canonicalize_delta(d: DeltaBatch, n: int) -> DeltaBatch:
    """Restore slot invariants: u < v, no self loops, in-range ids, -1 pads."""
    u = torch.minimum(d.edge_u, d.edge_v)
    v = torch.maximum(d.edge_u, d.edge_v)
    ok = (u >= 0) & (v < n) & (u != v) & (d.edge_op != EDGE_NOP)
    op = torch.where(ok, d.edge_op, EDGE_NOP)
    u = torch.where(ok, u, -1)
    v = torch.where(ok, v, -1)
    f_ok = (d.f_vertex >= 0) & (d.f_vertex < n)
    fv = torch.where(f_ok, d.f_vertex, -1)
    dr_ok = (d.drop_vertex >= 0) & (d.drop_vertex < n)
    dr = torch.where(dr_ok, d.drop_vertex, -1)
    i32 = torch.int32
    return DeltaBatch(edge_u=u.to(i32), edge_v=v.to(i32),
                      edge_op=op.to(i32), f_vertex=fv.to(i32),
                      f_value=d.f_value.to(torch.float32),
                      drop_vertex=dr.to(i32))


def _valid_pairs(n: int, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Slots holding a well-formed undirected edge: in range, no self loop."""
    return (u >= 0) & (u < n) & (v >= 0) & (v < n) & (u != v)


def _scatter_pairs(b: int, n: int, u: torch.Tensor, v: torch.Tensor,
                   on: torch.Tensor) -> torch.Tensor:
    """(B, N, N) bool with True at (u, v) and (v, u) for slots where ``on``.

    Every write stores True, so duplicate indices are harmless; slots that
    are off land in the sentinel row and column ``n``."""
    uu = torch.where(on, u, n).long()
    vv = torch.where(on, v, n).long()
    bidx = torch.arange(b, device=u.device)[:, None].expand_as(uu)
    m = torch.zeros((b, n + 1, n + 1), dtype=torch.bool, device=u.device)
    m[bidx, uu, vv] = True
    m = m[:, :n, :n]
    return m | m.transpose(-1, -2)


def _scatter_vertices(b: int, n: int, ids: torch.Tensor,
                      on: torch.Tensor) -> torch.Tensor:
    """(B, N) bool with True at the listed vertex ids where ``on``."""
    valid = on & (ids >= 0) & (ids < n)
    vv = torch.where(valid, ids, n).long()
    bidx = torch.arange(b, device=ids.device)[:, None].expand_as(vv)
    out = torch.zeros((b, n + 1), dtype=torch.bool, device=ids.device)
    out[bidx, vv] = True
    return out[:, :n]


def apply_delta(g: GraphBatch, d: DeltaBatch) -> GraphBatch:
    """Apply one DeltaBatch step to a GraphBatch (pure; on the batch's
    device).

    Update order: edge inserts, edge deletes (delete wins), endpoint
    activation, f ops, vertex drops (drop wins), then ``canonicalize``
    restores every GraphBatch invariant.
    """
    b, n = g.batch, g.n
    ok = _valid_pairs(n, d.edge_u, d.edge_v)
    is_ins = ok & (d.edge_op == EDGE_INSERT)
    is_del = ok & (d.edge_op == EDGE_DELETE)
    ins = _scatter_pairs(b, n, d.edge_u, d.edge_v, is_ins)
    dele = _scatter_pairs(b, n, d.edge_u, d.edge_v, is_del)
    adj = (g.adj | ins) & ~dele

    act = (_scatter_vertices(b, n, d.edge_u, is_ins)
           | _scatter_vertices(b, n, d.edge_v, is_ins))
    drop = _scatter_vertices(b, n, d.drop_vertex,
                             torch.ones_like(d.drop_vertex, dtype=torch.bool))
    mask = (g.mask | act) & ~drop

    f = g.f
    if d.f_slots:
        f_on = (d.f_vertex >= 0) & (d.f_vertex < n)
        fv = torch.where(f_on, d.f_vertex, n).long()
        slots = torch.arange(d.f_slots, dtype=torch.int64, device=g.device)
        win = torch.full((b, n + 1), -1, dtype=torch.int64, device=g.device)
        win = win.scatter_reduce(
            1, fv, torch.where(f_on, slots[None, :], -1), "amax")[:, :n]
        val = d.f_value.gather(1, win.clamp(min=0))
        f = torch.where(win >= 0, val, f)
    # newly activated vertices default to f = 0 unless an f op set them
    newly = mask & ~g.mask
    f = torch.where(newly & torch.isinf(f), 0.0, f)
    return canonicalize(adj, mask, f)


def delta_from_lists(
    edge_ops: Sequence[Sequence[tuple[int, int, int]]],
    f_ops: Sequence[Sequence[tuple[int, float]]] | None = None,
    drops: Sequence[Sequence[int]] | None = None,
    edge_slots: int | None = None,
    f_slots: int | None = None,
    drop_slots: int | None = None,
    device=None,
) -> DeltaBatch:
    """Build a single-step DeltaBatch from python lists (host-side helper).

    edge_ops[i] is a list of ``(u, v, op)`` with op in {EDGE_INSERT,
    EDGE_DELETE} (or the strings "insert"/"delete"); duplicate ops on the
    same canonical edge keep the *last* occurrence (last-wins dedupe).
    """
    dev = resolve_device(device)
    b = len(edge_ops)
    f_ops = f_ops if f_ops is not None else [[] for _ in range(b)]
    drops = drops if drops is not None else [[] for _ in range(b)]
    ops_named = {"insert": EDGE_INSERT, "delete": EDGE_DELETE}

    deduped: list[list[tuple[int, int, int]]] = []
    for ops in edge_ops:
        seen: dict[tuple[int, int], int] = {}
        for (u, v, op) in ops:
            op = ops_named.get(op, op)
            if u == v:
                continue
            seen[(min(u, v), max(u, v))] = int(op)
        deduped.append([(u, v, op) for (u, v), op in seen.items()])
    f_deduped = [list(dict(fo).items()) for fo in f_ops]

    e_cap = edge_slots if edge_slots is not None else max(
        [len(x) for x in deduped] + [0])
    f_cap = f_slots if f_slots is not None else max(
        [len(x) for x in f_deduped] + [0])
    d_cap = drop_slots if drop_slots is not None else max(
        [len(x) for x in drops] + [0])

    eu = np.full((b, e_cap), -1, np.int32)
    ev = np.full((b, e_cap), -1, np.int32)
    eo = np.full((b, e_cap), EDGE_NOP, np.int32)
    fv = np.full((b, f_cap), -1, np.int32)
    fx = np.zeros((b, f_cap), np.float32)
    dr = np.full((b, d_cap), -1, np.int32)
    for i in range(b):
        for j, (u, v, op) in enumerate(deduped[i][:e_cap]):
            eu[i, j], ev[i, j], eo[i, j] = u, v, op
        for j, (w, val) in enumerate(f_deduped[i][:f_cap]):
            fv[i, j], fx[i, j] = w, val
        for j, w in enumerate(list(drops[i])[:d_cap]):
            dr[i, j] = w
    return DeltaBatch(*(torch.from_numpy(a).to(dev)
                        for a in (eu, ev, eo, fv, fx, dr)))
