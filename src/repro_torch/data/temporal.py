"""Synthetic temporal-graph generators: (initial GraphBatch, update stream)
(counterpart of ``repro.data.temporal``).

Each generator returns ``(g0, deltas)``: ``g0`` a padded GraphBatch and
``deltas`` a stacked :class:`~repro_torch.core.delta.DeltaBatch` with a
leading time axis; ``delta_step(deltas, t)`` slices step ``t`` and feeding
the steps to ``TopoStream.apply`` replays the stream.  Streams are drawn on
the device (CUDA unless ``device="cpu"``) from a ``torch.Generator`` there,
made from ``seed`` when an int is given.  ``repro`` draws from
``jax.random``, whose draws are not reproduced: the families, their layouts
and their invariants are the same, not the streams.

The three families cover the three invalidation regimes of TopoStream:

* ``pa_growth_stream`` — preferential-attachment growth.  With ``m=1`` every
  arrival is a pendant vertex dominated by its target: nothing recomputes.
* ``community_churn_stream`` — edge churn inside planted communities.  Most
  updates land inside the (dim+1)-core: the recompute-bound regime.
* ``ego_decay_stream`` — a dense ego net whose peripheral edges decay and
  recover.  Satellite updates are provably skippable (coral for pendant
  satellites, PrunIT for hub-dominated ones); occasional core edges force
  real recomputes.  The paper's §6.2 regime made temporal.
"""
from __future__ import annotations

import torch

from repro_torch._device import resolve_device
from repro_torch.core.delta import (
    EDGE_DELETE,
    EDGE_INSERT,
    EDGE_NOP,
    DeltaBatch,
    _scatter_pairs,
    delta_step,
)
from repro_torch.core.graph import GraphBatch, canonicalize

__all__ = [
    "pa_growth_stream",
    "community_churn_stream",
    "ego_decay_stream",
    "delta_step",
]


def _generator(seed, device: torch.device) -> torch.Generator:
    """``seed`` as a generator on ``device`` (an int seeds a new one)."""
    if isinstance(seed, torch.Generator):
        if seed.device.type != device.type:
            raise ValueError(f"generator on {seed.device}, stream on {device}")
        return seed
    return torch.Generator(device=device).manual_seed(int(seed))


def _stack_delta(edge_u, edge_v, edge_op, f_vertex=None, f_value=None,
                 drop_vertex=None) -> DeltaBatch:
    """Assemble a stacked (T, B, ...) DeltaBatch from per-step lists,
    filling absent op kinds."""
    eu, ev, eo = (torch.stack(x) for x in (edge_u, edge_v, edge_op))
    t, b = eu.shape[0], eu.shape[1]
    dev = eu.device
    if f_vertex is None:
        fv = torch.full((t, b, 0), -1, dtype=torch.int32, device=dev)
        fx = torch.zeros((t, b, 0), dtype=torch.float32, device=dev)
    else:
        fv, fx = torch.stack(f_vertex), torch.stack(f_value)
    dr = (torch.full((t, b, 0), -1, dtype=torch.int32, device=dev)
          if drop_vertex is None else torch.stack(drop_vertex))
    i32 = torch.int32
    return DeltaBatch(edge_u=eu.to(i32), edge_v=ev.to(i32),
                      edge_op=eo.to(i32), f_vertex=fv.to(i32),
                      f_value=fx.to(torch.float32), drop_vertex=dr.to(i32))


# ---------------------------------------------------------------------------
# preferential-attachment growth
# ---------------------------------------------------------------------------

def pa_growth_stream(seed, batch: int, n_pad: int, n0: int, m: int,
                     steps: int, device=None) -> tuple[GraphBatch, DeltaBatch]:
    """Growing network: step t activates vertex ``n0 + t`` with ``m`` edges.

    Attachment targets are degree-weighted among existing vertices (drawn
    with replacement, so a step may repeat a target).  The filtration is
    vertex arrival time (``f(v) = v``), so old vertices never change f.
    Requires ``n0 + steps <= n_pad``.
    """
    if n0 + steps > n_pad:
        raise ValueError(f"n0 + steps = {n0 + steps} exceeds n_pad={n_pad}")
    if n0 < 2:
        raise ValueError("need n0 >= 2 seed vertices")
    dev = resolve_device(device)
    gen = _generator(seed, dev)
    idx = torch.arange(n_pad, device=dev)
    seed_adj = ((idx[None, :] < n0) & (idx[:, None] < n0)
                & (idx[None, :] != idx[:, None]))
    adj0 = seed_adj.expand(batch, n_pad, n_pad)
    mask0 = (idx < n0).expand(batch, n_pad)
    g0 = canonicalize(adj0, mask0, idx.to(torch.float32).expand(batch, n_pad))

    deg = adj0.sum(-1, dtype=torch.float32)
    bidx = torch.arange(batch, device=dev)[:, None]
    eu, ev, eo, fv, fx = [], [], [], [], []
    for t in range(steps):
        new_id = n0 + t
        w = (deg + 1.0) * (idx[None, :] < new_id)
        tgt = torch.multinomial(w, m, replacement=True, generator=gen)
        hot = torch.zeros((batch, n_pad), dtype=torch.bool, device=dev)
        hot[bidx.expand_as(tgt), tgt] = True
        deg = deg + hot
        deg[:, new_id] += hot.sum(-1)
        eu.append(tgt)
        ev.append(torch.full((batch, m), new_id, device=dev))
        eo.append(torch.full((batch, m), EDGE_INSERT, device=dev))
        fv.append(torch.full((batch, 1), new_id, device=dev))
        fx.append(torch.full((batch, 1), float(new_id), device=dev))
    return g0, _stack_delta(eu, ev, eo, f_vertex=fv, f_value=fx)


# ---------------------------------------------------------------------------
# community churn
# ---------------------------------------------------------------------------

def community_churn_stream(seed, batch: int, n_pad: int, n_vertices,
                           n_comm: int, p_in: float, p_out: float,
                           steps: int, churn: int, in_bias: float = 4.0,
                           churn_schedule=None, device=None
                           ) -> tuple[GraphBatch, DeltaBatch]:
    """Planted-partition graph whose edges churn: per step and per graph,
    ``churn`` existing edges (uniform) are deleted and ``churn`` non-edges
    (``in_bias`` times likelier inside a community) are inserted.  f is the
    community label, so churn only moves adjacency.

    ``churn_schedule`` (optional, ``steps`` ints in ``0..churn``) keeps only
    the first ``churn_schedule[t]`` delete and insert slots of step ``t``
    (the rest become NOPs): occasional full-size steps on a small schedule
    make rewiring bursts for drift detection.
    """
    dev = resolve_device(device)
    gen = _generator(seed, dev)
    if churn_schedule is None:
        sched = [churn] * steps
    else:
        sched = [int(x) for x in torch.as_tensor(churn_schedule).tolist()]
        if len(sched) != steps:
            raise ValueError(
                f"churn_schedule has {len(sched)} entries, want {steps}")
        if min(sched) < 0 or max(sched) > churn:
            raise ValueError(
                f"churn_schedule entries must be in 0..churn={churn} "
                f"(only churn op slots exist per step); got "
                f"[{min(sched)}, {max(sched)}]")
    n_vertices = torch.as_tensor(n_vertices, device=dev).expand(batch)
    idx = torch.arange(n_pad, device=dev)
    mask = idx[None, :] < n_vertices[:, None]
    comm = torch.randint(0, n_comm, (batch, n_pad), generator=gen,
                         device=dev)
    same = comm[:, :, None] == comm[:, None, :]
    p = torch.where(same, p_in, p_out)
    u = torch.rand((batch, n_pad, n_pad), generator=gen, device=dev)
    upper = torch.ones((n_pad, n_pad), dtype=torch.bool, device=dev).triu(1)
    g0 = canonicalize((u < p) & upper, mask, comm.to(torch.float32))

    live = mask[:, None, :] & mask[:, :, None]
    ins_w = torch.where(same, in_bias, 1.0)
    bidx = torch.arange(batch, device=dev)[:, None]
    slot = torch.arange(churn, device=dev)[None, :]

    def pick(weights):
        """(B, churn) flat upper-triangle indices drawn prop. to weights;
        a graph with no candidate draws a zero-weight index, masked out
        below."""
        w = weights.reshape(batch, -1).clamp(min=1e-30)
        return torch.multinomial(w, churn, replacement=True, generator=gen)

    adj = g0.adj
    eu, ev, eo = [], [], []
    for t in range(steps):
        cur = adj & upper & live
        flat_del = pick(cur.to(torch.float32))
        non = ~adj & upper & live
        flat_ins = pick(non.to(torch.float32) * ins_w)
        du, dv = flat_del // n_pad, flat_del % n_pad
        iu, iv = flat_ins // n_pad, flat_ins % n_pad
        slot_on = slot < sched[t]
        del_ok = cur[bidx, du, dv] & slot_on
        ins_ok = non[bidx, iu, iv] & slot_on
        eu.append(torch.cat([torch.where(del_ok, du, -1),
                             torch.where(ins_ok, iu, -1)], -1))
        ev.append(torch.cat([torch.where(del_ok, dv, -1),
                             torch.where(ins_ok, iv, -1)], -1))
        eo.append(torch.cat([torch.where(del_ok, EDGE_DELETE, EDGE_NOP),
                             torch.where(ins_ok, EDGE_INSERT, EDGE_NOP)], -1))
        adj = ((adj | _scatter_pairs(batch, n_pad, iu, iv, ins_ok))
               & ~_scatter_pairs(batch, n_pad, du, dv, del_ok))
    return g0, _stack_delta(eu, ev, eo)


# ---------------------------------------------------------------------------
# ego-net edge decay
# ---------------------------------------------------------------------------

def ego_decay_stream(seed, batch: int, n_pad: int, n_core: int,
                     n_double: int, n_pendant: int, steps: int,
                     toggles: int = 1, p_core_edge: float = 0.15,
                     p_er: float = 0.5, device=None
                     ) -> tuple[GraphBatch, DeltaBatch]:
    """Dense ego net with decaying/recovering peripheral edges.

    Layout per graph (f in parentheses):

    * hub 0 (0.0) — adjacent to every live vertex;
    * hub 1 (0.0) — adjacent to hub 0, the core, and the double satellites;
    * core ``2..n_core-1`` (1.0) — ER(p_er) among themselves;
    * double satellites (2.0) — attached to hubs 0 and 1; toggling their
      hub-1 edge is a **PrunIT hit** (hub 0 dominates both endpoints and is
      never touched), exact in every dimension;
    * pendant satellites (2.0) — attached to hub 0 only; toggling that edge
      is a **coral hit** for dim >= 1 but changes PD_0.

    Each step toggles ``toggles`` random satellite edges per graph and, with
    probability ``p_core_edge``, one random core–core edge (both endpoints
    in the 2-core: a real recompute).
    """
    n_live = n_core + n_double + n_pendant
    if n_live > n_pad:
        raise ValueError(f"{n_live} live vertices exceed n_pad={n_pad}")
    if n_core < 4:
        raise ValueError("need n_core >= 4 (2 hubs + >= 2 core vertices)")
    dev = resolve_device(device)
    gen = _generator(seed, dev)
    idx = torch.arange(n_pad, device=dev)
    live = idx < n_live
    corev = (idx >= 2) & (idx < n_core)
    dbl = (idx >= n_core) & (idx < n_core + n_double)

    u = torch.rand((batch, n_pad, n_pad), generator=gen, device=dev)
    er = (u < p_er) & corev[None, :, None] & corev[None, None, :]
    hub0 = (idx == 0)[:, None] & live[None, :]
    hub1 = (idx == 1)[:, None] & (corev | dbl | (idx == 0))[None, :]
    adj0 = er | hub0[None] | hub1[None]
    f0 = torch.where(idx < 2, 0.0, torch.where(idx < n_core, 1.0, 2.0))
    g0 = canonicalize(adj0, live.expand(batch, n_pad),
                      f0.expand(batch, n_pad))

    n_sat = n_double + n_pendant
    sat_ids = n_core + torch.arange(n_sat, device=dev)
    sat_hub = torch.where(torch.arange(n_sat, device=dev) < n_double, 1, 0)
    cu, cv = torch.triu_indices(n_core - 2, n_core - 2, 1, device=dev) + 2
    n_cand = cu.shape[0]

    sat_on = torch.ones((batch, n_sat), dtype=torch.bool, device=dev)
    core_on = g0.adj[:, cu, cv]
    bidx = torch.arange(batch, device=dev)[:, None]
    eu, ev, eo = [], [], []
    for _ in range(steps):
        pick = torch.randint(0, n_sat, (batch, toggles), generator=gen,
                             device=dev)
        hot = torch.zeros_like(sat_on)
        hot[bidx.expand_as(pick), pick] = True
        present = sat_on.gather(1, pick)
        s_op = torch.where(present, EDGE_DELETE, EDGE_INSERT)
        sat_on = sat_on ^ hot

        gate = torch.rand((batch,), generator=gen, device=dev) < p_core_edge
        cpick = torch.randint(0, n_cand, (batch, 1), generator=gen,
                              device=dev)
        c_present = core_on.gather(1, cpick)
        g1 = gate[:, None]
        c_op = torch.where(g1, torch.where(c_present, EDGE_DELETE,
                                           EDGE_INSERT), EDGE_NOP)
        chot = torch.zeros_like(core_on)
        chot[bidx, cpick] = gate[:, None]
        core_on = core_on ^ chot

        eu.append(torch.cat([sat_hub[pick], torch.where(g1, cu[cpick], -1)],
                            -1))
        ev.append(torch.cat([sat_ids[pick], torch.where(g1, cv[cpick], -1)],
                            -1))
        eo.append(torch.cat([s_op, c_op], -1))
    return g0, _stack_delta(eu, ev, eo)
