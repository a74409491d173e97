"""Plan -> execute API: reduce -> repack -> persist (counterpart of
``repro.core.api``).

``make_topo_plan(...)`` returns the process-wide ``TopoPlan`` of a
``TopoPlanKey`` (LRU-cached); ``topological_signature`` is a thin wrapper.
Plans run eagerly on the tensors' device: on CUDA the reduction and
persistence kernels carry the work, on the CPU their plain versions do.

* ``repack="off"`` (default): one reduce -> persist pass at the input caps.
* ``repack="on"``: the reduce phase iterates the passes to their fixpoint,
  compacts every graph and counts its simplices; after one host sync the
  graphs are grouped by the smallest ladder rung that holds them and each
  group is persisted at its rung's caps.  Rows are scattered back into an
  input-order Diagrams padded to the single-phase row count.

* ``mesh=`` (a :mod:`repro_torch.launch.mesh` grid, single-phase only):
  the batch splits along dim 0 into ``mesh.size`` equal contiguous shards
  in ``mesh.flat`` order, each shard runs the reduce -> persist body on its
  device, and the rows come back in input order on the batch's device
  (``topological_signature_sharded`` is the thin wrapper).  The shards
  run one after another, also when the mesh names several cards.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from repro_torch._device import device_context
from repro_torch.core.graph import GraphBatch
from repro_torch.core.persistence import (
    REDUCERS,
    Diagrams,
    persistence_diagrams_batched,
)
from repro_torch.core.reduction import (
    apply_passes,
    engine_exact_from_dim,
    method_for_passes,
    passes_for_method,
    run_reduction,
    validate_passes,
)
from repro_torch.core.repack import (
    RepackReport,
    ShapeClass,
    compact_batch,
    default_ladder,
    diagram_size,
    measure_counts,
    select_classes,
    slice_to,
)
from repro_torch.launch.mesh import DeviceMesh

REDUCTIONS = ("none", "coral", "prunit", "both")
REPACK_MODES = ("off", "on")


def reduce_graphs(g: GraphBatch, dim: int, method: str = "both",
                  sublevel: bool = True) -> GraphBatch:
    """Apply the paper's reduction(s) for computing PD_dim (one sweep)."""
    if method not in REDUCTIONS:
        raise ValueError(f"unknown reduction {method!r}; want one of {REDUCTIONS}")
    return apply_passes(g, passes_for_method(method), dim, sublevel)


@dataclasses.dataclass(frozen=True)
class TopoPlanKey:
    """Hashable identity of one pipeline (the plan-cache key)."""

    dim: int
    passes: tuple[str, ...]
    sublevel: bool
    edge_cap: int
    tri_cap: int
    quad_cap: int
    reducer: str
    mesh: Optional[DeviceMesh] = None  # None: one device, the batch's
    repack: str = "off"
    fixpoint: bool = False
    ladder: Optional[tuple[ShapeClass, ...]] = None

    def caps(self) -> tuple[int, int, int]:
        return (self.edge_cap, self.tri_cap, self.quad_cap)

    @property
    def method(self) -> str:
        return method_for_passes(self.passes)


@dataclasses.dataclass(frozen=True)
class TopoPlan:
    """A reduce -> persist pipeline plus its static metadata.

    ``execute`` (alias ``__call__``) maps a GraphBatch to Diagrams;
    ``execute_info`` also returns the :class:`RepackReport` (``None`` when
    repack is off).
    """

    key: TopoPlanKey
    _ladders: dict = dataclasses.field(
        default_factory=dict, compare=False, repr=False)

    def execute(self, g: GraphBatch) -> Diagrams:
        return self.execute_info(g)[0]

    def __call__(self, g: GraphBatch) -> Diagrams:
        return self.execute(g)

    @property
    def dim(self) -> int:
        return self.key.dim

    @property
    def method(self) -> str:
        return self.key.method

    @property
    def passes(self) -> tuple[str, ...]:
        return self.key.passes

    @property
    def sublevel(self) -> bool:
        return self.key.sublevel

    def exact_from_dim(self) -> int:
        """Lowest homology dimension this plan's reduction preserves."""
        return engine_exact_from_dim(self.key.passes, self.key.dim)

    def reduce_phase(self, g: GraphBatch):
        """Phase 1 of ``repack="on"``: reduce, compact, count simplices;
        ``-> (compacted GraphBatch, (nv, ne, nt))`` on the batch's device."""
        k = self.key
        gr = run_reduction(g, k.passes, k.dim, k.sublevel, k.fixpoint)
        gc, _ = compact_batch(gr)
        return gc, measure_counts(
            gc, count_triangles=k.dim >= 1 and k.tri_cap > 0)

    def persist_plan(self, sc: ShapeClass) -> "TopoPlan":
        """Phase 2: the no-reduction plan of one rung (shared via the cache)."""
        return make_topo_plan(
            dim=self.key.dim, passes=(), sublevel=self.key.sublevel,
            edge_cap=sc.edge_cap, tri_cap=sc.tri_cap, quad_cap=sc.quad_cap,
            reducer=self.key.reducer)

    def ladder_for(self, n: int) -> tuple[ShapeClass, ...]:
        """The persist ladder for input padded order ``n``.

        A custom ladder keeps only rungs no wider than the input and no
        larger than the plan's caps (quads: exactly the plan's quad_cap when
        they are live), plus a top rung at the input shape.
        """
        k = self.key
        lad = self._ladders.get(n)
        if lad is not None:
            return lad
        if k.ladder is not None:
            top = ShapeClass(n_pad=n, edge_cap=k.edge_cap,
                             tri_cap=k.tri_cap, quad_cap=k.quad_cap)
            quads_live = k.dim >= 2 and k.quad_cap
            fits = {c for c in k.ladder
                    if (c.n_pad <= n and c.edge_cap <= k.edge_cap
                        and c.tri_cap <= k.tri_cap
                        and (c.quad_cap == k.quad_cap if quads_live
                             else c.quad_cap <= k.quad_cap))}
            fits.add(top)
            lad = tuple(sorted(fits))
        else:
            lad = default_ladder(
                n, k.edge_cap, k.tri_cap if k.dim >= 1 else 0,
                k.quad_cap if k.dim >= 2 else 0)
        return self._ladders.setdefault(n, lad)

    def execute_info(self, g: GraphBatch
                     ) -> tuple[Diagrams, Optional[RepackReport]]:
        """Execute, also returning the repack report (``None`` when off).

        Two-phase execution: reduce/compact/measure, fetch the counts to the
        host (the one phase-boundary sync), group graphs by first-fit shape
        class, persist each group at its rung and scatter its rows into the
        input-order output.
        """
        k = self.key
        if k.mesh is not None:
            return _execute_sharded(g, k), None
        if k.repack != "on":
            return _pipeline(g, k), None
        gc, counts = self.reduce_phase(g)
        nv, ne, nt = (c.cpu().numpy() for c in counts)
        ladder = self.ladder_for(g.n)
        cls_idx = select_classes(ladder, nv, ne, nt)
        s_full = diagram_size(g.n, k.dim, k.edge_cap, k.tri_cap, k.quad_cap)
        out = _invalid_diagrams(g.batch, s_full, g.device)
        for ci in sorted(set(cls_idx.tolist())):
            sc = ladder[ci]
            idx = torch.from_numpy(np.nonzero(cls_idx == ci)[0]).to(g.device)
            sub = slice_to(gc.index(idx), sc.n_pad)
            d = self.persist_plan(sc).execute(sub)
            s = d.birth.shape[-1]
            for name in ("birth", "death", "dim", "valid"):
                getattr(out, name)[idx, :s] = getattr(d, name)
        report = RepackReport(ladder=ladder, class_index=cls_idx,
                              n_vertices=nv, n_edges=ne, n_triangles=nt)
        return out, report


def _pipeline(g: GraphBatch, key: TopoPlanKey) -> Diagrams:
    """The one reduce -> persist body of every single-phase execution."""
    gr = run_reduction(g, key.passes, key.dim, key.sublevel, key.fixpoint)
    return persistence_diagrams_batched(
        gr, max_dim=key.dim, edge_cap=key.edge_cap, tri_cap=key.tri_cap,
        quad_cap=key.quad_cap, sublevel=key.sublevel, reducer=key.reducer)


def map_shards(g: GraphBatch, mesh: DeviceMesh, fn) -> list:
    """``fn`` over equal contiguous shards of ``g`` along dim 0 in
    ``mesh.flat`` order (``repro``'s ``shard_map`` over
    ``P(mesh.axis_names)``), each shard on its device and run under it, one
    after another; returns the shards' outputs in order.  A batch the mesh
    size does not divide raises: padding is the caller's job (TopoServe
    pads its batches)."""
    devices = mesh.flat
    if g.batch % len(devices):
        raise ValueError(
            f"a batch of {g.batch} graphs is not evenly divisible by the "
            f"mesh size {len(devices)} (axes {mesh.axis_names}); pad "
            f"the batch to a multiple of it")
    per = g.batch // len(devices)
    parts = []
    for p, dev in enumerate(devices):
        rows = slice(p * per, (p + 1) * per)
        shard = GraphBatch(adj=g.adj[rows].to(dev), mask=g.mask[rows].to(dev),
                           f=g.f[rows].to(dev))
        with device_context(dev):
            parts.append(fn(shard))
    return parts


def _execute_sharded(g: GraphBatch, key: TopoPlanKey) -> Diagrams:
    """``_pipeline`` over ``key.mesh`` (:func:`map_shards`); input-order
    rows on the batch's device."""
    parts = map_shards(g, key.mesh, lambda shard: _pipeline(shard, key))
    if len(parts) == 1:
        return parts[0].to(g.device)
    return Diagrams(*(torch.cat([getattr(d, name).to(g.device)
                                 for d in parts])
                      for name in ("birth", "death", "dim", "valid")))


def _invalid_diagrams(b: int, s: int, device) -> Diagrams:
    """An all-invalid Diagrams tensor matching pairs_to_diagrams sentinels."""
    return Diagrams(
        birth=torch.full((b, s), float("nan"), device=device),
        death=torch.full((b, s), float("nan"), device=device),
        dim=torch.full((b, s), -1, dtype=torch.int32, device=device),
        valid=torch.zeros((b, s), dtype=torch.bool, device=device),
    )


_PLAN_CACHE: "OrderedDict[TopoPlanKey, TopoPlan]" = OrderedDict()
_PLAN_CACHE_MAXSIZE = 64
_PLAN_CACHE_LOCK = threading.Lock()
_PLAN_CACHE_STATS = {"hits": 0, "misses": 0, "evictions": 0}


def make_topo_plan(
    dim: int = 1,
    method: str = "both",
    sublevel: bool = True,
    edge_cap: int = 256,
    tri_cap: int = 512,
    quad_cap: int = 0,
    reducer: str = "blocks",
    mesh: Optional[DeviceMesh] = None,
    passes: Optional[tuple] = None,
    repack: str = "off",
    fixpoint: Optional[bool] = None,
    ladder: Optional[tuple] = None,
) -> TopoPlan:
    """Build or fetch the process-wide plan of this key (LRU, thread safe).

    ``passes`` overrides ``method``; ``fixpoint`` defaults to True exactly
    when ``repack="on"``; ``ladder`` pins the persist shape classes;
    ``mesh`` shards the single-phase plan's batch over the mesh's devices.
    """
    if passes is None:
        if method not in REDUCTIONS:
            raise ValueError(
                f"unknown reduction {method!r}; want one of {REDUCTIONS}")
        passes = passes_for_method(method)
    else:
        passes = validate_passes(passes)
    if repack not in REPACK_MODES:
        raise ValueError(f"repack must be one of {REPACK_MODES}, got {repack!r}")
    if reducer not in REDUCERS:
        raise ValueError(f"reducer must be one of {REDUCERS}, got {reducer!r}")
    if repack == "on" and mesh is not None:
        raise ValueError(
            "repack='on' is host-driven at the phase boundary and is not "
            "supported under a mesh; shard the single-phase plan instead "
            "(repack='off') or drive per-host two-phase plans")
    if fixpoint is None:
        fixpoint = repack == "on"
    key = TopoPlanKey(dim=dim, passes=passes, sublevel=bool(sublevel),
                      edge_cap=int(edge_cap), tri_cap=int(tri_cap),
                      quad_cap=int(quad_cap), reducer=reducer, mesh=mesh,
                      repack=repack, fixpoint=bool(fixpoint),
                      ladder=None if ladder is None else tuple(ladder))
    with _PLAN_CACHE_LOCK:
        plan = _PLAN_CACHE.get(key)
        if plan is not None:
            _PLAN_CACHE.move_to_end(key)
            _PLAN_CACHE_STATS["hits"] += 1
            return plan
        _PLAN_CACHE_STATS["misses"] += 1
        plan = _PLAN_CACHE[key] = TopoPlan(key=key)
        while len(_PLAN_CACHE) > _PLAN_CACHE_MAXSIZE:
            _PLAN_CACHE.popitem(last=False)
            _PLAN_CACHE_STATS["evictions"] += 1
    return plan


def plan_cache_info() -> dict:
    """Snapshot of the plan cache: hits/misses/evictions/currsize/maxsize."""
    with _PLAN_CACHE_LOCK:
        return dict(_PLAN_CACHE_STATS, currsize=len(_PLAN_CACHE),
                    maxsize=_PLAN_CACHE_MAXSIZE)


def clear_plan_cache() -> None:
    """Drop every cached plan and reset the counters."""
    with _PLAN_CACHE_LOCK:
        _PLAN_CACHE.clear()
        for k in _PLAN_CACHE_STATS:
            _PLAN_CACHE_STATS[k] = 0


def topological_signature(
    g: GraphBatch,
    dim: int = 1,
    method: str = "both",
    sublevel: bool = True,
    edge_cap: int = 256,
    tri_cap: int = 512,
    quad_cap: int = 0,
    reducer: str = "blocks",
    repack: str = "off",
) -> Diagrams:
    """End-to-end: reduce with the paper's algorithms, then exact PDs.

    The Diagrams cover dimensions 0..dim; with coral in ``method`` only
    dimension ``dim`` is guaranteed.  ``repack="on"`` gives the same valid
    pairs at other row positions.
    """
    plan = make_topo_plan(dim=dim, method=method, sublevel=sublevel,
                          edge_cap=edge_cap, tri_cap=tri_cap,
                          quad_cap=quad_cap, reducer=reducer, repack=repack)
    return plan.execute(g)


def topological_signature_sharded(
    g: GraphBatch,
    mesh: DeviceMesh,
    dim: int = 1,
    method: str = "both",
    sublevel: bool = True,
    edge_cap: int = 256,
    tri_cap: int = 512,
    quad_cap: int = 0,
    reducer: str = "blocks",
) -> Diagrams:
    """``topological_signature`` with the batch sharded over ``mesh``.

    Thin wrapper over ``make_topo_plan(..., mesh=mesh)``: the batch must
    divide the mesh size; the shards run one after another on their
    devices and the Diagrams come back in input order on ``g``'s device.
    """
    plan = make_topo_plan(dim=dim, method=method, sublevel=sublevel,
                          edge_cap=edge_cap, tri_cap=tri_cap,
                          quad_cap=quad_cap, reducer=reducer, mesh=mesh)
    return plan.execute(g)


@dataclasses.dataclass(frozen=True)
class ReductionStats:
    """Per-graph reduction accounting (the paper's evaluation metric)."""

    v_before: torch.Tensor
    v_after: torch.Tensor
    e_before: torch.Tensor
    e_after: torch.Tensor

    def v_reduction_pct(self) -> torch.Tensor:
        v0 = self.v_before.clamp(min=1)
        return 100.0 * (self.v_before - self.v_after) / v0

    def e_reduction_pct(self) -> torch.Tensor:
        e0 = self.e_before.clamp(min=1)
        return 100.0 * (self.e_before - self.e_after) / e0


def reduction_stats(g: GraphBatch, dim: int, method: str = "both",
                    sublevel: bool = True) -> ReductionStats:
    gr = reduce_graphs(g, dim, method, sublevel)
    return ReductionStats(
        v_before=g.n_vertices(), v_after=gr.n_vertices(),
        e_before=g.n_edges(), e_after=gr.n_edges(),
    )
