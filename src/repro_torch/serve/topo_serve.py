"""TopoServe: batched persistence-diagram serving on padding buckets
(counterpart of ``repro.serve.topo_serve``).

Turns the batch-at-a-time TDA core into a request-serving path:

* clients ``submit()`` single graphs (edge list + optional filtering values)
  and get back a ``TopoFuture``;
* the scheduler assigns each request to a **padding bucket** — a fixed
  ``(n_pad, edge_cap, tri_cap)`` shape class — so the number of distinct
  batch shapes is bounded by the bucket ladder, not by the query
  distribution;
* ``drain()`` packs each bucket's queue into a padded GraphBatch on the
  server's device, executes the bucket's plan through the process-wide plan
  cache (``repro_torch.core.api.make_topo_plan``; on CUDA its
  ``domination``, ``kcore_peel`` and ``gf2_reduce`` launches), and resolves
  the futures with per-graph Diagrams rows.

The loop is deliberately sync-first (``submit``/``drain`` under one lock) so
it is trivially testable; ``serve_forever`` runs the same drain as a blocking
loop for a dedicated thread, and ``serve_forever_async`` wraps it for an
asyncio event loop.  The server runs on ``device`` (CUDA unless
``device="cpu"``; without a card ``None`` raises).  With ``mesh=`` (e.g.
:func:`repro_torch.launch.make_serve_mesh`) requests are packed on the
mesh's first device, bucket batches are padded to a multiple of the mesh
size and each executes as the bucket's sharded plan.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch._device import device_context, resolve_device
from repro_torch._device import same_device as _same_device
from repro_torch.core.api import TopoPlan, make_topo_plan
from repro_torch.core.graph import GraphBatch, from_edge_lists
from repro_torch.core.persistence import REDUCERS, Diagrams
from repro_torch.core.repack import ShapeClass, default_ladder
from repro_torch.launch.mesh import DeviceMesh
from repro_torch.obs import flight as _flight
from repro_torch.obs.context import DeadlineExceeded, resolve_submit
from repro_torch.serve.futures import ServeFuture

_FIELDS = ("birth", "death", "dim", "valid")

# TopoScope instruments (always on; one series per server instance via the
# ``instance`` label, so tests and multi-server processes never mix stats).
# ``TopoServe.stats`` is a dict-shaped view over these — the registry is
# the single source of truth.
_C_SUBMITTED = obs.counter("serve.submitted",
                           help="requests accepted per bucket")
_C_SERVED = obs.counter("serve.served", help="futures resolved per bucket")
_C_FAILED = obs.counter("serve.failed", help="futures failed at drain")
_C_BATCHES = obs.counter("serve.batches", help="executed batches per bucket")
_C_PADDED = obs.counter("serve.padded_rows",
                        help="empty pad rows executed (mesh divisibility)")
_C_RUNGS = obs.counter(
    "serve.repack_rungs",
    help="repack='on' graphs per (input bucket, persist rung)")
_H_QWAIT = obs.histogram(
    "serve.queue_wait_seconds",
    help="submit -> drain-pickup wait per request")
_H_OCC = obs.histogram(
    "serve.batch_occupancy", help="executed batch fill vs max_batch",
    buckets=obs.DEFAULT_RATIO_BUCKETS)

# TopoWatch instruments: request outcomes + loop liveness.  The latency
# histogram feeds the per-bucket p50/p99 SLOs (obs/slo.py); the heartbeat
# and ready gauges back /healthz and /readyz (obs/http.py).
_H_LATENCY = obs.histogram(
    "serve.request_latency_seconds",
    help="submit -> resolve wall time per bucket")
_C_DEADLINE = obs.counter(
    "serve.deadline_exceeded",
    help="requests failed by the drain deadline sweep, per bucket")
_C_CANCELLED = obs.counter(
    "serve.cancelled", help="cancelled requests skipped at drain")
_G_HEARTBEAT = obs.gauge(
    "serve.heartbeat_ts",
    help="wall-clock timestamp of the drain loop's last iteration")
_G_READY = obs.gauge(
    "serve.ready", help="1 once serve_forever warmed the bucket plans")


@dataclasses.dataclass(frozen=True, order=True)
class Bucket:
    """One padding bucket == one batch-shape class.

    Every graph routed here is padded to ``n_pad`` vertices and persisted
    with this bucket's simplex caps, so all its batches share one plan.
    """

    n_pad: int
    edge_cap: int
    tri_cap: int


# Default ladder: ego-net-regime graphs (the paper's §6.2 workload).  Caps
# grow with the vertex budget; a graph lands in the first rung that fits
# both its order and its edge count.
DEFAULT_BUCKETS = (
    Bucket(n_pad=16, edge_cap=64, tri_cap=96),
    Bucket(n_pad=32, edge_cap=160, tri_cap=256),
    Bucket(n_pad=64, edge_cap=320, tri_cap=512),
    Bucket(n_pad=128, edge_cap=768, tri_cap=1024),
)


@dataclasses.dataclass(frozen=True)
class TopoServeConfig:
    """Scheduler policy + the pipeline parameters shared by every bucket.

    ``reducer`` names one of the port's reducers (``"blocks"``, the plan's
    default, or ``"flat"``); ``repro``'s ``"jnp"`` and ``"pallas"`` have no
    counterpart here and are refused.

    ``repack="on"`` switches every bucket to the two-phase plan: drain
    becomes reduce → measure → repack → persist, where the persist phase
    runs at each graph's post-reduction :class:`ShapeClass` instead of the
    input bucket's caps.  The persist ladder is shared across buckets (see
    ``repack_ladder_for``), so reduced graphs from different input buckets
    execute the same persist plans.
    """

    buckets: tuple[Bucket, ...] = DEFAULT_BUCKETS
    dim: int = 1
    method: str = "both"
    sublevel: bool = True
    quad_cap: int = 0
    reducer: str = "blocks"
    max_batch: int = 256      # largest executed batch per bucket flush
    pad_batch_to: int = 1     # executed batches padded to a multiple of this
    record_batches: bool = False  # keep (bucket, requests) per executed batch
    repack: str = "off"       # "off" | "on": two-phase reduce→repack→persist

    def __post_init__(self):
        if self.reducer not in REDUCERS:
            raise ValueError(
                f"reducer {self.reducer!r} is not one of the port's "
                f"reducers {REDUCERS} (repro's 'jnp' and 'pallas' paths have "
                f"no counterpart here)")


@dataclasses.dataclass(frozen=True)
class TopoRequest:
    """One client graph, host-side (hashable ids only; tensors built at
    pack)."""

    edges: tuple[tuple[int, int], ...]
    n_vertices: int
    f: Optional[tuple[float, ...]] = None  # None -> degree filtration


class TopoFuture(ServeFuture):
    """Handle for one submitted graph; resolved by a later ``drain()``.

    ``result()`` returns the per-graph Diagrams row (fields shaped (S,), no
    batch axis; views into the batch's tensors).  Thread-safe plumbing —
    including ``cancel()`` and the request id / deadline carried from
    ``submit()`` — lives in ``ServeFuture``.  With ``repack="on"``,
    ``repack_class`` carries the persist :class:`ShapeClass` this request
    was re-bucketed into (set at drain, before the future resolves).
    """

    __slots__ = ("bucket", "repack_class")

    def __init__(self, bucket: Bucket, request_id: Optional[str] = None,
                 deadline: Optional[float] = None):
        super().__init__(request_id=request_id, deadline=deadline)
        self.bucket = bucket
        self.repack_class: ShapeClass | None = None


def pack_requests(reqs: Sequence[TopoRequest], bucket: Bucket,
                  device=None) -> GraphBatch:
    """Pad a bucket's requests into one GraphBatch on ``device`` (CUDA
    unless ``device="cpu"``; shared with benchmarks so served-vs-direct
    parity checks run the exact same packing)."""
    if all(r.f is None for r in reqs):
        f_values = None  # from_edge_lists' vectorized degree-filtration default
    else:
        f_values = [r.f if r.f is not None
                    else _degree_f(r.edges, r.n_vertices) for r in reqs]
    return from_edge_lists(
        [list(r.edges) for r in reqs],
        [r.n_vertices for r in reqs],
        n_pad=bucket.n_pad,
        f_values=f_values,
        device=device,
    )


def _degree_f(edges: Sequence[tuple[int, int]], n_vertices: int) -> tuple[float, ...]:
    # dedupe first: duplicate/bidirectional entries must not inflate degrees
    # (from_edge_lists' adjacency-based default dedupes implicitly, and the
    # two paths must agree or co-batching would change a request's numerics)
    deg = np.zeros(n_vertices, dtype=np.float32)
    for (u, v) in {(min(u, v), max(u, v)) for (u, v) in edges if u != v}:
        deg[u] += 1
        deg[v] += 1
    return tuple(float(x) for x in deg)


def repack_ladder_for(buckets: Sequence[Bucket],
                      quad_cap: int = 0) -> tuple[ShapeClass, ...]:
    """The ONE persist-shape ladder shared by every repack-enabled server.

    Rungs are the serve buckets themselves (so a reduced graph that stays
    large persists at a familiar bucket shape) plus the default pow2
    sub-rungs below the smallest bucket (where most reduced ego-regime
    graphs land).  TopoServe and SimilarityServe both derive their ladders
    here — one definition, one set of persist plan-cache keys, so reduced
    queries from any serving surface share persist plans.
    """
    smallest = min(buckets)
    sub = default_ladder(smallest.n_pad, smallest.edge_cap,
                         smallest.tri_cap, quad_cap)[:-1]
    classes = {ShapeClass(n_pad=b.n_pad, edge_cap=b.edge_cap,
                          tri_cap=b.tri_cap, quad_cap=quad_cap)
               for b in buckets}
    classes.update(sub)
    return tuple(sorted(classes))


def _count_triangles(edge_set, n_vertices: int) -> int:
    """Host-side triangle count (trace(A^3)/6) for cap-aware routing."""
    a = np.zeros((n_vertices, n_vertices), dtype=np.int64)
    for (u, v) in edge_set:
        a[u, v] = a[v, u] = 1
    return int(np.trace(a @ a @ a) // 6)


def _row(d: Diagrams, i: int) -> Diagrams:
    """Graph ``i``'s Diagrams row: views into ``d``'s tensors, no copy."""
    return Diagrams(*(getattr(d, k)[i] for k in _FIELDS))


class TopoServe:
    """Bucketed batch scheduler over the plan cache.

    >>> server = TopoServe(device="cpu")
    >>> fut = server.submit(edges=[(0, 1), (1, 2), (2, 0)], n_vertices=3)
    >>> server.drain()
    1
    >>> int(fut.result().betti(0))
    1
    """

    def __init__(self, config: TopoServeConfig | None = None, device=None,
                 mesh: DeviceMesh | None = None):
        self.config = config or TopoServeConfig()
        if not self.config.buckets:
            raise ValueError("TopoServeConfig.buckets must be non-empty")
        if self.config.repack not in ("off", "on"):
            raise ValueError(
                f"repack must be 'off' or 'on', got {self.config.repack!r}")
        if self.config.repack == "on" and mesh is not None:
            raise ValueError(
                "repack='on' is not supported under a mesh (the repack "
                "phase boundary is host-driven); use repack='off'")
        self.mesh = mesh
        pad = max(1, self.config.pad_batch_to)
        if mesh is None:
            self.device = resolve_device(device)
        else:
            self.device = mesh.flat[0]
            if device is not None and not _same_device(
                    torch.device(device), self.device):
                raise ValueError(
                    f"device={device!r} disagrees with the mesh's first "
                    f"device {self.device}; pass one of them")
            # executed batches must divide the mesh, so round pad up to
            # the next multiple of the mesh size
            pad = -(-pad // mesh.size) * mesh.size
        self._pad_batch_to = pad
        self._buckets = tuple(sorted(self.config.buckets))
        self._repack_ladder = (
            repack_ladder_for(self._buckets, self.config.quad_cap)
            if self.config.repack == "on" else None)
        self._lock = threading.Lock()
        self._queues: dict[Bucket, deque] = {b: deque() for b in self._buckets}
        self._stopped = threading.Event()
        # (bucket, requests, futures) per executed batch when record_batches
        self.executed_batches: list[tuple] = []
        self._obs_instance = obs.next_instance("topo")
        # bucket -> stable label ("n32"); n_pad collisions disambiguate by
        # caps so per-bucket registry series stay distinct
        self._bucket_label: dict[Bucket, str] = {}
        for b in self._buckets:
            lbl = f"n{b.n_pad}"
            if lbl in self._bucket_label.values():
                lbl = f"n{b.n_pad}e{b.edge_cap}"
            if lbl in self._bucket_label.values():
                lbl = f"n{b.n_pad}e{b.edge_cap}t{b.tri_cap}"
            self._bucket_label[b] = lbl

    @property
    def stats(self) -> dict:
        """Dict-shaped view over the TopoScope registry (the same keys and
        key types as ``repro``'s).  Mutating the returned dict has no
        effect — counters live in ``repro_torch.obs``."""
        inst = self._obs_instance
        per_bucket = {}
        for b in self._buckets:
            lbl = self._bucket_label[b]
            per_bucket[b] = {
                "submitted": int(_C_SUBMITTED.value(instance=inst,
                                                    bucket=lbl)),
                "served": int(_C_SERVED.value(instance=inst, bucket=lbl)),
                "batches": int(_C_BATCHES.value(instance=inst, bucket=lbl)),
            }
        rungs = {}
        for key, v in _C_RUNGS.series().items():
            d = dict(key)
            if d.get("instance") != inst:
                continue
            rungs[(int(d["bucket"][1:]), int(d["rung"][1:]))] = int(v)
        return {
            "submitted": sum(pb["submitted"] for pb in per_bucket.values()),
            "served": sum(pb["served"] for pb in per_bucket.values()),
            "failed": int(_C_FAILED.value(instance=inst)),
            # per-bucket series summed over this instance
            "deadline_exceeded": int(_C_DEADLINE.total(instance=inst)),
            "cancelled": int(_C_CANCELLED.total(instance=inst)),
            "batches": sum(pb["batches"] for pb in per_bucket.values()),
            "padded_rows": int(_C_PADDED.value(instance=inst)),
            # repack="on": {(bucket n_pad, persist rung n_pad): graphs} —
            # rungs keyed by >1 bucket are shared persist plans
            "repack_rungs": rungs,
            "per_bucket": per_bucket,
        }

    # ------------------------------------------------------------- routing

    def bucket_for(self, n_vertices: int, n_edges: int,
                   n_triangles: int = 0) -> Bucket:
        """Deterministic bucket assignment: the smallest rung (buckets are
        totally ordered by (n_pad, edge_cap, tri_cap)) whose capacities hold
        every simplex of the graph — exactness requires caps >= the true
        counts, so a triangle-dense graph is promoted past rungs its edge
        count fits."""
        for b in self._buckets:
            if (n_vertices <= b.n_pad and n_edges <= b.edge_cap
                    and n_triangles <= b.tri_cap):
                return b
        raise ValueError(
            f"graph with {n_vertices} vertices / {n_edges} edges / "
            f"{n_triangles} triangles exceeds every bucket "
            f"(largest: {self._buckets[-1]})")

    def plan_for(self, bucket: Bucket) -> TopoPlan:
        """The bucket's pipeline, via the process-wide plan cache.

        With ``repack="on"`` every bucket's plan shares the one serve-wide
        persist ladder, so their reduced-size persist plans coincide in the
        plan cache whenever reductions land on the same rung.
        """
        c = self.config
        return make_topo_plan(
            dim=c.dim, method=c.method, sublevel=c.sublevel,
            edge_cap=bucket.edge_cap, tri_cap=bucket.tri_cap,
            quad_cap=c.quad_cap, reducer=c.reducer, mesh=self.mesh,
            repack=c.repack, ladder=self._repack_ladder,
        )

    # ------------------------------------------------------------- ingest

    def submit(self, edges: Sequence[tuple[int, int]], n_vertices: int,
               f: Sequence[float] | None = None, *,
               request_id: Optional[str] = None,
               deadline_s: Optional[float] = None) -> TopoFuture:
        """Enqueue one graph; returns a future resolved by a later drain.

        Malformed requests are rejected HERE (ValueError) so they can never
        poison a batch and fail co-batched clients' futures at drain time.

        Every request gets an id (explicit ``request_id``, the ambient
        ``obs.request_context()`` id, or a fresh mint) and an optional
        deadline: ``deadline_s`` is relative seconds-from-now, clamped to
        any ambient context deadline.  Expired requests are failed with
        :class:`~repro_torch.obs.DeadlineExceeded` by the drain sweep
        instead of executing late for nobody; cancelled futures are skipped
        the same way.
        """
        req = TopoRequest(
            edges=tuple((int(u), int(v)) for (u, v) in edges),
            n_vertices=int(n_vertices),
            f=None if f is None else tuple(float(x) for x in f),
        )
        if req.n_vertices < 1:
            raise ValueError(f"n_vertices must be >= 1, got {req.n_vertices}")
        for (u, v) in req.edges:
            if not (0 <= u < req.n_vertices and 0 <= v < req.n_vertices):
                raise ValueError(
                    f"edge ({u}, {v}) out of range for n_vertices="
                    f"{req.n_vertices}")
        if req.f is not None and len(req.f) != req.n_vertices:
            raise ValueError(
                f"f has {len(req.f)} values for {req.n_vertices} vertices")
        edge_set = {(min(u, v), max(u, v)) for (u, v) in req.edges if u != v}
        bucket = self.bucket_for(req.n_vertices, len(edge_set),
                                 _count_triangles(edge_set, req.n_vertices))
        rid, deadline = resolve_submit(request_id, deadline_s)
        fut = TopoFuture(bucket, request_id=rid, deadline=deadline)
        with self._lock:
            self._queues[bucket].append((req, fut))
        _C_SUBMITTED.inc(instance=self._obs_instance,
                         bucket=self._bucket_label[bucket])
        return fut

    def pending(self) -> int:
        with self._lock:
            return sum(len(q) for q in self._queues.values())

    # ------------------------------------------------------------- drain

    def drain(self) -> int:
        """Execute every queued request, bucket by bucket; returns #served.

        Bucket queues are flushed in submission order, chunked at
        ``max_batch`` and padded (with empty graphs, dropped after execution)
        to a multiple of ``pad_batch_to``, so executed batch shapes come
        from a small set.  Buckets are swept round-robin — one chunk per
        bucket per sweep — so sustained traffic into one bucket cannot starve
        requests queued in the others.

        Before each chunk executes, the TopoWatch sweep drops cancelled
        futures and fails expired ones with ``DeadlineExceeded`` — both
        counted per bucket — so the batch only carries requests somebody is
        still waiting for."""
        if not self.pending():
            return 0  # keep idle poll loops out of the trace
        with obs.span("serve.drain", frontend="topo") as sp:
            served = 0
            while True:
                progressed = False
                for b in self._buckets:
                    with self._lock:
                        q = self._queues[b]
                        items = [q.popleft()
                                 for _ in range(min(len(q),
                                                    self.config.max_batch))]
                    if items:
                        progressed = True
                        items = self._sweep(b, items)
                    if items:
                        served += self._execute(b, items)
                if not progressed:
                    sp.set(served=served)
                    return served

    def _sweep(self, bucket: Bucket, items: list) -> list:
        """Drop cancelled requests and fail expired ones (deadline sweep)."""
        inst = self._obs_instance
        lbl = self._bucket_label[bucket]
        now = time.monotonic()
        live = []
        for (req, fut) in items:
            if fut.cancelled():
                _C_CANCELLED.inc(instance=inst, bucket=lbl)
                _flight.record("serve", "cancelled_skip", frontend="topo",
                               bucket=lbl, rid=fut.request_id or "")
                continue
            if fut.expired(now):
                if fut._fail(DeadlineExceeded(
                        f"request {fut.request_id or '?'} expired "
                        f"{now - fut.deadline:.3f}s before drain pickup "
                        f"(bucket {lbl})")):
                    _C_DEADLINE.inc(instance=inst, bucket=lbl)
                    _flight.record("serve", "deadline_exceeded",
                                   frontend="topo", bucket=lbl,
                                   rid=fut.request_id or "",
                                   late_s=round(now - fut.deadline, 4))
                    _flight.auto_dump("deadline_exceeded")
                continue
            live.append((req, fut))
        return live

    def _execute(self, bucket: Bucket, items: list) -> int:
        inst = self._obs_instance
        lbl = self._bucket_label[bucket]
        reqs = tuple(r for (r, _) in items)
        futs = [f for (_, f) in items]
        now = time.perf_counter()
        for f in futs:
            _H_QWAIT.observe(now - f.submitted_at, instance=inst)
        _H_OCC.observe(len(items) / self.config.max_batch,
                       instance=inst, bucket=lbl)
        repack_info = None
        with obs.span("serve.batch", frontend="topo", bucket=lbl,
                      graphs=len(items)):
            try:
                with obs.span("serve.gather", bucket=lbl):
                    g = pack_requests(reqs, bucket, self.device)
                    n_pad_rows = (-len(reqs)) % self._pad_batch_to
                    if n_pad_rows:
                        g = _pad_batch(g, n_pad_rows)
                plan = self.plan_for(bucket)
                if self.config.repack == "on":
                    # two-phase drain: reduce → measure → repack → persist;
                    # the report carries each request's persist-rung
                    # assignment (plan.* spans nest here)
                    d, repack_info = plan.execute_info(g)
                else:
                    d = plan.execute(g)
                with obs.span("serve.sync"):
                    # a launch that failed asynchronously raises here, and
                    # the batch's futures get the error below
                    if d.birth.is_cuda:
                        torch.cuda.synchronize(d.birth.device)
            except Exception as e:  # resolve, don't wedge waiting clients
                n_failed = sum(1 for f in futs if f._fail(e))
                if n_failed:
                    _C_FAILED.inc(n_failed, instance=inst)
                _flight.record("serve", "batch_failed", frontend="topo",
                               bucket=lbl, graphs=len(futs), error=repr(e))
                return 0
            if self.config.record_batches:
                self.executed_batches.append((bucket, reqs, tuple(futs)))
            with obs.span("serve.resolve"):
                for i, f in enumerate(futs):
                    if repack_info is not None:
                        f.repack_class = repack_info.shape_class(i)
                    if f._resolve(_row(d, i)):
                        _H_LATENCY.observe(f.latency_s(),
                                           instance=inst, bucket=lbl)
        _C_SERVED.inc(len(futs), instance=inst, bucket=lbl)
        _C_BATCHES.inc(instance=inst, bucket=lbl)
        _flight.record("serve", "batch", frontend="topo", bucket=lbl,
                       graphs=len(futs))
        if n_pad_rows:
            _C_PADDED.inc(n_pad_rows, instance=inst)
        if repack_info is not None:
            for i in range(len(futs)):
                _C_RUNGS.inc(
                    instance=inst, bucket=f"n{bucket.n_pad}",
                    rung=f"n{repack_info.shape_class(i).n_pad}")
        return len(futs)

    # ------------------------------------------------------------- loops

    def warmup(self) -> None:
        """Build every bucket's plan through the process-wide plan cache.

        Called by ``serve_forever`` before raising ``serve.ready`` so
        ``/readyz`` flipping to 200 means plan construction cost is paid —
        the first live request will not eat it.
        """
        for b in self._buckets:
            self.plan_for(b)

    def _loop_enter(self) -> None:
        inst = self._obs_instance
        _flight.record("serve", "loop_start", frontend="topo", instance=inst)
        self.warmup()
        _G_HEARTBEAT.set(time.time(), frontend="topo", instance=inst)
        _G_READY.set(1, frontend="topo", instance=inst)

    def _loop_exit(self) -> None:
        inst = self._obs_instance
        _G_READY.set(0, frontend="topo", instance=inst)
        _flight.record("serve", "loop_stop", frontend="topo", instance=inst)

    def _drain_guarded(self) -> int:
        """One loop iteration: heartbeat + drain; flight-dump on escape.

        ``drain`` fails co-batched futures on per-batch errors, so anything
        escaping here is a scheduler bug — dump the flight ring before the
        loop dies so the wreckage is on disk even with tracing off.
        """
        _G_HEARTBEAT.set(time.time(), frontend="topo",
                         instance=self._obs_instance)
        try:
            return self.drain()
        except BaseException as e:
            _flight.record("serve", "drain_exception", frontend="topo",
                           error=repr(e))
            _flight.auto_dump("drain_exception")
            raise

    def _drain_on_device(self) -> int:
        with device_context(self.device):
            return self._drain_guarded()

    def serve_forever(self, poll_s: float = 1e-3) -> None:
        """Blocking drain loop (run on a dedicated thread); stop() exits it.

        Warms the bucket plans then raises ``serve.ready`` (readiness) and
        stamps ``serve.heartbeat_ts`` every iteration (liveness) — the
        gauges behind ``/readyz`` and ``/healthz``.  On CUDA the loop runs
        under ``torch.cuda.device(self.device)``.
        """
        with device_context(self.device):
            self._loop_enter()
            try:
                while not self._stopped.is_set():
                    if self._drain_guarded() == 0:
                        self._stopped.wait(poll_s)
            finally:
                self._loop_exit()

    async def serve_forever_async(self, poll_s: float = 1e-3) -> None:
        """Same loop for an asyncio host.  Each drain (plan execution +
        device sync, potentially hundreds of ms per batch) runs on a worker
        thread so request-ingestion / health-check coroutines keep
        interleaving on the event loop."""
        import asyncio

        await asyncio.to_thread(self._loop_enter)
        try:
            while not self._stopped.is_set():
                if await asyncio.to_thread(self._drain_on_device) == 0:
                    await asyncio.sleep(poll_s)
        finally:
            self._loop_exit()

    def stop(self) -> None:
        self._stopped.set()


def _pad_batch(g: GraphBatch, n_rows: int) -> GraphBatch:
    """Append ``n_rows`` empty graphs (all-padding rows) to a batch, on the
    batch's device."""

    def pad(x, fill):
        return torch.cat([x, torch.full((n_rows,) + tuple(x.shape[1:]), fill,
                                        dtype=x.dtype, device=x.device)])

    return GraphBatch(adj=pad(g.adj, False), mask=pad(g.mask, False),
                      f=pad(g.f, float("inf")))
