"""SimilarityServe: graph-similarity queries over TopoServe + TopoIndex
(counterpart of ``repro.serve.similarity``).

The third serving surface (after stateless TopoServe and session-ful
StreamServe): a client submits a *graph* and gets back the ``k`` nearest
*indexed* graphs with their diagram distances.  The drain is **two-phase**
— the same coarse→exact shape PR 4 gave reduce→repack→persist:

```
submit(edges, n, f, k) ──► TopoServe.submit          (bucketed PD batch path)
drain() ──► TopoServe.drain()                         (diagrams computed)
        ──► stage 1 (retrieve): ONE TopoIndex.query per shape group for
            top k·overfetch candidates — the pairwise_l1 Gram kernel,
            itself optionally LSH-prefiltered inside the index (on the
            device's hamming_scan kernel with ``sharded=True``)
        ──► stage 2 (re-rank, ``rerank="exact_w"``): batched auction-LAP
            exact Wasserstein between each query diagram and its
            candidates' stored compacted clouds, one MetricEngine
            ``compare_info`` per shape group (the auction_lap_collapsed
            kernel)
        ──► resolve SimilarityFuture(ids, distances, backends, diagrams)
```

``stage1_backend="exact_w"`` replaces the retrieve funnel entirely: stage 1
scores every query against **every** stored cloud with the exact metric —
recall 1.0 by construction, no overfetch/re-rank — which the
reservoir-collapsed forward/reverse auction plus the **price cache** makes
viable.  Every exact solve (stage-1 exact or stage-2 re-rank) routes
through one ``_exact_pairs`` helper that warm-starts the solver from an
LRU of converged price vectors keyed by ``(query LSH bucket code,
candidate row)`` (``repro_torch.metrics.price_cache``): near-duplicate queries
land in the same hyperplane bucket and inherit each other's equilibrium
prices across drains.

``stats`` reports the stages separately (``stage1_candidates``,
``stage2_pairs``, per-stage wall seconds), plus the auction telemetry
(``auction_rounds``, ``warm_start_hits``/``misses``), and every resolved
distance carries its backend label (``"gram"`` vs ``"exact_w"``) so
clients never mix the coarse and exact distance scales silently.

Indexing goes through the same diagram path (``add`` submits to the inner
server and indexes at drain), so corpus and queries share compiled plans
and the embedding contract of ``TopoIndex`` — a graph served from any
padding bucket lands in the same embedding space.

With ``repack="on"`` (pass it to the constructor, or set it on the
``TopoServeConfig``) queries and corpus adds are no longer persisted at
their *input*-shape bucket caps: the inner server's two-phase plans route
every reduced graph through the one serve-wide persist ladder
(``repro_torch.serve.topo_serve.repack_ladder_for`` — the same helper
TopoServe uses, so there is exactly one bucket-ladder definition), and
similarity queries share reduced-size persist plans with every other
serving surface in the process.

The inner server and a new index run on ``device`` (CUDA unless
``device="cpu"``).  ``sharded=True`` wraps the index in the port's
one-process :class:`~repro_torch.index.ShardedIndex` over ``index_mesh``
(a :func:`repro_torch.launch.make_index_mesh` grid).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch._device import device_context, resolve_device
from repro_torch.core.persistence import Diagrams
from repro_torch.index.sharded_index import ShardedIndex
from repro_torch.index.topo_index import TopoIndex, TopoIndexConfig
from repro_torch.metrics.engine import compare_info
from repro_torch.metrics.price_cache import PriceCache
from repro_torch.obs import flight as _flight
from repro_torch.obs.context import DeadlineExceeded, resolve_submit
from repro_torch.serve.futures import ServeFuture
from repro_torch.serve.topo_serve import (
    TopoFuture,
    TopoServe,
    TopoServeConfig,
)

RERANKS = ("off", "exact_w")
STAGE1_BACKENDS = ("gram", "exact_w")
_FIELDS = ("birth", "death", "dim", "valid")

# TopoScope instruments (one series per server instance); ``stats`` is a
# dict-shaped view over these.  stage1/stage2 wall-seconds are float
# counters — same semantics as the pre-TopoScope accumulators.
_C_EVENTS = obs.counter(
    "similarity.events",
    help="queries resolved / graphs indexed / add failures")
_C_STAGE = obs.counter(
    "similarity.stage_totals",
    help="stage1 candidates fetched, stage2 exact pairs, per-stage seconds")
_H_STAGE_S = obs.histogram(
    "similarity.stage_seconds", help="per-drain stage wall time")

# auction solver telemetry for the exact_w paths (stage-1 exact backend and
# the stage-2 re-rank both route through _exact_pairs); the warm-start
# hit/miss counts live with the cache itself (metrics/price_cache.py)
_C_ROUNDS = obs.counter(
    "auction.rounds",
    help="total bidding rounds spent by serve-side exact_w solves")
_H_ROUNDS = obs.histogram(
    "auction.rounds_per_pair",
    help="mean auction rounds per pair, one observation per exact batch")

# TopoWatch request-outcome instruments shared with the other frontends
# (bucket="query"), plus the liveness/readiness gauges for /healthz//readyz.
_C_DEADLINE = obs.counter("serve.deadline_exceeded")
_C_CANCELLED = obs.counter("serve.cancelled")
_H_LATENCY = obs.histogram("serve.request_latency_seconds")
_G_HEARTBEAT = obs.gauge("serve.heartbeat_ts")
_G_READY = obs.gauge("serve.ready")
_BUCKET = "query"


@dataclasses.dataclass(frozen=True)
class SimilarityResult:
    """kNN answer for one query graph: parallel id/distance lists plus the
    query's own Diagrams slice (so clients can inspect or re-index it).
    ``backends[i]`` names the metric backend that produced ``distances[i]``
    (``"gram"`` embedding-L1, or ``"exact_w"`` after the re-rank stage)."""

    ids: tuple[str, ...]
    distances: tuple[float, ...]
    diagrams: object  # per-graph Diagrams row (fields shaped (S,))
    backends: tuple[str, ...] = ()


class SimilarityFuture(ServeFuture):
    """Handle for one similarity query; resolves to a SimilarityResult.

    ``cancel()`` also cancels the inner PD future, so a cancelled query
    skips BOTH phases: the bucketed diagram batch slot and the
    retrieve/re-rank work.
    """

    __slots__ = ("k", "inner")

    def __init__(self, k: int, request_id: Optional[str] = None,
                 deadline: Optional[float] = None,
                 inner: Optional[TopoFuture] = None):
        super().__init__(request_id=request_id, deadline=deadline)
        self.k = k
        self.inner = inner

    def cancel(self) -> bool:
        won = super().cancel()
        if won and self.inner is not None:
            self.inner.cancel()
        return won


def _stack_by_shape(rows):
    """Group per-graph Diagrams rows by leaf shape and stack each group.

    Rows resolved in one drain can come from different padding buckets and
    therefore carry different tensor sizes S; the embedding is S-independent
    but ``torch.stack`` is not, so batching happens per shape class.  Yields
    ``(original_indices, stacked_batch)``.
    """
    groups: dict[tuple, list[int]] = {}
    for i, r in enumerate(rows):
        groups.setdefault(tuple(r.birth.shape), []).append(i)
    for idxs in groups.values():
        batch = Diagrams(*(torch.stack([getattr(rows[i], k) for i in idxs])
                           for k in _FIELDS))
        yield idxs, batch


class SimilarityServe:
    """Similarity-search front end over a TopoServe and a TopoIndex.

    >>> server = SimilarityServe(device="cpu")
    >>> server.add(edges=[(0, 1), (1, 2), (2, 0)], n_vertices=3, gid="tri")
    >>> fut = server.submit(edges=[(0, 1), (1, 2)], n_vertices=3, k=1)
    >>> server.drain()
    >>> fut.result().ids
    ('tri',)
    """

    def __init__(self, index: TopoIndex | None = None,
                 config: TopoServeConfig | None = None,
                 index_config: TopoIndexConfig | None = None,
                 default_k: int = 5, device=None,
                 repack: str | None = None,
                 rerank: str = "off", overfetch: int = 4,
                 stage1_backend: str = "gram",
                 price_cache_size: int = 4096,
                 sharded: bool = False, index_mesh=None):
        if rerank not in RERANKS:
            raise ValueError(f"unknown rerank {rerank!r}; want {RERANKS}")
        if stage1_backend not in STAGE1_BACKENDS:
            raise ValueError(f"unknown stage1_backend {stage1_backend!r}; "
                             f"want {STAGE1_BACKENDS}")
        self.device = resolve_device(device)
        # sharded=True swaps in the mesh-sharded index flavor; every drain
        # path below only touches the shared TopoIndex query surface
        # (add/query/clouds/query_codes/ids/config/device), so stage-1
        # retrieval, the stage-2 exact re-rank (shard-owner cloud gathers),
        # stats and obs counters all ride the sharded index transparently
        if index is not None:
            self.index = (ShardedIndex.from_index(index, mesh=index_mesh)
                          if sharded and not isinstance(index, ShardedIndex)
                          else index)
        elif sharded:
            self.index = ShardedIndex(index_config, mesh=index_mesh,
                                      device=self.device)
        else:
            self.index = TopoIndex(index_config, device=self.device)
        if repack is not None:
            config = dataclasses.replace(config or TopoServeConfig(),
                                         repack=repack)
        # the inner TopoServe owns bucket routing AND (repack="on") the
        # measure/repack helper + persist ladder — similarity queries are
        # re-bucketed by their *reduced* shape, not just their input shape
        self.server = TopoServe(config, device=self.device)
        self.default_k = int(default_k)
        self.rerank = rerank
        self.stage1_backend = stage1_backend
        self.overfetch = max(int(overfetch), 1)
        self._lock = threading.Lock()
        # serializes drains: the TopoIndex is not internally synchronized, so
        # concurrent index.add/query (embedding store mutation) must not race
        self._drain_lock = threading.Lock()
        self._pending_queries: list[tuple[TopoFuture, SimilarityFuture]] = []
        self._pending_adds: list[tuple[TopoFuture, Optional[str]]] = []
        self._stopped = threading.Event()
        self._obs_instance = obs.next_instance("sim")
        # converged price vectors for exact_w warm starts, keyed by
        # (query LSH bucket code, candidate row); used by _exact_pairs
        self._price_cache = PriceCache(price_cache_size,
                                       instance=self._obs_instance)

    @property
    def stats(self) -> dict:
        """Dict-shaped view over the TopoScope registry (backward compat
        with the pre-TopoScope ad-hoc ``stats`` dict, same keys)."""
        inst = self._obs_instance
        return {
            "queries": int(_C_EVENTS.value(instance=inst, event="query")),
            "indexed": int(_C_EVENTS.value(instance=inst, event="indexed")),
            "add_failures": int(_C_EVENTS.value(instance=inst,
                                                event="add_failure")),
            "stage1_candidates": int(_C_STAGE.value(instance=inst,
                                                    what="candidates",
                                                    stage="1")),
            "stage2_pairs": int(_C_STAGE.value(instance=inst, what="pairs",
                                               stage="2")),
            "stage1_s": float(_C_STAGE.value(instance=inst, what="seconds",
                                             stage="1")),
            "stage2_s": float(_C_STAGE.value(instance=inst, what="seconds",
                                             stage="2")),
            "cancelled": int(_C_CANCELLED.total(instance=inst)),
            "deadline_exceeded": int(_C_DEADLINE.total(instance=inst)),
            "auction_rounds": int(_C_ROUNDS.value(instance=inst)),
            "warm_start_hits": self._price_cache.hits,
            "warm_start_misses": self._price_cache.misses,
        }

    # ------------------------------------------------------------- ingest

    def add(self, edges: Sequence[tuple[int, int]], n_vertices: int,
            f: Sequence[float] | None = None,
            gid: Optional[str] = None) -> None:
        """Enqueue one graph for indexing (takes effect at the next drain)."""
        fut = self.server.submit(edges=edges, n_vertices=n_vertices, f=f)
        with self._lock:
            self._pending_adds.append((fut, gid))

    def submit(self, edges: Sequence[tuple[int, int]], n_vertices: int,
               f: Sequence[float] | None = None,
               k: int | None = None, *,
               request_id: Optional[str] = None,
               deadline_s: Optional[float] = None) -> SimilarityFuture:
        """Enqueue one similarity query; resolved by a later ``drain()``.

        The request id and deadline are minted once here and shared with
        the inner PD future, so an expired query is swept out of the
        bucketed batch by TopoServe's drain (counted there, per bucket)
        and the similarity layer just propagates the ``DeadlineExceeded``.
        """
        rid, deadline = resolve_submit(request_id, deadline_s)
        rem = (None if deadline is None
               else deadline - time.monotonic())
        fut = self.server.submit(edges=edges, n_vertices=n_vertices, f=f,
                                 request_id=rid, deadline_s=rem)
        sim = SimilarityFuture(
            k=int(k) if k is not None else self.default_k,
            request_id=rid, deadline=deadline, inner=fut)
        with self._lock:
            self._pending_queries.append((fut, sim))
        return sim

    def pending(self) -> int:
        with self._lock:
            return len(self._pending_queries) + len(self._pending_adds)

    def repack_rungs(self) -> dict:
        """(bucket n_pad, persist rung n_pad) -> graphs, from the inner
        server (empty unless ``repack="on"``)."""
        return dict(self.server.stats["repack_rungs"])

    # ------------------------------------------------------------- drain

    def drain(self) -> int:
        """Drain the inner server, index pending adds, answer queries.

        Adds are indexed before queries are answered, so a corpus graph and
        a query submitted before the same drain see each other.  Items whose
        inner future is still unresolved (submitted concurrently with this
        drain, after the inner server flushed) stay pending for the next
        drain.  Returns the number of similarity queries resolved.
        """
        with self._drain_lock:
            self.server.drain()
            with self._lock:
                adds, self._pending_adds = self._pending_adds, []
                queries, self._pending_queries = self._pending_queries, []

            done_adds, later_adds = [], []
            for (f, gid) in adds:
                if not f.done():  # raced a concurrent submit: keep for later
                    later_adds.append((f, gid))
                    continue
                try:
                    done_adds.append((f.result(timeout=0), gid))
                except Exception:  # a failed PD batch must not wedge indexing
                    _C_EVENTS.inc(instance=self._obs_instance,
                                  event="add_failure")
            for idxs, batch in _stack_by_shape([r for (r, _) in done_adds]):
                ids = [done_adds[i][1] for i in idxs]
                try:
                    self.index.add(
                        batch, ids=None if all(i is None for i in ids)
                        else [i if i is not None
                              else f"g{len(self.index) + j}"
                              for j, i in enumerate(ids)])
                    _C_EVENTS.inc(len(idxs), instance=self._obs_instance,
                                  event="indexed")
                except Exception:  # e.g. duplicate gid: drop group, continue
                    _C_EVENTS.inc(len(idxs), instance=self._obs_instance,
                                  event="add_failure")

            resolved = 0
            ready: list[tuple[object, SimilarityFuture]] = []
            later_queries = []
            now = time.monotonic()
            for (f, sim) in queries:
                if sim.cancelled():
                    # inner future already cancelled too (linked cancel);
                    # skip the retrieve/re-rank work entirely
                    _C_CANCELLED.inc(instance=self._obs_instance,
                                     bucket=_BUCKET)
                    _flight.record("serve", "cancelled_skip",
                                   frontend="similarity",
                                   rid=sim.request_id or "")
                    continue
                if sim.expired(now) and not f.done():
                    # inner sweep has not seen it yet (e.g. manual drain
                    # raced); fail here rather than hold the query over
                    if sim._fail(DeadlineExceeded(
                            f"similarity query {sim.request_id or '?'} "
                            "expired before drain pickup")):
                        _C_DEADLINE.inc(instance=self._obs_instance,
                                        bucket=_BUCKET)
                        _flight.auto_dump("deadline_exceeded")
                    continue
                if not f.done():
                    later_queries.append((f, sim))
                    continue
                try:
                    ready.append((f.result(timeout=0), sim))
                except Exception as e:  # propagate batch failure, don't wedge
                    sim._fail(e)
            if later_adds or later_queries:
                with self._lock:  # prepend: next drain sees FIFO order
                    self._pending_adds[:0] = later_adds
                    self._pending_queries[:0] = later_queries
            if not ready:
                return 0
            if not len(self.index):
                err = ValueError("similarity query against an empty index "
                                 "(add() graphs before querying)")
                for (_, sim) in ready:
                    sim._fail(err)
                return 0
            for idxs, batch in _stack_by_shape([r for (r, _) in ready]):
                sims = [ready[i][1] for i in idxs]
                try:
                    k_max = max(sim.k for sim in sims)
                    if self.stage1_backend == "exact_w":
                        # exact stage 1: no retrieve funnel, no stage 2 —
                        # every corpus entry is scored exactly already
                        ids, dists, backends = self._stage1_exact(
                            batch, k_max)
                    else:
                        k_fetch = (k_max * self.overfetch
                                   if self.rerank != "off" else k_max)
                        t0 = time.perf_counter()
                        with obs.span("similarity.stage1",
                                      frontend="similarity",
                                      k=k_fetch) as sp1:
                            res = self.index.query(batch, k=k_fetch)
                            n_cand = sum(len(row) for row in res.ids)
                            sp1.set(candidates=n_cand)
                        dt1 = time.perf_counter() - t0
                        inst = self._obs_instance
                        _C_STAGE.inc(dt1, instance=inst, what="seconds",
                                     stage="1")
                        _C_STAGE.inc(n_cand, instance=inst,
                                     what="candidates", stage="1")
                        _H_STAGE_S.observe(dt1, instance=inst, stage="1")
                        ids, dists, backends = (res.ids, res.distances,
                                                res.backends)
                        if self.rerank == "exact_w":
                            with obs.span("similarity.stage2",
                                          frontend="similarity") as sp2:
                                ids, dists, backends = self._rerank_exact(
                                    batch, res)
                                sp2.set(pairs=res.rows.shape[0]
                                        * res.rows.shape[1])
                except Exception as e:  # resolve, never wedge waiting clients
                    for sim in sims:
                        sim._fail(e)
                    continue
                for j, (i, sim) in enumerate(zip(idxs, sims)):
                    kk = min(sim.k, len(ids[j]))
                    if sim._resolve(SimilarityResult(
                        ids=tuple(ids[j][:kk]),
                        distances=tuple(float(x) for x in dists[j][:kk]),
                        diagrams=ready[i][0],
                        backends=tuple(backends[j][:kk]),
                    )):
                        _H_LATENCY.observe(sim.latency_s(),
                                           instance=self._obs_instance,
                                           bucket=_BUCKET)
                        resolved += 1
            if resolved:
                _C_EVENTS.inc(resolved, instance=self._obs_instance,
                              event="query")
            return resolved

    # ------------------------------------------------------------- loops

    def serve_forever(self, poll_s: float = 1e-3) -> None:
        """Blocking drain loop (run on a dedicated thread); stop() exits.

        Warms the inner TopoServe's bucket plans before raising
        ``serve.ready{frontend=similarity}``, and stamps
        ``serve.heartbeat_ts`` each iteration — same liveness/readiness
        contract as the other frontends (obs/http.py).
        """
        inst = self._obs_instance
        _flight.record("serve", "loop_start", frontend="similarity",
                       instance=inst)
        self.server.warmup()
        _G_HEARTBEAT.set(time.time(), frontend="similarity", instance=inst)
        _G_READY.set(1, frontend="similarity", instance=inst)
        try:
            with device_context(self.device):
                while not self._stopped.is_set():
                    _G_HEARTBEAT.set(time.time(), frontend="similarity",
                                     instance=inst)
                    try:
                        n = self.drain()
                    except BaseException as e:
                        _flight.record("serve", "drain_exception",
                                       frontend="similarity", error=repr(e))
                        _flight.auto_dump("drain_exception")
                        raise
                    if n == 0 and not self.pending():
                        self._stopped.wait(poll_s)
        finally:
            _G_READY.set(0, frontend="similarity", instance=inst)
            _flight.record("serve", "loop_stop", frontend="similarity",
                           instance=inst)

    def stop(self) -> None:
        self._stopped.set()

    # -------------------------------------------------------- exact solves

    def _exact_pairs(self, batch, rows):
        """exact_w distances for row-aligned (Q, C) query×candidate pairs.

        The one exact-solve path the stage-1 exact backend and the stage-2
        re-rank share: gathers the candidates' stored compacted clouds,
        warm-starts the collapsed auction from the price cache (keyed by
        query LSH bucket code × candidate row), pads the pair count to the
        next power of two (a bounded ladder of batch shapes), and stores
        the converged price vectors back for later drains.  The distances,
        rounds, prices and convergence flags come to the host in one copy
        each.  Returns the (Q, C) float32 distance matrix.
        """
        q, c = rows.shape
        cfg = self.index.config
        dev = self.index.device
        cand = self.index.clouds(rows)        # fields (Q, C, n_points)
        batch = batch.to(dev)
        left = Diagrams(*(x[:, None].expand((q, c) + tuple(x.shape[1:]))
                          for x in (getattr(batch, k) for k in _FIELDS)))
        codes = self.index.query_codes(batch)
        prices0, _, _ = self._price_cache.lookup(codes, rows, cfg.n_points)
        qc = q * c
        r = 1 << (qc - 1).bit_length()

        def one(x):
            x = x.reshape((qc,) + tuple(x.shape[2:]))
            if r == qc:
                return x
            return torch.cat([x, x[:1].expand((r - qc,) + tuple(x.shape[1:]))])

        def flat_pad(d):
            return Diagrams(*(one(getattr(d, k)) for k in _FIELDS))

        w, conv, rounds, prices = compare_info(
            flat_pad(left), flat_pad(cand), metric="exact_w", k=cfg.k,
            cap=cfg.cap, n_points=cfg.n_points,
            prices=one(torch.from_numpy(prices0).to(dev)))
        rounds = rounds[:qc].cpu().numpy()
        inst = self._obs_instance
        _C_ROUNDS.inc(int(rounds.sum()), instance=inst)
        _H_ROUNDS.observe(float(rounds.mean()), instance=inst)
        self._price_cache.store(
            codes, rows, prices[:qc].cpu().numpy().reshape(q, c, -1),
            conv[:qc].cpu().numpy().reshape(q, c))
        return w[:qc].cpu().numpy().reshape(q, c)

    def _stage1_exact(self, batch, k_max):
        """Stage 1 with ``stage1_backend="exact_w"``: score the whole corpus.

        Every query is matched exactly against **every** stored cloud — no
        retrieve funnel, so recall is 1.0 by construction and there is no
        stage 2.  Q·N auction solves per drain, made viable by the
        collapsed solver and the price-cache warm starts; reported under
        ``stage="1"`` so ``stats`` separates it from the gram stage.
        """
        q = batch.birth.shape[0]
        n = len(self.index)
        rows = np.broadcast_to(np.arange(n), (q, n))
        t0 = time.perf_counter()
        with obs.span("similarity.stage1", frontend="similarity",
                      backend="exact_w", k=k_max) as sp1:
            d = self._exact_pairs(batch, rows)
            sp1.set(candidates=q * n)
        dt1 = time.perf_counter() - t0
        inst = self._obs_instance
        _C_STAGE.inc(dt1, instance=inst, what="seconds", stage="1")
        _C_STAGE.inc(q * n, instance=inst, what="candidates", stage="1")
        _H_STAGE_S.observe(dt1, instance=inst, stage="1")
        kk = min(int(k_max), n)
        order = np.argsort(d, axis=-1, kind="stable")[:, :kk]
        ids_all = self.index.ids
        ids = [[ids_all[j] for j in row] for row in order]
        dists = np.take_along_axis(d, order, axis=-1).astype(np.float32)
        backends = [["exact_w"] * kk for _ in range(q)]
        return ids, dists, backends

    # ------------------------------------------------------------- rerank

    def _rerank_exact(self, batch, res):
        """Stage 2: exact re-rank of the stage-1 candidates.

        One batched ``compare_info(metric="exact_w")`` (via
        :meth:`_exact_pairs`, so re-rank solves share the price-cache warm
        starts) between the query diagrams and the candidates' stored
        clouds.  Returns ``(ids, dists, backends)`` reordered by exact
        distance.
        """
        rows = res.rows                             # (Q, C) index rows
        q, c = rows.shape
        t0 = time.perf_counter()
        d = self._exact_pairs(batch, np.asarray(rows))
        order = np.argsort(d, axis=-1, kind="stable")
        dt2 = time.perf_counter() - t0
        inst = self._obs_instance
        _C_STAGE.inc(q * c, instance=inst, what="pairs", stage="2")
        _C_STAGE.inc(dt2, instance=inst, what="seconds", stage="2")
        _H_STAGE_S.observe(dt2, instance=inst, stage="2")
        ids = [[res.ids[i][j] for j in order[i]] for i in range(q)]
        dists = np.take_along_axis(d, order, axis=-1).astype(np.float32)
        backends = [["exact_w"] * c for _ in range(q)]
        return ids, dists, backends
