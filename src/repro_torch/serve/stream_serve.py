"""StreamServe: stateful TopoStream sessions behind a TopoServe-style API
(counterpart of ``repro.serve.stream_serve``).

TopoServe (topo_serve.py) serves stateless one-shot queries; StreamServe
gives the serving layer *sessions*: a client registers a GraphBatch once,
then keeps submitting :class:`~repro_torch.core.delta.DeltaBatch` updates
to its session id.  ``drain()`` applies each session's queued updates in
submission order through its :class:`~repro_torch.stream.TopoStream` (on
CUDA each step's verdict launches ``kcore_peel`` and ``domination``, and
its recompute the plan's kernels) — so most ticks are
answered from cache by the reduction-aware invalidation check — and resolves
the futures with the fresh-or-cached diagrams plus that step's
hit/miss/recompute verdict.

Same sync-first design as TopoServe: ``submit``/``drain`` under one lock,
``serve_forever`` for a dedicated drain thread.  The counter surface
(``stats()``, ``session_stats(sid)``) exposes cumulative hits, coral/prunit
hit split, recomputes and skip rate, per session and aggregated.  Every
session runs on the server's ``device`` (CUDA unless ``device="cpu"``).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional

from repro_torch import obs
from repro_torch._device import device_context, resolve_device
from repro_torch.core.delta import DeltaBatch
from repro_torch.core.graph import GraphBatch
from repro_torch.core.persistence import Diagrams
from repro_torch.obs import flight as _flight
from repro_torch.obs.context import DeadlineExceeded, resolve_submit
from repro_torch.serve.futures import ServeFuture
from repro_torch.stream.topo_stream import TopoStream, TopoStreamConfig

# aggregate per-step outcome keys (the ``stats()`` surface)
_AGG_KEYS = ("graph_updates", "hits", "coral_hits", "prunit_hits",
             "recomputes", "anomalies")

# TopoScope instruments, one series per server instance.  Aggregates are
# incremented per applied step in ``_apply_items`` — i.e. UNDER the
# session's apply lock — fixing the pre-TopoScope inconsistency where
# ``stats()`` folded live session dicts and ``_closed_stats`` outside it
# (a drain racing a close could double- or under-count a step).
_C_STEPS = obs.counter(
    "stream.steps", help="per-step verdict outcomes, aggregated per server")
_C_OPENED = obs.counter("stream.sessions_opened")
_C_CLOSED = obs.counter("stream.sessions_closed")
_G_LIVE = obs.gauge("stream.sessions_live",
                    help="currently registered sessions per server")

# TopoWatch request-outcome instruments are SHARED with TopoServe (same
# registry names, bucket="session"), so the serve-wide SLO ratios in
# obs/slo.py — deadline misses / submissions, failures / submissions —
# see every frontend's traffic with one selector.
_C_SUBMITTED = obs.counter("serve.submitted")
_C_FAILED = obs.counter("serve.failed")
_C_DEADLINE = obs.counter("serve.deadline_exceeded")
_C_CANCELLED = obs.counter("serve.cancelled")
_H_LATENCY = obs.histogram("serve.request_latency_seconds")
_G_HEARTBEAT = obs.gauge("serve.heartbeat_ts")
_G_READY = obs.gauge("serve.ready")
_BUCKET = "session"  # stream steps have no padding bucket


class StreamFuture(ServeFuture):
    """Handle for one submitted update step; resolved by a later drain.

    ``result()`` returns the session's maintained Diagrams as of this step;
    ``info`` (available once done) is that step's verdict summary:
    ``{"graph_updates", "hits", "coral_hits", "prunit_hits", "recomputes",
    "anomalies"}`` plus, when the session scores drift
    (``TopoStreamConfig.drift_metric``), ``"drift"`` — the per-graph
    diagram-distance array of this step — and ``"anomaly"`` — its
    thresholded flags.  Thread-safe plumbing lives in ``ServeFuture``.
    """

    __slots__ = ("info", "session_id")

    def __init__(self, session_id: str, request_id: Optional[str] = None,
                 deadline: Optional[float] = None):
        super().__init__(request_id=request_id, deadline=deadline)
        self.info: Optional[dict] = None
        self.session_id = session_id

    def _resolve(self, value: Diagrams, info: dict) -> bool:  # type: ignore[override]
        self.info = info
        return super()._resolve(value)


class _Session:
    __slots__ = ("sid", "stream", "queue", "apply_lock")

    def __init__(self, sid: str, stream: TopoStream):
        self.sid = sid
        self.stream = stream
        self.queue: deque = deque()
        # serializes appliers: TopoStream is stateful, so concurrent drains
        # (serve_forever thread + a manual drain) must not interleave a
        # session's steps
        self.apply_lock = threading.Lock()


class StreamServe:
    """Session manager: one TopoStream per session id, drained like a server.

    >>> server = StreamServe(device="cpu")
    >>> sid = server.create_session(g0)
    >>> fut = server.submit(sid, delta)
    >>> server.drain()
    1
    >>> diagrams, verdict = fut.result(), fut.info
    """

    def __init__(self, config: TopoStreamConfig | None = None, device=None):
        self.config = config or TopoStreamConfig()
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._sessions: dict[str, _Session] = {}
        self._next_id = 0
        self._stopped = threading.Event()
        self._obs_instance = obs.next_instance("stream")

    # ----------------------------------------------------------- sessions

    def create_session(self, g: GraphBatch,
                       config: TopoStreamConfig | None = None) -> str:
        """Register a GraphBatch (moved to the server's device); computes
        its initial diagrams eagerly."""
        with obs.span("stream.init", frontend="stream"):
            stream = TopoStream(g, config or self.config, device=self.device)
        with self._lock:
            sid = f"s{self._next_id}"
            self._next_id += 1
            self._sessions[sid] = _Session(sid, stream)
        _C_OPENED.inc(instance=self._obs_instance)
        _G_LIVE.inc(instance=self._obs_instance)
        return sid

    def close_session(self, sid: str) -> dict:
        """Drop a session; returns its final stats.  Pending futures fail.

        Takes the session's apply lock so an in-flight drain finishes its
        current items first; queue hand-off happens under the global lock so
        a future is failed by close XOR resolved by a drain, never both.
        """
        with self._lock:
            sess = self._sessions.pop(sid, None)
        if sess is None:
            raise KeyError(f"unknown session {sid!r}")
        with sess.apply_lock:
            with self._lock:
                pending = list(sess.queue)
                sess.queue.clear()
            for (_, fut) in pending:
                fut._fail(RuntimeError(f"session {sid} closed before drain"))
            # aggregates need no folding: _apply_items already counted every
            # applied step into the registry, and those counters outlive the
            # session
            _C_CLOSED.inc(instance=self._obs_instance)
            _G_LIVE.dec(instance=self._obs_instance)
            return dict(sess.stream.stats)

    def diagrams(self, sid: str) -> Diagrams:
        """Current maintained diagrams of a session (no queue interaction)."""
        return self._session(sid).stream.diagrams

    def graph(self, sid: str) -> GraphBatch:
        return self._session(sid).stream.graph

    def _session(self, sid: str) -> _Session:
        with self._lock:
            sess = self._sessions.get(sid)
        if sess is None:
            raise KeyError(f"unknown session {sid!r}")
        return sess

    # ------------------------------------------------------------- ingest

    def submit(self, sid: str, delta: DeltaBatch, *,
               request_id: Optional[str] = None,
               deadline_s: Optional[float] = None) -> StreamFuture:
        """Enqueue one update step for a session (FIFO per session).

        Request id and optional deadline follow the TopoServe contract
        (explicit args > ambient ``obs.request_context()`` > fresh mint);
        expired steps are failed with ``DeadlineExceeded`` by the drain
        sweep, cancelled ones are skipped — a skipped step is NOT applied,
        so later steps of the session still see the pre-step state.
        """
        sess = self._session(sid)
        if delta.edge_u.ndim != 2:
            raise ValueError(
                "submit() takes one update step (leaves shaped (B, slots)); "
                "slice stacked streams with repro_torch.core.delta.delta_step")
        if delta.batch != sess.stream.graph.batch:
            raise ValueError(
                f"delta batch {delta.batch} != session batch "
                f"{sess.stream.graph.batch}")
        rid, deadline = resolve_submit(request_id, deadline_s)
        fut = StreamFuture(sid, request_id=rid, deadline=deadline)
        with self._lock:
            # re-check under the lock: a concurrent close_session may have
            # popped the session after _session() returned it — appending to
            # the dead queue would orphan the future (never failed, never
            # resolved)
            if self._sessions.get(sid) is not sess:
                raise KeyError(f"session {sid!r} closed")
            sess.queue.append((delta, fut))
        _C_SUBMITTED.inc(instance=self._obs_instance, bucket=_BUCKET)
        return fut

    def pending(self) -> int:
        with self._lock:
            return sum(len(s.queue) for s in self._sessions.values())

    # -------------------------------------------------------------- drain

    def drain(self) -> int:
        """Apply every queued update, session by session, in FIFO order.

        Returns the number of update steps applied.  A failing step fails
        its own future and every later future of the same session (their
        base state is gone), then the session queue is cleared.
        """
        if not self.pending():
            return 0  # keep idle poll loops out of the trace
        with obs.span("stream.drain", frontend="stream") as sp:
            applied = 0
            while True:
                with self._lock:
                    # snapshot so one hot session cannot starve the others:
                    # each pass gives every queued session one turn
                    queued = [s for s in self._sessions.values() if s.queue]
                if not queued:
                    sp.set(applied=applied)
                    return applied
                for sess in queued:
                    # take the apply lock BEFORE popping: a concurrent drain
                    # of the same session blocks here, then pops strictly
                    # later items, so per-session FIFO order survives
                    # concurrent drains
                    with sess.apply_lock:
                        with self._lock:
                            items = list(sess.queue)
                            sess.queue.clear()
                        applied += self._apply_items(sess, items)

    def _apply_items(self, sess: _Session, items: list) -> int:
        applied = 0
        inst = self._obs_instance
        for i, (delta, fut) in enumerate(items):
            # TopoWatch sweep: a cancelled/expired step is NOT applied, so
            # the stream state stays exactly as if it was never submitted
            if fut.cancelled():
                _C_CANCELLED.inc(instance=inst, bucket=_BUCKET)
                _flight.record("serve", "cancelled_skip", frontend="stream",
                               session=sess.sid, rid=fut.request_id or "")
                continue
            if fut.expired():
                if fut._fail(DeadlineExceeded(
                        f"stream step {fut.request_id or '?'} expired "
                        f"before drain pickup (session {sess.sid})")):
                    _C_DEADLINE.inc(instance=inst, bucket=_BUCKET)
                    _flight.record("serve", "deadline_exceeded",
                                   frontend="stream", session=sess.sid,
                                   rid=fut.request_id or "")
                    _flight.auto_dump("deadline_exceeded")
                continue
            before = dict(sess.stream.stats)
            try:
                with obs.span("stream.step", session=sess.sid):
                    d = sess.stream.apply(delta)
            except Exception as e:
                n_failed = sum(1 for (_, later) in items[i:]
                               if later._fail(e))
                if n_failed:
                    _C_FAILED.inc(n_failed, instance=inst)
                _flight.record("serve", "step_failed", frontend="stream",
                               session=sess.sid, error=repr(e))
                break
            after = sess.stream.stats
            info = {k: after[k] - before[k] for k in _AGG_KEYS}
            # aggregate registry counters, incremented under the apply lock
            # every caller of this method holds (see drain/close_session)
            for k, v in info.items():
                if v:
                    _C_STEPS.inc(v, instance=inst, key=k)
            if sess.stream.config.drift_metric is not None:
                # host arrays of this step, copied: the stream replaces
                # them at its next step
                info["drift"] = sess.stream.last_drift.copy()
                info["anomaly"] = sess.stream.last_anomaly.copy()
            if fut._resolve(d, info):
                _H_LATENCY.observe(fut.latency_s(),
                                   instance=inst, bucket=_BUCKET)
            applied += 1
        return applied

    # --------------------------------------------------------------- loops

    def serve_forever(self, poll_s: float = 1e-3) -> None:
        """Blocking drain loop (run on a dedicated thread); stop() exits.

        Stamps ``serve.heartbeat_ts{frontend=stream}`` each iteration and
        holds ``serve.ready`` high while running (no plan warmup needed:
        sessions compile eagerly at ``create_session``), so ``/healthz`` /
        ``/readyz`` cover this frontend too.
        """
        inst = self._obs_instance
        _flight.record("serve", "loop_start", frontend="stream",
                       instance=inst)
        _G_HEARTBEAT.set(time.time(), frontend="stream", instance=inst)
        _G_READY.set(1, frontend="stream", instance=inst)
        try:
            with device_context(self.device):
                while not self._stopped.is_set():
                    _G_HEARTBEAT.set(time.time(), frontend="stream",
                                     instance=inst)
                    try:
                        n = self.drain()
                    except BaseException as e:
                        _flight.record("serve", "drain_exception",
                                       frontend="stream", error=repr(e))
                        _flight.auto_dump("drain_exception")
                        raise
                    if n == 0:
                        self._stopped.wait(poll_s)
        finally:
            _G_READY.set(0, frontend="stream", instance=inst)
            _flight.record("serve", "loop_stop", frontend="stream",
                           instance=inst)

    def stop(self) -> None:
        self._stopped.set()

    # -------------------------------------------------------------- stats

    def session_stats(self, sid: str) -> dict:
        """One session's cumulative counters plus its skip rate."""
        stream = self._session(sid).stream
        out = dict(stream.stats)
        out["skip_rate"] = stream.skip_rate()
        return out

    def stats(self) -> dict:
        """Aggregate hit/miss/recompute counters over all sessions (live and
        closed) — the serving layer's cache-effectiveness surface.

        A dict-shaped view over the TopoScope registry: steps are counted
        once, at apply time, under the session's apply lock, so this read
        never races a drain or a close (pre-TopoScope it folded per-session
        dicts outside that lock).  Steps applied directly on a session's
        ``TopoStream`` object (bypassing ``submit``/``drain``) are that
        session's business and are not aggregated here.
        """
        inst = self._obs_instance
        with self._lock:
            n_live = len(self._sessions)
        agg = {k: int(_C_STEPS.value(instance=inst, key=k))
               for k in _AGG_KEYS}
        agg["sessions"] = n_live
        agg["sessions_closed"] = int(_C_CLOSED.value(instance=inst))
        agg["skip_rate"] = agg["hits"] / max(agg["graph_updates"], 1)
        return agg
