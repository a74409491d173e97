"""TopoScope tracing: nestable spans -> Chrome-trace (Perfetto) JSON (the
port's copy of ``repro.obs.trace``).

Tracing is the *opt-in* half of TopoScope and is off by default: until
``configure(enabled=True)`` is called (or the process starts with
``REPRO_OBS=1``), ``span(...)`` returns a shared stateless no-op context
manager — the disabled path is one module attribute read plus a call.

When enabled, each span records a complete ("ph": "X") Chrome-trace
event with microsecond timestamps relative to a process epoch, the
owning thread id, its parent span name, and arbitrary attributes
(``span("serve.batch", bucket="n32")`` or ``sp.set(graphs=7)`` from
inside the block).  Nesting is tracked per thread via a thread-local
span stack.  Every completed span also feeds the ``obs.span_seconds``
duration histogram in the metrics registry, so traces and metrics never
disagree about where time went.

``span(..., torch_profiler=True)`` additionally runs the block under
``torch.profiler`` (CPU activity, and CUDA activity when a card is
present) for kernel-level deep dives: the span's ``profiler`` attribute
holds the finished profile (``key_averages()``), and its Chrome trace lands
under the configured ``torch_trace_dir``, named in the span's
``torch_trace`` attribute.
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time
from typing import Any, Optional

from . import flight as _flight
from .context import current as _current_context
from .metrics import DEFAULT_TIME_BUCKETS, default_registry


class _Config:
    __slots__ = ("enabled", "capacity", "torch_trace_dir")

    def __init__(self):
        self.enabled = os.environ.get("REPRO_OBS", "").strip() not in (
            "", "0", "false", "off")
        self.capacity = 200_000
        self.torch_trace_dir = os.environ.get(
            "REPRO_OBS_TORCH_DIR", "results/torch_trace")


_CONFIG = _Config()

# trace buffer: list of Chrome-trace event dicts + overflow accounting
_EVENTS: list[dict] = []
_EVENTS_LOCK = threading.Lock()
_DROPPED = 0

_TLS = threading.local()  # .stack: list of active Span objects
_EPOCH = time.perf_counter()
_PID = os.getpid()
_PROFILE_SEQ = itertools.count()

# spans auto-feed this histogram (one series per span name) when enabled
_SPAN_SECONDS = default_registry().histogram(
    "obs.span_seconds", help="TopoScope span durations by span name",
    buckets=DEFAULT_TIME_BUCKETS)


def configure(enabled: Optional[bool] = None,
              capacity: Optional[int] = None,
              torch_trace_dir: Optional[str] = None) -> None:
    """Flip tracing on/off and tune the event buffer.

    Metrics instruments are unaffected — they are always live.  Only
    span recording (and the span->histogram feed) is gated.
    """
    if enabled is not None:
        _CONFIG.enabled = bool(enabled)
    if capacity is not None:
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        _CONFIG.capacity = int(capacity)
    if torch_trace_dir is not None:
        _CONFIG.torch_trace_dir = torch_trace_dir


def enabled() -> bool:
    return _CONFIG.enabled


def _stack() -> list:
    st = getattr(_TLS, "stack", None)
    if st is None:
        st = _TLS.stack = []
    return st


class _NoopSpan:
    """Singleton returned by span() while tracing is disabled."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


_NOOP = _NoopSpan()


class Span:
    """Live span; created by :func:`span` only while tracing is enabled."""

    __slots__ = ("name", "attrs", "parent", "_t0", "_torch", "profiler")

    def __init__(self, name: str, attrs: dict, torch_profiler: bool):
        self.name = name
        self.attrs = attrs
        self.parent: Optional[str] = None
        self._t0 = 0.0
        self._torch = torch_profiler
        self.profiler = None  # the finished torch.profiler.profile

    def set(self, **attrs) -> "Span":
        """Attach attributes from inside the block (end-of-span facts like
        candidate counts)."""
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        st = _stack()
        if st:
            self.parent = st[-1].name
        st.append(self)
        if self._torch:
            import torch
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self.profiler = profile(activities=acts)
            self.profiler.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        t1 = time.perf_counter()
        if self.profiler is not None:
            self.profiler.__exit__(None, None, None)
            os.makedirs(_CONFIG.torch_trace_dir, exist_ok=True)
            path = os.path.join(
                _CONFIG.torch_trace_dir,
                f"{self.name}-{_PID}-{next(_PROFILE_SEQ)}.json")
            self.profiler.export_chrome_trace(path)
            self.attrs["torch_trace"] = path
        st = _stack()
        if st and st[-1] is self:
            st.pop()
        dur = t1 - self._t0
        args: dict[str, Any] = {}
        if self.parent is not None:
            args["parent"] = self.parent
        if exc_type is not None:
            args["error"] = exc_type.__name__
        for k, v in self.attrs.items():
            args[k] = v if isinstance(v, (int, float, bool, str)) else str(v)
        event = {
            "name": self.name,
            "cat": self.name.split(".", 1)[0],
            "ph": "X",
            "ts": (self._t0 - _EPOCH) * 1e6,
            "dur": dur * 1e6,
            "pid": _PID,
            "tid": threading.get_ident() & 0x7FFFFFFF,
            "args": args,
        }
        global _DROPPED
        with _EVENTS_LOCK:
            if len(_EVENTS) < _CONFIG.capacity:
                _EVENTS.append(event)
            else:
                _DROPPED += 1
        _SPAN_SECONDS.observe(dur, span=self.name)
        # completed spans also feed the always-on flight recorder ring
        # (the recorder additionally gets explicit drain-level records,
        # so it stays useful with tracing off)
        _flight.record("span", self.name, dur_ms=round(dur * 1e3, 3),
                       **({"error": exc_type.__name__}
                          if exc_type is not None else {}))
        return False


def span(name: str, torch_profiler: bool = False, **attrs):
    """Open a nestable trace span; usable as a context manager.

    Disabled path returns a shared no-op (no allocation beyond the
    kwargs dict at the call site).
    """
    if not _CONFIG.enabled:
        return _NOOP
    ctx = _current_context()
    if ctx is not None and "rid" not in attrs:
        # request-context propagation: every span opened under a
        # request_context() carries the request id
        attrs["rid"] = ctx.request_id
    return Span(name, attrs, torch_profiler)


def current_span() -> Optional[Span]:
    """The innermost active span on this thread (None when outside any
    span or tracing is disabled)."""
    st = getattr(_TLS, "stack", None)
    return st[-1] if st else None


def trace_events() -> list[dict]:
    """Copy of the buffered Chrome-trace events."""
    with _EVENTS_LOCK:
        return list(_EVENTS)


def dropped_events() -> int:
    with _EVENTS_LOCK:
        return _DROPPED


def clear_trace() -> None:
    global _DROPPED
    with _EVENTS_LOCK:
        _EVENTS.clear()
        _DROPPED = 0


def export_chrome_trace(path: str) -> str:
    """Write buffered spans as a Chrome-trace JSON object — loadable in
    Perfetto (https://ui.perfetto.dev) or chrome://tracing."""
    events = sorted(trace_events(), key=lambda e: (e["tid"], e["ts"]))
    doc = {
        "displayTimeUnit": "ms",
        "otherData": {"producer": "repro_torch.obs", "dropped": dropped_events()},
        "traceEvents": events,
    }
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as fh:
        json.dump(doc, fh)
    return path
