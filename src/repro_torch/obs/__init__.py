"""TopoScope + TopoWatch: tracing, metrics, SLOs, and serving health (the
port's own copy of ``repro.obs``).

- **Metrics registry** (:mod:`repro_torch.obs.metrics`) — process-wide
  thread-safe counters/gauges/histograms, always live.
- **Tracing** (:mod:`repro_torch.obs.trace`) — nestable ``span()`` context
  managers producing Perfetto-loadable Chrome-trace JSON; off by default,
  enabled via ``REPRO_OBS=1`` or ``obs.configure(enabled=True)``;
  ``span(..., torch_profiler=True)`` runs the block under
  ``torch.profiler``.
- **Request context** (:mod:`repro_torch.obs.context`) — contextvars-scoped
  request ids + absolute deadlines, propagated into spans.
- **Flight recorder** (:mod:`repro_torch.obs.flight`) — always-on bounded
  ring of recent events, dumped to ``results/obs/FLIGHT_<rev>.json`` with
  the metrics snapshot and the SLO verdicts.
- **Export** (:mod:`repro_torch.obs.export`) — Prometheus text and
  JSON-lines snapshots.
- **SLO engine** (:mod:`repro_torch.obs.slo`) — declarative latency/error/
  skip-rate/recall objectives evaluated by multi-window burn-rate rules
  over registry snapshots.
- **Scrape endpoints** (:mod:`repro_torch.obs.http`) — dependency-free
  ``/metrics``, ``/healthz``, ``/readyz``, ``/varz``, ``/slo``,
  ``/debug/flight`` HTTP server, bound to ``127.0.0.1`` by default.
- **Trace report** (:mod:`repro_torch.obs.report`) — top-k self-time
  table over an exported trace, kernel spans labelled with the card's
  roofline cost cells; ``python -m repro_torch.obs report|watch|slo
  check`` is the CLI.

``repro_torch.counters`` (kernel launches, loop rounds) is separate and
stays as it is; every launch also counts in ``kernels.calls``.

Typical instrumentation site::

    from repro_torch import obs

    _CALLS = obs.counter("stream.verdicts")

    def step(x):
        _CALLS.inc(verdict="recompute")
        with obs.span("stream.recompute", misses=len(x)):
            return _impl(x)
"""
from __future__ import annotations

from typing import Iterable

from . import flight
from .context import (
    DeadlineExceeded,
    RequestContext,
    current_request_id,
    new_request_id,
    request_context,
    resolve_submit,
)
from .metrics import (
    DEFAULT_RATIO_BUCKETS,
    DEFAULT_TIME_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    bucket_count_over,
    bucket_quantile,
    default_registry,
    next_instance,
)
from .trace import (
    Span,
    clear_trace,
    configure,
    current_span,
    dropped_events,
    enabled,
    export_chrome_trace,
    span,
    trace_events,
)
from .export import (
    append_jsonl,
    export_prometheus,
    prometheus_text,
    snapshot,
)
from .http import ObsHTTPServer, start_http_server
from .report import report
from .slo import (
    BurnRule,
    SLOEngine,
    SLOSpec,
    default_serve_slos,
    slo_status,
)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "Span",
    "DEFAULT_TIME_BUCKETS", "DEFAULT_RATIO_BUCKETS",
    "bucket_quantile", "bucket_count_over",
    "default_registry", "next_instance",
    "counter", "gauge", "histogram", "get_instrument",
    "configure", "enabled", "span", "current_span",
    "trace_events", "clear_trace", "dropped_events",
    "export_chrome_trace", "export_prometheus", "prometheus_text",
    "snapshot", "append_jsonl", "reset", "flight",
    # TopoWatch
    "DeadlineExceeded", "RequestContext", "request_context",
    "new_request_id", "current_request_id", "resolve_submit",
    "BurnRule", "SLOEngine", "SLOSpec", "default_serve_slos",
    "slo_status",
    "ObsHTTPServer", "start_http_server",
    # TopoScope report
    "report",
]


def counter(name: str, help: str = "") -> Counter:
    """Get-or-create a counter in the default registry."""
    return default_registry().counter(name, help)


def gauge(name: str, help: str = "") -> Gauge:
    return default_registry().gauge(name, help)


def histogram(name: str, help: str = "",
              buckets: Iterable[float] = DEFAULT_TIME_BUCKETS) -> Histogram:
    return default_registry().histogram(name, help, buckets=buckets)


def get_instrument(name: str):
    return default_registry().get(name)


def reset() -> None:
    """Zero every metric series, drop buffered trace events, and clear
    the flight-recorder ring.

    Instruments stay registered, so module-level references held by the
    instrumented subsystems keep recording.
    """
    default_registry().reset()
    clear_trace()
    flight.clear()
