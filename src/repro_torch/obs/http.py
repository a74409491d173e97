"""TopoWatch scrape endpoints: a dependency-free ``http.server`` exporter
(the port's copy of ``repro.obs.http``).

One background :class:`ObsHTTPServer` makes the whole TopoScope/TopoWatch
surface scrapeable — no third-party web stack, just the standard
library's ``ThreadingHTTPServer`` so 8 Prometheus scrapers hammering
``/metrics`` during a drain never block each other or the drain:

==================  =====================================================
``/metrics``        Prometheus text exposition (v0.0.4) of the registry
``/healthz``        liveness: 200 while every registered drain-loop
                    heartbeat is fresh, 503 once any goes stale
``/readyz``         readiness: 200 once a frontend reports ready
                    (``serve_forever`` warmed the bucket plans), 503
                    before/after
``/varz``           full JSON registry snapshot (+ timestamp)
``/slo``            verdicts of the installed SLO engine (ticked per
                    scrape, so alerts never read stale burn rates)
``/debug/flight``   the flight recorder's in-memory ring, newest last
==================  =====================================================

Liveness is gauge-based, not handler-based: ``serve_forever`` loops set
``serve.heartbeat_ts{frontend=...}`` each iteration, and ``/healthz``
compares those wall-clock stamps against ``health_max_age_s`` — a wedged
drain (the exact failure the flight recorder exists for) keeps the HTTP
thread perfectly responsive, so only the heartbeat can tell the truth.
"""
from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import urlparse

from . import flight
from . import slo as _slo
from .export import prometheus_text, snapshot
from .metrics import Gauge, MetricsRegistry, default_registry

HEARTBEAT_GAUGE = "serve.heartbeat_ts"
READY_GAUGE = "serve.ready"


def loop_health(registry: Optional[MetricsRegistry] = None,
                max_age_s: float = 5.0) -> dict:
    """Heartbeat freshness of every registered drain loop.

    ``{"status": "ok"|"stale"|"no_loops", "loops": {label: age_s}}`` —
    ``no_loops`` (no ``serve_forever`` running anywhere) still reports
    healthy: the process is alive, there is just nothing to monitor.
    """
    reg = registry or default_registry()
    inst = reg.get(HEARTBEAT_GAUGE)
    now = time.time()
    loops: dict[str, float] = {}
    if isinstance(inst, Gauge):
        for key, ts in inst.series().items():
            d = dict(key)
            lbl = d.get("frontend", "?") + "/" + d.get("instance", "?")
            loops[lbl] = round(now - float(ts), 3)
    if not loops:
        return {"status": "no_loops", "loops": {}}
    stale = {k: v for k, v in loops.items() if v > max_age_s}
    return {"status": "stale" if stale else "ok", "loops": loops,
            "stale": sorted(stale), "max_age_s": max_age_s}


def readiness(registry: Optional[MetricsRegistry] = None) -> dict:
    """Ready once any frontend set its ``serve.ready`` gauge to 1 (done
    by ``serve_forever`` after plan-cache warmup, cleared on stop)."""
    reg = registry or default_registry()
    inst = reg.get(READY_GAUGE)
    ready: list[str] = []
    if isinstance(inst, Gauge):
        for key, v in inst.series().items():
            if float(v) >= 1.0:
                d = dict(key)
                ready.append(d.get("frontend", "?") + "/"
                             + d.get("instance", "?"))
    return {"status": "ready" if ready else "not_ready",
            "ready": sorted(ready)}


class _Handler(BaseHTTPRequestHandler):
    server_version = "TopoWatch/1.0"
    protocol_version = "HTTP/1.1"

    # the owning ObsHTTPServer injects itself here via a subclass attr
    obs_server: "ObsHTTPServer"

    def log_message(self, fmt, *args):  # silence per-request stderr spam
        pass

    def _send(self, code: int, body: bytes,
              content_type: str = "application/json") -> None:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, doc) -> None:
        self._send(code, (json.dumps(doc, indent=1) + "\n").encode())

    def do_GET(self) -> None:  # noqa: N802 (http.server API)
        srv = self.obs_server
        path = urlparse(self.path).path.rstrip("/") or "/"
        try:
            if path == "/metrics":
                self._send(200, prometheus_text(srv.registry).encode(),
                           "text/plain; version=0.0.4; charset=utf-8")
            elif path == "/healthz":
                h = loop_health(srv.registry, srv.health_max_age_s)
                self._send_json(200 if h["status"] != "stale" else 503, h)
            elif path == "/readyz":
                r = readiness(srv.registry)
                self._send_json(200 if r["status"] == "ready" else 503, r)
            elif path == "/varz":
                self._send_json(200, {"ts": time.time(),
                                      "metrics": snapshot(srv.registry)})
            elif path == "/slo":
                self._send_json(200, {
                    "ts": time.time(),
                    "status": _slo.slo_status(tick=True),
                    "breaches": _slo.verdict_block()["breaches_by_slo"],
                })
            elif path == "/debug/flight":
                self._send_json(200, {
                    "ts": time.time(),
                    "events": flight.events(limit=srv.flight_limit),
                    "last_dump": flight.last_dump_path(),
                })
            elif path == "/":
                self._send_json(200, {"endpoints": [
                    "/metrics", "/healthz", "/readyz", "/varz", "/slo",
                    "/debug/flight"]})
            else:
                self._send_json(404, {"error": f"unknown path {path!r}"})
        except BrokenPipeError:
            pass  # scraper went away mid-response
        except Exception as e:  # an exporter bug must not kill the server
            try:
                self._send_json(500, {"error": repr(e)})
            except Exception:
                pass


class ObsHTTPServer:
    """Background scrape server; ``port=0`` binds an ephemeral port
    (read it back from ``.port`` — tests and same-host scrapers do).

    >>> srv = start_http_server(port=0)
    >>> srv.url  # doctest: +SKIP
    'http://127.0.0.1:49152'
    >>> srv.stop()
    """

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 registry: Optional[MetricsRegistry] = None,
                 health_max_age_s: float = 5.0,
                 flight_limit: int = 256):
        self.registry = registry or default_registry()
        self.health_max_age_s = float(health_max_age_s)
        self.flight_limit = int(flight_limit)
        handler = type("_BoundHandler", (_Handler,), {"obs_server": self})
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = int(self._httpd.server_address[1])
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "ObsHTTPServer":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="topowatch-http",
            daemon=True)
        self._thread.start()
        flight.record("http", "exporter_started", url=self.url)
        return self

    def stop(self) -> None:
        if self._thread is None:
            return
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)
        self._thread = None


def start_http_server(port: int = 0, host: str = "127.0.0.1",
                      registry: Optional[MetricsRegistry] = None,
                      health_max_age_s: float = 5.0) -> ObsHTTPServer:
    """Create + start an exporter; returns the server (``.port``/
    ``.url``/``.stop()``)."""
    return ObsHTTPServer(port=port, host=host, registry=registry,
                         health_max_age_s=health_max_age_s).start()
