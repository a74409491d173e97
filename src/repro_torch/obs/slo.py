"""TopoWatch SLO engine: declarative objectives + multi-window burn rates
(the port's copy of ``repro.obs.slo``).

An :class:`SLOSpec` declares one objective over the TopoScope registry —
a per-bucket latency ceiling, an error-rate or deadline-miss budget, a
stream skip-rate floor, or a static recall floor read from a committed
bench baseline.  The :class:`SLOEngine` snapshots the relevant counters
on every ``tick()`` and evaluates each spec with **multi-window
burn-rate rules** (the SRE alerting pattern): the budget-consumption
rate is computed over a long and a short window, and the SLO only fires
when *both* exceed the rule's factor — the long window proves the
problem is real, the short window proves it is still happening, so a
transient blip neither fires nor masks an ongoing burn.

Burn rate 1.0 means "consuming exactly the whole error budget at a
sustained rate"; a factor above 1 alerts on faster-than-budget burns.

Verdicts surface three ways, all fed by the same ``tick()``:

- :func:`slo_status` / ``SLOEngine.status()`` — JSON-ready dicts;
- Prometheus gauges ``slo.burn_rate{slo,window}``, ``slo.status{slo}``
  and the counter ``slo.breaches_total{slo}`` (scraped via
  :mod:`repro_torch.obs.http`; the registry names and help texts are
  ``repro``'s, so one scrape config reads either package);
- a breach callback (default :func:`repro_torch.obs.flight.auto_dump`) so
  every new breach leaves a flight-recorder post-mortem.

The ``watch`` / ``slo check`` CLIs and PerfGate's ``abs_upper`` row over
``slo.breaches_total`` are not part of the port yet.
"""
from __future__ import annotations

import dataclasses
import json
import threading
import time
from collections import deque
from typing import Callable, Optional, Sequence

from . import flight
from .metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    bucket_count_over,
    bucket_quantile,
    default_registry,
)

KINDS = ("latency", "error_rate", "ratio_floor", "value_floor")

_G_BURN = default_registry().gauge(
    "slo.burn_rate", help="per-SLO budget burn rate per rule window")
_G_STATUS = default_registry().gauge(
    "slo.status", help="per-SLO verdict: 0 ok, 1 breach, -1 no_data")
_C_BREACH = default_registry().counter(
    "slo.breaches_total",
    help="ok->breach verdict transitions per SLO (gated abs_upper by "
         "PerfGate: a gate run with any breach fails)")


@dataclasses.dataclass(frozen=True)
class BurnRule:
    """One multi-window burn-rate rule: fire when the burn rate exceeds
    ``factor`` over BOTH the long and the short window."""

    long_s: float
    short_s: float
    factor: float = 1.0

    def __post_init__(self):
        if not (self.short_s > 0 and self.long_s >= self.short_s):
            raise ValueError(
                f"need long_s >= short_s > 0, got {self.long_s}/"
                f"{self.short_s}")


# Default pair: a fast rule for sharp burns and a slow one for sustained
# slow leaks.  Windows are short by production standards because the
# serving stack's unit of traffic is a drain (~ms-seconds), not minutes.
DEFAULT_RULES = (BurnRule(long_s=60.0, short_s=5.0, factor=1.0),
                 BurnRule(long_s=300.0, short_s=30.0, factor=0.5))


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """One declarative objective over registry instruments.

    Kinds (``budget`` is always the allowed *bad fraction* of events):

    - ``latency`` — ``histogram`` + ``quantile`` + ``ceiling_s``: "the
      q-quantile stays under the ceiling".  Bad events are observations
      above the ceiling (bucket-interpolated); the budget defaults to
      ``1 - quantile`` (a p99 ceiling allows 1% over).
    - ``error_rate`` — ``bad``/``total`` counter names: bad-event
      fraction must stay within ``budget``.
    - ``ratio_floor`` — ``good``/``total`` counter names + ``floor``:
      the good fraction must stay >= ``floor`` (bad = total - good,
      budget = 1 - floor).  Stream skip-rate floors use this.
    - ``value_floor`` — ``value_from`` (``"bench:<suite>:<benchmark>.
      <metric>"`` over a committed ``BENCH_<suite>.json``, or
      ``"gauge:<name>"``) + ``floor``: a static, un-windowed check
      (recall floors from bench telemetry).

    ``labels`` filters instrument series by label subset, e.g.
    ``(("bucket", "n32"),)`` for a per-bucket latency objective.
    """

    name: str
    kind: str
    description: str = ""
    # latency
    histogram: str = ""
    quantile: float = 0.99
    ceiling_s: float = 0.0
    # error_rate / ratio_floor: counter names + per-selector extra labels
    # (merged over ``labels``) — the stream skip-rate good/total pair
    # lives in ONE counter split by a ``key`` label, so each side needs
    # its own filter
    bad: str = ""
    good: str = ""
    total: str = ""
    bad_labels: tuple[tuple[str, str], ...] = ()
    good_labels: tuple[tuple[str, str], ...] = ()
    total_labels: tuple[tuple[str, str], ...] = ()
    # shared
    labels: tuple[tuple[str, str], ...] = ()
    budget: Optional[float] = None
    floor: float = 0.0
    value_from: str = ""
    rules: tuple[BurnRule, ...] = DEFAULT_RULES

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown SLO kind {self.kind!r}; want {KINDS}")
        if self.kind == "latency" and (not self.histogram
                                       or self.ceiling_s <= 0):
            raise ValueError(f"latency SLO {self.name!r} needs histogram "
                             "and ceiling_s > 0")
        if self.kind == "error_rate" and not (self.bad and self.total):
            raise ValueError(f"error_rate SLO {self.name!r} needs bad/total "
                             "counter names")
        if self.kind == "ratio_floor" and not (self.good and self.total):
            raise ValueError(f"ratio_floor SLO {self.name!r} needs "
                             "good/total counter names")
        if self.kind == "value_floor" and not self.value_from:
            raise ValueError(f"value_floor SLO {self.name!r} needs "
                             "value_from")
        if not self.rules and self.kind != "value_floor":
            raise ValueError(f"SLO {self.name!r} needs at least one "
                             "BurnRule")

    @property
    def bad_budget(self) -> float:
        """Allowed bad-event fraction (>0; a zero budget would make burn
        rate undefined — use an abs_upper PerfGate row for hard zeros)."""
        if self.budget is not None:
            b = self.budget
        elif self.kind == "latency":
            b = 1.0 - self.quantile
        elif self.kind == "ratio_floor":
            b = 1.0 - self.floor
        else:
            b = 0.01
        return max(float(b), 1e-9)


# ------------------------------------------------------------------ engine

class SLOEngine:
    """Snapshot ring + evaluator over one metrics registry.

    ``tick()`` is the only mutator: capture a snapshot, evaluate every
    spec's rules against the windowed deltas, update the Prom surfaces,
    count ok->breach transitions, and invoke ``on_breach`` for each new
    breach.  ``clock`` is injectable so tests drive synthetic time.
    """

    def __init__(self, specs: Sequence[SLOSpec],
                 registry: Optional[MetricsRegistry] = None,
                 clock: Callable[[], float] = time.monotonic,
                 on_breach: Optional[Callable[[str, dict],
                                              Optional[str]]] = None,
                 bench_dir: str = "results"):
        names = [s.name for s in specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO names in {names}")
        self.specs = tuple(specs)
        self.registry = registry or default_registry()
        self.clock = clock
        self.on_breach = (on_breach if on_breach is not None
                          else lambda name, v: flight.auto_dump(
                              f"slo_breach:{name}", extra={"verdict": v}))
        self.bench_dir = bench_dir
        self._lock = threading.Lock()
        self._history: deque[tuple[float, dict]] = deque()
        self._last_status: dict[str, dict] = {}
        self._bench_cache: dict[str, Optional[dict]] = {}

    # ------------------------------------------------------------ capture

    def _capture(self) -> dict:
        """{spec.name: state} — cumulative (bad, total) pairs or raw
        histogram bucket counts, per spec, at this instant."""
        snap: dict[str, object] = {}
        for spec in self.specs:
            labels = dict(spec.labels)
            if spec.kind == "latency":
                inst = self.registry.get(spec.histogram)
                if isinstance(inst, Histogram):
                    counts, _ = inst.merged_counts(**labels)
                    snap[spec.name] = (tuple(inst.buckets), tuple(counts))
                else:
                    snap[spec.name] = None
            elif spec.kind in ("error_rate", "ratio_floor"):
                if spec.kind == "error_rate":
                    first_name, first_extra = spec.bad, spec.bad_labels
                else:
                    first_name, first_extra = spec.good, spec.good_labels
                snap[spec.name] = (
                    self._counter_total(first_name,
                                        {**labels, **dict(first_extra)}),
                    self._counter_total(spec.total,
                                        {**labels,
                                         **dict(spec.total_labels)}))
            else:  # value_floor: stateless, evaluated directly
                snap[spec.name] = None
        return snap

    def _counter_total(self, name: str, labels: dict) -> float:
        inst = self.registry.get(name)
        if isinstance(inst, Counter):
            return inst.total(**labels)
        return 0.0

    # ----------------------------------------------------------- evaluate

    def _window_state(self, name: str, now: float, window_s: float):
        """The buffered state closest to (and at least as old as)
        ``now - window_s``; falls back to the oldest snapshot when the
        history is younger than the window."""
        target = now - window_s
        chosen = None
        for (t, snap) in self._history:  # oldest -> newest
            if t <= target:
                chosen = (t, snap.get(name))
            else:
                break
        if chosen is None and self._history:
            t0, snap0 = self._history[0]
            chosen = (t0, snap0.get(name))
        return chosen

    @staticmethod
    def _bad_total(spec: SLOSpec, state) -> tuple[float, float]:
        """Cumulative (bad, total) events from one captured state."""
        if state is None:
            return 0.0, 0.0
        if spec.kind == "latency":
            bounds, counts = state
            total = float(sum(counts))
            return bucket_count_over(bounds, counts, spec.ceiling_s), total
        first, total = state
        if spec.kind == "error_rate":
            return float(first), float(total)
        # ratio_floor: first is the GOOD count
        return float(total) - float(first), float(total)

    def _burn(self, spec: SLOSpec, name: str, now: float,
              window_s: float) -> tuple[Optional[float], float]:
        """(burn rate over the window, total events in window); burn is
        None when the window saw no events."""
        past = self._window_state(name, now, window_s)
        cur = self._history[-1][1].get(name) if self._history else None
        bad1, tot1 = self._bad_total(spec, cur)
        bad0, tot0 = self._bad_total(spec, past[1]) if past else (0.0, 0.0)
        d_bad, d_tot = bad1 - bad0, tot1 - tot0
        if d_tot <= 0:
            return None, 0.0
        return (d_bad / d_tot) / spec.bad_budget, d_tot

    def _eval_value_floor(self, spec: SLOSpec) -> dict:
        value = self._static_value(spec.value_from)
        if value is None:
            return {"status": "no_data", "value": None, "floor": spec.floor}
        return {"status": "breach" if value < spec.floor else "ok",
                "value": value, "floor": spec.floor}

    def _static_value(self, src: str) -> Optional[float]:
        try:
            scheme, rest = src.split(":", 1)
        except ValueError:
            return None
        if scheme == "gauge":
            inst = self.registry.get(rest)
            if isinstance(inst, Gauge):
                series = inst.series()
                return float(next(iter(series.values()))) if series else None
            return None
        if scheme == "bench":
            suite, key = rest.split(":", 1)
            bench, metric = key.rsplit(".", 1)
            payload = self._bench_cache.get(suite)
            if suite not in self._bench_cache:
                try:
                    with open(f"{self.bench_dir}/BENCH_{suite}.json") as fh:
                        payload = json.load(fh)
                except Exception:
                    payload = None
                self._bench_cache[suite] = payload
            if not payload:
                return None
            for row in payload.get("rows", ()):
                if (row.get("benchmark"), row.get("metric")) == (bench,
                                                                 metric):
                    return float(row["value"])
        return None

    def _evaluate(self, now: float) -> dict[str, dict]:
        out: dict[str, dict] = {}
        for spec in self.specs:
            if spec.kind == "value_floor":
                verdict = self._eval_value_floor(spec)
                verdict.update(slo=spec.name, kind=spec.kind,
                               description=spec.description)
                out[spec.name] = verdict
                continue
            rules_out, firing, any_data = [], False, False
            for rule in spec.rules:
                burn_l, n_l = self._burn(spec, spec.name, now, rule.long_s)
                burn_s, n_s = self._burn(spec, spec.name, now, rule.short_s)
                fired = (burn_l is not None and burn_s is not None
                         and burn_l >= rule.factor and burn_s >= rule.factor)
                firing = firing or fired
                any_data = any_data or burn_l is not None
                rules_out.append({
                    "long_s": rule.long_s, "short_s": rule.short_s,
                    "factor": rule.factor, "burn_long": burn_l,
                    "burn_short": burn_s, "events_long": n_l,
                    "fired": fired,
                })
                _G_BURN.set(burn_l if burn_l is not None else -1.0,
                            slo=spec.name, window=f"{rule.long_s:g}s")
            verdict = {
                "slo": spec.name, "kind": spec.kind,
                "description": spec.description,
                "status": ("breach" if firing
                           else "ok" if any_data else "no_data"),
                "budget": spec.bad_budget,
                "rules": rules_out,
            }
            if spec.kind == "latency":
                state = (self._history[-1][1].get(spec.name)
                         if self._history else None)
                if state is not None:
                    bounds, counts = state
                    verdict["quantile"] = spec.quantile
                    verdict["ceiling_s"] = spec.ceiling_s
                    verdict["observed_q_s"] = bucket_quantile(
                        bounds, counts, spec.quantile)
            out[spec.name] = verdict
        return out

    # --------------------------------------------------------------- tick

    def tick(self, now: Optional[float] = None) -> dict[str, dict]:
        """Capture + evaluate; returns {slo name: verdict dict}."""
        if now is None:
            now = self.clock()
        with self._lock:
            self._history.append((now, self._capture()))
            horizon = max((r.long_s for s in self.specs for r in s.rules),
                          default=60.0)
            while (len(self._history) > 2
                   and self._history[1][0] <= now - horizon):
                self._history.popleft()
            status = self._evaluate(now)
            prev = self._last_status
            self._last_status = status
        for name, verdict in status.items():
            st = verdict["status"]
            _G_STATUS.set({"ok": 0, "breach": 1}.get(st, -1), slo=name)
            was = prev.get(name, {}).get("status")
            if st == "breach" and was != "breach":
                _C_BREACH.inc(slo=name)
                flight.record("slo", name, status="breach",
                              slo_kind=verdict["kind"])
                if self.on_breach is not None:
                    try:
                        self.on_breach(name, verdict)
                    except Exception:
                        pass  # a broken dump hook must not kill the loop
            elif st == "ok" and was == "breach":
                flight.record("slo", name, status="recovered")
        return status

    def status(self) -> dict[str, dict]:
        """Last ``tick()`` verdicts (empty before the first tick)."""
        with self._lock:
            return dict(self._last_status)

    def breached(self) -> list[str]:
        return [n for n, v in self.status().items()
                if v.get("status") == "breach"]


# ------------------------------------------------------- default objectives

def default_serve_slos(latency_p99_s: float = 2.0,
                       latency_p50_s: float = 0.5,
                       error_budget: float = 0.01,
                       deadline_budget: float = 0.01,
                       skip_rate_floor: float = 0.5,
                       recall_floor: float = 0.95,
                       buckets: Sequence[str] = ("n16", "n32", "n64",
                                                 "n128"),
                       rules: tuple[BurnRule, ...] = DEFAULT_RULES,
                       ) -> tuple[SLOSpec, ...]:
    """The serving stack's stock objectives (tune per deployment).

    Per-bucket p50/p99 latency ceilings over the request-latency
    histogram, an error-rate and a deadline-miss budget over the serve
    counters, a stream skip-rate floor (the cache-effectiveness
    contract), and a static retrieval-recall floor read from the
    committed metrics bench baseline.
    """
    specs: list[SLOSpec] = []
    for lbl in buckets:
        specs.append(SLOSpec(
            name=f"serve-latency-p99-{lbl}", kind="latency",
            histogram="serve.request_latency_seconds",
            quantile=0.99, ceiling_s=latency_p99_s,
            labels=(("bucket", lbl),), rules=rules,
            description=f"bucket {lbl}: p99 submit->resolve latency "
                        f"<= {latency_p99_s:g}s"))
        specs.append(SLOSpec(
            name=f"serve-latency-p50-{lbl}", kind="latency",
            histogram="serve.request_latency_seconds",
            quantile=0.5, ceiling_s=latency_p50_s,
            labels=(("bucket", lbl),), rules=rules,
            description=f"bucket {lbl}: p50 submit->resolve latency "
                        f"<= {latency_p50_s:g}s"))
    specs += [
        SLOSpec(name="serve-error-rate", kind="error_rate",
                bad="serve.failed", total="serve.submitted",
                budget=error_budget, rules=rules,
                description="failed futures / submitted requests"),
        SLOSpec(name="serve-deadline-miss", kind="error_rate",
                bad="serve.deadline_exceeded", total="serve.submitted",
                budget=deadline_budget, rules=rules,
                description="requests expired in queue / submitted"),
        SLOSpec(name="stream-skip-rate", kind="ratio_floor",
                good="stream.steps", good_labels=(("key", "hits"),),
                total="stream.steps",
                total_labels=(("key", "graph_updates"),),
                floor=skip_rate_floor, rules=rules,
                description="certified update skips / graph updates"),
        SLOSpec(name="rerank-recall", kind="value_floor",
                value_from="bench:metrics:metrics_rerank.recall_at_10",
                floor=recall_floor,
                description="two-stage retrieval recall@10 from the "
                            "committed bench baseline"),
    ]
    return tuple(specs)


# ----------------------------------------------------------- installation

_INSTALLED: Optional[SLOEngine] = None
_INSTALL_LOCK = threading.Lock()


def install(engine: Optional[SLOEngine]) -> Optional[SLOEngine]:
    """Make ``engine`` the process-wide engine surfaced by
    :func:`slo_status`, ``/slo``, and the CLIs; returns the previous one.
    Pass None to uninstall."""
    global _INSTALLED
    with _INSTALL_LOCK:
        prev, _INSTALLED = _INSTALLED, engine
    return prev


def installed() -> Optional[SLOEngine]:
    return _INSTALLED


def slo_status(tick: bool = True) -> dict[str, dict]:
    """Verdicts of the installed engine ({} when none installed);
    ``tick=True`` re-evaluates first so scrapes always see fresh state."""
    eng = _INSTALLED
    if eng is None:
        return {}
    return eng.tick() if tick else eng.status()


def verdict_block() -> dict:
    """JSON block for reports (GATE_report.json, flight dumps): installed
    flag, per-SLO verdicts, and the cumulative breach counter."""
    eng = _INSTALLED
    breaches = _C_BREACH.labeled("slo")
    return {
        "installed": eng is not None,
        "status": eng.status() if eng is not None else {},
        "breaches_total": int(sum(breaches.values())),
        "breaches_by_slo": {k: int(v) for k, v in sorted(breaches.items())},
    }
