"""The port's copy of the observability core (``repro_torch.obs``):
metrics, spans, request context and the flight recorder.

The behaviour cases of ``tests/test_obs.py`` and ``tests/test_obs_watch.py``
for these four modules, run against the port's copy, plus the same
sequences of records through both packages' registries (equal snapshots
and quantiles) and the ``torch_profiler=`` bridge on the CPU.  No case
bounds a time.
"""
from __future__ import annotations

import json
import math
import threading

import numpy as np
import pytest
import torch

from repro.obs import metrics as metrics_j
from repro_torch import obs
from repro_torch.obs import flight
from repro_torch.obs.context import (
    current,
    current_request_id,
    new_request_id,
    request_context,
    resolve_submit,
)
from repro_torch.obs.metrics import (
    Counter,
    MetricsRegistry,
    bucket_count_over,
    bucket_quantile,
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: parallel test workers would oversubscribe the
    CPUs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def traced():
    """Enable tracing for one test; restore the disabled default after."""
    obs.configure(enabled=True)
    obs.clear_trace()
    try:
        yield
    finally:
        obs.configure(enabled=False)
        obs.clear_trace()


# ----------------------------------------------------------------- registry

def test_counter_labels_and_totals():
    reg = MetricsRegistry()
    c = reg.counter("req.count", help="requests")
    c.inc(bucket="n16", frontend="topo")
    c.inc(3, bucket="n32", frontend="topo")
    c.inc(bucket="n16", frontend="sim")
    assert c.value(bucket="n16", frontend="topo") == 1
    assert c.value(bucket="n32", frontend="topo") == 3
    assert c.total(frontend="topo") == 4
    assert c.total() == 5
    assert c.labeled("bucket") == {"n16": 2.0, "n32": 3.0}
    with pytest.raises(ValueError):
        c.inc(-1)


def test_counter_thread_safety():
    c = Counter("c")
    n_threads, n_incs = 8, 2000

    def worker(i):
        for _ in range(n_incs):
            c.inc(thread=i % 2)

    ts = [threading.Thread(target=worker, args=(i,))
          for i in range(n_threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert c.total() == n_threads * n_incs


def test_gauge_updown():
    reg = MetricsRegistry()
    g = reg.gauge("sessions.live")
    g.inc()
    g.inc()
    g.dec()
    assert g.value() == 1
    g.set(7, instance="s-0")
    assert g.value(instance="s-0") == 7


def test_histogram_bucket_math():
    reg = MetricsRegistry()
    h = reg.histogram("lat", buckets=(1.0, 2.0, 4.0))
    for v in (1.0, 1.5, 4.0, 5.0):
        h.observe(v)
    (series,) = h.snapshot_series().values()
    assert series["buckets"] == [(1.0, 1), (2.0, 2), (4.0, 3), ("+Inf", 4)]
    assert series["count"] == 4
    assert series["sum"] == pytest.approx(11.5)


def test_histogram_rejects_bad_buckets():
    reg = MetricsRegistry()
    with pytest.raises(ValueError):
        reg.histogram("bad", buckets=(2.0, 1.0))
    with pytest.raises(ValueError):
        reg.histogram("bad2", buckets=())


def test_registry_type_conflict_and_reset():
    reg = MetricsRegistry()
    c = reg.counter("x")
    assert reg.counter("x") is c
    with pytest.raises(TypeError):
        reg.gauge("x")
    c.inc(5)
    reg.reset()
    assert c.total() == 0
    assert reg.get("x") is c


def test_snapshot_is_json_ready():
    reg = MetricsRegistry()
    reg.counter("a").inc(2, k="v")
    reg.histogram("b", buckets=(1.0,)).observe(0.5)
    snap = reg.snapshot()
    json.dumps(snap)
    assert snap["a"]["type"] == "counter"
    assert snap["a"]["series"] == [{"labels": {"k": "v"}, "value": 2.0}]
    assert snap["b"]["series"][0]["count"] == 1


def _drive(reg, rng_seed=3):
    """One fixed sequence of records on a registry of either package."""
    rng = np.random.default_rng(rng_seed)
    c = reg.counter("stream.verdicts", help="verdicts")
    g = reg.gauge("sessions.live")
    h = reg.histogram("stream.drift_score",
                      buckets=(0.01, 0.03, 0.1, 0.3, 1.0, 3.0))
    for i in range(200):
        c.inc(int(rng.integers(1, 4)),
              verdict=("coral_hit", "prunit_hit", "recompute")[i % 3])
        g.set(float(rng.integers(0, 9)), instance=f"s-{i % 2}")
        h.observe(float(rng.exponential(0.5)), backend=("sw", "exact_w")[i % 2])
    return h


def test_registry_matches_repro():
    reg_t, reg_j = MetricsRegistry(), metrics_j.MetricsRegistry()
    h_t, h_j = _drive(reg_t), _drive(reg_j)
    assert reg_t.snapshot() == reg_j.snapshot()
    for q in (0.1, 0.5, 0.9, 0.99):
        assert h_t.quantile(q) == h_j.quantile(q)
        assert (h_t.quantile(q, backend="sw")
                == h_j.quantile(q, backend="sw"))
    for thr in (0.02, 0.5, 2.0):
        assert h_t.count_over(thr) == h_j.count_over(thr)
    assert h_t.merged_counts() == h_j.merged_counts()


# -------------------------------------------------------- histogram quantiles

def test_bucket_quantile_uniform_exact():
    bounds = (1.0, 2.0, 3.0, 4.0)
    counts = [25, 25, 25, 25, 0]
    assert bucket_quantile(bounds, counts, 0.5) == pytest.approx(2.0)
    assert bucket_quantile(bounds, counts, 0.25) == pytest.approx(1.0)
    assert bucket_quantile(bounds, counts, 0.875) == pytest.approx(3.5)


def test_bucket_quantile_empty_and_overflow():
    bounds = (1.0, 2.0)
    assert math.isnan(bucket_quantile(bounds, [0, 0, 0], 0.5))
    assert bucket_quantile(bounds, [0, 0, 10], 0.99) == pytest.approx(2.0)


def test_bucket_count_over_interpolates():
    bounds = (1.0, 2.0, 3.0)
    counts = [10, 10, 10, 0]
    assert bucket_count_over(bounds, counts, 1.5) == pytest.approx(15.0)
    assert bucket_count_over(bounds, counts, 3.0) == pytest.approx(0.0)


def test_histogram_quantile_matches_numpy():
    rng = np.random.default_rng(7)
    samples = rng.uniform(0.0, 1.0, size=5000)
    edges = tuple(np.linspace(0.02, 1.0, 50))
    reg = MetricsRegistry()
    h = reg.histogram("t.lat", buckets=edges)
    for s in samples:
        h.observe(float(s))
    for q in (0.1, 0.5, 0.9, 0.99):
        assert abs(h.quantile(q) - float(np.quantile(samples, q))) < 0.02
    qs = [h.quantile(q) for q in (0.1, 0.5, 0.9, 0.99)]
    assert qs == sorted(qs)


def test_histogram_quantile_label_superset():
    reg = MetricsRegistry()
    h = reg.histogram("t.lat2", buckets=(1.0, 2.0, 4.0))
    for _ in range(10):
        h.observe(0.5, bucket="a")
    for _ in range(10):
        h.observe(3.0, bucket="b")
    assert h.quantile(0.5, bucket="a") <= 1.0
    assert h.quantile(0.5, bucket="b") > 2.0
    assert 1.0 <= h.quantile(0.5) <= 4.0
    assert math.isnan(h.quantile(0.5, bucket="zzz"))


# ------------------------------------------------------------------ tracing

def test_span_disabled_is_noop():
    assert not obs.enabled()
    with obs.span("x", foo=1) as sp:
        assert sp is obs.span("y")
        sp.set(bar=2)
    assert obs.trace_events() == []


def test_span_nesting_and_attrs(traced):
    with obs.span("t.outer", frontend="topo") as outer:
        assert obs.current_span() is outer
        with obs.span("t.inner") as inner:
            inner.set(graphs=3)
        outer.set(served=1)
    assert obs.current_span() is None
    by_name = {e["name"]: e for e in obs.trace_events()}
    assert set(by_name) == {"t.outer", "t.inner"}
    inner, outer = by_name["t.inner"], by_name["t.outer"]
    assert inner["args"]["parent"] == "t.outer"
    assert "parent" not in outer["args"]
    assert inner["args"]["graphs"] == 3
    assert outer["args"]["served"] == 1
    assert outer["cat"] == "t" and outer["ph"] == "X"
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1.0


def test_span_records_error_and_unwinds(traced):
    with pytest.raises(RuntimeError):
        with obs.span("t.fail"):
            raise RuntimeError("boom")
    (ev,) = obs.trace_events()
    assert ev["args"]["error"] == "RuntimeError"
    assert obs.current_span() is None


def test_span_feeds_duration_histogram(traced):
    h = obs.get_instrument("obs.span_seconds")
    before = {k: v.count for k, v in h.series().items()}
    with obs.span("t.feed"):
        pass
    key = (("span", "t.feed"),)
    assert h.series()[key].count == before.get(key, 0) + 1


def test_trace_capacity_drops_not_grows(traced):
    obs.configure(capacity=5)
    try:
        for _ in range(8):
            with obs.span("t.cap"):
                pass
        assert len(obs.trace_events()) == 5
        assert obs.dropped_events() == 3
    finally:
        obs.configure(capacity=200_000)


def test_chrome_trace_export_round_trip(tmp_path, traced):
    with obs.span("t.a", shape="G64_D128"):
        with obs.span("t.b"):
            pass
    path = str(tmp_path / "trace.json")
    assert obs.export_chrome_trace(path) == path
    doc = json.load(open(path))
    assert doc["displayTimeUnit"] == "ms"
    assert doc["otherData"]["dropped"] == 0
    events = doc["traceEvents"]
    assert {e["name"] for e in events} == {"t.a", "t.b"}
    for e in events:
        assert {"name", "cat", "ph", "ts", "dur", "pid", "tid",
                "args"} <= set(e)


def test_cross_thread_spans_get_own_tid(traced):
    def other():
        with obs.span("t.worker"):
            pass

    t = threading.Thread(target=other)
    with obs.span("t.main"):
        t.start()
        t.join()
    by_name = {e["name"]: e for e in obs.trace_events()}
    assert by_name["t.worker"]["tid"] != by_name["t.main"]["tid"]
    assert "parent" not in by_name["t.worker"]["args"]


def test_span_carries_request_id(traced):
    with request_context(request_id="req-7"):
        with obs.span("t.req"):
            pass
    (ev,) = obs.trace_events()
    assert ev["args"]["rid"] == "req-7"


def test_span_torch_profiler_bridge(tmp_path, traced):
    obs.configure(torch_trace_dir=str(tmp_path))
    try:
        x = torch.arange(64, dtype=torch.float32).reshape(8, 8)
        with obs.span("t.prof", torch_profiler=True) as sp:
            y = (x @ x).sum()
        assert float(y) == float((x.double() @ x.double()).sum())
        names = {e.key for e in sp.profiler.key_averages()}
        assert any("mm" in n for n in names), names
        (ev,) = obs.trace_events()
        path = ev["args"]["torch_trace"]
        assert path.startswith(str(tmp_path))
        assert "traceEvents" in json.load(open(path))
    finally:
        obs.configure(torch_trace_dir="results/torch_trace")


def test_reset_keeps_instruments():
    c = obs.counter("t.reset_probe")
    c.inc(4)
    flight.record("test", "reset-probe")
    obs.reset()
    assert c.total() == 0 and obs.get_instrument("t.reset_probe") is c
    assert not [e for e in flight.events() if e["name"] == "reset-probe"]
    c.inc()
    assert obs.snapshot()["t.reset_probe"]["series"][0]["value"] == 1.0


# --------------------------------------------------------- request context

def test_request_context_ambient_and_nesting():
    assert current() is None
    with request_context(deadline_s=10.0) as outer:
        assert current_request_id() == outer.request_id
        assert outer.deadline is not None
        with request_context() as inner:
            assert inner.request_id != outer.request_id
            assert inner.deadline == outer.deadline
        with request_context(deadline_s=10_000.0) as inner2:
            assert inner2.deadline == outer.deadline
        with request_context(deadline_s=0.001) as inner3:
            assert inner3.deadline < outer.deadline
        assert current() is outer
    assert current() is None


def test_resolve_submit_precedence():
    rid, dl = resolve_submit("my-rid", None)
    assert rid == "my-rid" and dl is None
    with request_context(request_id="ctx-rid", deadline_s=5.0) as ctx:
        rid, dl = resolve_submit(None, None)
        assert rid == "ctx-rid" and dl == ctx.deadline
        rid, dl = resolve_submit(None, 10_000.0)
        assert dl == ctx.deadline
    rid, dl = resolve_submit(None, None)
    assert rid and dl is None
    assert new_request_id() != new_request_id()


def test_request_context_thread_isolation():
    seen = {}

    def worker():
        seen["rid"] = current_request_id()

    with request_context(request_id="outer-only"):
        t = threading.Thread(target=worker)
        t.start()
        t.join()
    assert seen["rid"] is None


def test_request_context_expiry():
    with request_context(deadline_s=-1.0) as ctx:
        assert ctx.expired() and ctx.remaining_s() < 0
    with request_context() as ctx:
        assert not ctx.expired() and ctx.remaining_s() is None


# ------------------------------------------------------------ flight recorder

def test_flight_ring_bounded_and_ordered():
    flight.configure(capacity=8)
    try:
        def worker():
            for i in range(30):
                flight.record("test", f"ev-{i}", i=i)

        t = threading.Thread(target=worker, name="torch-flight-probe")
        t.start()
        t.join()
        mine = [e for e in flight.events()
                if e["thread"] == "torch-flight-probe"]
        assert len(mine) == 8
        assert [e["name"] for e in mine] == [f"ev-{i}"
                                             for i in range(22, 30)]
        seqs = [e["seq"] for e in flight.events()]
        assert seqs == sorted(seqs)
    finally:
        flight.configure(capacity=512)


def test_flight_dump_roundtrip(tmp_path):
    flight.record("test", "dump-probe", answer=42, obj=object())
    path = flight.dump("unit-test", path=str(tmp_path / "FLIGHT_t.json"))
    assert flight.last_dump_path() == path
    with open(path) as fh:
        doc = json.load(fh)
    assert doc["schema"] == 1
    assert doc["reason"] == "unit-test"
    assert any(e["name"] == "dump-probe" and e["attrs"]["answer"] == 42
               for e in doc["events"])
    assert "metrics" in doc and doc["slo"] is None


def test_flight_auto_dump_rate_limited(tmp_path):
    flight.clear()
    flight.configure(dump_dir=str(tmp_path), min_dump_interval_s=3600.0)
    try:
        flight.record("test", "incident")
        p1 = flight.auto_dump("first")
        assert p1 is not None and p1.startswith(str(tmp_path))
        assert flight.auto_dump("second") is None
        assert flight.last_dump_path() == p1
    finally:
        flight.configure(dump_dir="results/obs", min_dump_interval_s=30.0)
        flight.clear()


def test_flight_records_spans(traced):
    flight.clear()
    with obs.span("t.flight"):
        pass
    (ev,) = [e for e in flight.events() if e["name"] == "t.flight"]
    assert ev["kind"] == "span" and "dur_ms" in ev["attrs"]
