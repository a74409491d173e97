"""The port's TopoWatch layer against ``repro``'s: exporters, the SLO
engine and the scrape endpoints.

Two registries, one per package, are fed the same observations: their
Prometheus text, snapshots and JSON-lines records are equal (timestamps
left out).  The SLO engines of both packages tick in lockstep on a
synthetic clock over the cases of tests/test_obs_watch.py and give equal
verdicts and burn rates at every step.  Both packages' HTTP exporters, on
``127.0.0.1`` and an ephemeral port, answer every endpoint with the same
status code and the same JSON keys.  A scrape runs concurrently with the
port's TopoServe drains.  Every thread a test starts is joined with a
timeout.
"""
from __future__ import annotations

import dataclasses
import json
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

import repro.obs.export as export_j
import repro.obs.http as http_j
import repro.obs.metrics as metrics_j
import repro.obs.slo as slo_j
from repro_torch import obs
from repro_torch.obs import export, flight, http, metrics, slo
from repro_torch.serve import TopoServe, TopoServeConfig

PORT = dict(export=export, http=http, metrics=metrics, slo=slo)
REPRO = dict(export=export_j, http=http_j, metrics=metrics_j, slo=slo_j)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: parallel test workers would oversubscribe the
    CPUs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _get(url: str, timeout: float = 10.0):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _feed(m):
    """One fixed sequence of records into a fresh registry of package
    ``m``: counters with labels (escapes included), gauges, histograms on
    custom and default buckets, names that need mangling."""
    reg = m["metrics"].MetricsRegistry()
    c = reg.counter("serve.submitted", help='requests "accepted"\nper bucket')
    for i in range(7):
        c.inc(instance="topo-0", bucket=f"n{16 << (i % 3)}")
    c.inc(2.5, instance='we"ird\\lbl', bucket="n16")
    reg.counter("9lives.c").inc(3)
    g = reg.gauge("stream.sessions_live", help="live sessions")
    g.set(1700000000.25, frontend="topo", instance="topo-0")
    g.set(-1.0, frontend="stream", instance="stream-0")
    h = reg.histogram("serve.request_latency_seconds", help="latency")
    for i in range(40):
        h.observe(0.0007 * (i + 1) ** 2, instance="topo-0",
                  bucket="n16" if i % 2 else "n32")
    r = reg.histogram("serve.batch_occupancy", help="fill",
                      buckets=m["metrics"].DEFAULT_RATIO_BUCKETS)
    for x in (0.1, 0.5, 0.5, 1.0, 1.5):
        r.observe(x, bucket="n16")
    return reg


# ---------------------------------------------------------------- exporters

def test_prometheus_text_and_snapshot_equal_repro(tmp_path):
    reg, reg_j = _feed(PORT), _feed(REPRO)
    text = export.prometheus_text(reg)
    assert text == export_j.prometheus_text(reg_j)
    assert "# TYPE serve_submitted_total counter" in text
    assert '_9lives_c_total 3' in text
    assert export.snapshot(reg) == export_j.snapshot(reg_j)
    p = export.export_prometheus(str(tmp_path / "port" / "m.prom"), reg)
    p_j = export_j.export_prometheus(str(tmp_path / "repro" / "m.prom"),
                                     reg_j)
    assert open(p).read() == open(p_j).read() == text


def test_append_jsonl_equal_repro_but_the_timestamp(tmp_path):
    reg, reg_j = _feed(PORT), _feed(REPRO)
    path, path_j = str(tmp_path / "a.jsonl"), str(tmp_path / "b.jsonl")
    for _ in range(2):
        export.append_jsonl(path, reg)
        export_j.append_jsonl(path_j, reg_j)
    lines = [json.loads(x) for x in open(path)]
    lines_j = [json.loads(x) for x in open(path_j)]
    assert len(lines) == len(lines_j) == 2
    for a, b in zip(lines, lines_j):
        assert isinstance(a.pop("ts"), float) and isinstance(b.pop("ts"),
                                                             float)
        assert a == b


def test_default_registry_exports_serving_instruments():
    # importing the serving layer registers repro's instrument names
    import repro_torch.serve  # noqa: F401

    text = obs.prometheus_text()
    for name in ("serve_submitted_total", "serve_request_latency_seconds",
                 "serve_heartbeat_ts", "slo_breaches_total_total",
                 "similarity_events_total", "stream_steps_total"):
        assert f"# TYPE {name} " in text, name
    assert obs.snapshot() == export.snapshot()


# ------------------------------------------------------ SLO engine (clock)

def _err_spec(m, rules):
    return m["slo"].SLOSpec(name="t-err", kind="error_rate", bad="t.bad",
                            total="t.total", budget=0.01, rules=rules)


def _breach_and_recovery(m):
    """tests/test_obs_watch.py's breach / recovery case; returns every
    tick's verdicts, the breach callbacks and the breach-counter steps."""
    s = m["slo"]
    reg = m["metrics"].MetricsRegistry()
    bad, total = reg.counter("t.bad"), reg.counter("t.total")
    seen = []
    engine = s.SLOEngine(
        [_err_spec(m, (s.BurnRule(long_s=10.0, short_s=5.0, factor=1.0),))],
        registry=reg, on_breach=lambda name, v: seen.append(name))
    counter = s.default_registry().counter("slo.breaches_total")
    n0 = counter.total(slo="t-err")
    out = [engine.tick(now=0.0)]
    total.inc(100)
    bad.inc(50)
    out.append(engine.tick(now=1.0))
    out.append(engine.tick(now=2.0))
    total.inc(1000)
    out.append(engine.tick(now=20.0))
    bad.inc(600)
    total.inc(600)
    out.append(engine.tick(now=21.0))
    return out, seen, counter.total(slo="t-err") - n0, engine.breached()


def _short_blip(m):
    s = m["slo"]
    reg = m["metrics"].MetricsRegistry()
    bad, total = reg.counter("t.bad"), reg.counter("t.total")
    engine = s.SLOEngine(
        [_err_spec(m, (s.BurnRule(long_s=100.0, short_s=5.0, factor=1.0),))],
        registry=reg, on_breach=lambda name, v: None)
    out = [engine.tick(now=0.0)]
    bad.inc(50)
    total.inc(100)
    out.append(engine.tick(now=1.0))
    total.inc(10_000)
    out.append(engine.tick(now=90.0))
    total.inc(500)
    out.append(engine.tick(now=96.0))
    return out


def _latency(m):
    s = m["slo"]
    reg = m["metrics"].MetricsRegistry()
    h = reg.histogram("t.lat3", buckets=(0.01, 0.1, 1.0))
    spec = s.SLOSpec(name="t-lat", kind="latency", histogram="t.lat3",
                     quantile=0.5, ceiling_s=0.1, budget=0.5,
                     labels=(("bucket", "n16"),),
                     rules=(s.BurnRule(10.0, 5.0, 1.0),))
    engine = s.SLOEngine([spec], registry=reg,
                         on_breach=lambda name, v: None)
    out = [engine.tick(now=0.0)]
    for i in range(100):
        h.observe(0.5 if i % 4 else 0.05, bucket="n16")
        h.observe(0.001, bucket="n32")   # another bucket: filtered out
    out.append(engine.tick(now=1.0))
    out.append(engine.tick(now=30.0))
    return out


def _ratio_and_value_floors(m):
    """The stream skip-rate floor (one counter split by a ``key`` label)
    and two static floors (a gauge, and a missing bench file)."""
    s = m["slo"]
    reg = m["metrics"].MetricsRegistry()
    steps = reg.counter("stream.steps")
    reg.gauge("t.recall").set(0.9)
    specs = [s.SLOSpec(name="skip", kind="ratio_floor", good="stream.steps",
                       good_labels=(("key", "hits"),), total="stream.steps",
                       total_labels=(("key", "graph_updates"),), floor=0.5,
                       rules=(s.BurnRule(30.0, 5.0, 1.0),)),
             s.SLOSpec(name="recall", kind="value_floor",
                       value_from="gauge:t.recall", floor=0.95),
             s.SLOSpec(name="bench", kind="value_floor",
                       value_from="bench:nosuch:row.metric", floor=0.5)]
    engine = s.SLOEngine(specs, registry=reg, on_breach=lambda n, v: None,
                         bench_dir="no/such/dir")
    out = [engine.tick(now=0.0)]
    steps.inc(100, key="graph_updates")
    steps.inc(80, key="hits")
    out.append(engine.tick(now=1.0))
    steps.inc(100, key="graph_updates")
    steps.inc(10, key="hits")
    out.append(engine.tick(now=2.0))
    return out


@pytest.mark.parametrize("case", [_short_blip, _latency,
                                  _ratio_and_value_floors])
def test_slo_engine_lockstep_with_repro(case):
    got, want = case(PORT), case(REPRO)
    # through JSON, so an empty window's NaN quantile compares equal
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)
    assert len(got) >= 3


def test_slo_breach_and_recovery_lockstep_with_repro():
    got, want = _breach_and_recovery(PORT), _breach_and_recovery(REPRO)
    assert got == want
    ticks, seen, breaches, breached = got
    assert [t["t-err"]["status"] for t in ticks] == [
        "no_data", "breach", "breach", "ok", "breach"]
    assert seen == ["t-err", "t-err"] and breaches == 2
    assert breached == ["t-err"]
    rules = ticks[1]["t-err"]["rules"][0]
    assert rules["burn_long"] == pytest.approx(50.0)


def test_slo_gauges_match_repro():
    # the burn-rate and status gauges the engines set on their default
    # registries carry the same series after the same ticks
    _breach_and_recovery(PORT)
    _breach_and_recovery(REPRO)
    for name in ("slo.burn_rate", "slo.status"):
        ours = obs.get_instrument(name).series()
        theirs = metrics_j.default_registry().get(name).series()
        assert {k: v for k, v in ours.items() if ("slo", "t-err") in k} == {
            k: v for k, v in theirs.items() if ("slo", "t-err") in k}


def test_slo_spec_validation_like_repro():
    for m in (PORT, REPRO):
        s = m["slo"]
        for kwargs in (dict(name="x", kind="nope"),
                       dict(name="x", kind="latency"),
                       dict(name="x", kind="error_rate", bad="b"),
                       dict(name="x", kind="ratio_floor", total="t"),
                       dict(name="x", kind="value_floor"),
                       dict(name="x", kind="error_rate", bad="b", total="t",
                            rules=())):
            with pytest.raises(ValueError):
                s.SLOSpec(**kwargs)
        with pytest.raises(ValueError):
            s.BurnRule(long_s=1.0, short_s=5.0)
        with pytest.raises(ValueError, match="duplicate"):
            s.SLOEngine([_err_spec(m, s.DEFAULT_RULES)] * 2)


def test_default_serve_slos_same_shape_as_repro():
    specs, specs_j = slo.default_serve_slos(), slo_j.default_serve_slos()
    assert len(specs) == 2 * 4 + 4
    assert [dataclasses.asdict(s) for s in specs] == [
        dataclasses.asdict(s) for s in specs_j]
    assert [s.bad_budget for s in specs] == [s.bad_budget for s in specs_j]


def test_install_uninstall_roundtrip():
    reg = metrics.MetricsRegistry()
    engine = slo.SLOEngine([_err_spec(PORT, slo.DEFAULT_RULES)],
                           registry=reg, on_breach=lambda name, v: None)
    prev = slo.install(engine)
    try:
        assert slo.installed() is engine
        assert "t-err" in slo.slo_status(tick=True)
        assert slo.verdict_block()["installed"] is True
    finally:
        assert slo.install(prev) is engine
    if prev is None:
        assert slo.slo_status() == {}
        assert slo.verdict_block()["status"] == {}


# ------------------------------------------------------------ HTTP exporter

PATHS = ("/metrics", "/healthz", "/readyz", "/varz", "/slo", "/debug/flight",
         "/", "/nope")


def _scrape_all(m, reg):
    """Every endpoint of package ``m``'s exporter over ``reg``: (status,
    JSON keys or Prometheus text) per path, before and after a stale
    heartbeat and a ready frontend."""
    srv = m["http"].start_http_server(port=0, registry=reg,
                                      health_max_age_s=1.0)
    assert srv.host == "127.0.0.1" and srv.port > 0
    out = []
    try:
        for phase in ("fresh", "stale+ready"):
            if phase == "stale+ready":
                reg.gauge("serve.heartbeat_ts").set(
                    time.time() - 100, frontend="topo", instance="t-0")
                reg.gauge("serve.ready").set(1, frontend="topo",
                                             instance="t-0")
            for path in PATHS:
                code, body = _get(srv.url + path)
                if path == "/metrics":  # the stale stamp is the clock's
                    out.append((phase, path, code, [
                        line for line in body.decode().splitlines()
                        if not line.startswith("serve_heartbeat_ts{")]))
                else:
                    doc = json.loads(body)
                    out.append((phase, path, code, sorted(doc),
                                doc.get("status") if path in (
                                    "/healthz", "/readyz") else None))
    finally:
        srv.stop()
    assert srv._thread is None
    return out


def test_http_endpoints_match_repro():
    got = _scrape_all(PORT, _feed(PORT))
    want = _scrape_all(REPRO, _feed(REPRO))
    assert got == want
    codes = {(phase, path): code for phase, path, code, *_ in got}
    assert codes[("fresh", "/healthz")] == 200
    assert codes[("fresh", "/readyz")] == 503
    assert codes[("stale+ready", "/healthz")] == 503
    assert codes[("stale+ready", "/readyz")] == 200
    assert codes[("fresh", "/nope")] == 404


def test_loop_health_and_readiness_match_repro():
    for m in (PORT, REPRO):
        reg = m["metrics"].MetricsRegistry()
        assert m["http"].loop_health(reg)["status"] == "no_loops"
        assert m["http"].readiness(reg)["status"] == "not_ready"
    reg, reg_j = metrics.MetricsRegistry(), metrics_j.MetricsRegistry()
    now = time.time()
    for r in (reg, reg_j):
        r.gauge("serve.heartbeat_ts").set(now, frontend="topo",
                                          instance="t-0")
        r.gauge("serve.heartbeat_ts").set(now - 100, frontend="sim",
                                          instance="s-0")
        r.gauge("serve.ready").set(1, frontend="topo", instance="t-0")
    h, h_j = http.loop_health(reg), http_j.loop_health(reg_j)
    assert h["status"] == h_j["status"] == "stale"
    assert h["stale"] == h_j["stale"] == ["sim/s-0"]
    assert http.readiness(reg) == http_j.readiness(reg_j)


def _prom_samples(text: str) -> int:
    n = 0
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        name_part, _, value_part = line.rpartition(" ")
        assert name_part, line
        float(value_part)
        n += 1
    return n


def test_scrape_concurrent_with_drains_and_readyz_follows_the_loop():
    server = TopoServe(TopoServeConfig(dim=1, method="prunit",
                                       sublevel=False, max_batch=8,
                                       pad_batch_to=8), device="cpu")
    srv = obs.start_http_server(port=0)
    stop = threading.Event()
    errors: list[BaseException] = []
    n_scrapes = [0] * 2

    def scraper(i: int):
        while not stop.is_set():
            try:
                code, body = _get(srv.url + "/metrics")
                assert code == 200
                assert _prom_samples(body.decode()) > 0
                n_scrapes[i] += 1
            except BaseException as e:  # noqa: BLE001 - reported below
                errors.append(e)
                return
            stop.wait(0.005)

    threads = [threading.Thread(target=scraper, args=(i,), daemon=True)
               for i in range(2)]
    loop = threading.Thread(target=server.serve_forever, daemon=True)
    ready = obs.gauge("serve.ready")
    try:
        for t in threads:
            t.start()
        for _ in range(3):                  # drains mutate counters
            futs = [server.submit(edges=[(0, 1), (1, 2), (2, 0)],
                                  n_vertices=3) for _ in range(6)]
            server.drain()
            for f in futs:
                f.result(timeout=60)
        loop.start()
        deadline = time.monotonic() + 30
        while ready.value(frontend="topo",
                          instance=server._obs_instance) != 1:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        code, body = _get(srv.url + "/readyz")
        assert code == 200, body
        assert f"topo/{server._obs_instance}" in json.loads(body)["ready"]
        assert server.submit(edges=[(0, 1)], n_vertices=2).result(
            timeout=60) is not None
        # this loop's heartbeat is fresh (loops of other servers in the
        # process may have gone stale since they stopped)
        code, body = _get(srv.url + "/healthz")
        assert code in (200, 503)
        assert json.loads(body)["loops"][
            f"topo/{server._obs_instance}"] < 5.0
    finally:
        server.stop()
        loop.join(timeout=10)
        stop.set()
        for t in threads:
            t.join(timeout=10)
        srv.stop()
    assert not loop.is_alive() and not any(t.is_alive() for t in threads)
    assert not errors, errors[0]
    assert all(n > 0 for n in n_scrapes), n_scrapes
    assert ready.value(frontend="topo", instance=server._obs_instance) == 0


def test_slo_endpoint_reads_the_installed_engine():
    reg = metrics.MetricsRegistry()
    bad, total = reg.counter("t.bad"), reg.counter("t.total")
    engine = slo.SLOEngine(
        [_err_spec(PORT, (slo.BurnRule(long_s=10.0, short_s=5.0),))],
        registry=reg, on_breach=lambda name, v: None)
    prev = slo.install(engine)
    srv = http.start_http_server(port=0, registry=reg)
    try:
        engine.tick()
        total.inc(10)
        bad.inc(5)
        code, body = _get(srv.url + "/slo")
        doc = json.loads(body)
        assert code == 200 and sorted(doc) == ["breaches", "status", "ts"]
        assert doc["status"]["t-err"]["status"] == "breach"
        assert doc["breaches"].get("t-err", 0) >= 1
        code, body = _get(srv.url + "/debug/flight")
        assert any(e["kind"] == "slo" and e["name"] == "t-err"
                   for e in json.loads(body)["events"])
    finally:
        srv.stop()
        slo.install(prev)
        flight.clear()
