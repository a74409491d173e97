"""The port's trace-report path against ``repro``'s: ``obs/report.py``,
``perfgate/cost_cells.py``, ``launch/roofline.py``, the
``python -m repro_torch.obs`` CLI, and the kernel spans and the
``kernels.calls`` counter of ``kernels/ops.py``.

Everything runs on the CPU.  Report rows are held equal to ``repro``'s
(span, shape, calls, total and self time, order); only the cost-cell column
may differ, since the port's cells are the card's.  Kernel span names and
shape strings are held equal to what ``repro``'s wrappers emit for the same
inputs (its Pallas kernels in interpret mode); ``repro``'s gf2 kernel raises
on this jax, so its two shape strings are the expressions of its
``kernels/ops.py``.  Bounds are held within 1% of ``PERF.md`` §6's.
"""
from __future__ import annotations

import io
import json
import threading
from contextlib import redirect_stdout

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as obs_j
from repro.kernels import ops as ops_j
from repro.obs import __main__ as cli_j
from repro.obs import report as report_j
from repro.perfgate import cost_cells as cost_cells_j
from repro_torch import counters, obs
from repro_torch.convert import graph_batch_from_numpy
from repro_torch.core import api
from repro_torch.kernels import ops, ref
from repro_torch.launch import roofline
from repro_torch.metrics import testing
from repro_torch.obs import __main__ as cli
from repro_torch.obs import slo
from repro_torch.obs.report import (
    KERNEL_CELLS, aggregate, format_report, load_trace)
from repro_torch.perfgate import attribute, parse_shape
from tests.conftest import graphs_to_batch, random_graphs


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: these tests run many small torch ops, which
    gain nothing from threads, and parallel test workers would
    oversubscribe the CPUs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tracing():
    """Tracing on in both packages, empty buffers; off again after."""
    for o in (obs, obs_j):
        o.configure(enabled=True)
        o.clear_trace()
    yield
    for o in (obs, obs_j):
        o.configure(enabled=False)
        o.clear_trace()


def _kernel_spans(o) -> list[tuple[str, str]]:
    return [(e["name"], e["args"].get("shape", ""))
            for e in o.trace_events() if e["name"].startswith("kernels.")]


# ------------------------------------------------------------ the report

def _synthetic_events() -> list[dict]:
    """Nested spans on two threads of two processes' worth of ids, kernel
    spans with shape tokens, a span without args, and a non-"X" event."""
    rng = np.random.default_rng(5)
    events = []
    for tid in (11, 12):
        t = float(tid)
        for i in range(6):
            dur = float(rng.integers(200, 400))
            events.append({"name": "serve.batch", "ph": "X", "ts": t,
                           "dur": dur, "pid": 1, "tid": tid,
                           "args": {"bucket": f"n{16 * (i % 2 + 1)}"}})
            k = t + 5.0
            for name, shape in (("kernels.domination", "B128_N16"),
                                ("kernels.kcore_peel", "B128_N16"),
                                ("kernels.gf2_reduce_batch",
                                 f"B128_S{40 + 8 * (i % 2)}"),
                                ("kernels.hamming_scan", "Q7_N1024_W4")):
                kd = float(rng.integers(10, 40))
                events.append({"name": name, "ph": "X", "ts": k, "dur": kd,
                               "pid": 1, "tid": tid,
                               "args": {"shape": shape,
                                        "parent": "serve.batch"}})
                inner = {"name": "plan.step", "ph": "X", "ts": k + 1.0,
                         "dur": kd / 4, "pid": 1, "tid": tid}
                events.append(inner)  # no args at all
                k += kd + 2.0
            t += dur + float(rng.integers(1, 20))
    events.append({"name": "serve.queue", "ph": "i", "ts": 3.0, "pid": 1,
                   "tid": 11})
    return events


@pytest.mark.parametrize("form", ["object", "array"])
def test_aggregate_and_format_equal_repro(tmp_path, form):
    events = _synthetic_events()
    doc = {"traceEvents": events} if form == "object" else events
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(doc))
    evs, evs_j = load_trace(str(path)), report_j.load_trace(str(path))
    assert evs == evs_j and len(evs) == len(events) - 1
    rows, rows_j = aggregate(evs), report_j.aggregate(evs_j)
    keys = ("span", "shape", "calls", "total_us", "self_us")
    assert [[r[k] for k in keys] for r in rows] == \
        [[r[k] for k in keys] for r in rows_j]
    for top in (3, 50):
        text = format_report(evs, top=top).splitlines()
        text_j = report_j.format_report(evs_j, top=top).splitlines()
        assert text[:3] == text_j[:3] and len(text) == len(text_j)
        for a, b in zip(text[3:], text_j[3:]):
            if "%  " in a:  # the cost-cell column may differ
                a, b = a.split("%  ")[0], b.split("%  ")[0]
            assert a == b
    assert format_report([]) == report_j.format_report([]) == "(empty trace)"


def test_kernel_cells_are_repros_and_carry_the_cards_cells():
    assert KERNEL_CELLS == report_j.KERNEL_CELLS
    assert "kernels.hamming_scan" not in KERNEL_CELLS
    assert "kernels.auction_lap_collapsed" not in KERNEL_CELLS
    from repro_torch.obs.report import cost_cell_for

    assert cost_cell_for("serve.batch", "B8_N16") is None
    cell = cost_cell_for("kernels.domination", "B4096_N64")
    assert cell["modeled"] and cell["bound"] == "memory"


# every shape string the kernel wrappers emit, at the main path's shapes
SHAPES = ["B4096_N64", "B256_N320", "B16_N1024", "S120", "S512",
          "B689_S128", "B253_S512", "B689_S248_C632", "G4096_D652",
          "G72_D372", "B2048_M32", "B128_M3200", "B2048_K16",
          "Q256_N4096_W4", "B32_N128_jnp_s", "no_tokens", ""]


@pytest.mark.parametrize("shape", SHAPES)
def test_parse_shape_equals_repro(shape):
    assert parse_shape(shape) == cost_cells_j.parse_shape(shape)


@pytest.mark.parametrize("bench,shape,want_ms,by", [
    ("kernel_domination", "B4096_N64", 0.01009, "memory"),
    ("kernel_kcore", "B4096_N64", 0.00516, "memory"),
    ("kernel_pairwise_gram", "G4096_D652", 0.653, "compute"),
    # unmapped by KERNEL_CELLS, modeled all the same (PERF.md §6 row 11
    # and the collapsed auction at exact_n64)
    ("kernel_hamming", "Q256_N4096_W4", 0.001274, "memory"),
    ("kernel_auction_collapsed", "B2048_K16", 0.000768, "memory"),
])
def test_attribute_gives_the_perf_md_bounds(bench, shape, want_ms, by):
    """The bounds PERF.md §6 gives for these shapes (chip_smoke.py's
    counts), within 1%."""
    cell = attribute("obs", bench, shape)
    assert cell["modeled"] and cell["bound"] == by
    assert abs(cell["bound_s"] * 1e3 - want_ms) <= 0.01 * want_ms
    assert set(cost_cells_j.attribute("obs", bench, shape)) <= set(cell)
    assert cell["flops"] == sum(cell["ops"].values())


def test_domination_bound_is_chip_smokes():
    import chip_smoke

    got = attribute("obs", "kernel_domination", "B4096_N64")["bound_s"]
    want = chip_smoke._domination_bounds(4096, 64)
    assert want["bound_by"] == "bytes"
    assert abs(got * 1e3 - want["bound_ms"]) <= 1e-12


@pytest.mark.parametrize("span,shape", [
    ("kernels.gf2_reduce", "S120"), ("kernels.gf2_reduce_batch", "B689_S128"),
    ("kernels.gf2_reduce_batch", "B689_S248_C632"),
    ("kernels.sinkhorn_lse", "B2048_M64"),
    ("kernels.sinkhorn_pair_sum", "B128_M3200"),
    ("kernels.auction_lap", "B128_M128"),
    ("kernels.common_neighbors", "B4096_N64"),
    ("kernels.pairwise_l1", "G72_D372")])
def test_every_mapped_span_is_modeled(span, shape):
    cell = attribute("obs", KERNEL_CELLS[span], shape)
    assert cell["modeled"] and cell["bound_s"] > 0
    data_bound = span.split(".")[1] in (
        "gf2_reduce", "gf2_reduce_batch", "sinkhorn_lse",
        "sinkhorn_pair_sum", "auction_lap", "common_neighbors")
    assert ("shape-only" in cell["cell"]) == data_bound


def test_unmodeled_rows_name_their_layer():
    for bench, cell in (("serve_drain", "TopoServe"), ("stream_x", "Stream"),
                        ("kernel_unknown", "kernel")):
        got = attribute("suite", bench, "B8")
        assert not got["modeled"] and cell in got["cell"]
    assert attribute("suite", "kernel_domination", "x")["bound"] == \
        "unmodeled"
    assert attribute("suite", "other", "x")["cell"] == "suite/other"


def test_roofline_terms_and_bound_ms():
    t = roofline.roofline_terms(3.35e12, {"lane": 33.5e12, "mufu": 0.0})
    assert t["memory_s"] == t["compute_s"] == t["bound_s"] == 1.0
    assert t["dominant"] == "memory"  # a tie is bytes, as chip_smoke's was
    assert roofline.bound_ms(3.35e9, {}) == (1.0, "bytes")
    ms, by = roofline.bound_ms(0.0, {"mufu": roofline.MUFU_OPS_PER_S})
    assert (ms, by) == (1e3, "operations")
    assert roofline.roofline_terms(0, {"int8_tc": 1979e12})[
        "compute_unit"] == "int8_tc"
    with pytest.raises(ValueError, match="unknown units"):
        roofline.roofline_terms(1.0, {"fp64": 1.0})


# ----------------------------------------------------------------- the CLI

def _run(main, argv) -> tuple[int, str]:
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def test_cli_report(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": _synthetic_events()}))
    rc, out = _run(cli.main, ["report", str(path), "--top", "4"])
    assert rc == 0
    assert out == obs.report(str(path), top=4) + "\n"
    rc_j, out_j = _run(cli_j.main, ["report", str(path), "--top", "4"])
    assert rc_j == 0
    assert out.splitlines()[:3] == out_j.splitlines()[:3]


SLO_FILES = {
    "ok": {"ts": 1.0, "status": {"latency": {"status": "ok"},
                                 "errors": {"status": "no_data"}}},
    "breach": {"status": {"latency": {"status": "breach",
                                      "description": "p99 under 2 s"},
                          "errors": {"status": "ok"}}},
    "bare": {"latency": {"status": "breach"}},
    "empty": {"status": {}},
}


@pytest.mark.parametrize("name", [*SLO_FILES, "missing"])
def test_cli_slo_check_file_exit_codes_equal_repro(tmp_path, name):
    path = tmp_path / f"{name}.json"
    if name in SLO_FILES:
        path.write_text(json.dumps(SLO_FILES[name]))
    argv = ["slo", "check", "--file", str(path)]
    rc, out = _run(cli.main, argv)
    rc_j, out_j = _run(cli_j.main, argv)
    assert rc == rc_j == {"ok": 0, "breach": 1, "bare": 1}.get(name, 2)
    assert out == out_j


def test_cli_slo_check_url(tmp_path):
    """Against a running exporter of the port: the same verdict as
    ``repro``'s CLI on the same URL; an address nobody serves gives 2."""
    prev = slo.install(slo.SLOEngine(slo.default_serve_slos()))
    srv = obs.start_http_server(port=0)
    try:
        rc, out = _run(cli.main, ["slo", "check", "--url", srv.url])
        rc_j, _ = _run(cli_j.main, ["slo", "check", "--url", srv.url + "/slo"])
        assert rc == rc_j == 0 and "[slo check] OK" in out
    finally:
        srv.stop()
        slo.install(prev)
    rc, out = _run(cli.main, ["slo", "check", "--url", srv.url,
                              "--timeout", "2"])
    assert rc == 2 and "cannot reach" in out


@pytest.mark.parametrize("demo", [False, True])
def test_cli_watch_prints_verdicts_and_stops(demo):
    before = {t.ident for t in threading.enumerate()}
    prev = slo.installed()
    argv = ["watch", "--port", "0", "--interval", "0.1", "--duration", "0.3",
            "--device", "cpu"] + (["--demo"] if demo else [])
    try:
        rc, out = _run(cli.main, argv)
    finally:
        slo.install(prev)
    assert rc == 0
    lines = out.splitlines()
    assert lines[0].startswith("[watch] exporter at http://127.0.0.1:")
    verdicts = [ln for ln in lines[1:] if ln.startswith("[watch ")]
    assert verdicts and all("latency" in ln for ln in verdicts)
    left = [t for t in threading.enumerate() if t.ident not in before]
    for t in left:
        t.join(timeout=5)
    assert not [t for t in left if t.is_alive()]


# ------------------------------------------- kernel spans and the counter

def _graphs(b, n, p, seed):
    rng = np.random.default_rng(seed)
    adj = np.triu(rng.random((b, n, n)) < p, 1)
    adj = adj | adj.transpose(0, 2, 1)
    mask = rng.random((b, n)) < 0.85
    return adj & mask[:, None, :] & mask[:, :, None], mask


def _wrapper_calls():
    """(name, port call, repro call) on the same seeded inputs; a repro
    call of None means its shape string is taken from its source."""
    adj, mask = _graphs(3, 16, 0.3, seed=1)
    a, m = torch.from_numpy(adj), torch.from_numpy(mask)
    aj, mj = jnp.asarray(adj), jnp.asarray(mask)
    rng = np.random.default_rng(2)
    x = rng.uniform(0, 8, (5, 33)).astype(np.float32)
    y = rng.uniform(0, 8, (7, 33)).astype(np.float32)
    cq, cd, mq = testing.hamming_operands(rng, 5, 40, 16, "probe")
    au = testing.auction_operands(rng, 2, 6, "warm", "cpu")
    cost = au["cbar"].abs().contiguous()
    coll = [au[k] for k in ("cbar", "keep1", "keep2", "price0")]
    sk = testing.sinkhorn_operands(rng, 2, 12, 9, 3, device="cpu")
    sk_np = {k: v.numpy() for k, v in sk.items()}

    def pad8(p):
        return np.concatenate([p, np.zeros((p.shape[0], 5, p.shape[2]),
                                           np.float32)], axis=1)

    skj = {k: jnp.asarray(pad8(v) if k in ("xp", "yp") else v)
           for k, v in sk_np.items()}
    lse = ("xp", "yp", "g", "log_b", "e_t")
    pair = ("xp", "yp", "f", "g", "log_a", "log_b", "e_t")
    words = rng.integers(-2**31, 2**31, (3, 40, 2), dtype=np.int64)
    words[..., 1] &= 0xFF  # 40 rows: bits 0-39
    block = torch.from_numpy(words.astype(np.int32))
    return [
        ("domination", lambda: ops.domination(a, m),
         lambda: ops_j.domination(aj, mj, tile=8)),
        ("kcore_peel", lambda: ops.kcore_peel(a, m, 2, sweeps=1),
         lambda: ops_j.kcore_peel(aj, mj, 2, tile=8)),
        ("common_neighbors", lambda: ops.common_neighbors(a),
         lambda: ops_j.common_neighbors(aj, tile=8)),
        ("clustering", lambda: ops.clustering_coefficients(a, m),
         lambda: ops_j.clustering_coefficients(aj, mj, tile=8)),
        ("pairwise_l1",
         lambda: ops.pairwise_l1(torch.from_numpy(x), torch.from_numpy(y)),
         lambda: ops_j.pairwise_l1(jnp.asarray(x), jnp.asarray(y))),
        ("hamming_scan", lambda: ops.hamming_scan(cq, cd, mq, device="cpu"),
         lambda: ops_j.hamming_scan(cq, cd, mq)),
        ("auction_lap", lambda: ops.auction_lap(cost, n_scales=3),
         lambda: ops_j.auction_lap(jnp.asarray(cost.numpy()), n_scales=3)),
        ("auction_lap_collapsed",
         lambda: ops.auction_lap_collapsed(*coll, n_scales=3),
         lambda: ops_j.auction_lap_collapsed(
             *(jnp.asarray(t.numpy()) for t in coll), n_scales=3)),
        ("sinkhorn_lse", lambda: ops.sinkhorn_lse(*(sk[k] for k in lse)),
         lambda: ops_j.sinkhorn_lse(*(skj[k] for k in lse))),
        ("sinkhorn_pair_sum",
         lambda: ops.sinkhorn_pair_sum(*(sk[k] for k in pair)),
         lambda: ops_j.sinkhorn_pair_sum(*(skj[k] for k in pair))),
        # repro's gf2 Pallas kernel raises on this jax: its strings are
        # f"S{b.shape[0]}" and f"B{b.shape[0]}_S{b.shape[1]}"
        # (src/repro/kernels/ops.py, gf2_reduce and gf2_reduce_batch)
        ("gf2_reduce", lambda: ops.gf2_reduce(block[0]),
         [("kernels.gf2_reduce", f"S{block.shape[1]}")]),
        ("gf2_reduce_batch", lambda: ops.gf2_reduce_batch(block),
         [("kernels.gf2_reduce_batch",
           f"B{block.shape[0]}_S{block.shape[1]}")]),
    ]


WRAPPERS = [c[0] for c in _wrapper_calls()]


@pytest.mark.parametrize("name", WRAPPERS)
def test_span_names_and_shapes_equal_repros(tracing, name):
    _, port_call, repro_call = next(c for c in _wrapper_calls()
                                    if c[0] == name)
    port_call()
    got = _kernel_spans(obs)
    if callable(repro_call):
        repro_call()
        want = _kernel_spans(obs_j)
    else:
        want = repro_call
    assert got == want and len(got) == 1


def test_main_path_spans_equal_repros(tracing, monkeypatch):
    """``topological_signature`` on the CPU: every kernel span the port's
    main path opens is the one ``repro``'s wrapper opens on the same
    inputs (recorded as the path passes them); the multi-block GF(2)
    launch's string is the port's own form."""
    gj = graphs_to_batch(random_graphs("er", 3, seed=1)
                         + random_graphs("ba", 3, seed=2), n_pad=24)
    g = graph_batch_from_numpy(np.asarray(gj.adj), np.asarray(gj.mask),
                               np.asarray(gj.f), device="cpu")
    want = []
    real = {k: getattr(ops, k) for k in ("domination", "kcore_peel",
                                         "gf2_reduce_blocks")}

    def dom(adj, mask):
        ops_j.domination(jnp.asarray(adj.numpy()), jnp.asarray(mask.numpy()),
                         tile=8)
        return real["domination"](adj, mask)

    def kcore(adj, alive, k, sweeps=1):
        ops_j.kcore_peel(jnp.asarray(adj.numpy()),
                         jnp.asarray(alive.numpy()), k, tile=8)
        return real["kcore_peel"](adj, alive, k, sweeps)

    def blocks(bl, rows):
        bl = list(bl)
        g_, cols = bl[0].shape[0], sum(b.shape[1] for b in bl)
        words = sum(b.shape[1] * b.shape[2] for b in bl)
        want.append(("kernels.gf2_reduce_batch", f"B{g_}_S{cols}_C{words}"))
        return real["gf2_reduce_blocks"](bl, rows)

    for k, fn in (("domination", dom), ("kcore_peel", kcore),
                  ("gf2_reduce_blocks", blocks)):
        monkeypatch.setattr(ops, k, fn)
    api.topological_signature(g, dim=1, method="both", edge_cap=96,
                              tri_cap=128)
    got = _kernel_spans(obs)
    names = {n for n, _ in got}
    assert names == {"kernels.domination", "kernels.kcore_peel",
                     "kernels.gf2_reduce_batch"}
    assert [s for s in got if s[0] != "kernels.gf2_reduce_batch"] == \
        _kernel_spans(obs_j)
    assert [s for s in got if s[0] == "kernels.gf2_reduce_batch"] == want


def _as_launches(monkeypatch):
    """Route every wrapper to its launch branch, each ``*_cuda`` entry
    replaced by its plain version, so the launch sites count here."""
    monkeypatch.setattr(ops, "_route", lambda device, kernel: True)
    fakes = {
        "kcore_peel_cuda": lambda adj, alive, k, sweeps: ref.kcore_peel_ref(
            adj, alive, k),
        "domination_cuda": ref.domination_ref,
        "gf2_reduce_cuda": lambda bl, rows: [ref.gf2_reduce_ref(b, r)
                                             for b, r in zip(bl, rows)],
        "common_neighbors_cuda": ref.common_neighbors_ref,
        "common_neighbors_rowsums_cuda": ref.common_neighbors_rowsums_ref,
        "pairwise_l1_cuda": ref.pairwise_l1_ref,
        "hamming_scan_cuda": ref.hamming_scan_ref,
        "auction_lap_cuda": lambda c, ladder, r: ref.auction_lap_ref(
            c, n_scales=ladder.numel(), max_rounds=r),
        "auction_lap_collapsed_cuda": (
            lambda c, k1, k2, p0, ladder, r, rev: ref.auction_lap_collapsed_ref(
                c, k1, k2, p0, n_scales=ladder.numel(), max_rounds=r,
                rev_every=rev)),
        "sinkhorn_lse_cuda": lambda xp, yp, d, lw, e, packed: (
            ref.sinkhorn_lse_ref(xp, yp, d, lw, e)),
        "sinkhorn_pair_sum_cuda": ref.sinkhorn_pair_sum_ref,
    }
    for k, fn in fakes.items():
        monkeypatch.setattr(ops, k, fn)


def test_kernels_calls_counts_each_launch_once(tracing, monkeypatch):
    """``kernels.calls`` moves with ``counters.KERNEL_LAUNCHES``, launch
    for launch (the gf2 labels summed into its one launch count), and each
    launch opens one span."""
    _as_launches(monkeypatch)
    calls = obs.get_instrument("kernels.calls")
    before = calls.labeled("kernel")
    counters.reset()
    for _, port_call, _ in _wrapper_calls():
        port_call()
    after = calls.labeled("kernel")
    delta = {k: after.get(k, 0) - before.get(k, 0) for k in after}
    delta = {k: v for k, v in delta.items() if v}
    launches = {k: v for k, v in counters.KERNEL_LAUNCHES.items() if v}
    gf2 = delta.pop("gf2_reduce") + delta.pop("gf2_reduce_batch")
    assert gf2 == launches.pop("gf2_reduce") == 2
    assert delta == launches
    assert sum(launches.values()) + gf2 == len(_kernel_spans(obs)) == 12
    assert launches["common_neighbors"] == 2  # the counts and the clustering


def test_kernels_calls_series_equals_repros():
    assert ops._KCALLS.help == ops_j._KCALLS.help
    reg, reg_j = obs.MetricsRegistry(), obs_j.MetricsRegistry()
    for r, o in ((reg, obs), (reg_j, obs_j)):
        c = r.counter("kernels.calls", help=ops._KCALLS.help)
        for name in ("domination", "gf2_reduce_batch", "domination"):
            c.inc(kernel=name)
    assert obs.prometheus_text(reg) == obs_j.prometheus_text(reg_j)
    assert 'kernels_calls_total{kernel="domination"} 2' in \
        obs.prometheus_text(reg)


def test_spans_cost_nothing_while_tracing_is_off():
    obs.configure(enabled=False)
    obs.clear_trace()
    adj, mask = _graphs(2, 8, 0.3, seed=3)
    ops.domination(torch.from_numpy(adj), torch.from_numpy(mask))
    assert obs.trace_events() == []
    assert obs.span("kernels.domination", shape="B2_N8") is \
        obs.span("x")  # the shared no-op
