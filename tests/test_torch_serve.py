"""The port's TopoServe and StreamServe against ``repro``'s.

Both packages get the same numpy-made edge lists and deltas.  Bucket
routing and ``pack_requests`` (adj, mask, f) are bitwise equal; the same
traffic through both servers gives the same executed batches, and every
served Diagrams is bitwise ``repro``'s and bitwise a direct
``topological_signature`` of its recorded batch (the ``serve_bench``
parity check) for methods ``none``/``prunit``/``both``, repack off and on
and padded batches.  Submit validation, failed batches, cancel, the
deadline sweep, the ambient request id, ``stats`` and the drain threads
behave as ``repro``'s.  StreamServe sessions run in lockstep with
``repro``'s, info and Diagrams bitwise at every step (SW drift scores
within rtol 1e-5, as in tests/test_torch_stream.py).  ``repro`` runs with
its jnp reducer; the port on the CPU (its plain kernel versions).
"""
from __future__ import annotations

import asyncio
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.delta as delta_j
import repro.serve as serve_j
from repro.core.graph import GraphBatch as GraphBatchJ
from repro.core.graph import from_edge_lists as from_edge_lists_j
from repro.serve.topo_serve import pack_requests as pack_requests_j
from repro.stream import TopoStreamConfig as TopoStreamConfigJ
from repro.topo.features import feature_vector as feature_vector_j
from repro_torch import obs
from repro_torch.convert import delta_batch_from_numpy, graph_batch_from_numpy
from repro_torch.core.api import make_topo_plan, topological_signature
from repro_torch.core.delta import EDGE_INSERT, delta_from_lists, delta_step
from repro_torch.core.persistence import diagrams_bitwise_equal
from repro_torch.obs.context import DeadlineExceeded, request_context
from repro_torch.serve import (
    DEFAULT_BUCKETS,
    Bucket,
    FutureCancelled,
    SimilarityServe,
    StreamServe,
    TopoRequest,
    TopoServe,
    TopoServeConfig,
    pack_requests,
)
from repro_torch.serve import topo_serve
from repro_torch.data.temporal import ego_decay_stream
from repro_torch.stream import TopoStreamConfig
from repro_torch.topo.features import feature_vector, signature_features

BUCKETS = DEFAULT_BUCKETS[:2]  # n16 and n32


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: these tests run many small torch ops, which
    gain nothing from threads, and parallel test workers would
    oversubscribe the CPUs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _edges(rng, n, p):
    """One G(n, p) edge list (numpy), with a duplicate and a reversed entry
    now and then (submit dedupes them)."""
    iu, iv = np.nonzero(np.triu(rng.random((n, n)) < p, 1))
    edges = [(int(u), int(v)) for u, v in zip(iu, iv)]
    if edges and rng.random() < 0.3:
        u, v = edges[0]
        edges += [(u, v), (v, u)]
    return edges


def traffic(seed, count=24, n_min=3, n_max=30):
    """``count`` requests (edges, n, f) in the n16/n32 buckets; a third
    carry their own f."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        n = int(rng.integers(n_min, n_max + 1))
        p = float(rng.uniform(0.1, 0.35)) if n > 16 else float(
            rng.uniform(0.2, 0.6))
        f = (None if i % 3 else
             [float(x) for x in rng.integers(0, 6, n).astype(np.float32)])
        out.append((_edges(rng, n, p), n, f))
    return out


def _pair(**cfg):
    return (TopoServe(TopoServeConfig(buckets=BUCKETS, **cfg), device="cpu"),
            serve_j.TopoServe(serve_j.TopoServeConfig(
                buckets=tuple(serve_j.Bucket(*(b.n_pad, b.edge_cap,
                                               b.tri_cap)) for b in BUCKETS),
                reducer="jnp", **cfg)))


def _submit_both(srv, srv_j, reqs):
    futs = [srv.submit(e, n, f) for e, n, f in reqs]
    futs_j = [srv_j.submit(e, n, f) for e, n, f in reqs]
    return futs, futs_j


def _bucket_tuple(b):
    return (b.n_pad, b.edge_cap, b.tri_cap)


# ------------------------------------------------------------------ routing

ROUTING = [(3, 3, 0), (16, 64, 0), (16, 64, 96), (16, 64, 97), (17, 10, 0),
           (10, 65, 0), (32, 160, 256), (32, 160, 257), (13, 78, 286),
           (40, 200, 0), (64, 320, 512), (100, 700, 900)]


@pytest.mark.parametrize("ladder", ["default", "custom"])
def test_bucket_for_matches_repro(ladder):
    buckets = (DEFAULT_BUCKETS if ladder == "default"
               else (Bucket(8, 16, 16), Bucket(24, 96, 128)))
    srv = TopoServe(TopoServeConfig(buckets=buckets), device="cpu")
    srv_j = serve_j.TopoServe(serve_j.TopoServeConfig(
        buckets=tuple(serve_j.Bucket(*_bucket_tuple(b)) for b in buckets)))
    for nv, ne, nt in ROUTING:
        try:
            want = _bucket_tuple(srv_j.bucket_for(nv, ne, nt))
        except ValueError as e:
            with pytest.raises(ValueError, match="exceeds every bucket"):
                srv.bucket_for(nv, ne, nt)
            assert "exceeds every bucket" in str(e)
            continue
        assert _bucket_tuple(srv.bucket_for(nv, ne, nt)) == want


def test_triangle_dense_graph_promoted_past_tri_cap():
    # K13: 78 edges fit the n32 rung but its 286 triangles exceed tri_cap
    # 256, so both packages promote it to n64 and serve the same diagrams
    k13 = [(u, v) for u in range(13) for v in range(u + 1, 13)]
    srv = TopoServe(TopoServeConfig(method="none"), device="cpu")
    srv_j = serve_j.TopoServe(serve_j.TopoServeConfig(method="none",
                                                      reducer="jnp"))
    fut, fut_j = srv.submit(k13, 13), srv_j.submit(k13, 13)
    assert _bucket_tuple(fut.bucket) == _bucket_tuple(fut_j.bucket)
    assert fut.bucket.n_pad == 64
    srv.drain()
    srv_j.drain()
    assert diagrams_bitwise_equal(fut.result(), fut_j.result())
    assert int(fut.result().betti(0)) == 1 and int(fut.result().betti(1)) == 0


@pytest.mark.parametrize("f_mode", ["degree", "mixed", "given"])
def test_pack_requests_bitwise(f_mode):
    rng = np.random.default_rng(3)
    reqs = []
    for i in range(7):
        n = int(rng.integers(2, 17))
        edges = _edges(rng, n, 0.4)
        f = None
        if f_mode == "given" or (f_mode == "mixed" and i % 2):
            f = tuple(float(x) for x in rng.normal(size=n).astype(np.float32))
        reqs.append((tuple(edges), n, f))
    bucket = Bucket(16, 64, 96)
    g = pack_requests([TopoRequest(*r) for r in reqs], bucket, device="cpu")
    g_j = pack_requests_j([serve_j.TopoRequest(*r) for r in reqs],
                          serve_j.Bucket(16, 64, 96))
    for k in ("adj", "mask", "f"):
        np.testing.assert_array_equal(getattr(g, k).numpy(),
                                      np.asarray(getattr(g_j, k)), err_msg=k)


def test_duplicate_edges_degree_invariant_under_cobatching():
    dup = [(0, 1), (1, 0), (1, 2), (1, 2), (2, 0)]
    alone = TopoServe(TopoServeConfig(method="none"), device="cpu")
    f_alone = alone.submit(dup, 3)
    alone.drain()
    mixed = TopoServe(TopoServeConfig(method="none"), device="cpu")
    f_mixed = mixed.submit(dup, 3)
    mixed.submit([(0, 1)], 2, f=[5.0, 7.0])
    mixed.drain()
    assert diagrams_bitwise_equal(f_alone.result(), f_mixed.result())


# ---------------------------------------------------------------- serving

def _assert_served_parity(srv, srv_j, futs, futs_j):
    """Same executed batches; every served row bitwise repro's and a direct
    ``topological_signature`` of its recorded batch."""
    c = srv.config
    assert len(srv.executed_batches) == len(srv_j.executed_batches)
    for (b, reqs, bf), (b_j, reqs_j, bf_j) in zip(srv.executed_batches,
                                                  srv_j.executed_batches):
        assert _bucket_tuple(b) == _bucket_tuple(b_j)
        assert [(r.edges, r.n_vertices, r.f) for r in reqs] == [
            (r.edges, r.n_vertices, r.f) for r in reqs_j]
        g = pack_requests(reqs, b, device="cpu")
        if c.repack == "off":
            direct = topological_signature(
                g, dim=c.dim, method=c.method, sublevel=c.sublevel,
                edge_cap=b.edge_cap, tri_cap=b.tri_cap, quad_cap=c.quad_cap)
        else:  # the direct two-phase plan on the serve-wide ladder
            direct = make_topo_plan(
                dim=c.dim, method=c.method, sublevel=c.sublevel,
                edge_cap=b.edge_cap, tri_cap=b.tri_cap, quad_cap=c.quad_cap,
                repack="on", ladder=topo_serve.repack_ladder_for(
                    BUCKETS, c.quad_cap)).execute(g)
        for i, (f, f_j) in enumerate(zip(bf, bf_j)):
            got = f.result(timeout=0)
            assert diagrams_bitwise_equal(got, f_j.result(timeout=0))
            assert diagrams_bitwise_equal(got, topo_serve._row(direct, i))
            if c.repack == "on":
                assert f.repack_class == type(f.repack_class)(
                    *(getattr(f_j.repack_class, k) for k in
                      ("n_pad", "edge_cap", "tri_cap", "quad_cap")))
    assert all(f.done() for f in futs) and all(f.done() for f in futs_j)


@pytest.mark.parametrize("repack", ["off", "on"])
@pytest.mark.parametrize("method", ["none", "prunit", "both"])
def test_served_bitwise_repro_and_direct(method, repack):
    # requests over two buckets, chunks of at most 16 padded to 16 rows:
    # every executed batch holds padded rows, and each package builds one
    # batch shape a bucket.  repack="on" persists every group of graphs at
    # its rung (a jit compile a group in repro), so there the traffic is 10
    # graphs of 9-16 vertices in the n16 bucket
    n = 20 if repack == "off" else 10
    srv, srv_j = _pair(method=method, repack=repack, max_batch=16,
                       pad_batch_to=16, record_batches=True)
    futs, futs_j = _submit_both(srv, srv_j, traffic(
        11, count=n, n_min=3 if repack == "off" else 9,
        n_max=30 if repack == "off" else 16))
    assert srv.drain() == srv_j.drain() == len(futs)
    _assert_served_parity(srv, srv_j, futs, futs_j)
    assert [_bucket_tuple(f.bucket) for f in futs] == [
        _bucket_tuple(f.bucket) for f in futs_j]
    # the stats surface after the same traffic
    st, st_j = srv.stats, srv_j.stats
    assert st["padded_rows"] > 0
    per, per_j = st.pop("per_bucket"), st_j.pop("per_bucket")
    assert st == st_j
    assert {_bucket_tuple(b): v for b, v in per.items()} == {
        _bucket_tuple(b): v for b, v in per_j.items()}
    assert sum(st["repack_rungs"].values()) == (n if repack == "on" else 0)


def test_served_diagram_values():
    srv = TopoServe(TopoServeConfig(method="none"), device="cpu")
    c6 = srv.submit([(i, (i + 1) % 6) for i in range(6)], 6)
    k5 = srv.submit([(u, v) for u in range(5) for v in range(u + 1, 5)], 5)
    srv.drain()
    assert int(c6.result().betti(0)) == 1 and int(c6.result().betti(1)) == 1
    assert int(k5.result().betti(1)) == 0
    # a row is a view into its batch's tensors, not a copy
    assert c6.result().birth._base is not None


# ------------------------------------------------------------- validation

def test_oversize_and_malformed_rejected_like_repro():
    srv = TopoServe(device="cpu")
    srv_j = serve_j.TopoServe()
    cases = [
        (dict(edges=[(i, i + 1) for i in range(200)], n_vertices=201),
         "exceeds every bucket"),
        (dict(edges=[(0, 500)], n_vertices=5), "out of range"),
        (dict(edges=[(-1, 0)], n_vertices=5), "out of range"),
        (dict(edges=[(0, 1)], n_vertices=3, f=[1.0]), "f has"),
        (dict(edges=[], n_vertices=0), "n_vertices"),
    ]
    for kwargs, msg in cases:
        with pytest.raises(ValueError, match=msg) as e:
            srv.submit(**kwargs)
        with pytest.raises(ValueError) as e_j:
            srv_j.submit(**kwargs)
        assert str(e.value) == str(e_j.value)
    assert srv.pending() == 0


def test_config_validation():
    with pytest.raises(ValueError, match="not one of the port's reducers"):
        TopoServeConfig(reducer="jnp")
    with pytest.raises(ValueError, match="repack must be"):
        TopoServe(TopoServeConfig(repack="sometimes"), device="cpu")
    with pytest.raises(ValueError, match="non-empty"):
        TopoServe(TopoServeConfig(buckets=()), device="cpu")


def test_no_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (TopoServe, StreamServe, SimilarityServe):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


# ---------------------------------------------------------------- failures

def test_failed_batch_resolves_futures_with_error():
    # an unexecutable plan (unknown reduction) fails the futures in both
    # packages instead of hanging result()
    srv = TopoServe(TopoServeConfig(method="nonsense"), device="cpu")
    srv_j = serve_j.TopoServe(serve_j.TopoServeConfig(method="nonsense"))
    fut, fut_j = srv.submit([(0, 1), (1, 2)], 3), srv_j.submit([(0, 1),
                                                                 (1, 2)], 3)
    assert srv.drain() == srv_j.drain() == 0
    with pytest.raises(ValueError) as e:
        fut.result(timeout=1)
    with pytest.raises(ValueError) as e_j:
        fut_j.result(timeout=1)
    assert str(e.value) == str(e_j.value)
    assert srv.stats["failed"] == srv_j.stats["failed"] == 1


def test_failed_launch_resolves_batch_with_its_error(monkeypatch):
    # an error raised while the batch executes (a kernel launch, or the
    # device sync after it) reaches every future of that batch only
    srv = TopoServe(TopoServeConfig(buckets=BUCKETS, method="prunit"),
                    device="cpu")
    boom = RuntimeError("launch failed")
    plan = srv.plan_for(BUCKETS[1])
    real = type(plan).execute

    def execute(self, g):
        if g.n == BUCKETS[1].n_pad:
            raise boom
        return real(self, g)

    monkeypatch.setattr(type(plan), "execute", execute)
    small = srv.submit([(0, 1), (1, 2)], 3)
    big = [srv.submit([(0, 1)], 20) for _ in range(3)]
    assert srv.drain() == 1
    assert small.result(timeout=1) is not None
    for f in big:
        with pytest.raises(RuntimeError, match="launch failed"):
            f.result(timeout=1)
    assert srv.stats["failed"] == 3


# ------------------------------------------- cancel, deadlines, request ids

WATCH_CFG = dict(dim=1, method="prunit", sublevel=False, max_batch=8,
                 pad_batch_to=8)


def _watch_scenario(srv, request_context, cancelled, expired_error):
    """tests/test_obs_watch.py's cancel / deadline / request-id cases on
    one server (``request_context`` and the two exception types are its
    package's); returns what a client sees."""
    out = {}
    dead = srv.submit(edges=[(0, 1), (1, 2)], n_vertices=3)
    with pytest.raises(TimeoutError):
        dead.result(timeout=0.01)           # no drain loop running
    out["cancel"] = dead.cancel()
    out["cancel_again"] = dead.cancel()
    live = [srv.submit(edges=[(0, 1), (1, 2)], n_vertices=3)
            for _ in range(3)]
    expired = srv.submit(edges=[(0, 1), (1, 2)], n_vertices=3,
                         deadline_s=0.0)
    ok = srv.submit(edges=[(0, 1), (1, 2)], n_vertices=3, deadline_s=60.0)
    with request_context(request_id="req-77"):
        ambient = srv.submit(edges=[(0, 1)], n_vertices=2)
    explicit = srv.submit(edges=[(0, 1)], n_vertices=2, request_id="req-88",
                          deadline_s=60.0)
    time.sleep(0.01)
    out["served"] = srv.drain()
    out["pending"] = srv.pending()
    out["live"] = [f.result(timeout=30) is not None for f in live + [ok]]
    with pytest.raises(cancelled):
        dead.result(timeout=1)
    with pytest.raises(expired_error):
        expired.result(timeout=1)
    out["ids"] = (ambient.request_id, explicit.request_id,
                  explicit.deadline is not None)
    st = srv.stats
    out["stats"] = {k: st[k] for k in ("cancelled", "deadline_exceeded",
                                       "served", "batches", "failed")}
    return out


def test_cancel_deadline_and_request_id_like_repro(tmp_path):
    from repro.obs import flight as flight_j
    from repro.obs.context import DeadlineExceeded as DeadlineExceededJ
    from repro.obs.context import request_context as request_context_j
    from repro.serve.futures import FutureCancelled as FutureCancelledJ
    from repro_torch.obs import flight

    flight.configure(dump_dir=str(tmp_path))
    flight_j.configure(dump_dir=str(tmp_path))
    try:
        got = _watch_scenario(
            TopoServe(TopoServeConfig(**WATCH_CFG), device="cpu"),
            request_context, FutureCancelled, DeadlineExceeded)
        want = _watch_scenario(
            serve_j.TopoServe(serve_j.TopoServeConfig(reducer="jnp",
                                                      **WATCH_CFG)),
            request_context_j, FutureCancelledJ, DeadlineExceededJ)
    finally:
        flight.configure(dump_dir="results/obs")
        flight_j.configure(dump_dir="results/obs")
    assert got == want
    assert got["ids"] == ("req-77", "req-88", True)
    assert got["stats"]["cancelled"] == 1
    assert got["stats"]["deadline_exceeded"] == 1
    by_bucket = obs.counter("serve.deadline_exceeded").labeled("bucket")
    assert sum(by_bucket.values()) >= 1


def test_cancelled_request_never_executes():
    srv = TopoServe(TopoServeConfig(record_batches=True, **WATCH_CFG),
                    device="cpu")
    fut = srv.submit(edges=[(0, 1), (1, 2)], n_vertices=3)
    assert fut.cancel()
    srv.drain()
    assert srv.executed_batches == [] and srv.pending() == 0
    assert srv.stats["batches"] == 0 and srv.stats["cancelled"] == 1


# ------------------------------------------------------------------ loops

def test_serve_forever_thread_joined():
    srv = TopoServe(TopoServeConfig(buckets=BUCKETS, method="prunit"),
                    device="cpu")
    ready = obs.gauge("serve.ready")
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        futs = [srv.submit([(i, (i + 1) % (4 + k)) for i in range(4 + k)],
                           4 + k) for k in range(5)]
        results = [f.result(timeout=120) for f in futs]
        assert all(int(d.betti(1)) == 1 for d in results)
        assert ready.value(frontend="topo", instance=srv._obs_instance) == 1
    finally:
        srv.stop()
        t.join(timeout=10)
    assert not t.is_alive()
    assert ready.value(frontend="topo", instance=srv._obs_instance) == 0
    assert srv.stats["served"] == 5


def test_serve_forever_async():
    srv = TopoServe(TopoServeConfig(buckets=BUCKETS, method="prunit"),
                    device="cpu")

    async def main():
        loop = asyncio.create_task(srv.serve_forever_async())
        fut = srv.submit([(0, 1), (1, 2), (2, 3), (3, 0)], 4)
        d = await asyncio.to_thread(fut.result, 120)
        srv.stop()
        await asyncio.wait_for(loop, timeout=10)
        return d

    assert int(asyncio.run(main()).betti(1)) == 1


# --------------------------------------------------------------- features

def test_signature_features_matches_feature_vector():
    plan = make_topo_plan(dim=1, method="prunit", edge_cap=64, tri_cap=96)
    c6 = tuple((i, (i + 1) % 6) for i in range(6))
    petersen = tuple([(i, (i + 1) % 5) for i in range(5)]
                     + [(i, i + 5) for i in range(5)]
                     + [(5 + i, 5 + (i + 2) % 5) for i in range(5)])
    reqs = [TopoRequest(c6, 6), TopoRequest(petersen, 10)]
    g = pack_requests(reqs, Bucket(16, 64, 96), device="cpu")
    direct = feature_vector(plan.execute(g), max_dim=plan.dim, res=4)
    assert torch.equal(direct, signature_features(g, plan, res=4))
    g_j = pack_requests_j([serve_j.TopoRequest(*(r.edges, r.n_vertices))
                           for r in reqs], serve_j.Bucket(16, 64, 96))
    import repro.core.api as api_j
    want = feature_vector_j(api_j.make_topo_plan(
        dim=1, method="prunit", edge_cap=64, tri_cap=96).execute(g_j),
        max_dim=1, res=4)
    np.testing.assert_allclose(direct.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


# ------------------------------------------------------------ StreamServe

STREAM_CFG = dict(dim=1, method="both", edge_cap=48, tri_cap=96)


def _g_both(edge_lists, n_vertices, n_pad):
    gj = from_edge_lists_j(edge_lists, n_vertices, n_pad=n_pad)
    return graph_batch_from_numpy(*(np.asarray(getattr(gj, k))
                                    for k in ("adj", "mask", "f")),
                                  device="cpu"), gj


def _d_both(ops):
    dj = delta_j.delta_from_lists(ops)
    return delta_batch_from_numpy(
        *(np.asarray(getattr(dj, k)) for k in
          ("edge_u", "edge_v", "edge_op", "f_vertex", "f_value",
           "drop_vertex")), device="cpu"), dj


def _stream_pair(**cfg):
    return (StreamServe(TopoStreamConfig(**cfg), device="cpu"),
            serve_j.StreamServe(TopoStreamConfigJ(reducer="jnp", **cfg)))


def _assert_step_equal(f, f_j, drift_rtol=None):
    assert diagrams_bitwise_equal(f.result(timeout=0), f_j.result(timeout=0))
    info, info_j = dict(f.info), dict(f_j.info)
    if "drift" in info_j:
        np.testing.assert_allclose(info.pop("drift"), info_j.pop("drift"),
                                   rtol=drift_rtol, atol=0)
        np.testing.assert_array_equal(info.pop("anomaly"),
                                      info_j.pop("anomaly"))
    assert info == info_j


def test_stream_session_flow_like_repro():
    srv, srv_j = _stream_pair(**STREAM_CFG)
    g, gj = _g_both([[(0, 1), (1, 2), (2, 0), (0, 3)]], [4], 8)
    sid, sid_j = srv.create_session(g), srv_j.create_session(gj)
    assert sid == sid_j
    assert diagrams_bitwise_equal(srv.diagrams(sid), srv_j.diagrams(sid_j))
    futs, futs_j = [], []
    for ops in ([[(0, 3, "delete")]],
                [[(1, 3, EDGE_INSERT), (2, 3, EDGE_INSERT)]]):
        d, dj = _d_both(ops)
        futs.append(srv.submit(sid, d))
        futs_j.append(srv_j.submit(sid_j, dj))
    assert srv.pending() == srv_j.pending() == 2
    assert srv.drain() == srv_j.drain() == 2
    for f, f_j in zip(futs, futs_j):
        _assert_step_equal(f, f_j)
    assert futs[0].info["hits"] == 1 and futs[1].info["recomputes"] == 1
    assert srv.session_stats(sid) == srv_j.session_stats(sid_j)


def test_stream_sessions_are_independent_like_repro():
    srv, srv_j = _stream_pair(**STREAM_CFG)
    square = [[(0, 1), (1, 2), (2, 3), (3, 0)]]
    sids = [srv.create_session(_g_both(square, [4], 8)[0]) for _ in range(2)]
    sids_j = [srv_j.create_session(_g_both(square, [4], 8)[1])
              for _ in range(2)]
    d, dj = _d_both([[(0, 2, EDGE_INSERT)]])
    srv.submit(sids[0], d)
    srv_j.submit(sids_j[0], dj)
    srv.drain()
    srv_j.drain()
    for s, s_j in zip(sids, sids_j):
        assert diagrams_bitwise_equal(srv.diagrams(s), srv_j.diagrams(s_j))
    assert not diagrams_bitwise_equal(srv.diagrams(sids[0]),
                                      srv.diagrams(sids[1]))
    assert srv.stats() == srv_j.stats()
    assert srv.close_session(sids[0]) == srv_j.close_session(sids_j[0])
    assert srv.stats() == srv_j.stats()
    assert srv.stats()["sessions_closed"] == 1
    with pytest.raises(KeyError):
        srv.diagrams(sids[0])


def _ego_stream_both(seed, steps):
    """The port's ego-decay stream (2 graphs of n_pad 32), and the same
    graphs and deltas as ``repro`` objects."""
    g0, ds = ego_decay_stream(seed, batch=2, n_pad=32, n_core=10,
                              n_double=6, n_pendant=6, steps=steps,
                              toggles=1, device="cpu")
    g0j = GraphBatchJ(*(jnp.asarray(getattr(g0, k).numpy())
                        for k in ("adj", "mask", "f")))
    dsj = delta_j.DeltaBatch(*(jnp.asarray(getattr(ds, k).numpy()) for k in
                               ("edge_u", "edge_v", "edge_op", "f_vertex",
                                "f_value", "drop_vertex")))
    return g0, ds, g0j, dsj


EGO_CFG = dict(dim=1, method="both", edge_cap=192, tri_cap=512)


def test_stream_submit_validation():
    srv = StreamServe(TopoStreamConfig(**EGO_CFG), device="cpu")
    g0, ds, _, _ = _ego_stream_both(0, 3)
    sid = srv.create_session(g0)
    with pytest.raises(ValueError, match="one update step"):
        srv.submit(sid, ds)  # stacked stream, not a step
    with pytest.raises(ValueError, match="batch"):
        srv.submit(sid, delta_from_lists([[(0, 1, EDGE_INSERT)]] * 5,
                                         device="cpu"))
    with pytest.raises(KeyError):
        srv.submit("s999", delta_step(ds, 0))


def test_stream_drain_in_order_lockstep_with_repro():
    srv, srv_j = _stream_pair(**EGO_CFG)
    g0, ds, g0j, dsj = _ego_stream_both(1, 6)
    sid, sid_j = srv.create_session(g0), srv_j.create_session(g0j)
    futs = [srv.submit(sid, delta_step(ds, t)) for t in range(6)]
    futs_j = [srv_j.submit(sid_j, delta_j.delta_step(dsj, t))
              for t in range(6)]
    assert srv.drain() == srv_j.drain() == 6
    for f, f_j in zip(futs, futs_j):
        _assert_step_equal(f, f_j)
    assert srv.stats() == srv_j.stats()
    assert srv.stats()["hits"] > 0
    assert srv.session_stats(sid) == srv_j.session_stats(sid_j)


def test_stream_failed_step_fails_dependent_futures_like_repro():
    cfg = dict(dim=1, method="none", edge_cap=4, tri_cap=8)
    srv, srv_j = _stream_pair(**cfg)
    square = [[(0, 1), (1, 2), (2, 3), (3, 0)]]
    g, gj = _g_both(square, [4], 8)
    sid, sid_j = srv.create_session(g), srv_j.create_session(gj)
    steps = [[[(0, 1, "delete")]],
             [[(0, 2, EDGE_INSERT), (1, 3, EDGE_INSERT)]],
             [[(0, 1, EDGE_INSERT)]]]
    futs, futs_j = [], []
    for ops in steps:
        d, dj = _d_both(ops)
        futs.append(srv.submit(sid, d))
        futs_j.append(srv_j.submit(sid_j, dj))
    srv.drain()
    srv_j.drain()
    _assert_step_equal(futs[0], futs_j[0])
    for f, f_j in zip(futs[1:], futs_j[1:]):
        with pytest.raises(ValueError, match="simplex caps") as e:
            f.result(timeout=1)
        with pytest.raises(ValueError) as e_j:
            f_j.result(timeout=1)
        assert str(e.value) == str(e_j.value)


def test_stream_drift_info_like_repro():
    cfg = dict(STREAM_CFG, drift_metric="sw", drift_threshold=0.5)
    srv, srv_j = _stream_pair(**cfg)
    g, gj = _g_both([[(0, 1), (1, 2), (2, 3)]], [4], 8)
    sid, sid_j = srv.create_session(g), srv_j.create_session(gj)
    futs = []
    for ops in ([[(0, 3, EDGE_INSERT)]], [[(0, 3, EDGE_INSERT)]]):
        d, dj = _d_both(ops)
        f, f_j = srv.submit(sid, d), srv_j.submit(sid_j, dj)
        srv.drain()
        srv_j.drain()
        _assert_step_equal(f, f_j, drift_rtol=1e-5)
        futs.append(f)
    assert futs[0].info["anomalies"] == 1 and futs[0].info["drift"][0] > 0.5
    assert futs[1].info["drift"].tolist() == [0.0]
    # the info arrays are this step's copies, not the stream's live state
    assert futs[0].info["drift"] is not srv._session(sid).stream.last_drift
    assert srv.stats()["anomalies"] == srv_j.stats()["anomalies"] == 1


def test_stream_serve_forever_thread_joined():
    srv = StreamServe(TopoStreamConfig(**EGO_CFG), device="cpu")
    g0, ds, _, _ = _ego_stream_both(2, 4)
    sid = srv.create_session(g0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        futs = [srv.submit(sid, delta_step(ds, i)) for i in range(4)]
        for f in futs:
            f.result(timeout=120)
    finally:
        srv.stop()
        t.join(timeout=10)
    assert not t.is_alive()
    assert srv.session_stats(sid)["applied"] == 4
