"""The port's SimilarityServe against ``repro``'s.

Both packages index the same numpy-made corpus (48 graphs of at most 16
vertices with random vertex filtrations) through their servers and answer
the same 8 queries.  Stage-1 ``gram`` ids are equal where there is no near
tie (two candidates whose embedding distances lie within the pairwise-L1
tolerance may swap, as in tests/test_torch_index.py).  Every ``exact_w``
distance, from the re-rank and from the exact stage 1 alike, is within
1e-5 of the Hungarian oracle on the compacted clouds
(``repro_torch.metrics.reference``), and is held to ``repro``'s only where
``repro`` is within 1e-5 of the oracle (the port sums W^q in f64; ROADMAP
Queue 3).  Price-cache hits and misses equal ``repro``'s on a second drain
of the same queries; auction rounds are not compared
(``AUCTION_REV_EVERY`` differs).  ``sharded=True`` on 1-4 CPU shards gives
the unsharded ids and distances bitwise, and ``repack="on"`` shares the
persist ladder with a TopoServe in the same process.
"""
from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

from repro.index import TopoIndexConfig as TopoIndexConfigJ
from repro.serve import SimilarityServe as SimilarityServeJ
from repro.serve import TopoServeConfig as TopoServeConfigJ
from repro_torch.core.api import make_topo_plan
from repro_torch.core.persistence import Diagrams, diagrams_bitwise_equal
from repro_torch.index import ShardedIndex, TopoIndexConfig
from repro_torch.kernels import ops
from repro_torch.launch import make_index_mesh
from repro_torch.metrics import compact_top_k, reference
from repro_torch.obs.context import DeadlineExceeded
from repro_torch.serve import (
    DEFAULT_BUCKETS,
    FutureCancelled,
    SimilarityServe,
    TopoServe,
    TopoServeConfig,
)
from repro_torch.serve.topo_serve import repack_ladder_for

FIELDS = ("birth", "death", "dim", "valid")
INDEX_CFG = dict(embedding="sw", k=1, n_points=8, n_dirs=8)
# one bucket (n16), every executed batch 16 rows: one batch shape in each
# package
SERVE_CFG = dict(buckets=DEFAULT_BUCKETS[:1], max_batch=16, pad_batch_to=16)
K = 3
ORACLE_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: these tests run many small torch ops, which
    gain nothing from threads, and parallel test workers would
    oversubscribe the CPUs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _graph(rng):
    n = int(rng.integers(6, 17))
    p = float(rng.uniform(0.25, 0.5))
    iu, iv = np.nonzero(np.triu(rng.random((n, n)) < p, 1))
    f = [float(x) for x in rng.random(n).astype(np.float32)]
    return dict(edges=[(int(u), int(v)) for u, v in zip(iu, iv)],
                n_vertices=n, f=f)


CORPUS = [_graph(np.random.default_rng((5, i))) for i in range(48)]
QUERIES = [_graph(np.random.default_rng((6, i))) for i in range(8)]


def _servers(index=None, **kw):
    """The port's and repro's SimilarityServe, same configuration."""
    from repro.serve import Bucket as BucketJ

    index_cfg = dict(INDEX_CFG, **(index or {}))
    srv = SimilarityServe(config=TopoServeConfig(**SERVE_CFG),
                          index_config=TopoIndexConfig(**index_cfg),
                          default_k=K, device="cpu", **kw)
    srv_j = SimilarityServeJ(
        config=TopoServeConfigJ(
            buckets=tuple(BucketJ(b.n_pad, b.edge_cap, b.tri_cap)
                          for b in SERVE_CFG["buckets"]),
            max_batch=SERVE_CFG["max_batch"],
            pad_batch_to=SERVE_CFG["pad_batch_to"]),
        index_config=TopoIndexConfigJ(**index_cfg), default_k=K, **kw)
    return srv, srv_j


def _load(srv, queries=QUERIES):
    for i, g in enumerate(CORPUS):
        srv.add(gid=f"c{i}", **g)
    srv.drain()
    futs = [srv.submit(**g) for g in queries]
    assert srv.drain() == len(queries)
    return [f.result(timeout=0) for f in futs]


def _oracle(index, qd, gid):
    """Hungarian W2 between a query row's compacted cloud and an indexed
    graph's stored cloud."""
    cfg = index.config
    b, e, keep = compact_top_k(Diagrams(*(getattr(qd, k)[None]
                                          for k in FIELDS)),
                               cfg.k, cfg.n_points, cfg.cap)
    p1 = [(float(x), float(y))
          for x, y, kk in zip(b[0].tolist(), e[0].tolist(), keep[0].tolist())
          if kk]
    cl = index.base._clouds if isinstance(index, ShardedIndex) else \
        index._clouds
    cl = cl[list(index.ids).index(gid)]
    p2 = [(float(x), float(y)) for x, y, kk in zip(*cl.tolist()) if kk > 0]
    return reference.wasserstein_exact(p1, p2)


def _assert_exact(srv, res, res_j):
    """Every exact distance within the oracle's tolerance; held to repro's
    where repro is within it too; ids equal where no two exact distances
    of the query lie within the tolerance."""
    n_held = 0
    for r, r_j in zip(res, res_j):
        assert r.backends == ("exact_w",) * len(r.ids)
        assert list(r.distances) == sorted(r.distances)
        want = [_oracle(srv.index, r.diagrams, gid) for gid in r.ids]
        np.testing.assert_allclose(r.distances, want, rtol=0,
                                   atol=ORACLE_ATOL)
        want_j = {gid: _oracle(srv.index, r.diagrams, gid) for gid in r_j.ids}
        for gid, d_j in zip(r_j.ids, r_j.distances):
            if abs(d_j - want_j[gid]) <= ORACLE_ATOL and gid in r.ids:
                d = r.distances[r.ids.index(gid)]
                assert abs(d - d_j) <= 2 * ORACLE_ATOL
                n_held += 1
        if set(r.ids) == set(r_j.ids) and (
                np.diff(r.distances) > 2 * ORACLE_ATOL).all():
            assert r.ids == r_j.ids
    return n_held


@pytest.fixture(scope="module")
def gram_pair():
    srv, srv_j = _servers()
    return srv, srv_j, _load(srv), _load(srv_j)


# ----------------------------------------------------------------- stage 1

def _l1_tol(x, y):
    return (1e-5 * (np.abs(x).sum(1)[:, None] + np.abs(y).sum(1)[None, :])
            + 1e-6)


def _assert_gram_answers(srv, res, res_j):
    """Same ids but near ties, and distances to rtol 1e-5, as
    tests/test_torch_index.py holds TopoIndex queries."""
    index = srv.index
    for r, r_j in zip(res, res_j):
        assert diagrams_bitwise_equal(r.diagrams, r_j.diagrams)
        assert r.backends == ("gram",) * len(r.ids)
        eq = index.embed(Diagrams(*(getattr(r.diagrams, k)[None]
                                    for k in FIELDS)))
        emb = index._emb
        dist = ops.pairwise_l1(eq, torch.from_numpy(emb)).numpy()[0]
        tol = _l1_tol(eq.numpy(), emb)[0]
        for a, b in zip(r.ids, r_j.ids):
            if a != b:
                ra, rb = index.ids.index(a), index.ids.index(b)
                assert abs(dist[ra] - dist[rb]) <= max(tol[ra], tol[rb])
        np.testing.assert_allclose(r.distances, r_j.distances, rtol=1e-5,
                                   atol=1e-6)


def test_gram_stage1_matches_repro(gram_pair):
    srv, srv_j, res, res_j = gram_pair
    _assert_gram_answers(srv, res, res_j)
    assert srv.index.ids == srv_j.index.ids
    st, st_j = srv.stats, srv_j.stats
    for k in ("queries", "indexed", "add_failures", "stage1_candidates",
              "stage2_pairs"):
        assert st[k] == st_j[k], k


def test_lsh_stage1_matches_repro():
    srv, srv_j = _servers(index=dict(coarse="lsh", lsh_bits=64,
                                     lsh_overfetch=2))
    _assert_gram_answers(srv, _load(srv), _load(srv_j))
    np.testing.assert_array_equal(srv.index._codes, srv_j.index._codes)


# ----------------------------------------------------------- exact solves

@pytest.fixture(scope="module")
def rerank_pair():
    srv, srv_j = _servers(rerank="exact_w", overfetch=4)
    res, res_j = _load(srv), _load(srv_j)
    return srv, srv_j, res, res_j


def test_rerank_exact_w_within_oracle_and_repro(rerank_pair):
    srv, srv_j, res, res_j = rerank_pair
    assert _assert_exact(srv, res, res_j) > 0
    st = srv.stats
    assert st["stage2_pairs"] == len(QUERIES) * K * 4
    assert st["auction_rounds"] > 0


def test_price_cache_second_drain_matches_repro(rerank_pair):
    srv, srv_j, first, _ = rerank_pair
    before = (srv.stats["warm_start_hits"], srv.stats["warm_start_misses"])
    before_j = (srv_j.stats["warm_start_hits"],
                srv_j.stats["warm_start_misses"])
    assert before == before_j
    futs = [srv.submit(**g) for g in QUERIES]
    futs_j = [srv_j.submit(**g) for g in QUERIES]
    srv.drain()
    srv_j.drain()
    st, st_j = srv.stats, srv_j.stats
    assert (st["warm_start_hits"], st["warm_start_misses"]) == (
        st_j["warm_start_hits"], st_j["warm_start_misses"])
    assert st["warm_start_hits"] > before[0]
    # warm starts move rounds, never the answers
    for f, r_first in zip(futs, first):
        assert f.result(timeout=0).ids == r_first.ids
    assert _assert_exact(srv, [f.result(timeout=0) for f in futs],
                         [f.result(timeout=0) for f in futs_j]) > 0


def test_stage1_exact_w_within_oracle_and_repro():
    srv, srv_j = _servers(stage1_backend="exact_w")
    res, res_j = _load(srv), _load(srv_j)
    assert _assert_exact(srv, res, res_j) > 0
    assert srv.stats["stage1_candidates"] == len(QUERIES) * len(CORPUS)
    assert srv.stats["stage1_candidates"] == srv_j.stats["stage1_candidates"]
    assert srv.stats["stage2_pairs"] == 0


# ----------------------------------------------------------------- sharded

@pytest.fixture(scope="module")
def unsharded():
    srv = SimilarityServe(
        config=TopoServeConfig(**SERVE_CFG),
        index_config=TopoIndexConfig(**INDEX_CFG, coarse="lsh", lsh_bits=64,
                                     lsh_overfetch=2),
        default_k=K, device="cpu", rerank="exact_w", overfetch=2)
    return _load(srv)


@pytest.mark.parametrize("shards", [1, 2, 3, 4])
def test_sharded_bitwise_unsharded(unsharded, shards):
    srv = SimilarityServe(
        config=TopoServeConfig(**SERVE_CFG),
        index_config=TopoIndexConfig(**INDEX_CFG, coarse="lsh", lsh_bits=64,
                                     lsh_overfetch=2),
        default_k=K, device="cpu", rerank="exact_w", overfetch=2,
        sharded=True, index_mesh=make_index_mesh(devices=["cpu"] * shards))
    assert isinstance(srv.index, ShardedIndex)
    assert srv.index.n_shards == shards
    for r, want in zip(_load(srv), unsharded):
        assert r.ids == want.ids
        assert r.distances == want.distances
        assert r.backends == want.backends
        assert diagrams_bitwise_equal(r.diagrams, want.diagrams)


def test_sharded_wrap_of_existing_index():
    from repro_torch.index import TopoIndex

    index = TopoIndex(TopoIndexConfig(**INDEX_CFG), device="cpu")
    srv = SimilarityServe(index=index, sharded=True, device="cpu",
                          index_mesh=make_index_mesh(devices=["cpu"] * 2))
    assert isinstance(srv.index, ShardedIndex) and srv.index.base is index


# ---------------------------------------------------------------- repack

def test_repack_on_shares_the_persist_ladder_with_topo_serve():
    sim = SimilarityServe(config=TopoServeConfig(buckets=DEFAULT_BUCKETS[:2]),
                          index_config=TopoIndexConfig(**INDEX_CFG),
                          default_k=1, device="cpu", repack="on")
    topo = TopoServe(TopoServeConfig(buckets=DEFAULT_BUCKETS[:2],
                                     repack="on"), device="cpu")
    ladder = repack_ladder_for(DEFAULT_BUCKETS[:2])
    assert sim.server._repack_ladder == topo._repack_ladder == ladder
    for b in DEFAULT_BUCKETS[:2]:
        assert sim.server.plan_for(b) is topo.plan_for(b)
    sim.add(edges=[(0, 1), (0, 2), (0, 3)], n_vertices=4, gid="star")
    fut = sim.submit(edges=[(0, 1), (0, 2)], n_vertices=3, k=1)
    tf = topo.submit(edges=[(0, 1), (0, 2)], n_vertices=3)
    sim.drain()
    topo.drain()
    assert fut.result(timeout=0).ids == ("star",)
    # (input bucket, persist rung) accounting flows through the inner server
    assert set(topo.stats["repack_rungs"]) <= set(sim.repack_rungs())
    # the query's persist rung is the TopoServe request's, one shared plan
    rung = tf.repack_class
    assert fut.inner.repack_class == rung
    plan = make_topo_plan(dim=1, passes=(), sublevel=True,
                          edge_cap=rung.edge_cap, tri_cap=rung.tri_cap,
                          quad_cap=rung.quad_cap)
    assert topo.plan_for(DEFAULT_BUCKETS[0]).persist_plan(rung) is plan
    assert diagrams_bitwise_equal(fut.result(timeout=0).diagrams,
                                  tf.result(timeout=0))


# ------------------------------------------------------ serving behaviour

def test_validation_and_empty_index():
    with pytest.raises(ValueError, match="unknown rerank"):
        SimilarityServe(rerank="bogus", device="cpu")
    with pytest.raises(ValueError, match="unknown stage1_backend"):
        SimilarityServe(stage1_backend="bogus", device="cpu")
    srv = SimilarityServe(config=TopoServeConfig(**SERVE_CFG), device="cpu")
    fut = srv.submit(edges=[(0, 1), (1, 2)], n_vertices=3)
    srv.drain()
    with pytest.raises(ValueError, match="empty index"):
        fut.result(timeout=0)


def test_duplicate_gid_does_not_wedge_queries():
    srv = SimilarityServe(config=TopoServeConfig(**SERVE_CFG),
                          index_config=TopoIndexConfig(n_points=4, n_dirs=4),
                          device="cpu")
    srv.add(edges=[(0, 1), (1, 2), (2, 3), (3, 0)], n_vertices=4, gid="dup")
    srv.drain()
    srv.add(edges=[(0, 1), (1, 2)], n_vertices=3, gid="dup")
    fut = srv.submit(edges=[(0, 1), (1, 2), (2, 3), (3, 0)], n_vertices=4,
                     k=1)
    assert srv.drain() == 1
    assert fut.result(timeout=5).ids == ("dup",)
    assert srv.stats["add_failures"] == 1 and len(srv.index) == 1


def test_cancel_and_deadline_skip_both_phases(gram_pair, tmp_path):
    from repro_torch.obs import flight

    srv = gram_pair[0]
    q = QUERIES[0]
    dead = srv.submit(**q)
    assert dead.cancel() and dead.inner.cancelled()
    late = srv.submit(**q, deadline_s=0.0)
    ok = srv.submit(**q, deadline_s=60.0)
    before = srv.stats
    flight.configure(dump_dir=str(tmp_path))  # the expiry's flight dump
    try:
        assert srv.drain() == 1
    finally:
        flight.configure(dump_dir="results/obs")
    with pytest.raises(FutureCancelled):
        dead.result(timeout=0)
    with pytest.raises(DeadlineExceeded):
        late.result(timeout=0)
    assert ok.result(timeout=0).ids
    st = srv.stats
    assert st["cancelled"] == before["cancelled"] + 1
    assert st["queries"] == before["queries"] + 1
    assert srv.server.stats["deadline_exceeded"] >= 1


def test_serve_forever_thread_joined(gram_pair):
    srv = gram_pair[0]
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        futs = [srv.submit(**g) for g in QUERIES[:3]]
        res = [f.result(timeout=120) for f in futs]
    finally:
        srv.stop()
        t.join(timeout=10)
    assert not t.is_alive()
    for r, want in zip(res, gram_pair[2][:3]):
        assert r.ids == want.ids and r.distances == want.distances
