"""The port's stream path against ``repro``'s: deltas, verdicts, TopoStream.

Every case of ``tests/test_topo_stream.py`` runs through both packages on
the same numpy inputs: ``apply_delta`` and ``canonicalize_delta`` bitwise;
``invalidation_verdict``'s seven fields bitwise on the same
``(g_old, g_new, core, elig)``; ``TopoStream`` step by step on ``repro``'s
three temporal streams at ``benchmarks/stream_bench.py``'s sizes, with the
verdict vectors, ``stats``, ``all_dims_exact`` and the whole Diagrams
tensors bitwise at every step, and the guaranteed dimensions' pairs
bitwise a from-scratch ``topological_signature`` of the current state.
Drift scores are exactly 0 on hits and within the registry's tolerance of
``repro``'s on recomputes (``sw``: rtol 1e-5; ``exact_w``: atol 1e-5).
The port runs on the CPU (its plain kernel versions).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.delta as delta_j
import repro.data.temporal as temporal_j
import repro.stream as stream_j
import repro.stream.calibration as calibration_j
from repro.core.graph import from_edge_lists as from_edge_lists_j
from repro.core.persistence_jax import diagrams_bitwise_equal
from repro_torch.convert import (
    delta_batch_from_numpy,
    delta_batch_to_numpy,
    graph_batch_from_numpy,
    graph_batch_to_numpy,
)
from repro_torch.core import api, delta
from repro_torch.core.kcore import kcore_mask
from repro_torch.core.delta import (
    EDGE_DELETE,
    EDGE_INSERT,
    EDGE_NOP,
    DeltaBatch,
    apply_delta,
    canonicalize_delta,
    delta_from_lists,
    empty_delta,
)
from repro_torch.data import temporal
from repro_torch.metrics import reference
from repro_torch.stream import (
    TopoStream,
    TopoStreamConfig,
    dim_pairs,
    invalidation_verdict,
)
from repro_torch.stream import calibration
from repro_torch.stream import topo_stream

CFG = dict(edge_cap=48, tri_cap=96)
VERDICT_FIELDS = ("touched", "coral_hit", "prunit_hit", "recompute",
                  "core_mask", "elig", "caps_ok")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: these tests run many small torch ops, which
    gain nothing from threads, and parallel test workers would
    oversubscribe the CPUs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _g_t(gj):
    return graph_batch_from_numpy(np.asarray(gj.adj), np.asarray(gj.mask),
                                  np.asarray(gj.f), device="cpu")


def _d_t(dj):
    return delta_batch_from_numpy(
        *(np.asarray(getattr(dj, k)) for k in
          ("edge_u", "edge_v", "edge_op", "f_vertex", "f_value",
           "drop_vertex")), device="cpu")


def _eq(a_torch, b_jax, msg=""):
    np.testing.assert_array_equal(a_torch.numpy(), np.asarray(b_jax),
                                  err_msg=msg)


def _graph_eq(gt, gj):
    for k in ("adj", "mask", "f"):
        _eq(getattr(gt, k), getattr(gj, k), k)


def _delta_eq(dt, dj):
    for k in ("edge_u", "edge_v", "edge_op", "f_vertex", "f_value",
              "drop_vertex"):
        _eq(getattr(dt, k), getattr(dj, k), k)
        assert getattr(dt, k).dtype == (torch.float32 if k == "f_value"
                                        else torch.int32)


def _raw(dj_fields):
    """The same raw DeltaBatch in both packages from numpy fields."""
    arrs = [np.asarray(x) for x in dj_fields]
    arrs = [arrs[0], arrs[1], arrs[2], arrs[3], arrs[4].astype(np.float32),
            arrs[5]]
    dj = delta_j.DeltaBatch(*(jnp.asarray(a) for a in arrs))
    return dj, _d_t(dj)


def _empty(b):
    return (np.full((b, 0), -1, np.int32), np.zeros((b, 0), np.float32))


# ------------------------------------------------------------------- delta

def test_canonicalize_delta_bitwise():
    dj, dt = _raw(([[3, 2, 9, 1]], [[1, 2, 0, 2]],
                   [[EDGE_INSERT, EDGE_INSERT, EDGE_DELETE, EDGE_NOP]],
                   [[7, 2]], [[1.0, 2.0]], [[5, 3]]))
    for n in (6, 10):
        c = canonicalize_delta(dt, n=n)
        _delta_eq(c, delta_j.canonicalize_delta(dj, n=n))
    c = canonicalize_delta(dt, n=6)
    assert c.edge_u.tolist() == [[1, -1, -1, -1]]
    assert c.f_vertex.tolist() == [[-1, 2]]


def _apply_both(gj, dj):
    gt = apply_delta(_g_t(gj), _d_t(dj))
    want = delta_j.apply_delta(gj, dj)
    _graph_eq(gt, want)
    return gt, want


def test_apply_delta_insert_delete_and_invariants():
    gj = from_edge_lists_j([[(0, 1), (1, 2)]], [4], n_pad=6)
    dj = delta_j.delta_from_lists([[(2, 3, EDGE_INSERT), (0, 1, EDGE_DELETE)]])
    _delta_eq(delta_from_lists([[(2, 3, EDGE_INSERT), (0, 1, EDGE_DELETE)]],
                               device="cpu"), dj)
    gt, _ = _apply_both(gj, dj)
    a = gt.adj[0].numpy()
    assert a[2, 3] and not a[0, 1] and np.array_equal(a, a.T)


def test_apply_delta_delete_beats_insert():
    gj = from_edge_lists_j([[(0, 1)]], [3], n_pad=4)
    e, z = _empty(1)
    dj, dt = _raw(([[0, 0]], [[2, 2]], [[EDGE_INSERT, EDGE_DELETE]], e, z, e))
    gt, _ = _apply_both(gj, dj)
    assert not bool(gt.adj[0, 0, 2])


def test_apply_delta_activates_endpoints_with_default_f():
    gj = from_edge_lists_j([[(0, 1)]], [2], n_pad=5)
    gt, _ = _apply_both(gj, delta_j.delta_from_lists([[(1, 4, EDGE_INSERT)]]))
    assert bool(gt.mask[0, 4]) and float(gt.f[0, 4]) == 0.0


def test_apply_delta_drop_clears_incident_edges():
    gj = from_edge_lists_j([[(0, 1), (1, 2), (2, 0)]], [3], n_pad=4)
    dj = delta_j.delta_from_lists([[]], drops=[[1]], drop_slots=1)
    _delta_eq(delta_from_lists([[]], drops=[[1]], drop_slots=1,
                               device="cpu"), dj)
    gt, _ = _apply_both(gj, dj)
    assert not bool(gt.mask[0, 1]) and not gt.adj[0, 1].any()


def test_apply_delta_invalid_edge_ops_are_fully_dropped():
    gj = from_edge_lists_j([[(0, 1)]], [2], n_pad=6)
    e, z = _empty(1)
    dj, _ = _raw(([[4, 1, -3]], [[4, 9, 2]],
                  [[EDGE_INSERT, EDGE_INSERT, EDGE_INSERT]], e, z, e))
    gt, _ = _apply_both(gj, dj)
    _graph_eq(gt, gj)


def test_apply_delta_duplicate_f_ops_last_slot_wins():
    gj = from_edge_lists_j([[(0, 1)]], [2], n_pad=4)
    e, _ = _empty(1)
    dj, _ = _raw((e, e, e, [[1, 1, 0]], [[5.0, 9.0, 2.0]], e))
    gt, _ = _apply_both(gj, dj)
    assert float(gt.f[0, 1]) == 9.0 and float(gt.f[0, 0]) == 2.0


def test_apply_delta_random_raw_ops_bitwise():
    # raw slots of every kind, duplicates, out-of-range ids and NOPs mixed,
    # on a batch whose graphs activate, drop and relabel vertices
    rng = np.random.default_rng(17)
    b, n = 6, 10
    gj = from_edge_lists_j(
        [[(int(u), int(v)) for u, v in rng.integers(0, 7, (8, 2)) if u != v]
         for _ in range(b)], [7] * b, n_pad=n,
        f_values=rng.integers(0, 5, (b, 7)).astype(np.float32).tolist())
    for _ in range(5):
        dj, dt = _raw((rng.integers(-2, n + 2, (b, 7)),
                       rng.integers(-2, n + 2, (b, 7)),
                       rng.integers(0, 3, (b, 7)),
                       rng.integers(-1, n + 1, (b, 4)),
                       rng.integers(0, 6, (b, 4)),
                       rng.integers(-1, n + 1, (b, 2))))
        _delta_eq(canonicalize_delta(dt, n), delta_j.canonicalize_delta(dj, n))
        _, gj = _apply_both(gj, dj)


def test_empty_delta_is_noop():
    gj = from_edge_lists_j([[(0, 1), (1, 2)]], [4], n_pad=6)
    e = empty_delta(1, 2, 1, 1, device="cpu")
    _delta_eq(e, delta_j.empty_delta(1, 2, 1, 1))
    _graph_eq(apply_delta(_g_t(gj), e), gj)


def test_delta_helpers():
    eu = np.arange(24, dtype=np.int32).reshape(2, 3, 4)
    d = delta_batch_from_numpy(eu, eu, eu % 3, eu[..., :1], eu[..., :1] * .5,
                               eu[..., :0], device="cpu")
    assert (d.steps, d.batch, d.edge_slots, d.f_slots, d.drop_slots) == (
        2, 3, 4, 1, 0)
    one = delta.delta_step(d, 1)
    assert one.steps == 1 and one.edge_u.tolist() == eu[1].tolist()
    assert one.index(torch.tensor([2, 0])).edge_u.tolist() == \
        eu[1][[2, 0]].tolist()
    back = delta_batch_to_numpy(one.to("cpu"))
    assert [a.dtype for a in back] == [np.int32] * 4 + [np.float32, np.int32]
    np.testing.assert_array_equal(back[4], eu[1][:, :1] * np.float32(.5))


# ------------------------------------------------------------ verdict cases

def _lockstep(gj, steps, check_dims=None, **cfg):
    """Run repro's and the port's TopoStream side by side over ``steps``
    (repro DeltaBatches).  At every step: the port's invalidation_verdict on
    repro's (g_old, g_new, core, elig) has repro's seven fields; both
    sessions have equal stats, all_dims_exact and Diagrams; and the port's
    guaranteed dims equal a direct topological_signature.  Returns both
    sessions."""
    sj = stream_j.TopoStream(gj, stream_j.TopoStreamConfig(**cfg))
    cfg_t = TopoStreamConfig(**cfg)
    st = TopoStream(_g_t(gj), cfg_t, device="cpu")
    assert diagrams_bitwise_equal(st.diagrams, sj.diagrams)
    if check_dims is None:
        check_dims = (tuple(range(cfg_t.dim + 1))
                      if cfg_t.exact_dims == "all" else (cfg_t.dim,))
    for t, dj in enumerate(steps):
        g_new_j = delta_j.apply_delta(sj.graph, dj)
        vj = stream_j.invalidation_verdict(
            sj.graph, g_new_j, sj._core, sj._elig, dim=cfg_t.dim,
            sublevel=cfg_t.sublevel, use_coral=sj._use_coral,
            check_caps=cfg_t.check_caps, edge_cap=cfg_t.edge_cap,
            tri_cap=cfg_t.tri_cap, quad_cap=cfg_t.quad_cap)
        vt = invalidation_verdict(
            _g_t(sj.graph), _g_t(g_new_j), torch.from_numpy(
                np.array(sj._core)), torch.from_numpy(np.array(sj._elig)),
            dim=cfg_t.dim, sublevel=cfg_t.sublevel, use_coral=st._use_coral,
            check_caps=cfg_t.check_caps, edge_cap=cfg_t.edge_cap,
            tri_cap=cfg_t.tri_cap, quad_cap=cfg_t.quad_cap)
        for k in VERDICT_FIELDS:
            _eq(getattr(vt, k), getattr(vj, k), f"step {t}: {k}")
        dt = st.apply(_d_t(dj))
        sj.apply(dj)
        assert st.stats == sj.stats, t
        np.testing.assert_array_equal(st.all_dims_exact, sj.all_dims_exact)
        _graph_eq(st.graph, sj.graph)
        assert diagrams_bitwise_equal(dt, sj.diagrams), t
        ref = api.topological_signature(
            st.graph, dim=cfg_t.dim, method=cfg_t.method,
            sublevel=cfg_t.sublevel, edge_cap=cfg_t.edge_cap,
            tri_cap=cfg_t.tri_cap, quad_cap=cfg_t.quad_cap)
        for b in range(st.graph.batch):
            for k in check_dims:
                assert dim_pairs(dt, b, k) == dim_pairs(ref, b, k), (t, b, k)
    return st, sj


def test_outside_core_update_is_cache_hit():
    gj = from_edge_lists_j([[(0, 1), (1, 2), (2, 0), (0, 3)]], [4], n_pad=8)
    st, _ = _lockstep(gj, [delta_j.delta_from_lists([[(0, 3, EDGE_DELETE)]])],
                      dim=1, method="both", **CFG)
    assert st.stats["hits"] == 1 and st.stats["coral_hits"] == 1
    assert st.stats["recomputes"] == 0


def test_core_touching_update_recomputes():
    gj = from_edge_lists_j([[(0, 1), (1, 2), (2, 3), (3, 0)]], [4], n_pad=8)
    st, _ = _lockstep(gj, [delta_j.delta_from_lists([[(0, 2, EDGE_INSERT)]])],
                      dim=1, method="both", **CFG)
    assert st.stats["recomputes"] == 1 and st.stats["hits"] == 0


def test_outside_core_insert_creating_core_recomputes():
    gj = from_edge_lists_j([[(0, 1), (1, 2), (2, 3)]], [4], n_pad=8)
    st, _ = _lockstep(gj, [delta_j.delta_from_lists([[(0, 3, EDGE_INSERT)]])],
                      dim=1, method="both", **CFG)
    assert st.stats["recomputes"] == 1
    assert dim_pairs(st.diagrams, 0, 1) != []


_HUB = [(0, 1), (0, 2), (0, 3), (0, 4), (1, 2), (1, 3), (2, 3), (1, 4)]
_HUB_F = [[0.0, 0.0, 1.0, 1.0, 2.0]]


def test_dominated_toggle_is_prunit_hit_all_dims():
    gj = from_edge_lists_j([_HUB], [5], n_pad=8, f_values=_HUB_F)
    steps = [delta_j.delta_from_lists([[(1, 4, op)]])
             for op in (EDGE_DELETE, EDGE_INSERT)]
    st, _ = _lockstep(gj, steps, dim=1, method="prunit", exact_dims="all",
                      **CFG)
    assert st.stats["prunit_hits"] == 2 and st.stats["recomputes"] == 0
    assert st.all_dims_exact.all()


def test_dropping_dominated_vertex_is_prunit_hit():
    gj = from_edge_lists_j([_HUB], [5], n_pad=8, f_values=_HUB_F)
    st, _ = _lockstep(
        gj, [delta_j.delta_from_lists([[]], drops=[[4]], drop_slots=1)],
        dim=1, method="prunit", exact_dims="all", **CFG)
    assert st.stats["prunit_hits"] == 1 and st.stats["recomputes"] == 0


def test_f_update_outside_core_hits_inside_core_recomputes():
    gj = from_edge_lists_j([[(0, 1), (1, 2), (2, 0), (0, 3)]], [4], n_pad=8,
                           f_values=[[1.0, 2.0, 3.0, 4.0]])
    steps = [delta_j.delta_from_lists([[]], f_ops=[[(3, 9.0)]], f_slots=1),
             delta_j.delta_from_lists([[]], f_ops=[[(0, 7.0)]], f_slots=1)]
    st, _ = _lockstep(gj, steps, dim=1, method="both", **CFG)
    assert st.stats["hits"] == 1 and st.stats["recomputes"] == 1


def test_ineffective_update_never_invalidates():
    gj = from_edge_lists_j([[(0, 1), (1, 2), (2, 0)]], [3], n_pad=4,
                           f_values=[[1.0, 2.0, 3.0]])
    st, _ = _lockstep(gj, [delta_j.delta_from_lists(
        [[(0, 1, EDGE_INSERT)]], f_ops=[[(2, 3.0)]], f_slots=1)],
        dim=1, method="both", **CFG)
    assert st.stats["graph_updates"] == 0 and st.stats["recomputes"] == 0


def test_only_affected_graphs_recompute():
    gj = from_edge_lists_j([[(0, 1), (1, 2), (2, 3), (3, 0)]] * 4, [4] * 4,
                           n_pad=8)
    steps = [delta_j.delta_from_lists([[], [], [(0, 2, EDGE_INSERT)], []],
                                      edge_slots=1),
             delta_j.delta_from_lists([[(0, 1, EDGE_DELETE)], [],
                                       [(0, 1, EDGE_DELETE)], []],
                                      edge_slots=1)]
    st, _ = _lockstep(gj, steps, dim=1, method="both", **CFG)
    assert st.stats["recomputes"] == 2 and st.stats["recomputed_rows"] == 2
    assert st.stats["prunit_hits"] == 1
    assert st.recompute_sizes == [1, 1]


def test_coral_hit_marks_lower_dims_stale():
    gj = from_edge_lists_j([[(0, 1), (1, 2), (2, 0), (0, 3)]], [4], n_pad=8)
    st, _ = _lockstep(gj, [delta_j.delta_from_lists([[(0, 3, EDGE_DELETE)]])],
                      dim=1, method="prunit", **CFG)
    assert st.stats["coral_hits"] == 1 and not st.all_dims_exact[0]


def test_caps_overflow_raises():
    gj = from_edge_lists_j([[(0, 1), (1, 2)]], [4], n_pad=6)
    s = TopoStream(_g_t(gj), TopoStreamConfig(dim=1, method="none",
                                              edge_cap=3, tri_cap=4),
                   device="cpu")
    with pytest.raises(ValueError, match="simplex caps"):
        s.apply(delta_from_lists([[(0, 2, EDGE_INSERT), (0, 3, EDGE_INSERT),
                                   (1, 3, EDGE_INSERT)]], device="cpu"))


def _random_steps(rng, n_live, count, dims_all=False):
    out = []
    for _ in range(count):
        ops, f_ops = [], []
        for _ in range(rng.integers(1, 3)):
            u, v = rng.choice(n_live, size=2, replace=False)
            op = EDGE_INSERT if rng.random() < 0.5 else EDGE_DELETE
            ops.append((int(u), int(v), op))
        if rng.random() < 0.5:
            f_ops.append((int(rng.integers(0, n_live)),
                          float(rng.integers(0, 7))))
        out.append(delta_j.delta_from_lists([ops], [f_ops], edge_slots=2,
                                            f_slots=1))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_sequences_bitwise(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(6, 11))
    edges = [(u, v) for u in range(n) for v in range(u + 1, n)
             if rng.random() < 0.3]
    f = [[float(rng.integers(0, 7)) for _ in range(n)]]
    gj = from_edge_lists_j([edges], [n], n_pad=12, f_values=f)
    if seed % 2:
        kw = dict(method="prunit", exact_dims="all")
    else:
        kw = dict(method="both")
    _lockstep(gj, _random_steps(rng, n, 4), dim=1, edge_cap=66,
              tri_cap=220, **kw)


# --------------------------------------------------------- temporal streams

@pytest.fixture(scope="module")
def bench_keys():
    return jax.random.split(jax.random.PRNGKey(20), 3)


def _steps(deltas_j, n):
    return [delta_j.delta_step(deltas_j, t) for t in range(n)]


@pytest.mark.parametrize("pad", ["pow2", "full"])
def test_stream_ego_decay_bitwise(bench_keys, pad):
    """stream_bench --quick's ego workload: 8 graphs of n_pad 32, 64 steps."""
    steps = 64 if pad == "pow2" else 24
    g0, deltas = temporal_j.ego_decay_stream(
        bench_keys[0], batch=8, n_pad=32, n_core=10, n_double=6,
        n_pendant=6, steps=steps, toggles=1, p_core_edge=0.15)
    st, _ = _lockstep(g0, _steps(deltas, steps), dim=1, method="both",
                      edge_cap=192, tri_cap=512, recompute_pad=pad)
    assert st.stats["coral_hits"] > 0 and st.stats["prunit_hits"] > 0
    assert st.stats["recomputes"] > 0
    if pad == "pow2":
        assert len(set(st.recompute_sizes)) >= 2
    else:
        assert set(st.recompute_sizes) == {8}


def test_stream_pa_growth_bitwise(bench_keys):
    """stream_bench's growth workload: prunit, exact_dims='all'."""
    g0, deltas = temporal_j.pa_growth_stream(bench_keys[1], batch=8,
                                             n_pad=64, n0=4, m=1, steps=48)
    st, _ = _lockstep(g0, _steps(deltas, 48), dim=1, method="prunit",
                      exact_dims="all", edge_cap=128, tri_cap=192)
    assert st.skip_rate() == 1.0 and st.stats["recomputes"] == 0


@pytest.mark.parametrize("repack", ["off", "on"])
def test_stream_community_churn_bitwise(bench_keys, repack):
    """stream_bench's churn workload: the recompute-bound regime."""
    steps = 32 if repack == "off" else 12
    g0, deltas = temporal_j.community_churn_stream(
        bench_keys[2], batch=8, n_pad=24, n_vertices=20, n_comm=4,
        p_in=0.45, p_out=0.05, steps=steps, churn=2)
    st, sj = _lockstep(g0, _steps(deltas, steps), dim=1, method="both",
                       edge_cap=160, tri_cap=384, repack=repack)
    assert st.stats["recomputes"] > st.stats["hits"]
    if repack == "on":
        np.testing.assert_array_equal(st.last_repack.class_index,
                                      sj.last_repack.class_index)


# -------------------------------------------------------------------- drift

def test_drift_zero_on_cache_hit():
    g = from_edge_lists_j([[(0, 1), (1, 2), (2, 0), (0, 3)]], [4], n_pad=8)
    s = TopoStream(_g_t(g), TopoStreamConfig(
        dim=1, method="both", drift_metric="sw", drift_threshold=0.0, **CFG),
        device="cpu")
    s.apply(delta_from_lists([[(0, 3, EDGE_DELETE)]], device="cpu"))
    assert s.stats["hits"] == 1
    assert s.last_drift.tolist() == [0.0]
    assert not s.last_anomaly.any() and s.stats["anomalies"] == 0


@pytest.mark.parametrize("metric", ["sw", "exact_w"])
def test_drift_burst_workload_against_repro(metric):
    """The drift auto-calibration workload (churn with two rewiring
    bursts).  Scores are exactly 0 on every hit.  On recomputes: ``sw``
    within rtol 1e-5 of repro's; ``exact_w`` within atol 1e-5 of the
    Hungarian oracle (the registry's bound), and of repro's wherever
    repro's own score is within that bound of the oracle (on this workload
    repro's scores miss the oracle by up to ~1e-3 on many recomputes).  The thresholds
    are those of repro's calibrator fed the port's scores."""
    steps, churn = 26, 8
    schedule = np.asarray([churn if t in (20, 24) else 1
                           for t in range(steps)])
    g0, deltas = temporal_j.community_churn_stream(
        jax.random.PRNGKey(5), batch=4, n_pad=16, n_vertices=14, n_comm=3,
        p_in=0.5, p_out=0.06, steps=steps, churn=churn,
        churn_schedule=jnp.asarray(schedule))
    cfg = dict(dim=1, method="both", edge_cap=96, tri_cap=192,
               drift_metric=metric, drift_threshold="auto:q0.9",
               drift_warmup=5)
    sj = stream_j.TopoStream(g0, stream_j.TopoStreamConfig(**cfg))
    st = TopoStream(_g_t(g0), TopoStreamConfig(**cfg), device="cpu")
    cal = calibration_j.DriftCalibrator(4, q=0.9, warmup=5)
    scored = repro_on = 0
    for t in range(steps):
        dj = delta_j.delta_step(deltas, t)
        old = st.diagrams
        st.apply(_d_t(dj))
        needs = st.last_flags["recompute"]
        sj.apply(dj)
        assert st.stats == sj.stats
        want_j = np.asarray(sj.last_drift)
        assert (st.last_drift[~needs] == 0).all()
        np.testing.assert_array_equal(st.last_anomaly,
                                      st.last_drift > cal.thresholds())
        if metric == "sw":
            np.testing.assert_allclose(st.last_drift, want_j, rtol=1e-5,
                                       atol=0)
        else:
            for b in np.nonzero(needs)[0]:
                oracle = reference.wasserstein_exact(
                    reference.cap_points(dim_pairs(old, b, 1), 64.0),
                    reference.cap_points(dim_pairs(st.diagrams, b, 1), 64.0))
                assert abs(st.last_drift[b] - oracle) <= 1e-5, (t, b)
                if abs(want_j[b] - oracle) <= 1e-5:
                    assert abs(st.last_drift[b] - want_j[b]) <= 1e-5
                    repro_on += 1
        cal.observe(np.nonzero(needs)[0], st.last_drift[needs])
        scored += int(needs.sum())
    assert scored > 0 and (metric == "sw" or repro_on > 0)
    np.testing.assert_array_equal(st.drift_thresholds(), cal.thresholds())
    assert np.isfinite(st.drift_thresholds()).any()


def test_drift_scores_only_recomputed_graphs():
    g = from_edge_lists_j([[(0, 1), (1, 2), (2, 3)]] * 2, [4, 4], n_pad=8)
    s = TopoStream(_g_t(g), TopoStreamConfig(
        dim=1, method="both", drift_metric="sw", drift_threshold=0.5, **CFG),
        device="cpu")
    d = DeltaBatch(*(torch.tensor(x) for x in (
        [[0], [0]], [[3], [1]], [[EDGE_INSERT], [EDGE_INSERT]],
        [[-1], [-1]], [[0.0], [0.0]], [[-1], [-1]])))
    d = DeltaBatch(*(x.to(torch.float32 if x.is_floating_point()
                          else torch.int32) for x in
                     (d.edge_u, d.edge_v, d.edge_op, d.f_vertex, d.f_value,
                      d.drop_vertex)))
    s.apply(d)
    assert s.last_drift[0] > 0 and s.last_drift[1] == 0.0
    assert s.last_anomaly.tolist() == [True, False]


# ------------------------------------------------------ calibration, config

def test_p2_and_calibrator_sequences_equal_repro():
    rng = np.random.default_rng(0)
    xs = rng.exponential(2.0, size=600)
    for q in (0.5, 0.9, 0.99):
        a, b = calibration.P2Quantile(q), calibration_j.P2Quantile(q)
        assert a.value() is None and b.value() is None
        for x in xs:
            a.update(float(x))
            b.update(float(x))
            assert a.value() == b.value()
    ca = calibration.DriftCalibrator(batch=3, q=0.9, warmup=5)
    cb = calibration_j.DriftCalibrator(batch=3, q=0.9, warmup=5)
    for i in range(40):
        idx = rng.choice(3, size=int(rng.integers(1, 4)), replace=False)
        sc = rng.exponential(1.0, size=len(idx)).astype(np.float32)
        ca.observe(idx, sc)
        cb.observe(idx, sc)
        np.testing.assert_array_equal(ca.thresholds(), cb.thresholds())
        np.testing.assert_array_equal(ca.counts(), cb.counts())
    for spec in (0.5, "auto:q0.9", 3):
        assert (calibration.parse_drift_threshold(spec)
                == calibration_j.parse_drift_threshold(spec))


def test_config_validation():
    with pytest.raises(ValueError, match="exact_dims"):
        TopoStreamConfig(exact_dims="bogus")
    with pytest.raises(ValueError, match="every"):
        TopoStreamConfig(method="both", exact_dims="all")
    with pytest.raises(ValueError, match="unknown reduction"):
        TopoStreamConfig(method="nonsense")
    for name in ("jnp", "pallas"):
        with pytest.raises(ValueError, match="port's reducers"):
            TopoStreamConfig(reducer=name)
    assert TopoStreamConfig().reducer == "blocks"
    TopoStreamConfig(reducer="flat")
    with pytest.raises(ValueError, match="recompute_pad"):
        TopoStreamConfig(recompute_pad="pow3")
    with pytest.raises(ValueError, match="repack"):
        TopoStreamConfig(repack="maybe")
    with pytest.raises(ValueError, match="drift_metric"):
        TopoStreamConfig(drift_metric="bogus")
    with pytest.raises(ValueError, match="drift_dim"):
        TopoStreamConfig(dim=1, drift_dim=2, drift_metric="sw")
    with pytest.raises(ValueError, match="exact_dims"):
        TopoStreamConfig(dim=1, drift_dim=0, drift_metric="sw")
    TopoStreamConfig(dim=1, drift_dim=0, drift_metric="sw",
                     method="prunit", exact_dims="all")
    with pytest.raises(ValueError, match="auto:q"):
        TopoStreamConfig(drift_threshold="q0.99")
    with pytest.raises(ValueError, match="quantile"):
        TopoStreamConfig(drift_threshold="auto:q1.5")
    with pytest.raises(ValueError, match="drift_warmup"):
        TopoStreamConfig(drift_threshold="auto:q0.9", drift_warmup=2)
    TopoStreamConfig(drift_threshold="auto:q0.99", drift_metric="exact_w")


def test_stream_entry_points_want_a_device_choice():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    g = from_edge_lists_j([[(0, 1)]], [2], n_pad=4)
    for make in (lambda: TopoStream(_g_t(g)),
                 lambda: temporal.ego_decay_stream(0, 1, 16, 4, 2, 2, 1),
                 lambda: temporal.pa_growth_stream(0, 1, 8, 3, 1, 2),
                 lambda: temporal.community_churn_stream(0, 1, 8, 6, 2, .5,
                                                         .1, 2, 1),
                 lambda: delta_from_lists([[]]),
                 lambda: empty_delta(1)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


def test_stream_accessors():
    gj = from_edge_lists_j([[(0, 1), (1, 2), (2, 0), (0, 3)]], [4], n_pad=8)
    s = TopoStream(_g_t(gj), TopoStreamConfig(**CFG), device="cpu")
    _eq(s.coreness(), stream_j.TopoStream(
        gj, stream_j.TopoStreamConfig(**CFG)).coreness())
    assert s.skip_rate() == 0.0 and s.plan.dim == 1
    np.testing.assert_array_equal(s.drift_thresholds(), [1.0])
    assert graph_batch_to_numpy(s.graph)[0].shape == (1, 8, 8)
    before = topo_stream._OBS_VERDICTS.total(verdict="coral_hit")
    s.apply(delta_from_lists([[(0, 3, EDGE_DELETE)]], device="cpu"))
    assert topo_stream._OBS_VERDICTS.total(verdict="coral_hit") == before + 1


# -------------------------------------------- the port's temporal generators

def _replay_invariants(g0, deltas, steps):
    g = g0
    for t in range(steps):
        g = apply_delta(g, delta.delta_step(deltas, t))
        a, m, f = (x.numpy() for x in (g.adj, g.mask, g.f))
        assert np.array_equal(a, np.swapaxes(a, -1, -2))
        assert not a[:, np.arange(g.n), np.arange(g.n)].any()
        assert not (a & ~(m[:, None, :] & m[:, :, None])).any()
        assert np.isinf(f[~m]).all() and np.isfinite(f[m]).all()
    return g


def test_pa_growth_activates_one_vertex_per_step():
    g0, deltas = temporal.pa_growth_stream(0, batch=3, n_pad=16, n0=3, m=2,
                                           steps=8, device="cpu")
    assert deltas.steps == 8 and deltas.batch == 3
    assert int(g0.n_vertices()[0]) == 3
    g = _replay_invariants(g0, deltas, 8)
    assert (g.n_vertices() == 11).all()
    m = g.mask.numpy()
    assert (g.f.numpy()[m] == np.tile(np.arange(16), (3, 1))[m]).all()
    g1, d1 = temporal.pa_growth_stream(0, batch=3, n_pad=16, n0=3, m=2,
                                       steps=8, device="cpu")
    assert torch.equal(d1.edge_u, deltas.edge_u)  # seeded


def test_pa_growth_m1_all_updates_skip():
    g0, deltas = temporal.pa_growth_stream(1, batch=2, n_pad=12, n0=3, m=1,
                                           steps=6, device="cpu")
    s = TopoStream(g0, TopoStreamConfig(dim=1, method="prunit",
                                        exact_dims="all", edge_cap=40,
                                        tri_cap=64), device="cpu")
    for t in range(6):
        s.apply(delta.delta_step(deltas, t))
    assert s.skip_rate() == 1.0 and s.stats["recomputes"] == 0


def test_pa_growth_rejects_overflow():
    with pytest.raises(ValueError, match="n_pad"):
        temporal.pa_growth_stream(0, batch=1, n_pad=8, n0=4, m=1, steps=8,
                                  device="cpu")


def test_community_churn_preserves_vertex_set_and_f():
    g0, deltas = temporal.community_churn_stream(
        2, batch=3, n_pad=12, n_vertices=10, n_comm=3, p_in=0.5, p_out=0.1,
        steps=6, churn=2, device="cpu")
    g = _replay_invariants(g0, deltas, 6)
    assert torch.equal(g.mask, g0.mask) and torch.equal(g.f, g0.f)
    assert (deltas.edge_op != EDGE_NOP).any()
    # every delete names an edge of the state it applies to, every insert
    # a non-edge: the generator tracks the stream it emits
    g = g0
    for t in range(6):
        d = delta.delta_step(deltas, t)
        a = g.adj
        bidx = torch.arange(3)[:, None].expand_as(d.edge_u)
        on = d.edge_op != EDGE_NOP
        u, v = d.edge_u.clamp(min=0).long(), d.edge_v.clamp(min=0).long()
        present = a[bidx, u, v]
        assert (present[on & (d.edge_op == EDGE_DELETE)]).all()
        assert (~present[on & (d.edge_op == EDGE_INSERT)]).all()
        g = apply_delta(g, d)
    with pytest.raises(ValueError, match="churn_schedule"):
        temporal.community_churn_stream(2, 1, 12, 10, 3, .5, .1, 3, 2,
                                        churn_schedule=[1, 3, 0],
                                        device="cpu")


def test_ego_decay_mixes_hits_and_recomputes():
    g0, deltas = temporal.ego_decay_stream(3, batch=4, n_pad=32, n_core=10,
                                           n_double=6, n_pendant=6,
                                           steps=12, toggles=1,
                                           p_core_edge=0.3, device="cpu")
    _replay_invariants(g0, deltas, 12)
    s = TopoStream(g0, TopoStreamConfig(dim=1, method="both", edge_cap=192,
                                        tri_cap=512), device="cpu")
    for t in range(12):
        s.apply(delta.delta_step(deltas, t))
    assert s.stats["hits"] > 0 and s.stats["coral_hits"] > 0
    assert s.stats["prunit_hits"] > 0
    assert 0.0 < s.skip_rate() <= 1.0
    # the layout is repro's: mask, f and the hub rows are not drawn
    gj, _ = temporal_j.ego_decay_stream(jax.random.PRNGKey(3), 4, 32, 10, 6,
                                        6, 1)
    _eq(g0.mask, gj.mask)
    _eq(g0.f, gj.f)
    _eq(g0.adj[:, :2], np.asarray(gj.adj)[:, :2])
    # the pendant satellites never enter the 2-core
    assert not kcore_mask(g0.adj, g0.mask, 2)[:, 16:].any()


def test_ego_decay_layout_validation():
    with pytest.raises(ValueError, match="n_pad"):
        temporal.ego_decay_stream(0, batch=1, n_pad=8, n_core=6, n_double=4,
                                  n_pendant=4, steps=2, device="cpu")
    with pytest.raises(ValueError, match="n_core"):
        temporal.ego_decay_stream(0, batch=1, n_pad=16, n_core=3,
                                  n_double=2, n_pendant=2, steps=2,
                                  device="cpu")
