"""The port's entropic Sinkhorn-W2 path and MetricEngine against ``repro``.

Both packages get the same numpy-made inputs and run on the CPU; ``repro``'s
Pallas kernels run in interpret mode, as its own tests run them.

Tolerances, and why each is not zero:

* rtol 1e-5, atol 1e-5 for the plain kernels against ``repro``'s jnp
  oracle and interpret-mode Pallas kernels: the same float32 algebra, with
  float sums in another order and XLA's ``exp``/``log``, which are not
  correctly rounded; -inf must sit exactly where ``repro`` has it.
* rtol 1e-4, atol 1e-5 for ``sinkhorn_w2`` and ``compare`` against
  ``repro`` (and blocked against dense while the cloud fits one 128-column
  tile): 1800 Sinkhorn half-updates each carry an ulp or so, and at the
  last eps stage one ulp of an exponent is ~1e-4 relative after ``exp``.
* rtol 1e-3, atol 1e-4 for blocked against dense on the full tensor, where
  the port's plain blocked version takes one maximum per row and ``repro``
  merges 32-column tiles: ``repro``'s own bound for its two forms.
* bit-exact: self-distance (0.0), the ``tile`` argument (no effect),
  ``block_rows`` chunking, the numpy oracles and the seeded generators.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as kops_j
from repro.kernels import ref as kref_j
from repro.metrics import distances as distances_j
from repro.metrics import engine as engine_j
from repro.metrics import reference as reference_j
from repro.metrics import testing as testing_j
from repro_torch import counters
from repro_torch.core.persistence import Diagrams
from repro_torch.kernels import ops, ref
from repro_torch.metrics import distances, engine, reference, testing

CAP = 64.0
SHORT = dict(n_iters=10, n_scales=3)  # a short eps ladder keeps JAX quick


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file: its hundreds of small Sinkhorn
    updates gain nothing from threads, and when test files run in parallel
    worker processes, threads in every worker oversubscribe the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stack_j(rows):
    return jax.tree.map(lambda *x: jnp.stack(x), *rows)


def _to_port(dj) -> Diagrams:
    return Diagrams(*(torch.from_numpy(np.array(getattr(dj, k)))
                      for k in ("birth", "death", "dim", "valid")))


def _pairs(seed, b, s, n=None, essential=0):
    """(repro, port) batches of ``b`` random diagram pairs of size ``s``."""
    rng = np.random.default_rng(seed)
    rows = [(testing_j.random_diagram(rng, s=s, n=n, essential=essential),
             testing_j.random_diagram(rng, s=s, n=n)) for _ in range(b)]
    d1 = _stack_j([a for a, _ in rows])
    d2 = _stack_j([b_ for _, b_ in rows])
    return (d1, d2), (_to_port(d1), _to_port(d2))


# ------------------------------------------------------ kernel plain versions

def _pad8(p):
    """repro's (B, 8, M) layout: five zero planes of TPU sublane padding."""
    return np.concatenate([p, np.zeros((p.shape[0], 5, p.shape[2]),
                                       np.float32)], axis=1)


# the shared edge cases small enough for interpret-mode Pallas on the CPU
KERNEL_CASES = [c for c in testing.SINKHORN_CASES if c[0] * c[1] * c[2] < 1e5]


def _kernel_inputs(b, m, n, v0, seed=0):
    """Numpy operands (xp, yp, f, g, log_a, log_b, e_t), seeded."""
    t = testing.sinkhorn_operands(np.random.default_rng(seed), b, m, n, v0,
                                  device="cpu")
    return tuple(t[k].numpy()
                 for k in ("xp", "yp", "f", "g", "log_a", "log_b", "e_t"))


def _assert_close_with_inf(got, want, rtol, atol):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    assert np.isfinite(got[fin]).all()
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol, atol=atol)


@pytest.mark.parametrize("b,m,n,v0", KERNEL_CASES)
def test_sinkhorn_lse_ref_matches_repro(b, m, n, v0):
    xp, yp, _, dual, _, logw, e_t = _kernel_inputs(b, m, n, v0)
    t = [torch.from_numpy(a) for a in (xp, yp, dual, logw, e_t)]
    got = ops.sinkhorn_lse(*t).numpy()
    assert got.shape == (b, m)
    j = [jnp.asarray(a) for a in (_pad8(xp), _pad8(yp), dual, logw, e_t)]
    _assert_close_with_inf(got, kref_j.sinkhorn_lse_ref(*j), 1e-5, 1e-5)
    _assert_close_with_inf(got, kops_j.sinkhorn_lse(*j), 1e-5, 1e-5)
    if v0 == 0:  # batch item 0 has no valid column: -inf, never NaN
        assert np.isneginf(got[0]).all()


@pytest.mark.parametrize("mode", ["plan", "cost"])
@pytest.mark.parametrize("b,m,n,v0", KERNEL_CASES)
def test_sinkhorn_pair_sum_ref_matches_repro(b, m, n, v0, mode):
    args = _kernel_inputs(b, m, n, v0, seed=1)
    xp, yp = args[:2]
    got = ops.sinkhorn_pair_sum(*(torch.from_numpy(a) for a in args),
                                mode=mode).numpy()
    assert got.shape == (b,)
    want = kops_j.sinkhorn_pair_sum(
        *(jnp.asarray(a) for a in (_pad8(xp), _pad8(yp), *args[2:])),
        mode=mode)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    if v0 == 0:  # batch item 0 has no valid pair
        assert got[0] == 0.0


def test_pair_sum_rejects_unknown_mode():
    args = [torch.from_numpy(a) for a in _kernel_inputs(1, 3, 4, 2)]
    with pytest.raises(ValueError, match="unknown pair-sum mode"):
        ops.sinkhorn_pair_sum(*args, mode="both")
    with pytest.raises(ValueError, match="unknown pair-sum mode"):
        ref.sinkhorn_pair_sum_ref(*args, "both")


def test_sinkhorn_wrappers_check_their_operands():
    xp, yp, _, dual, _, logw, e_t = (
        torch.from_numpy(a) for a in _kernel_inputs(2, 5, 7, 2))
    with pytest.raises(ValueError, match="contiguous"):
        ops.sinkhorn_lse(xp, yp, dual.t().contiguous().t(), logw, e_t)
    with pytest.raises(ValueError, match="shape"):
        ops.sinkhorn_lse(xp, yp, dual[:, :-1].contiguous(), logw, e_t)
    with pytest.raises(TypeError, match="dtype"):
        ops.sinkhorn_lse(xp, yp, dual.double(), logw, e_t)
    with pytest.raises(ValueError, match="planes"):
        ops.sinkhorn_lse(xp[:, 0], yp, dual, logw, e_t)


# ------------------------------------------------------------- sinkhorn_w2

@pytest.mark.parametrize("n_points", [32, None], ids=["n32", "full"])
@pytest.mark.parametrize("impl", ["dense", "blocked"])
def test_sinkhorn_w2_matches_repro(impl, n_points):
    # s = 20: clouds of 40 (full) or 64 (n_points 32) slots, past repro's
    # tile of 32, so repro's blocked form merges several column tiles
    (j1, j2), (t1, t2) = _pairs(16, 4, 20, essential=1)
    kw = dict(k=1, cap=CAP, impl=impl, n_points=n_points, **SHORT)
    want = np.asarray(distances_j.sinkhorn_w2(j1, j2, tile=32, **kw))
    got = distances.sinkhorn_w2(t1, t2, **kw).numpy()
    assert got.shape == (4,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("impl", ["dense", "blocked"])
def test_sinkhorn_self_distance_is_exactly_zero(impl):
    _, (t1, _) = _pairs(17, 5, 16, essential=1)
    got = distances.sinkhorn_w2(t1, t1, impl=impl, **SHORT)
    assert torch.equal(got, torch.zeros(5))


def test_sinkhorn_tile_has_no_effect():
    _, (t1, t2) = _pairs(18, 3, 24)
    runs = [distances.sinkhorn_w2(t1, t2, impl="blocked", n_points=None,
                                  tile=tile, **SHORT) for tile in (8, 32, 128)]
    assert all(torch.equal(r, runs[0]) for r in runs[1:])


@pytest.mark.parametrize("s,n_points,rtol,atol", [
    (12, 32, 1e-4, 1e-5),     # the cloud (64) fits one tile
    (40, None, 1e-3, 1e-4),   # the full tensor (80 slots)
], ids=["tile_fit", "full"])
def test_blocked_agrees_with_dense(s, n_points, rtol, atol):
    _, (t1, t2) = _pairs(19, 6, s)
    kw = dict(n_points=n_points, **SHORT)
    dense = distances.sinkhorn_w2(t1, t2, impl="dense", **kw).numpy()
    blocked = distances.sinkhorn_w2(t1, t2, impl="blocked", **kw).numpy()
    np.testing.assert_allclose(blocked, dense, rtol=rtol, atol=atol)


def test_sinkhorn_rejects_unknown_impl():
    _, (t1, t2) = _pairs(20, 2, 8)
    with pytest.raises(ValueError, match="unknown sinkhorn impl"):
        distances.sinkhorn_w2(t1, t2, impl="bogus")


def test_blocked_sinkhorn_flattens_leading_axes():
    _, (t1, t2) = _pairs(21, 6, 10)
    sq = [Diagrams(*(getattr(d, k).reshape(2, 3, -1)
                     for k in ("birth", "death", "dim", "valid")))
          for d in (t1, t2)]
    flat = distances.sinkhorn_w2(t1, t2, impl="blocked", **SHORT)
    got = distances.sinkhorn_w2(*sq, impl="blocked", **SHORT)
    assert got.shape == (2, 3)
    assert torch.equal(got.reshape(-1), flat)


def test_empty_pairs_give_zero():
    rng = np.random.default_rng(22)
    e = [testing.random_diagram(rng, s=6, n=0, device="cpu") for _ in range(2)]
    d = Diagrams(*(torch.stack([getattr(x, k) for x in e])
                   for k in ("birth", "death", "dim", "valid")))
    for impl in ("dense", "blocked"):
        got = distances.sinkhorn_w2(d, d, impl=impl, **SHORT)
        assert torch.equal(got, torch.zeros(2))


# ------------------------------------------------------------ MetricEngine

@pytest.mark.parametrize("metric", ["sw", "sinkhorn"])
def test_compare_matches_repro(metric):
    # the registry defaults (sinkhorn: dense, n_points 32, 6 eps stages)
    (j1, j2), (t1, t2) = _pairs(23, 6, 12, essential=1)
    want = np.asarray(engine_j.compare(j1, j2, metric=metric, k=1, cap=CAP))
    counters.reset()
    got = engine.compare(t1, t2, metric=metric, k=1, cap=CAP).numpy()
    assert counters.METRIC_CALLS[(metric, "compare")] == 1
    rtol = 1e-5 if metric == "sw" else 1e-4  # sw: the features' bound
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-5)


@pytest.mark.parametrize("metric,params", [
    ("sw", {"n_dirs": 8}), ("sinkhorn", SHORT),
    ("sinkhorn", dict(impl="blocked", **SHORT))], ids=["sw", "sinkhorn",
                                                       "sinkhorn_blocked"])
def test_pairwise_matches_repro_and_chunks_exactly(metric, params):
    (j1, j2), (t1, t2) = _pairs(24, 5, 10)
    q = Diagrams(*(getattr(t1, k)[:3] for k in ("birth", "death", "dim",
                                                  "valid")))
    counters.reset()
    full = engine.pairwise(q, t2, metric=metric, **params)
    assert full.shape == (3, 5)
    assert counters.METRIC_CALLS[(metric, "pairwise")] == 1
    chunked = engine.pairwise(q, t2, metric=metric, block_rows=2, **params)
    assert torch.equal(chunked, full)
    qj = jax.tree.map(lambda x: x[:3], j1)
    want = np.asarray(engine_j.pairwise(qj, j2, metric=metric, **params))
    rtol = 1e-5 if metric == "sw" else 1e-4
    np.testing.assert_allclose(full.numpy(), want, rtol=rtol, atol=1e-5)
    # pairwise(d) is d against itself: a zero diagonal
    self_ = engine.pairwise(q, metric=metric, **params)
    assert not bool(self_.diagonal().any())


@pytest.mark.parametrize("metric", ["sw", "sinkhorn"])
def test_registry_contract_equals_repro(metric):
    assert engine.metric_params(metric) == engine_j.metric_params(metric)
    mine, theirs = engine.get_metric(metric), engine_j.get_metric(metric)
    for field in ("exact", "error_bound", "cost_class", "defaults"):
        assert getattr(mine, field) == getattr(theirs, field)
    assert "Pallas" not in mine.description


def test_registry_rejects_unknown_names():
    _, (t1, t2) = _pairs(25, 2, 8)
    with pytest.raises(ValueError, match="does not accept"):
        engine.compare(t1, t2, metric="sinkhorn", n_dirs=8)
    with pytest.raises(ValueError, match="does not accept"):
        engine.pairwise(t1, t2, metric="sw", eps=0.1)
    for name in ("bogus", "exact", "bottleneck"):
        with pytest.raises(ValueError, match="unknown metric backend"):
            engine.compare(t1, t2, metric=name)
    with pytest.raises(ValueError, match="no diagnostics entry point"):
        engine.compare_info(t1, t2, metric="sinkhorn")
    with pytest.raises(ValueError, match="already registered"):
        engine.register_metric(engine.get_metric("sw"))


# ------------------------------------------------- oracles and generators

def test_reference_oracles_equal_repro():
    rng = np.random.default_rng(26)
    for _ in range(6):
        a = [(float(b), float(b + d)) for b, d in
             zip(rng.uniform(0, 8, 5), rng.uniform(0.2, 6, 5))]
        b = [(float(b), float(b + d)) for b, d in
             zip(rng.uniform(0, 8, 4), rng.uniform(0.2, 6, 4))]
        b[0] = (b[0][0], float("inf"))
        a, b = reference.cap_points(a, CAP), reference.cap_points(b, CAP)
        assert a == reference_j.cap_points(a, CAP)
        assert reference.sw_dense(a, b) == reference_j.sw_dense(a, b)
        for q in (1.0, 2.0):
            assert (reference.wasserstein_exact(a, b, q=q)
                    == reference_j.wasserstein_exact(a, b, q=q))
        assert (reference.bottleneck_exact(a, b)
                == reference_j.bottleneck_exact(a, b))
        c = reference._augmented_cost(a, b, 2.0, "l2")
        assert reference.hungarian_cost(c) == reference_j.hungarian_cost(c)
    assert reference.wasserstein_exact([], []) == 0.0


def _arrays(d):
    return [np.asarray(getattr(d, k).cpu() if isinstance(d, Diagrams)
                       else getattr(d, k))
            for k in ("birth", "death", "dim", "valid")]


def test_generators_give_repro_arrays():
    for kw in (dict(), dict(s=20, n=7, essential=2), dict(scatter=False)):
        mine = testing.random_diagram(np.random.default_rng(27), device="cpu",
                                      **kw)
        theirs = testing_j.random_diagram(np.random.default_rng(27), **kw)
        for a, b in zip(_arrays(mine), _arrays(theirs)):
            np.testing.assert_array_equal(a, b)
        assert (testing.diagram_points(mine, 1, CAP)
                == testing_j.diagram_points(theirs, 1, CAP))
    seeds = testing.seed_diagram_arrays(np.random.default_rng(28), 4, 16)
    seeds_j = testing_j.seed_diagram_arrays(np.random.default_rng(28), 4, 16)
    for a, b in zip(seeds, seeds_j):
        np.testing.assert_array_equal(a, b)
    mine = testing.noisy_copies(seeds, np.random.default_rng(29), 9, 0.01,
                                0.2, device="cpu")
    theirs = testing_j.noisy_copies(seeds_j, np.random.default_rng(29), 9,
                                    0.01, 0.2)
    for a, b in zip(_arrays(mine), _arrays(theirs)):
        np.testing.assert_array_equal(a, b)
