"""The port's features and sliced-Wasserstein distances against ``repro``.

Both packages get the same numpy-made Diagrams (``diagrams_from_numpy`` on
one side, ``repro``'s Diagrams on the other) and run on the CPU.

Tolerances, and why each is not zero:

* bit-exact: Betti curves, landscapes, ``finite_points``, the count and
  Betti columns of ``persistence_stats``, ``masked_points`` and the
  ``compact_top_k`` clouds (ties included): every one is a comparison, a
  min/max, a subtraction or an integer count.
* rtol 1e-5, atol 1e-6: the other statistics columns, persistence images,
  SW embeddings and SW distances.  XLA's float32 ``exp``, ``cos`` and
  ``sin`` are not correctly rounded (the port takes them in float64 and
  rounds once), XLA contracts ``b*cos + e*sin`` into a fused multiply-add,
  and float sums run in another order; each costs an ulp or so.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.persistence_jax import Diagrams as DiagramsJ
from repro.metrics import distances as distances_j
from repro.topo import features as features_j
from repro_torch.convert import diagrams_from_numpy
from repro_torch.metrics import distances
from repro_torch.topo import features


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: these tests run many small torch ops, which
    gain nothing from threads, and parallel test workers would
    oversubscribe the CPUs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RTOL, ATOL = 1e-5, 1e-6


def random_diagrams(b, s, seed, integer=True, max_dim=1):
    """(birth, death, dim, valid) arrays in repro's layout: NaN on invalid
    rows, some +inf (essential) deaths, dims 0..max_dim."""
    rng = np.random.default_rng(seed)
    if integer:
        birth = rng.integers(0, 24, (b, s)).astype(np.float32)
        death = birth + rng.integers(1, 24, (b, s)).astype(np.float32)
    else:
        birth = rng.uniform(0, 24, (b, s)).astype(np.float32)
        death = birth + rng.uniform(0.01, 24, (b, s)).astype(np.float32)
    death[rng.random((b, s)) < 0.1] = np.inf
    valid = rng.random((b, s)) < 0.6
    valid[0] = False  # an empty diagram
    dim = np.where(valid, rng.integers(0, max_dim + 1, (b, s)), -1)
    return (np.where(valid, birth, np.nan).astype(np.float32),
            np.where(valid, death, np.nan).astype(np.float32),
            dim.astype(np.int32), valid)


def both(arrays):
    """The same Diagrams in both packages."""
    return (diagrams_from_numpy(*arrays, device="cpu"),
            DiagramsJ(*(jnp.asarray(a) for a in arrays)))


@pytest.fixture(scope="module", params=[True, False], ids=["int", "float"])
def pair(request):
    return both(random_diagrams(6, 40, seed=3, integer=request.param))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def test_finite_points_bit_exact(pair):
    d, dj = pair
    for got, want in zip(d.finite_points(9.0), dj.finite_points(9.0)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("k", [0, 1])
def test_betti_curve_and_landscape_bit_exact(pair, k):
    d, dj = pair
    grid = np.linspace(-1, 50, 37).astype(np.float32)
    np.testing.assert_array_equal(
        features.betti_curve(d, k, torch.from_numpy(grid)).numpy(),
        np.asarray(features_j.betti_curve(dj, k, jnp.asarray(grid))))
    np.testing.assert_array_equal(
        features.persistence_landscape(d, k, torch.from_numpy(grid)).numpy(),
        np.asarray(features_j.persistence_landscape(dj, k,
                                                    jnp.asarray(grid))))


@pytest.mark.parametrize("k", [0, 1, 2])
def test_persistence_stats(pair, k):
    """k = 2 is an empty dimension: all six columns are 0."""
    d, dj = pair
    got = features.persistence_stats(d, k, cap=40.0).numpy()
    want = np.asarray(features_j.persistence_stats(dj, k, cap=40.0))
    np.testing.assert_array_equal(got[:, :2], want[:, :2])  # count, betti
    _close(got, want)
    if k == 2:
        np.testing.assert_array_equal(got, 0.0)


@pytest.mark.parametrize("res,lo,hi,sigma", [(8, 0.0, 32.0, 1.0),
                                             (6, 0.0, 32.0, 1.0),
                                             (5, 1.5, 20.0, 2.5)])
def test_persistence_image(pair, res, lo, hi, sigma):
    d, dj = pair
    for k in (0, 1):
        _close(features.persistence_image(d, k, res, lo, hi, sigma, 40.0),
               features_j.persistence_image(dj, k, res, lo, hi, sigma, 40.0))


def test_linspace_grid_equals_repro_jitted_grid():
    """The image grid is bit-identical to the one XLA folds for the jitted
    feature_vector (constant bounds)."""
    import jax

    for lo, hi, num in ((0.0, 32.0, 8), (0.0, 32.0, 6), (1.5, 33.3, 9),
                        (-3.0, 7.0, 13), (0.0, 10.0, 1)):
        want = jax.jit(lambda: jnp.linspace(lo, hi, num))()
        np.testing.assert_array_equal(features.linspace_f32(lo, hi, num),
                                      np.asarray(want))


@pytest.mark.parametrize("max_dim,res", [(1, 8), (0, 4)])
def test_feature_vector(pair, max_dim, res):
    d, dj = pair
    got = features.feature_vector(d, max_dim=max_dim, res=res)
    assert got.shape == (6, (6 + res * res) * (max_dim + 1))
    _close(got, features_j.feature_vector(dj, max_dim=max_dim, res=res))


def test_signature_features_through_both_plans():
    from repro.core import api as api_j
    from repro.core.graph import GraphBatch as GraphBatchJ
    from repro_torch.convert import graph_batch_from_numpy
    from repro_torch.core import api
    from repro_torch.data import graphs

    g = graphs.with_degree_filtration(
        graphs.powerlaw_cluster(4, 5, 20, 18, 2, 0.3, device="cpu"))
    arrays = [t.numpy() for t in (g.adj, g.mask, g.f)]
    gj = GraphBatchJ(*(jnp.asarray(a) for a in arrays))
    kw = dict(dim=1, method="both", edge_cap=64, tri_cap=96)
    got = features.signature_features(
        graph_batch_from_numpy(*arrays, device="cpu"),
        api.make_topo_plan(**kw), res=4)
    want = features_j.signature_features(
        gj, api_j.make_topo_plan(reducer="jnp", **kw), res=4)
    _close(got, want)


def test_direction_grid_and_masked_points(pair):
    d, dj = pair
    for n in (8, 12, 16, 33):
        for got, want in zip(distances.direction_grid(n, "cpu"),
                             distances_j.direction_grid(n)):
            _close(got, want)  # an ulp apart where XLA's cos/sin round off
    for k in (0, 1):
        for got, want in zip(distances.masked_points(d, k, 30.0),
                             distances_j.masked_points(dj, k, 30.0)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def tied_diagrams():
    """One graph's worth of rows with many equal persistences: which rows
    survive truncation is decided by the tie order alone."""
    rows = [(0, 2), (1, 3), (5, 7), (2, 4), (3, 5), (4, 9), (6, 8), (7, 9),
            (1, np.inf), (8, 10), (2, 4), (0, 5)]
    s = 16
    birth = np.full((2, s), np.nan, np.float32)
    death = np.full((2, s), np.nan, np.float32)
    dim = np.full((2, s), -1, np.int32)
    valid = np.zeros((2, s), bool)
    for i, (b, e) in enumerate(rows):
        birth[0, i + 2], death[0, i + 2] = b, e
        dim[0, i + 2], valid[0, i + 2] = 1, True
    birth[1, :3], death[1, :3], dim[1, :3], valid[1, :3] = 1, 4, 1, True
    return birth, death, dim, valid


@pytest.mark.parametrize("n_points", [3, 5, 8, 16, 20])
def test_compact_top_k_ties_and_truncation_bit_exact(n_points):
    d, dj = both(tied_diagrams())
    got = distances.compact_top_k(d, 1, n_points, cap=12.0)
    want = distances_j.compact_top_k(dj, 1, n_points, cap=12.0)
    for g_, w_ in zip(got, want):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))
    if n_points == 5:
        # persistence 11 (the capped essential), 5, 5, then the first two
        # of the nine rows of persistence 2: the lowest rows win the tie
        b, e, keep = (t[0].numpy() for t in got)
        assert keep.all()
        np.testing.assert_array_equal(b, [1, 4, 0, 0, 1])
        np.testing.assert_array_equal(e, [12, 9, 5, 2, 3])


@pytest.mark.parametrize("n_points,n_dirs", [(4, 8), (8, 16), (16, 12)])
def test_sw_embedding(pair, n_points, n_dirs):
    d, dj = pair
    for k in (0, 1):
        got = distances.sw_embedding(d, k, n_points, n_dirs, cap=40.0)
        assert got.shape == (6, n_dirs * 2 * n_points)
        _close(got, distances_j.sw_embedding(dj, k, n_points, n_dirs,
                                             cap=40.0))
    d_t, dj_t = both(tied_diagrams())
    _close(distances.sw_embedding(d_t, 1, n_points, n_dirs, cap=12.0),
           distances_j.sw_embedding(dj_t, 1, n_points, n_dirs, cap=12.0))


def test_sliced_wasserstein(pair):
    d, dj = pair
    rolled = [np.roll(a, 1, axis=0) for a in random_diagrams(6, 40, seed=3)]
    d2, dj2 = both(rolled)
    for k in (0, 1):
        _close(distances.sliced_wasserstein(d, d2, k, 16, 40.0),
               distances_j.sliced_wasserstein(dj, dj2, k, 16, 40.0))
        # a diagram is at distance 0 from itself
        np.testing.assert_array_equal(
            distances.sliced_wasserstein(d, d, k, 16, 40.0).numpy(), 0.0)


def test_creating_entry_points_need_a_device_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        distances.direction_grid(8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        diagrams_from_numpy(*random_diagrams(1, 4, seed=0))
