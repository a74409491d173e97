"""The paper's last two reductions through the port, against ``repro``.

Strong collapse (Table 3) masks, ``graph_power_distances``, ego-net
extraction (Fig 5b) and PrunIT's ``dom_fn=`` hook, on the same numpy
inputs through both packages.  Every comparison is bitwise: masks, hop
distances, adjacency, filtration values and Diagrams.  The port runs on
the CPU (its plain kernel versions).
"""
import importlib

import jax
import jax.numpy as jnp
import networkx as nx
import numpy as np
import pytest
import torch

import repro.core.filtration as filtration_j
import repro.core.strong_collapse as strong_collapse_j
import repro.data.ego as ego_j
from repro.core import api as api_j
from repro.core.graph import from_networkx
from repro.core.persistence_jax import diagrams_bitwise_equal
from repro.data import graphs as gdata_j
from repro_torch.convert import graph_batch_from_numpy
from repro_torch.core import api, filtration, strong_collapse
from repro_torch.data import ego
from repro_torch.kernels import ref

prunit = importlib.import_module("repro_torch.core.prunit")
prunit_j = importlib.import_module("repro.core.prunit")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: these tests run many small torch ops, which
    gain nothing from threads, and parallel test workers would
    oversubscribe the CPUs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _to_torch(gj):
    return graph_batch_from_numpy(np.asarray(gj.adj), np.asarray(gj.mask),
                                  np.asarray(gj.f), device="cpu")


def _eq(a_torch, b_jax):
    np.testing.assert_array_equal(a_torch.numpy(), np.asarray(b_jax))


# ----------------------------------------------------------- strong collapse

@pytest.fixture(scope="module")
def enron():
    """Table 3's graph: the Email-Enron surrogate as the benchmark loads it."""
    gj = gdata_j.load_large_network("Email-Enron", jax.random.PRNGKey(29),
                                    n_pad=512)
    return gj, _to_torch(gj)


@pytest.mark.parametrize("delta", [4, 12])
def test_strong_collapse_table3_bitwise(enron, delta):
    gj, gt = enron
    fmax = float(jnp.max(jnp.where(gj.mask, gj.f, -jnp.inf)))
    n_steps = max(2, int(np.ceil(fmax / delta)))
    th = np.arange(1, n_steps + 1, dtype=np.float32) * delta
    sub_j, col_j = strong_collapse_j.strong_collapse_filtration_masks(
        gj, jnp.asarray(th), n_steps, sublevel=False)
    sub_t, col_t = strong_collapse.strong_collapse_filtration_masks(
        gt, torch.from_numpy(th), n_steps, sublevel=False)
    _eq(sub_t, sub_j)
    _eq(col_t, col_j)
    # the collapse removed something at every step that had a dominated vertex
    assert int(col_t.sum()) < int(sub_t.sum())


@pytest.mark.parametrize("sublevel", [True, False])
def test_strong_collapse_batch_bitwise(sublevel):
    rng = np.random.default_rng(41)
    graphs = [nx.gnp_random_graph(int(rng.integers(8, 20)),
                                  float(rng.uniform(0.2, 0.6)),
                                  seed=int(rng.integers(1 << 30)))
              for _ in range(5)]
    gj = from_networkx(graphs, n_pad=20)
    gt = _to_torch(gj)
    th = np.array([1.0, 3.0, 5.0, 8.0], np.float32)
    sub_j, col_j = strong_collapse_j.strong_collapse_filtration_masks(
        gj, jnp.asarray(th), 4, sublevel=sublevel)
    sub_t, col_t = strong_collapse.strong_collapse_filtration_masks(
        gt, torch.from_numpy(th), 4, sublevel=sublevel)
    _eq(sub_t, sub_j)
    _eq(col_t, col_j)
    with pytest.raises(ValueError, match="thresholds"):
        strong_collapse.strong_collapse_filtration_masks(
            gt, torch.from_numpy(th), 3)


def _edge_case_graphs():
    return {
        "empty": (nx.empty_graph(5), 8),
        "single": (nx.empty_graph(1), 4),
        "complete": (nx.complete_graph(7), 8),
        "cycle4": (nx.cycle_graph(4), 6),
        "cycle7": (nx.cycle_graph(7), 8),
        "path": (nx.path_graph(6), 8),
        "star": (nx.star_graph(6), 8),
        "two_triangles": (nx.disjoint_union(nx.complete_graph(3),
                                            nx.complete_graph(3)), 8),
        "petersen": (nx.petersen_graph(), 12),
        "octahedron": (nx.octahedral_graph(), 8),
    }


@pytest.mark.parametrize("name", sorted(_edge_case_graphs()))
def test_collapse_mask_edge_cases(name):
    graph, n_pad = _edge_case_graphs()[name]
    gj = from_networkx([graph], n_pad=n_pad)
    gt = _to_torch(gj)
    want = strong_collapse_j.collapse_mask(gj.adj, gj.mask)
    _eq(strong_collapse.collapse_mask(gt.adj, gt.mask), want)
    # one graph unbatched gives the same row
    _eq(strong_collapse.collapse_mask(gt.adj[0], gt.mask[0]), want[0])
    # a fully masked-out batch stays empty
    dead = torch.zeros_like(gt.mask)
    assert not strong_collapse.collapse_mask(gt.adj, dead).any()


# ------------------------------------------------------ graph power distances

def test_graph_power_distances_disconnected_and_masked():
    rng = np.random.default_rng(5)
    cases = []
    g = nx.disjoint_union(nx.path_graph(5), nx.cycle_graph(6))
    a = nx.to_numpy_array(g, dtype=bool)
    cases.append((a, np.ones(len(a), bool)))
    m = np.ones(len(a), bool)
    m[[2, 7]] = False  # cuts the path and opens the cycle
    cases.append((a, m))
    for _ in range(4):
        n = int(rng.integers(6, 16))
        up = np.triu(rng.random((n, n)) < 0.2, 1)
        a = up | up.T
        cases.append((a, rng.random(n) < 0.8))
    cases.append((np.zeros((4, 4), bool), np.array([1, 0, 1, 1], bool)))
    for a, m in cases:
        got = filtration.graph_power_distances(a, m)
        want = filtration_j.graph_power_distances(a, m)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        assert np.isinf(got).any()


# ------------------------------------------------------------------ ego nets

@pytest.fixture(scope="module")
def fig5b_host():
    """Fig 5b's host graph: BA(192, 3) with degree filtering."""
    host = gdata_j.barabasi_albert(jax.random.PRNGKey(3), 1, 192, 192, 3)
    f = host.degrees()[0].astype(jnp.float32)
    return np.array(host.adj[0]), np.array(f)


def _ego_eq(gt, gj):
    _eq(gt.adj, gj.adj)
    _eq(gt.mask, gj.mask)
    _eq(gt.f, gj.f)


def test_ego_batch_fig5b_bitwise(fig5b_host):
    adj, f = fig5b_host
    gj = ego_j.ego_batch(jnp.asarray(adj), jnp.asarray(f), n_pad=64)
    gt = ego.ego_batch(torch.from_numpy(adj), torch.from_numpy(f), n_pad=64,
                       device="cpu")
    _ego_eq(gt, gj)
    # the largest ego net holds 42 vertices: n_pad 16 truncates, among
    # the degree filtration's many ties
    sizes = ego.ego_sizes(torch.from_numpy(adj))
    _eq(sizes, ego_j.ego_sizes(jnp.asarray(adj)))
    assert sizes.dtype == torch.int32
    assert int(sizes.max()) > 16
    small = ego.ego_batch(adj, f, n_pad=16, centers=[0, 5, 17, 100, 191],
                          device="cpu")
    _ego_eq(small, ego_j.ego_batch(jnp.asarray(adj), jnp.asarray(f),
                                   n_pad=16,
                                   centers=jnp.asarray([0, 5, 17, 100, 191])))


def test_ego_batch_truncates_ties_bitwise():
    # a hub with 40 neighbours whose f takes three values: the first 12
    # slots of its ego keep the smallest (f, id), ties broken by id
    rng = np.random.default_rng(8)
    n = 48
    adj = np.zeros((n, n), bool)
    adj[0, 1:41] = adj[1:41, 0] = True
    up = np.triu(rng.random((n, n)) < 0.15, 1)
    adj |= up | up.T
    np.fill_diagonal(adj, False)
    f = rng.integers(0, 3, size=n).astype(np.float32)
    f[[3, 9, 27]] = -0.0  # signed zeros tie with 0.0
    for n_pad, centers in ((12, None), (12, [0, 3, 3, 40]), (64, None)):
        gj = ego_j.ego_batch(jnp.asarray(adj), jnp.asarray(f), n_pad=n_pad,
                             centers=None if centers is None
                             else jnp.asarray(centers))
        gt = ego.ego_batch(adj, f, n_pad=n_pad, centers=centers,
                           device="cpu")
        _ego_eq(gt, gj)
    assert int(ego.ego_sizes(torch.from_numpy(adj))[0]) > 12


@pytest.mark.parametrize("method", ["none", "prunit"])
def test_ego_fig5b_pd0_bitwise(fig5b_host, method):
    """Fig 5b's PD_0 of every ego net (superlevel, caps 192/8)."""
    adj, f = fig5b_host
    gj = ego_j.ego_batch(jnp.asarray(adj), jnp.asarray(f), n_pad=64)
    gt = ego.ego_batch(adj, f, n_pad=64, device="cpu")
    kw = dict(dim=0, method=method, sublevel=False, edge_cap=192, tri_cap=8)
    d_t = api.topological_signature(gt, **kw)
    d_j = api_j.topological_signature(gj, reducer="jnp", **kw)
    assert diagrams_bitwise_equal(d_t, d_j)


def test_ego_batch_requires_a_device_choice():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        ego.ego_batch(np.zeros((3, 3), bool), np.zeros(3, np.float32), 4)


# ------------------------------------------------------------------- dom_fn=

def test_dom_fn_passed_through():
    gj = from_networkx([nx.barbell_graph(4, 2), nx.wheel_graph(7)], n_pad=12)
    gt = _to_torch(gj)
    calls = []

    def counting(adj, mask):
        calls.append(adj.shape)
        return ref.domination_ref(adj, mask)

    for sublevel in (True, False):
        got = prunit.prune_round_mask(gt.adj, gt.mask, gt.f, sublevel,
                                      dom_fn=counting)
        _eq(got, prunit_j.prune_round_mask(
            gj.adj, gj.mask, gj.f, sublevel,
            dom_fn=prunit_j.domination_matrix))
        elig = prunit.eligibility_matrix(gt.adj, gt.mask, gt.f, sublevel,
                                         counting)
        _eq(elig, prunit_j.eligibility_matrix(gj.adj, gj.mask, gj.f,
                                              sublevel))
    assert calls == [(2, 12, 12)] * 4
    # a domination matrix with no entries removes nothing
    none = prunit.prune_round_mask(
        gt.adj, gt.mask, gt.f, dom_fn=lambda a, m: torch.zeros_like(a))
    assert torch.equal(none, gt.mask)
    assert not torch.equal(prunit.prune_round_mask(gt.adj, gt.mask, gt.f),
                           gt.mask)
