"""The port's numpy persistence oracle (``repro_torch.core.persistence_ref``)
against ``repro``'s, the port's Diagrams against the oracle, and the
paper's exactness theorems on the port's reductions.

* Every oracle function gives ``repro``'s result exactly on seeded graphs
  (cliques, filtration order, GF(2) pairs, diagrams under both
  orientations, Betti numbers, the power filtration, simplex counts,
  ``diagrams_equal``'s verdicts).
* ``topological_signature`` (plain CPU path) gives the oracle's diagrams for
  every method on seeded graphs with integer filtrations (ties included).
* Thm 2 (CoralTDA): PD_k(G) = PD_k of the (k+1)-core, k = 1, 2.
* Thm 7 (PrunIT): removing dominated vertices keeps every diagram, sub- and
  superlevel; PrunIT then CoralTDA keeps PD_k; Thm 10: PrunIT keeps the
  power filtration's PD_1 of a connected graph.

Everything is exact (multiset equality of diagrams at atol 1e-9, which the
oracle's own ``diagrams_equal`` applies); the graphs are small (4-13
vertices) because the oracle is pure Python.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.core import persistence_ref as ref_j
from repro_torch.convert import graph_batch_from_numpy
from repro_torch.core import (
    coral_reduce,
    diagrams_to_numpy,
    prunit,
    prunit_then_coral,
    topological_signature,
)
from repro_torch.core import persistence_ref as ref

N_PAD = 16


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: these tests run many small torch ops, which
    gain nothing from threads, and parallel test workers would
    oversubscribe the CPUs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_graphs(seed, count, n_min=4, n_max=13, connected=False):
    """(adj, f) pairs: G(n, p) with p in [0.2, 0.75] and integer f in
    0..5 (so the filtration has ties); ``connected`` adds a path."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        n = int(rng.integers(n_min, n_max + 1))
        adj = np.triu(rng.random((n, n)) < rng.uniform(0.2, 0.75), 1)
        if connected:
            adj[np.arange(n - 1), np.arange(1, n)] = True
        adj = adj | adj.T
        out.append((adj, rng.integers(0, 6, n).astype(np.float32)))
    return out


def batch(graphs):
    """The graphs padded to N_PAD as the port's GraphBatch (f = +inf on
    padding)."""
    b = len(graphs)
    adj = np.zeros((b, N_PAD, N_PAD), bool)
    mask = np.zeros((b, N_PAD), bool)
    f = np.full((b, N_PAD), np.inf, np.float32)
    for i, (a, fv) in enumerate(graphs):
        n = a.shape[0]
        adj[i, :n, :n] = a
        mask[i, :n] = True
        f[i, :n] = fv
    return graph_batch_from_numpy(adj, mask, f, device="cpu")


def oracle(g, i, max_dim, sublevel=True):
    return ref.persistence_diagrams(
        g.adj[i].numpy(), g.f[i].numpy(), g.mask[i].numpy(),
        max_dim=max_dim, sublevel=sublevel)


# ------------------------------------------------- the oracle against repro

@pytest.mark.parametrize("seed", range(4))
def test_oracle_matches_repro(seed):
    for adj, f in random_graphs(seed, 6):
        mask = np.ones(adj.shape[0], bool)
        mask[-1] = seed % 2 == 0  # sometimes a masked vertex
        for size in (2, 3, 4):
            assert (ref.enumerate_cliques(adj, mask, size)
                    == ref_j.enumerate_cliques(adj, mask, size))
        cliques = ref.enumerate_cliques(adj, mask, 3)
        for sub in (True, False):
            order = ref.sublevel_order(cliques, f, sub)
            assert order == ref_j.sublevel_order(cliques, f, sub)
            assert ref.reduce_boundary(order[0]) == ref_j.reduce_boundary(
                order[0])
            for max_dim in (0, 1, 2):
                for keep_zero in (False, True):
                    kw = dict(max_dim=max_dim, sublevel=sub,
                              keep_zero=keep_zero)
                    assert (ref.persistence_diagrams(adj, f, mask, **kw)
                            == ref_j.persistence_diagrams(adj, f, mask, **kw))
        assert (ref.betti_numbers(adj, f, mask, max_dim=2)
                == ref_j.betti_numbers(adj, f, mask, max_dim=2))
        assert (ref.betti_numbers(adj) == ref_j.betti_numbers(adj))
        for max_dim in (1, 2):
            assert (ref.simplex_count(adj, mask, max_dim)
                    == ref_j.simplex_count(adj, mask, max_dim))


@pytest.mark.parametrize("seed", range(2))
def test_power_filtration_matches_repro(seed):
    for adj, _ in random_graphs(10 + seed, 4, n_max=9):
        for keep_zero in (False, True):
            assert (ref.power_filtration_diagrams(adj, keep_zero=keep_zero)
                    == ref_j.power_filtration_diagrams(
                        adj, keep_zero=keep_zero))
        mask = np.ones(adj.shape[0], bool)
        mask[0] = False
        assert (ref.power_filtration_diagrams(adj, mask)
                == ref_j.power_filtration_diagrams(adj, mask))


def test_diagrams_equal_matches_repro():
    inf = np.inf
    d = {0: [(0.0, inf), (1.0, 2.0)], 1: [(2.0, 3.0)]}
    cases = [
        (d, {0: [(1.0, 2.0), (0.0, inf)], 1: [(2.0, 3.0)]}, None),
        (d, {0: [(0.0, inf), (1.0, 2.0)]}, None),
        (d, {0: [(0.0, inf), (1.0, 2.0)]}, 0),
        (d, {0: [(0.0, 5.0), (1.0, 2.0)], 1: [(2.0, 3.0)]}, None),
        (d, {0: [(0.0, inf), (1.0, 2.0 + 1e-12)], 1: [(2.0, 3.0)]}, None),
        (d, {0: [(0.0, inf), (1.0, 2.1)], 1: [(2.0, 3.0)]}, None),
        ({}, {1: []}, None),
    ]
    verdicts = [ref.diagrams_equal(a, b, m) for a, b, m in cases]
    assert verdicts == [ref_j.diagrams_equal(a, b, m) for a, b, m in cases]
    assert verdicts == [True, False, True, False, True, False, True]


# --------------------------------------------- the port's Diagrams, oracle

@pytest.mark.parametrize("method", ["none", "coral", "prunit", "both"])
@pytest.mark.parametrize("sublevel", [True, False])
def test_signature_matches_oracle(method, sublevel):
    """The port's diagrams equal the oracle's in the dimensions its method
    guarantees: every dimension without CoralTDA, PD_1 with it."""
    graphs = random_graphs(20 + sublevel, 12)
    g = batch(graphs)
    d = topological_signature(g, dim=1, method=method, sublevel=sublevel,
                              edge_cap=96, tri_cap=384)
    dims = [1] if method in ("coral", "both") else [0, 1]
    for i in range(len(graphs)):
        want = oracle(g, i, 1, sublevel)
        got = diagrams_to_numpy(d, i, 1)
        assert ref.diagrams_equal({k: want.get(k, []) for k in dims},
                                  {k: got[k] for k in dims}), (i, want, got)


# ------------------------------------------------------------ the theorems

@pytest.mark.parametrize("k", [1, 2])
def test_coral_keeps_pd_k(k):
    """Thm 2: the (k+1)-core has the graph's PD_k."""
    graphs = random_graphs(30 + k, 24)
    g = batch(graphs)
    gr = coral_reduce(g, k)
    assert int((gr.mask.sum(1) < g.mask.sum(1)).sum()) > 0  # it reduces
    for i in range(len(graphs)):
        want, got = oracle(g, i, k), oracle(gr, i, k)
        assert ref.diagrams_equal({k: want.get(k, [])},
                                  {k: got.get(k, [])}), (i, want, got)


@pytest.mark.parametrize("sublevel", [True, False])
def test_prunit_keeps_every_diagram(sublevel):
    """Thm 7: removing dominated vertices keeps PD_0 and PD_1."""
    graphs = random_graphs(40 + sublevel, 24)
    g = batch(graphs)
    gp = prunit(g, sublevel=sublevel)
    assert int((gp.mask.sum(1) < g.mask.sum(1)).sum()) > 0
    for i in range(len(graphs)):
        assert ref.diagrams_equal(oracle(g, i, 1, sublevel),
                                  oracle(gp, i, 1, sublevel)), i


@pytest.mark.parametrize("k", [1, 2])
def test_prunit_then_coral_keeps_pd_k(k):
    graphs = random_graphs(50 + k, 16, n_min=5, n_max=12)
    g = batch(graphs)
    gc = prunit_then_coral(g, k)
    for i in range(len(graphs)):
        want, got = oracle(g, i, k), oracle(gc, i, k)
        assert ref.diagrams_equal({k: want.get(k, [])},
                                  {k: got.get(k, [])}), i


def test_prunit_keeps_power_filtration():
    """Thm 10: on a connected graph, PrunIT (superlevel degree, which meets
    Remark 8's condition) keeps the power filtration's PD_1."""
    graphs = random_graphs(60, 10, n_min=5, n_max=10, connected=True)
    g = batch(graphs)
    g = graph_batch_from_numpy(
        g.adj.numpy(), g.mask.numpy(),
        np.where(g.mask.numpy(), g.adj.numpy().sum(2), np.inf), device="cpu")
    gp = prunit(g, sublevel=False)
    for i in range(len(graphs)):
        want = ref.power_filtration_diagrams(g.adj[i].numpy(),
                                             g.mask[i].numpy())
        got = ref.power_filtration_diagrams(gp.adj[i].numpy(),
                                            gp.mask[i].numpy())
        assert ref.diagrams_equal({1: want.get(1, [])},
                                  {1: got.get(1, [])}), i
