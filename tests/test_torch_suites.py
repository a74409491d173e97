"""The main path's done criterion: the paper's reduction suites report the
same reductions through the port as through ``repro``.

Each suite's inputs are built by ``repro.data.graphs`` with the suite's own
key and size (fig4: ``load_dataset(·, PRNGKey(42), batch=32)`` at k 1–5;
fig5a: ``PRNGKey(7)``; table1: ``load_large_network(·, fold_in(PRNGKey(11),
1), n_pad=1024)``; fig6: ``fold_in(PRNGKey(13), 2)`` at cores 2–5;
``reduction_bench``'s coral_heavy batch), carried to the port through
numpy, and reduced by both packages' ``reduction_stats`` on the CPU.  The
vertex and edge counts before and after must be equal on every graph of
every cell (114 cells of fig4, fig5a, table1 and fig6, and coral_heavy).
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import api as api_j
from repro.data import graphs as gdata_j
from repro_torch.convert import graph_batch_from_numpy
from repro_torch.core import api

FIG4 = ("DHFR", "ENZYMES", "NCI1", "PROTEINS", "SYNNEW", "OHSU",
        "TWITTER", "FACEBOOK", "CORA", "CITESEER")
FIG5A = ("DHFR", "ENZYMES", "NCI1", "PROTEINS", "SYNNEW", "OHSU",
         "TWITTER", "FACEBOOK", "FIRSTMM")


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


def _assert_same_stats(gj, dim, method, sublevel):
    st_j = api_j.reduction_stats(gj, dim, method, sublevel)
    st_t = api.reduction_stats(_to_torch(gj), dim, method, sublevel)
    for name in ("v_before", "v_after", "e_before", "e_after"):
        np.testing.assert_array_equal(getattr(st_t, name).numpy(),
                                      np.asarray(getattr(st_j, name)),
                                      err_msg=name)
    return st_t


@pytest.mark.parametrize("name", FIG4)
def test_fig4_coral(name):
    gj = gdata_j.load_dataset(name, jax.random.PRNGKey(42), batch=32)
    for k in (1, 2, 3, 4, 5):
        _assert_same_stats(gj, k, "coral", True)


@pytest.mark.parametrize("name", FIG5A)
def test_fig5a_prunit(name):
    gj = gdata_j.load_dataset(name, jax.random.PRNGKey(7), batch=32)
    _assert_same_stats(gj, 0, "prunit", False)


@pytest.mark.parametrize("name", sorted(gdata_j.TABLE1))
def test_table1_prunit(name):
    key = jax.random.fold_in(jax.random.PRNGKey(11), 1)
    gj = gdata_j.load_large_network(name, key, n_pad=1024)
    st = _assert_same_stats(gj, 0, "prunit", False)
    assert int(st.v_after.sum()) < int(st.v_before.sum())


@pytest.mark.parametrize("name", sorted(gdata_j.TABLE1))
def test_fig6_combined(name):
    key = jax.random.fold_in(jax.random.PRNGKey(13), 2)
    gj = gdata_j.load_large_network(name, key, n_pad=1024)
    for core in (2, 3, 4, 5):
        _assert_same_stats(gj, core - 1, "both", False)


def test_reduction_bench_coral_heavy():
    """``reduction_bench``'s coral_heavy batch (64 graphs of n_pad 64): the
    one-sweep stats and the two-phase plan's reduce-phase counts, which the
    benchmark reports as its reduction percentages."""
    _, k_er, k_sat = jax.random.split(jax.random.PRNGKey(7), 3)
    core = gdata_j.erdos_renyi(k_er, batch=64, n_pad=64, n_vertices=56,
                               p=0.05)
    gj = gdata_j.attach_satellites(k_sat, core, frac=0.5)
    st = _assert_same_stats(gj, 1, "both", True)
    assert int(st.v_after.sum()) < int(st.v_before.sum()) // 4
    caps = dict(edge_cap=320, tri_cap=512)
    _, counts_j = api_j.make_topo_plan(
        dim=1, method="both", repack="on", **caps).reduce_executor(gj)
    _, counts_t = api.make_topo_plan(
        dim=1, method="both", repack="on", **caps).reduce_phase(_to_torch(gj))
    for got, want in zip(counts_t, counts_j):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
