"""The port's main path against ``repro``'s: bit-identical Diagrams.

``topological_signature`` of the port (CPU, plain kernel versions) and of
``repro`` (``reducer="jnp"``) on the same graphs from the conftest er/ba/plc
generators, for every method, both orientations and both repack modes;
plus ``reduction_stats``, the repack report, the flat reducer, dimension 2
and ``chip_smoke.py``'s refusal to run without a card or a checkout.
"""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import api as api_j
from repro.core.persistence_jax import diagrams_bitwise_equal
from repro_torch import counters
from repro_torch.convert import diagrams_arrays, graph_batch_from_numpy
from repro_torch.core import api
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


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def batches():
    gs = (random_graphs("er", 2, seed=1) + random_graphs("ba", 2, seed=2)
          + random_graphs("plc", 2, seed=3))
    gj = graphs_to_batch(gs, n_pad=24)
    gt = graph_batch_from_numpy(np.asarray(gj.adj), np.asarray(gj.mask),
                                np.asarray(gj.f), device="cpu")
    return gj, gt


@pytest.mark.parametrize("repack", ["off", "on"])
@pytest.mark.parametrize("sublevel", [True, False])
@pytest.mark.parametrize("method", ["none", "coral", "prunit", "both"])
def test_signature_bitwise_equal_to_repro(batches, method, sublevel, repack):
    gj, gt = batches
    kw = dict(dim=1, method=method, sublevel=sublevel, repack=repack)
    plan_t = api.make_topo_plan(**kw)
    d_t, rep_t = plan_t.execute_info(gt)
    d_j, rep_j = api_j.make_topo_plan(reducer="jnp", **kw).execute_info(gj)
    assert diagrams_bitwise_equal(d_t, d_j)
    for k in (0, 1):
        np.testing.assert_array_equal(d_t.betti(k).numpy(),
                                      np.asarray(d_j.betti(k)))
        np.testing.assert_array_equal(d_t.count(k).numpy(),
                                      np.asarray(d_j.count(k)))
    np.testing.assert_array_equal(d_t.finite_death(9.0).numpy(),
                                  np.asarray(d_j.finite_death(9.0)))
    if repack == "on":
        np.testing.assert_array_equal(rep_t.class_index, rep_j.class_index)
        for name in ("n_vertices", "n_edges", "n_triangles"):
            np.testing.assert_array_equal(getattr(rep_t, name),
                                          getattr(rep_j, name))
        assert rep_t.rung_histogram() == rep_j.rung_histogram()
    else:
        assert rep_t is None and rep_j is None


@pytest.mark.parametrize("sublevel", [True, False])
@pytest.mark.parametrize("method", ["none", "coral", "prunit", "both"])
def test_reduction_stats_equal(batches, method, sublevel):
    gj, gt = batches
    for dim in (0, 1):
        st_t = api.reduction_stats(gt, dim, method, sublevel)
        st_j = api_j.reduction_stats(gj, dim, method, sublevel)
        for name in ("v_before", "v_after", "e_before", "e_after"):
            np.testing.assert_array_equal(getattr(st_t, name).numpy(),
                                          np.asarray(getattr(st_j, name)))
        np.testing.assert_array_equal(st_t.v_reduction_pct().numpy(),
                                      np.asarray(st_j.v_reduction_pct()))


def test_flat_reducer_and_dim2_equal_to_repro(batches):
    gj, gt = batches
    d_t = api.topological_signature(gt, dim=1, method="prunit",
                                    reducer="flat", edge_cap=96, tri_cap=128)
    d_j = api_j.topological_signature(gj, dim=1, method="prunit",
                                      reducer="jnp-flat", edge_cap=96,
                                      tri_cap=128)
    assert diagrams_bitwise_equal(d_t, d_j)
    d_t = api.topological_signature(gt, dim=2, method="prunit", edge_cap=96,
                                    tri_cap=128, quad_cap=64)
    d_j = api_j.topological_signature(gj, dim=2, method="prunit",
                                      reducer="jnp", edge_cap=96,
                                      tri_cap=128, quad_cap=64)
    assert diagrams_bitwise_equal(d_t, d_j)
    arrays = diagrams_arrays(d_t)
    assert arrays["birth"].shape == np.asarray(d_j.birth).shape


def test_plan_cache_and_cpu_path_counts(batches):
    _, gt = batches
    api.clear_plan_cache()
    p1 = api.make_topo_plan(dim=1, method="both", repack="on")
    assert api.make_topo_plan(dim=1, method="both", repack="on") is p1
    counters.reset()
    p1.execute(gt)
    info = api.plan_cache_info()
    assert info["hits"] == 1 and info["currsize"] >= 2  # plus persist rungs
    snap = counters.snapshot()
    # the CPU path launches no kernel; the host-driven loops are counted
    assert snap["kcore_peel"] == snap["domination"] == snap["gf2_reduce"] == 0
    assert snap["prune_rounds"] > 0 and snap["fixpoint_sweeps"] > 0
    with pytest.raises(ValueError):
        api.make_topo_plan(repack="sometimes")
    with pytest.raises(ValueError):
        api.make_topo_plan(reducer="jnp")


def _run_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_outside_a_checkout(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    out = _run_smoke(tmp_path)
    assert out.returncode != 0 and out.stdout == ""


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run in full")
    out = _run_smoke(ROOT)
    assert out.returncode != 0 and out.stdout == ""
