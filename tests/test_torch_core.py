"""The port's core modules against ``repro``'s, on the same numpy inputs.

Every comparison is exact: masks, integer counts, simplex tables and packed
words must be identical.  The port runs on the CPU here (its plain kernel
versions); ``repro`` runs as its own tests run it.
"""
import importlib
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.filtration as filtration_j
import repro.core.graph as graph_j
import repro.core.persistence_jax as persistence_j
import repro.core.reduction as reduction_j
import repro.core.repack as repack_j
from repro_torch.convert import graph_batch_from_numpy, graph_batch_to_numpy
from repro_torch.core import filtration, graph, persistence, reduction, repack
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


# the packages' __init__ re-export functions named like these modules
kcore = importlib.import_module("repro_torch.core.kcore")
prunit = importlib.import_module("repro_torch.core.prunit")
kcore_j = importlib.import_module("repro.core.kcore")
prunit_j = importlib.import_module("repro.core.prunit")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pair(kind="er", count=4, seed=3, n_pad=24, f_mode="degree"):
    """The same graphs as a repro GraphBatch and a port GraphBatch (CPU)."""
    gj = graphs_to_batch(random_graphs(kind, count, seed=seed), n_pad=n_pad,
                         f_mode=f_mode, seed=seed)
    gt = graph_batch_from_numpy(np.asarray(gj.adj), np.asarray(gj.mask),
                                np.asarray(gj.f), device="cpu")
    return gj, gt


def _eq(a_torch, b_jax):
    np.testing.assert_array_equal(a_torch.numpy(), np.asarray(b_jax))


def test_graph_batch_helpers_match():
    gs = random_graphs("plc", 3, seed=4)
    gj = graph_j.from_networkx(gs, n_pad=24)
    gt = graph.from_networkx(gs, n_pad=24, device="cpu")
    for a, b in zip(graph_batch_to_numpy(gt), (gj.adj, gj.mask, gj.f)):
        np.testing.assert_array_equal(a, np.asarray(b))
    _eq(gt.degrees(), gj.degrees())
    _eq(gt.n_vertices(), gj.n_vertices())
    _eq(gt.n_edges(), gj.n_edges())
    m = np.asarray(gj.mask) & (np.arange(24) % 3 != 0)
    gm_t, gm_j = gt.with_mask(torch.from_numpy(m)), gj.with_mask(jnp.asarray(m))
    _eq(gm_t.adj, gm_j.adj)
    _eq(gm_t.f, gm_j.f)
    _eq(graph.degree_filtration(gm_t).f, graph_j.degree_filtration(gm_j).f)


def test_creating_entry_points_need_a_device_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from repro_torch.data.graphs import erdos_renyi

    with pytest.raises(RuntimeError, match="device='cpu'"):
        graph.from_edge_lists([[(0, 1)]], [2])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        erdos_renyi(0, 2, 8, 8, 0.3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        graph_batch_from_numpy(np.zeros((1, 2, 2), bool), np.ones((1, 2), bool),
                               np.zeros((1, 2), np.float32))
    assert graph.from_edge_lists([[(0, 1)]], [2], device="cpu").n == 2


def test_port_imports_neither_jax_nor_repro():
    code = ("import sys, repro_torch, repro_torch.convert, "
            "repro_torch.data.graphs, repro_torch.kernels.ops\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'networkx')]\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("kind", ["er", "ba"])
def test_kcore_mask_coreness_match(kind):
    gj, gt = _pair(kind, 4, seed=8)
    for k in (1, 2, 3):
        _eq(kcore.kcore_mask(gt.adj, gt.mask, k),
            kcore_j.kcore_mask(gj.adj, gj.mask, k))
    _eq(kcore.coreness(gt.adj, gt.mask), kcore_j.coreness(gj.adj, gj.mask))
    _eq(kcore.degeneracy(gt.adj, gt.mask), kcore_j.degeneracy(gj.adj, gj.mask))


@pytest.mark.parametrize("kind,f_mode", [("er", "degree"), ("ba", "degree"),
                                         ("plc", "random")])
@pytest.mark.parametrize("sublevel", [True, False])
def test_prunit_masks_match(kind, f_mode, sublevel):
    gj, gt = _pair(kind, 4, seed=9, f_mode=f_mode)
    _eq(prunit.prune_round_mask(gt.adj, gt.mask, gt.f, sublevel),
        prunit_j.prune_round_mask(gj.adj, gj.mask, gj.f, sublevel))
    for equal_only in (False, True):
        _eq(prunit.prunit_mask(gt.adj, gt.mask, gt.f, sublevel,
                               equal_only=equal_only),
            prunit_j.prunit_mask(gj.adj, gj.mask, gj.f, sublevel,
                                 equal_only=equal_only))
    _eq(prunit.prunit_mask(gt.adj, gt.mask, gt.f, sublevel, max_rounds=1),
        prunit_j.prunit_mask(gj.adj, gj.mask, gj.f, sublevel, max_rounds=1))


def test_graph_level_reductions_match():
    gj, gt = _pair("ba", 4, seed=10)
    for dim in (0, 1, 2):
        _eq(prunit.prunit_then_coral(gt, dim).mask,
            prunit_j.prunit_then_coral(gj, dim).mask)
        _eq(kcore.coral_reduce(gt, dim).mask, kcore_j.coral_reduce(gj, dim).mask)
    _eq(prunit.prunit(gt, sublevel=False).adj,
        prunit_j.prunit(gj, sublevel=False).adj)
    _eq(kcore.kcore(gt, 2).f, kcore_j.kcore(gj, 2).f)


@pytest.mark.parametrize("passes", [("prunit", "kcore"), ("kcore",),
                                    ("strong_collapse", "kcore")])
@pytest.mark.parametrize("dim", [0, 1])
def test_reduce_fixpoint_and_sweep_match(passes, dim):
    gj, gt = _pair("plc", 5, seed=12)
    for sub in (True, False):
        _eq(reduction.reduce_fixpoint(gt, passes, dim, sub).mask,
            reduction_j.reduce_fixpoint(gj, passes, dim, sub).mask)
        _eq(reduction.apply_passes(gt, passes, dim, sub).mask,
            reduction_j.apply_passes(gj, passes, dim, sub).mask)
    assert (reduction.engine_exact_from_dim(passes, dim)
            == reduction_j.engine_exact_from_dim(passes, dim))


def test_registry_matches():
    assert reduction.METHOD_PASSES == reduction_j.METHOD_PASSES
    assert sorted(reduction.PASS_REGISTRY) == sorted(reduction_j.PASS_REGISTRY)
    assert repr(reduction.ReductionEngine()) == repr(reduction_j.ReductionEngine())


def _fc_j(gj, max_dim, edge_cap, tri_cap, quad_cap, sublevel):
    build = jax.jit(jax.vmap(lambda a, m, f: filtration_j.build_filtered_complex(
        a, m, f, max_dim, edge_cap, tri_cap, quad_cap, sublevel)))
    return build(gj.adj, gj.mask, gj.f)


@pytest.mark.parametrize("max_dim,caps", [
    (0, (64, 0, 0)), (1, (64, 128, 0)), (1, (20, 12, 0)), (2, (64, 96, 40))])
@pytest.mark.parametrize("sublevel", [True, False])
def test_build_filtered_complex_matches(max_dim, caps, sublevel):
    """Values, dims, validity and face positions, including the truncation
    of simplices past a cap (the (20, 12) caps overflow)."""
    gj, gt = _pair("plc", 4, seed=5, n_pad=20, f_mode="random")
    fc_t = filtration.build_filtered_complex(gt.adj, gt.mask, gt.f, max_dim,
                                             *caps, sublevel=sublevel)
    fc_j = _fc_j(gj, max_dim, *caps, sublevel)
    for name in ("values", "dims", "valid", "face_pos"):
        _eq(getattr(fc_t, name), getattr(fc_j, name))
    ok_t = filtration.complex_caps_ok(gt.adj, gt.mask, *caps, max_dim=max_dim)
    ok_j = jax.jit(jax.vmap(lambda a, m: filtration_j.complex_caps_ok(
        a, m, *caps, max_dim=max_dim)))(gj.adj, gj.mask)
    _eq(ok_t, ok_j)


@pytest.mark.parametrize("sublevel", [True, False])
def test_pack_boundary_matches(sublevel):
    gj, gt = _pair("er", 3, seed=6, n_pad=20)
    caps = (80, 160, 0)
    fc_t = filtration.build_filtered_complex(gt.adj, gt.mask, gt.f, 1, *caps,
                                             sublevel=sublevel)
    fc_j = _fc_j(gj, 1, *caps, sublevel)
    bcaps = persistence._block_caps(20, *caps)
    blocks_t, ranks_t, por_t = persistence.pack_boundary_blocks(fc_t, bcaps)
    blocks_j, ranks_j, por_j = jax.jit(jax.vmap(
        lambda fc: persistence_j.pack_boundary_blocks(fc, bcaps)))(fc_j)
    for bt, bj in zip(blocks_t, blocks_j):
        np.testing.assert_array_equal(bt.numpy().view(np.uint32),
                                      np.asarray(bj))
    _eq(ranks_t, ranks_j)
    for pt, pj in zip(por_t, por_j):
        _eq(pt, pj)
    np.testing.assert_array_equal(
        persistence.pack_boundary(fc_t).numpy().view(np.uint32),
        np.asarray(jax.jit(jax.vmap(persistence_j.pack_boundary))(fc_j)))
    own_t, pos_t = persistence.reduce_packed_blocks(fc_t, bcaps)
    own_j, pos_j = jax.jit(jax.vmap(
        lambda fc: persistence_j.reduce_packed_blocks(fc, bcaps)))(fc_j)
    _eq(own_t, own_j)
    _eq(pos_t, pos_j)


def test_compact_and_measure_match():
    gj, gt = _pair("ba", 4, seed=14)
    m = np.asarray(gj.mask) & (np.arange(24) % 4 != 1)
    gj = gj.with_mask(jnp.asarray(m))
    gt = gt.with_mask(torch.from_numpy(m))
    (ct, ot), (cj, oj) = repack.compact_batch(gt), repack_j.compact_batch(gj)
    for name in ("adj", "mask", "f"):
        _eq(getattr(ct, name), getattr(cj, name))
    _eq(ot, oj)
    for a, b in zip(repack.measure_counts(ct), repack_j.measure_counts(cj)):
        _eq(a, b)


def test_ladder_and_selection_match():
    for n, caps in ((64, (320, 512, 0)), (24, (256, 512, 8)), (320, (1024, 256, 0))):
        assert repack.default_ladder(n, *caps) == tuple(
            repack.ShapeClass(*dataclass_fields(c))
            for c in repack_j.default_ladder(n, *caps))
    lad = repack.default_ladder(64, 320, 512)
    nv, ne, nt = [np.array([3, 9, 40, 64]), np.array([2, 20, 100, 320]),
                  np.array([0, 5, 30, 512])]
    np.testing.assert_array_equal(
        repack.select_classes(lad, nv, ne, nt),
        repack_j.select_classes(repack_j.default_ladder(64, 320, 512),
                                nv, ne, nt))
    assert repack.diagram_size(64, 1, 320, 512) == repack_j.diagram_size(
        64, 1, 320, 512)


def dataclass_fields(c):
    return (c.n_pad, c.edge_cap, c.tri_cap, c.quad_cap)


@pytest.mark.parametrize("name", ["CITESEER", "CORA", "DD", "DHFR", "ENZYMES",
                                  "FACEBOOK", "FIRSTMM", "NCI1", "OHSU",
                                  "PROTEINS", "REDDIT-BINARY", "SYNNEW",
                                  "TWITTER"])
def test_load_dataset_surrogates_are_canonical_and_seeded(name):
    from repro_torch.data import graphs as gd

    spec = gd.TABLE2[name]
    g = gd.load_dataset(name, 3, batch=3, device="cpu")
    assert g.adj.shape == (3, spec.n_pad, spec.n_pad)
    assert torch.equal(g.adj, g.adj.transpose(1, 2))
    assert not g.adj.diagonal(dim1=1, dim2=2).any()
    assert not (g.adj & ~(g.mask[:, None, :] & g.mask[:, :, None])).any()
    nv = g.n_vertices()
    assert bool(((nv >= 4) & (nv <= spec.n_pad)).all())
    assert torch.equal(g.f, torch.where(g.mask, g.degrees().float(),
                                        float("inf")))
    again = gd.load_dataset(name, 3, batch=3, device="cpu")
    assert torch.equal(again.adj, g.adj) and torch.equal(again.mask, g.mask)


@pytest.mark.parametrize("name", ["SYNNEW", "REDDIT-BINARY", "ENZYMES",
                                  "OHSU", "FIRSTMM", "TWITTER"])
def test_dataset_families_match_repro_statistics(name):
    """One dataset per family: the numpy generators draw other graphs than
    repro's, from the same models; over 64 graphs the mean order and the
    mean degree agree to 25% (about four standard errors of the order's
    lognormal draw)."""
    from repro.data import graphs as gd_j
    from repro_torch.data import graphs as gd

    g = gd.load_dataset(name, 0, batch=64, device="cpu")
    gj = gd_j.load_dataset(name, jax.random.PRNGKey(0), batch=64)
    nv, nv_j = float(g.n_vertices().sum()), float(np.asarray(gj.mask).sum())
    deg = float(g.degrees().sum()) / nv
    deg_j = float(np.asarray(gj.degrees()).sum()) / nv_j
    assert abs(nv - nv_j) <= 0.25 * nv_j and abs(deg - deg_j) <= 0.25 * deg_j


@pytest.mark.parametrize("name", ["com-youtube", "web-Stanford", "emailEuAll",
                                  "p2pGnutella31"])
def test_load_large_network_matches_repro_statistics(name):
    from repro.data import graphs as gd_j
    from repro_torch.data import graphs as gd

    g = gd.load_large_network(name, 1, n_pad=512, device="cpu")
    gj = gd_j.load_large_network(name, jax.random.PRNGKey(1), n_pad=512)
    assert g.adj.shape == (1, 512, 512) and int(g.n_vertices()) == 512
    assert not g.adj.diagonal(dim1=1, dim2=2).any()
    deg = float(g.degrees().float().mean())
    deg_j = float(np.asarray(gj.degrees()).mean())
    assert abs(deg - deg_j) <= 0.25 * deg_j
