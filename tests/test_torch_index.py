"""The port's TopoIndex and the Fig 2 path against ``repro``.

Graphs are made once with the port's numpy generators and handed to both
packages; ``repro``'s Diagrams of them are handed to the port through
``diagrams_from_numpy``, so both indexes see the same diagrams.  Everything
runs on the CPU (``repro``'s Pallas Gram in interpret mode).

Tolerances:

* bit-exact: stored clouds, ``clouds()``, ids returned by ``query``, LSH
  codes and coarse candidates computed from the same embeddings, and
  everything a save/load round trip carries.  Ids are compared bitwise on
  corpora without near ties; where each package embeds its own queries
  against another's stored embeddings (the cross-package loads), two
  neighbours whose distances lie within the L1 tolerance may swap ranks.
* rtol 1e-5, atol 1e-6: embeddings and returned distances (XLA's float32
  ``exp``/``cos``/``sin`` and sum order differ from the port's by an ulp;
  see tests/test_torch_features.py).
* Gram matrices: |Δ| <= 1e-5 * Σ_d(|x_d| + |y_d|) + 1e-6, the pairwise-L1
  tolerance (sums of D terms in another order, over embeddings that agree
  to an ulp).
"""
import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.fig2_clustering import (
    cluster_purity,
    kernel_kmeans,
    kernel_ncc_accuracy,
)
from repro.core import api as api_j
from repro.core.graph import GraphBatch as GraphBatchJ
from repro.index import TopoIndex as TopoIndexJ
from repro.index import TopoIndexConfig as TopoIndexConfigJ
from repro_torch.convert import diagrams_from_numpy
from repro_torch.core.persistence import Diagrams
from repro_torch.data import graphs
from repro_torch.index import TopoIndex, TopoIndexConfig, clouds_to_diagrams


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
FIELDS = ("birth", "death", "dim", "valid")


def family_graphs(per_family, seed=5):
    """fig2's three families (rewired rings, dense ER, BA trees), numpy-made
    on the CPU, with degree filtration; and their labels."""
    gens = (lambda s: graphs.watts_strogatz(s, per_family, 24, 20, 4, 0.1,
                                            device="cpu"),
            lambda s: graphs.erdos_renyi(s, per_family, 24, 20, 0.45,
                                         device="cpu"),
            lambda s: graphs.barabasi_albert(s, per_family, 24, 20, 1,
                                             device="cpu"))
    gs = [graphs.with_degree_filtration(gen(seed + i))
          for i, gen in enumerate(gens)]
    adj, mask, f = (torch.cat([getattr(g, k) for g in gs]).numpy()
                    for k in ("adj", "mask", "f"))
    return (adj, mask, f), np.repeat(np.arange(3), per_family)


def repro_diagrams(arrays, **caps):
    gj = GraphBatchJ(*(jnp.asarray(a) for a in arrays))
    return api_j.topological_signature(gj, dim=1, method="both", **caps)


def to_port(dj) -> Diagrams:
    return diagrams_from_numpy(*(np.asarray(getattr(dj, k)) for k in FIELDS),
                               device="cpu")


@pytest.fixture(scope="module")
def corpus():
    """48 diagrams (16 per family) and 8 query diagrams, both packages."""
    arrays, _ = family_graphs(16)
    qarrays, _ = family_graphs(3, seed=40)
    caps = dict(edge_cap=160, tri_cap=384)
    dj, dqj = repro_diagrams(arrays, **caps), repro_diagrams(qarrays, **caps)
    dqj = type(dqj)(*(getattr(dqj, k)[:8] for k in FIELDS))
    return to_port(dj), dj, to_port(dqj), dqj


def l1_tol(x, y):
    return (1e-5 * (np.abs(x).sum(1)[:, None] + np.abs(y).sum(1)[None, :])
            + 1e-6)


def pair_of_indexes(cfg):
    return (TopoIndex(TopoIndexConfig(**cfg), device="cpu"),
            TopoIndexJ(TopoIndexConfigJ(**cfg)))


CONFIGS = {
    "sw": dict(embedding="sw", n_points=8, n_dirs=8),
    "features": dict(embedding="features", res=4),
    "both": dict(embedding="both", k=1, n_points=12, n_dirs=12, res=6),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_embed_add_clouds_and_gram_match(corpus, name):
    d, dj, _, _ = corpus
    index, index_j = pair_of_indexes(CONFIGS[name])
    assert index.add(d) == index_j.add(dj)
    assert index.config.width == index_j.config.width == index._emb.shape[1]
    np.testing.assert_allclose(index._emb, index_j._emb, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(index._clouds, index_j._clouds)
    rows = np.array([[0, 5], [47, 3]])
    got, want = index.clouds(rows), index_j.clouds(rows)
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)))
    gram, gram_j = index.gram().numpy(), np.asarray(index_j.gram())
    assert (np.abs(gram - gram_j) <= l1_tol(index._emb, index._emb)).all()
    np.testing.assert_array_equal(np.diagonal(gram), 0.0)


def test_pairwise_l1_on_the_same_embeddings(corpus):
    """The port's Gram over repro's own embeddings: only the sum order
    differs."""
    from repro.kernels import ops as ops_j
    from repro_torch.kernels import ops

    d, dj, _, _ = corpus
    _, index_j = pair_of_indexes(CONFIGS["both"])
    index_j.add(dj)
    e = index_j._emb
    got = ops.pairwise_l1(torch.from_numpy(e), torch.from_numpy(e[:7].copy()))
    want = np.asarray(ops_j.pairwise_l1(jnp.asarray(e), jnp.asarray(e[:7])))
    assert (np.abs(got.numpy() - want) <= l1_tol(e, e[:7])).all()


@pytest.mark.parametrize("coarse,probes", [("none", 1), ("lsh", 1),
                                           ("lsh", 4)])
def test_query_matches_repro(corpus, coarse, probes):
    d, dj, dq, dqj = corpus
    cfg = dict(CONFIGS["both"], coarse=coarse, lsh_overfetch=2, probes=probes)
    index, index_j = pair_of_indexes(cfg)
    index.add(d)
    index_j.add(dj)
    got, want = index.query(dq, k=4), index_j.query(dqj, k=4)
    assert got.ids == want.ids
    np.testing.assert_array_equal(np.asarray(got.rows), np.asarray(want.rows))
    np.testing.assert_allclose(got.distances, want.distances, rtol=1e-5,
                               atol=1e-6)
    assert got.stats == want.stats and got.backends == want.backends
    assert list(got) == [got.ids, got.distances] and len(got) == 2


def test_query_ties_break_to_the_lower_row():
    """Copies of one diagram are exactly tied in both packages; the tied
    rows come back lowest first (lax.top_k's order).  The distinct diagrams
    here lie far apart: where two distinct neighbours are equally far in
    exact arithmetic, the packages may round them apart in opposite
    directions (embeddings agree to an ulp), so near ties are kept out of
    a bit-exact comparison of ids."""
    s = 6
    birth = np.full((12, s), np.nan, np.float32)
    death = np.full((12, s), np.nan, np.float32)
    dim = np.full((12, s), -1, np.int32)
    valid = np.zeros((12, s), bool)
    for row in range(12):  # diagram row % 4, three copies of each
        for j in range(row % 4 + 1):
            birth[row, j], death[row, j] = j, 3 * j + 2 + 5 * (row % 4)
            dim[row, j], valid[row, j] = 1, True
    arrays = (birth, death, dim, valid)
    index, index_j = pair_of_indexes(CONFIGS["sw"])
    index.add(diagrams_from_numpy(*arrays, device="cpu"))
    index_j.add(_repro_diagrams(arrays))
    queries = [a[:4] for a in arrays]
    got = index.query(diagrams_from_numpy(*queries, device="cpu"), k=12)
    want = index_j.query(_repro_diagrams(queries), k=12)
    assert got.ids == want.ids
    np.testing.assert_allclose(got.distances, want.distances, rtol=1e-5,
                               atol=1e-6)
    rows = np.asarray(got.rows)
    for q in range(4):
        groups = rows[q].reshape(4, 3)  # three exact ties per distance
        np.testing.assert_array_equal(groups, np.sort(groups, axis=1))
        assert sorted(groups[:, 0] % 4) == [0, 1, 2, 3]
        assert groups[0, 0] == q
    assert (got.distances[:, :3] == 0).all()


def _repro_diagrams(arrays):
    from repro.core.persistence_jax import Diagrams as DiagramsJ

    return DiagramsJ(*(jnp.asarray(a) for a in arrays))


def test_lsh_code_path_bitwise_on_the_same_embeddings(corpus):
    """Codes, multi-probe masks and coarse candidates from the same numpy
    embeddings are bit-identical in both packages."""
    _, dj, _, _ = corpus
    cfg = dict(CONFIGS["both"], coarse="lsh", probes=8)
    index, index_j = pair_of_indexes(cfg)
    index_j.add(dj)
    emb = index_j._emb
    index._codes = index_j._codes
    np.testing.assert_array_equal(index._lsh_codes(emb), index_j._codes)
    margins = index._lsh_margins(emb)
    np.testing.assert_array_equal(margins, index_j._lsh_margins(emb))
    np.testing.assert_array_equal(index._query_bit_masks(margins),
                                  index_j._query_bit_masks(margins))
    for m, chunk in ((5, 1 << 16), (12, 7)):
        np.testing.assert_array_equal(
            index._coarse_candidates(emb[:9], m, chunk=chunk),
            index_j._coarse_candidates(emb[:9], m, chunk=chunk))


def assert_same_answers_but_near_ties(index, dq, got, want):
    """``got`` and ``want`` name the same rows, except at ranks where the
    two rows' distances from the query, under ``index``, lie within the L1
    tolerance of each other (a near tie, which embeddings that agree only
    to an ulp may order either way)."""
    from repro_torch.kernels import ops

    eq = index.embed(dq)
    dist = ops.pairwise_l1(eq, index._emb_device).numpy()
    tol = l1_tol(eq.numpy(), index._emb)
    a, b = np.asarray(got.rows), np.asarray(want.rows)
    qi, ri = np.nonzero(a != b)
    ra, rb = a[qi, ri], b[qi, ri]
    assert (np.abs(dist[qi, ra] - dist[qi, rb])
            <= np.maximum(tol[qi, ra], tol[qi, rb])).all()
    np.testing.assert_allclose(got.distances, want.distances, rtol=1e-5,
                               atol=1e-6)


def _assert_same_index(a, b):
    assert dataclasses.asdict(a.config) == dataclasses.asdict(b.config)
    assert a.ids == b.ids
    np.testing.assert_array_equal(a._emb, b._emb)
    np.testing.assert_array_equal(a._clouds, b._clouds)
    np.testing.assert_array_equal(a._codes, b._codes)


@pytest.mark.parametrize("name", ["index.npz", "index.topo"])
def test_save_in_the_port_load_in_repro(corpus, tmp_path, name):
    d, _, dq, dqj = corpus
    index = TopoIndex(TopoIndexConfig(**CONFIGS["both"], coarse="lsh",
                                      lsh_overfetch=2), device="cpu")
    index.add(d, ids=[f"graph-{i}" for i in range(len(d.birth))])
    path = str(tmp_path / name)
    index.save(path)
    loaded = TopoIndexJ.load(path)
    _assert_same_index(index, loaded)
    assert_same_answers_but_near_ties(index, dq, index.query(dq, k=3),
                                      loaded.query(dqj, k=3))


@pytest.mark.parametrize("coarse", ["none", "lsh"])
def test_save_in_repro_load_in_the_port(corpus, tmp_path, coarse):
    _, dj, dq, dqj = corpus
    index_j = TopoIndexJ(TopoIndexConfigJ(**CONFIGS["sw"], coarse=coarse,
                                          lsh_overfetch=2))
    index_j.add(dj)
    path = str(tmp_path / "index.npz")
    index_j.save(path)
    loaded = TopoIndex.load(path, device="cpu")
    _assert_same_index(loaded, index_j)
    assert torch.equal(loaded._emb_device, torch.from_numpy(index_j._emb))
    assert_same_answers_but_near_ties(loaded, dq, loaded.query(dq, k=3),
                                      index_j.query(dqj, k=3))
    # and re-saves what it loaded
    loaded.save(path)
    _assert_same_index(TopoIndexJ.load(path), index_j)


def test_index_validation_and_device_guard(corpus, monkeypatch):
    d, _, _, _ = corpus
    index = TopoIndex(TopoIndexConfig(**CONFIGS["sw"]), device="cpu")
    with pytest.raises(ValueError, match="empty"):
        index.query(d)
    index.add(d)
    with pytest.raises(ValueError, match="duplicate"):
        index.add(d, ids=index.ids)
    with pytest.raises(ValueError):
        TopoIndexConfig(coarse="ivf")
    with pytest.raises(ValueError):
        TopoIndexConfig(lsh_bits=12)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TopoIndex()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        clouds_to_diagrams(index._clouds[:2], 1)
    assert index.clouds(np.arange(2)).birth.device.type == "cpu"


def test_fig2_probe3_through_both_packages():
    """Probe 3 of benchmarks/fig2_clustering.py on the same numpy graphs (8
    per family): Diagrams bitwise, the Gram within the L1 tolerance, the
    same kernel k-means assignment and the same scores."""
    from repro_torch.convert import graph_batch_from_numpy
    from repro_torch.core import api

    arrays, labels = family_graphs(8)
    caps = dict(edge_cap=160, tri_cap=384)
    dj = repro_diagrams(arrays, **caps)
    d = api.topological_signature(
        graph_batch_from_numpy(*arrays, device="cpu"), dim=1,
        method="both", **caps)
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(d, k).numpy(),
                                      np.asarray(getattr(dj, k)))
    index, index_j = pair_of_indexes(CONFIGS["both"])
    index.add(d)
    index_j.add(dj)
    dist, dist_j = index.gram().numpy(), np.asarray(index_j.gram())
    assert (np.abs(dist - dist_j) <= l1_tol(index._emb, index._emb)).all()
    scores = []
    for g in (dist, dist_j):
        kmat = np.exp(-g / max(np.median(g[g > 0]), 1e-9))
        assign = kernel_kmeans(kmat, n_clusters=3, seed=3)
        train = (np.arange(len(labels)) % 3) != 2
        scores.append((assign, cluster_purity(assign, labels),
                       kernel_ncc_accuracy(kmat, labels, train)))
    np.testing.assert_array_equal(scores[0][0], scores[1][0])
    assert scores[0][1:] == scores[1][1:]
    assert scores[0][1] >= 0.66 and scores[0][2] >= 0.66


def test_fig2_modules_import_neither_jax_nor_repro():
    code = ("import sys, repro_torch.index, repro_torch.topo, "
            "repro_torch.metrics, repro_torch.data.graphs\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'networkx', 'benchmarks')]\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


# ---------------------------------------------------------------------------
# The coarse stage's device scan (TopoIndex on CUDA, ShardedIndex anywhere),
# run here through the plain hamming_scan: candidate rows bitwise the host
# scan's.

TIE_CFG = dict(embedding="sw", n_points=8, n_dirs=8, coarse="lsh",
               lsh_bits=128)


@pytest.fixture(scope="module")
def tie_corpus():
    """64 seed diagrams x 16 noisy copies (codes tie in crowds) and 7
    queries (Q not a multiple of 4), both as port Diagrams on the CPU."""
    from repro_torch.metrics.testing import noisy_copies, seed_diagram_arrays

    rng = np.random.default_rng(64)
    seeds = seed_diagram_arrays(rng, 64, 16)
    return (noisy_copies(seeds, rng, 64 * 16, 0.01, 0.05, device="cpu"),
            noisy_copies(seeds, rng, 7, 0.01, 0.05, device="cpu"))


def _scans(index, emb_q, m, probes, chunk=None, pieces=None):
    """(host scan, device scan) of the same query codes, the device scan
    over ``pieces`` (row bounds) of the device codes, the last padded."""
    from repro_torch.index.topo_index import device_scan, host_scan

    codes_q, mask_q = index._query_codes(emb_q, probes)
    n = len(index)
    words = index._device_codes()
    blocks = [(0, words)]
    if pieces is not None:
        cuts = [0, *pieces, n]
        blocks = [(a, words[a:b]) for a, b in zip(cuts, cuts[1:])]
        pad = torch.zeros((5, words.shape[1]), dtype=torch.int32)
        blocks[-1] = (cuts[-2], torch.cat([blocks[-1][1], pad]))
    return (host_scan(codes_q, index._codes, mask_q, m),
            device_scan(codes_q, mask_q, blocks, n, m, "cpu", chunk=chunk))


@pytest.mark.parametrize("probes", [1, 3])
@pytest.mark.parametrize("chunk,pieces", [(None, None), (300, None),
                                          (512, (400,)), (None, (97, 600))])
def test_device_scan_equals_the_host_scan(tie_corpus, probes, chunk,
                                          pieces):
    d, dq = tie_corpus
    index = TopoIndex(TopoIndexConfig(**TIE_CFG), device="cpu")
    index.add(d)
    emb_q = index.embed(dq).numpy()
    for m in (1, 40, 97):
        host, dev = _scans(index, emb_q, m, probes, chunk, pieces)
        assert host.dtype == dev.dtype == np.int64
        np.testing.assert_array_equal(dev, host)
    # tie-heavy: the kept rows share their distances in crowds
    codes_q, mask_q = index._query_codes(emb_q, probes)
    x = codes_q[:, None, :] ^ index._codes[host]
    if mask_q is not None:
        x &= mask_q[:, None, :]
    dist = np.unpackbits(x, axis=-1).sum(-1)
    assert sum(len(np.unique(row)) for row in dist) < dist.size // 4


def test_device_codes_follow_add_and_a_repro_save(tie_corpus, tmp_path):
    """The device copy of the codes stays the host codes' words after an
    add that follows a query and after loading a save of ``repro``'s; the
    scans agree on it, and with ``repro``'s own coarse stage."""
    from repro_torch.kernels.hamming import as_int32_words, pack_codes_u32

    d, dq = tie_corpus
    fields = [getattr(d, k).numpy() for k in FIELDS]
    half = len(fields[0]) // 2
    first = diagrams_from_numpy(*(a[:half] for a in fields), device="cpu")
    rest = diagrams_from_numpy(*(a[half:] for a in fields), device="cpu")
    index = TopoIndex(TopoIndexConfig(**TIE_CFG), device="cpu")
    index.add(first)
    emb_q = index.embed(dq).numpy()
    np.testing.assert_array_equal(*_scans(index, emb_q, 30, 1))
    index.query(dq, k=3)
    index.add(rest)

    def words_of(ix):
        return as_int32_words(pack_codes_u32(ix._codes))

    assert torch.equal(index._device_codes(), words_of(index))
    np.testing.assert_array_equal(*_scans(index, emb_q, 30, 3, chunk=256))

    index_j = TopoIndexJ(TopoIndexConfigJ(**TIE_CFG))
    index_j.add(_repro_diagrams(fields))
    path = str(tmp_path / "index.npz")
    index_j.save(path)
    loaded = TopoIndex.load(path, device="cpu")
    assert torch.equal(loaded._device_codes(), words_of(loaded))
    for probes in (1, 3):
        host, dev = _scans(loaded, emb_q, 40, probes, chunk=512)
        np.testing.assert_array_equal(dev, host)
        np.testing.assert_array_equal(
            host, index_j._coarse_candidates(emb_q, 40, probes=probes))
