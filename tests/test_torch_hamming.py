"""The port's Hamming scan and its one-process ShardedIndex against ``repro``.

Every input comes from a fixed numpy seed.  Everything runs on the CPU:
``repro``'s Pallas kernels in interpret mode, the port's wrappers on their
plain versions, and the port's meshes lay P shards over the one CPU device.

Tolerances:

* bit-exact: packed words, Hamming distances (integers), coarse candidate
  sets (ties included), ids and distances of LSH queries against the
  single-host index (the same candidates feed the same Gram call), gathered
  clouds, and everything a save/load round trip carries;
* the pairwise-L1 tolerance |Δ| <= 1e-5 * Σ_d(|x_d| + |y_d|) + 1e-6 for the
  SUMMA Gram, whose width slices sum in another order than one Gram call;
* against ``repro``'s ShardedIndex: ids equal except at near ties, and
  distances within rtol 1e-5, atol 1e-6 (each package embeds its own
  queries, and the embeddings agree to an ulp; tests/test_torch_index.py).
"""
import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.index import ShardedIndex as ShardedIndexJ
from repro.index import TopoIndex as TopoIndexJ
from repro.index import TopoIndexConfig as TopoIndexConfigJ
from repro.kernels import ref as kref_j
from repro.kernels.hamming import hamming_scan_pallas
from repro.kernels.hamming import pack_codes_u32 as pack_codes_u32_j
from repro.metrics import testing as testing_j
from repro_torch import counters
from repro_torch.convert import diagrams_from_numpy
from repro_torch.core.persistence import Diagrams, diagrams_bitwise_equal
from repro_torch.index import ShardedIndex, TopoIndex, TopoIndexConfig
from repro_torch.kernels import ops, ref
from repro_torch.kernels.hamming import as_int32_words, pack_codes_u32
from repro_torch.launch import make_index_mesh
from repro_torch.metrics.testing import (
    HAMMING_CASES, hamming_operands, noisy_copies, seed_diagram_arrays)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("birth", "death", "dim", "valid")
# tests/test_sharded_index.py's configurations
CFG_LSH = dict(embedding="sw", n_points=8, n_dirs=8, coarse="lsh",
               lsh_bits=64, lsh_overfetch=4)
CFG_DENSE = dict(embedding="sw", n_points=8, n_dirs=8, coarse="none")
SHARDS = (1, 2, 3, 4)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file: its ops are small, and threads in
    every parallel test worker oversubscribe the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case_id(case):
    return "q{}_n{}_b{}_{}".format(*case)


# ------------------------------------------------------------ the kernel

@pytest.mark.parametrize("nbytes", range(1, 18))
def test_pack_codes_u32_matches_repro(nbytes):
    codes = np.random.default_rng(nbytes).integers(0, 256, (5, nbytes),
                                                   dtype=np.uint8)
    got, want = pack_codes_u32(codes), pack_codes_u32_j(codes)
    assert got.dtype == want.dtype == np.uint32
    np.testing.assert_array_equal(got, want)
    words = as_int32_words(got)
    assert words.dtype == torch.int32
    np.testing.assert_array_equal(words.numpy().view(np.uint32), want)


@pytest.mark.parametrize("case", HAMMING_CASES, ids=_case_id)
def test_hamming_scan_plain_matches_repro(case):
    """The port's plain version against repro's oracle and its Pallas
    kernel in interpret mode, on the same words: bitwise."""
    cq8, cd8, mq8 = hamming_operands(np.random.default_rng(sum(case[:3])),
                                     *case)
    cq, cd, mq = (pack_codes_u32(a) for a in (cq8, cd8, mq8))
    got = ref.hamming_scan_ref(*(as_int32_words(a) for a in (cq, mq, cd)))
    assert got.dtype == torch.int32
    want = np.asarray(kref_j.hamming_scan_ref(
        jnp.asarray(cq), jnp.asarray(mq), jnp.asarray(cd)))
    pallas = np.asarray(hamming_scan_pallas(
        jnp.asarray(cq), jnp.asarray(mq), jnp.asarray(cd), interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), pallas)
    assert (cd.view(np.int32) < 0).any()  # words with bit 31 set
    k = min(case[0], case[1])
    assert not got.numpy()[np.arange(k), np.arange(k)].any()  # copies


@pytest.mark.parametrize("case", HAMMING_CASES, ids=_case_id)
def test_ops_hamming_scan_input_forms(case):
    """ops.hamming_scan on the CPU takes numpy uint8 bytes, uint32 words
    (numpy or torch) and int32 tensors, with mask_q=None meaning all ones;
    every form gives repro's distances and launches nothing."""
    cq8, cd8, mq8 = hamming_operands(np.random.default_rng(sum(case[:3])),
                                     *case)
    want = np.asarray(kref_j.hamming_scan_ref(
        *(jnp.asarray(pack_codes_u32_j(a)) for a in (cq8, mq8, cd8))))
    u32 = [pack_codes_u32(a) for a in (cq8, cd8, mq8)]
    forms = {"uint8": (cq8, cd8, mq8), "uint32": u32,
             "uint32 tensor": [torch.from_numpy(a) for a in u32],
             "int32": [as_int32_words(a) for a in u32]}
    counters.reset()
    for name, (q, c, m) in forms.items():
        got = ops.hamming_scan(q, c, m, device="cpu")
        assert got.dtype == torch.int32 and got.device.type == "cpu", name
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    if case[3] == "ones":
        got = ops.hamming_scan(forms["int32"][0], forms["int32"][1])
        np.testing.assert_array_equal(got.numpy(), want)
    assert counters.KERNEL_LAUNCHES["hamming_scan"] == 0


def test_repro_ops_on_bytes_match_the_port():
    """repro's own wrapper on uint8 bytes, through its host repack."""
    from repro.kernels import ops as kops_j

    cq8, cd8, mq8 = hamming_operands(np.random.default_rng(3), 5, 40, 16,
                                     "probe")
    want = np.asarray(kops_j.hamming_scan(cq8, cd8, mq8))
    got = ops.hamming_scan(cq8, cd8, mq8, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_hamming_scan_rejects_bad_operands(monkeypatch):
    q = torch.zeros((3, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="W"):
        ops.hamming_scan(q, torch.zeros((4, 3), dtype=torch.int32))
    with pytest.raises(ValueError, match="mask_q"):
        ops.hamming_scan(q, q, torch.zeros((2, 2), dtype=torch.int32))
    with pytest.raises(TypeError):
        ops.hamming_scan(q.float(), q)
    with pytest.raises(TypeError):
        ops.hamming_scan(np.zeros((3, 2), np.int64), q)
    with pytest.raises(TypeError):  # bytes come as numpy, words as tensors
        ops.hamming_scan(torch.zeros((3, 8), dtype=torch.uint8), q)
    assert ops.hamming_scan(q[:0], q).shape == (0, 3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ops.hamming_scan(np.zeros((3, 2), np.uint32),
                         np.zeros((3, 2), np.uint32))


# --------------------------------------------------------------- the mesh

@pytest.mark.parametrize("n,shape", [(1, (1, 1)), (2, (1, 2)), (3, (1, 3)),
                                     (4, (2, 2)), (6, (2, 3)), (8, (2, 4)),
                                     (9, (3, 3)), (12, (3, 4))])
def test_make_index_mesh_shape_rule(n, shape):
    """repro's rule: rows is the largest divisor of n that is <= sqrt(n)."""
    mesh = make_index_mesh(devices=["cpu"] * n)
    assert (mesh.shape["row"], mesh.shape["col"]) == shape
    assert mesh.size == n and mesh.axis_names == ("row", "col")
    assert mesh.flat == [torch.device("cpu")] * n


def test_make_index_mesh_options_and_guard(monkeypatch):
    mesh = make_index_mesh(n_devices=4, rows=1, devices=["cpu"] * 6)
    assert mesh.shape == {"row": 1, "col": 4}
    with pytest.raises(ValueError):
        make_index_mesh(rows=3, devices=["cpu"] * 4)
    with pytest.raises(ValueError):
        make_index_mesh(n_devices=5, devices=["cpu"] * 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="devices="):
        make_index_mesh()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ShardedIndex(TopoIndexConfig(**CFG_LSH))


# ---------------------------------------------------------- ShardedIndex

def _noisy(n=97, seed=11):
    rng = np.random.default_rng(seed)
    return noisy_copies(seed_diagram_arrays(rng, 6, 16), rng, n, 0.05, 0.6,
                        device="cpu")


def _ties(n=30):
    """Copies of five diagrams: every code is repeated, so the Hamming
    distances tie in groups of n / 5 rows."""
    s = 6
    birth = np.full((n, s), np.nan, np.float32)
    death = np.full((n, s), np.nan, np.float32)
    dim = np.full((n, s), -1, np.int32)
    valid = np.zeros((n, s), bool)
    for row in range(n):
        for j in range(row % 5 + 1):
            birth[row, j], death[row, j] = j, 3 * j + 2 + 5 * (row % 5)
            dim[row, j], valid[row, j] = 1, True
    return diagrams_from_numpy(birth, death, dim, valid, device="cpu")


CORPORA = {"noisy": _noisy, "ties": _ties}


def _rows(d, sl):
    return Diagrams(*(getattr(d, k)[sl] for k in FIELDS))


def _mesh(p):
    return make_index_mesh(devices=["cpu"] * p)


def _pair(corpus="noisy", **cfg):
    """(single-host index, its corpus) on the CPU."""
    d = CORPORA[corpus]()
    base = TopoIndex(TopoIndexConfig(**cfg), device="cpu")
    base.add(d)
    return base, d


def l1_tol(x, y):
    return (1e-5 * (np.abs(x).sum(1)[:, None] + np.abs(y).sum(1)[None, :])
            + 1e-6)


@pytest.mark.parametrize("probes", [1, 4])
@pytest.mark.parametrize("corpus", sorted(CORPORA))
@pytest.mark.parametrize("p", SHARDS)
def test_candidates_equal_the_host_scan(p, corpus, probes):
    """The shards' device scans and the host merge give the base's host
    scan bit for bit, ties included.  N (97 and 30) is not a multiple of 4,
    97 of no P > 1, and m = N - 1 exceeds the rows per shard for P > 1."""
    base, d = _pair(corpus, **CFG_LSH)
    sharded = ShardedIndex.from_index(base, mesh=_mesh(p))
    emb = base.embed(_rows(d, slice(0, 9))).numpy()
    n = len(base)
    for m in (5, min(20 * probes, n - 1), n - 1):
        got = sharded._coarse_candidates(emb, m, probes=probes)
        np.testing.assert_array_equal(
            got, base._coarse_candidates(emb, m, probes=probes))


@pytest.mark.parametrize("probes", [1, 4])
@pytest.mark.parametrize("p", SHARDS)
def test_lsh_query_equals_the_single_host_index(p, probes):
    base, d = _pair(**CFG_LSH)
    sharded = ShardedIndex.from_index(base, mesh=_mesh(p))
    q = _rows(d, slice(0, 7))
    counters.reset()
    got, want = sharded.query(q, k=5, probes=probes), base.query(
        q, k=5, probes=probes)
    assert got.ids == want.ids
    np.testing.assert_array_equal(np.asarray(got.rows),
                                  np.asarray(want.rows))
    np.testing.assert_array_equal(got.distances, want.distances)
    assert got.stats["stage"] == "sharded_lsh+gram"
    assert got.stats["probes"] == probes and got.stats["shards"] == p
    assert got.stats["mesh"] == sharded.mesh.shape
    assert counters.INDEX[("sharded_scans", "hamming")] == 1
    assert counters.INDEX[("sharded_rows", "hamming")] == 7 * len(base)
    assert counters.KERNEL_LAUNCHES["hamming_scan"] == 0  # the CPU path
    np.testing.assert_array_equal(got.distances[:, 0], 0.0)


@pytest.mark.parametrize("p", SHARDS)
def test_dense_query_and_gram_through_summa(p):
    base, d = _pair(**CFG_DENSE)
    sharded = ShardedIndex.from_index(base, mesh=_mesh(p))
    q = _rows(d, slice(0, 5))
    got, want = sharded.query(q, k=4), base.query(q, k=4)
    assert got.stats["stage"] == "sharded_gram"
    emb_q = base.embed(q).numpy()
    dist = ops.pairwise_l1(torch.from_numpy(emb_q),
                           base._emb_device).numpy()
    tol = l1_tol(emb_q, base._emb)
    a, b = np.asarray(got.rows), np.asarray(want.rows)
    qi, ri = np.nonzero(a != b)
    assert (np.abs(dist[qi, a[qi, ri]] - dist[qi, b[qi, ri]])
            <= np.maximum(tol[qi, a[qi, ri]], tol[qi, b[qi, ri]])).all()
    assert (np.abs(got.distances - want.distances)
            <= np.take_along_axis(tol, b, axis=1)).all()
    gram, want_g = sharded.gram(), base.gram()
    assert gram.shape == want_g.shape and gram.device == base.device
    assert (np.abs(gram.numpy() - want_g.numpy())
            <= l1_tol(base._emb, base._emb)).all()
    np.testing.assert_array_equal(np.diagonal(gram.numpy()), 0.0)
    if p == 1:  # one width slice: the same Gram call
        assert torch.equal(gram, want_g)
    assert counters.INDEX[("sharded_scans", "summa")] >= 2


@pytest.mark.parametrize("p", SHARDS)
def test_clouds_owner_gather_is_bitwise(p):
    base, _ = _pair(**CFG_LSH)
    sharded = ShardedIndex.from_index(base, mesh=_mesh(p))
    rng = np.random.default_rng(p)
    for rows in (np.array([0, 96, 50, 3, 3]), rng.integers(0, 97, (4, 6))):
        got = sharded.clouds(rows)
        assert got.birth.shape == rows.shape + (CFG_LSH["n_points"],)
        assert diagrams_bitwise_equal(got, base.clouds(rows))


@pytest.mark.parametrize("p", [1, 3])
def test_add_then_query_reshards(p):
    d = _noisy(n=60)
    base = TopoIndex(TopoIndexConfig(**CFG_LSH), device="cpu")
    sharded = ShardedIndex.from_index(base, mesh=_mesh(p))
    with pytest.raises(ValueError, match="empty"):
        sharded.query(_rows(d, slice(0, 2)))
    sharded.add(_rows(d, slice(0, 40)))
    q = _rows(d, slice(30, 36))
    sharded.query(q, k=3)
    assert sharded._per == -(-40 // p)
    sharded.add(_rows(d, slice(40, 60)))
    assert len(sharded) == 60 and sharded.ids == base.ids
    got, want = sharded.query(q, k=3), base.query(q, k=3)
    assert sharded._per == -(-60 // p)
    assert got.ids == want.ids
    np.testing.assert_array_equal(got.distances, want.distances)
    assert diagrams_bitwise_equal(sharded.clouds(np.arange(45, 60)),
                                  base.clouds(np.arange(45, 60)))


def test_save_load_roundtrip(tmp_path):
    base, d = _pair(**CFG_LSH)
    sharded = ShardedIndex.from_index(base, mesh=_mesh(2))
    path = str(tmp_path / "index.npz")
    sharded.save(path)
    loaded = ShardedIndex.load(path, mesh=_mesh(3), device="cpu")
    assert loaded.n_shards == 3 and loaded.ids == sharded.ids
    assert dataclasses.asdict(loaded.config) == dataclasses.asdict(
        sharded.config)
    np.testing.assert_array_equal(loaded.base._codes, base._codes)
    np.testing.assert_array_equal(loaded.base._emb, base._emb)
    q = _rows(d, slice(10, 16))
    got, want = loaded.query(q, k=4), sharded.query(q, k=4)
    assert got.ids == want.ids
    np.testing.assert_array_equal(got.distances, want.distances)
    assert diagrams_bitwise_equal(loaded.clouds(np.arange(97)),
                                  sharded.clouds(np.arange(97)))
    with pytest.raises(ValueError, match="not both"):
        ShardedIndex(TopoIndexConfig(**CFG_LSH), base=base)


@pytest.mark.parametrize("cfg", [CFG_LSH, CFG_DENSE], ids=["lsh", "dense"])
def test_one_npz_through_both_sharded_indexes(tmp_path, cfg):
    """A .npz saved by repro's TopoIndex, loaded into repro's ShardedIndex
    (mesh (1, 1) in process) and into the port's on 1 and 3 shards."""
    rng = np.random.default_rng(11)
    seeds = testing_j.seed_diagram_arrays(rng, 6, 16)
    corpus_j = testing_j.noisy_copies(seeds, rng, 96, 0.05, 0.6)
    index_j = TopoIndexJ(TopoIndexConfigJ(**cfg))
    index_j.add(corpus_j)
    path = str(tmp_path / "index.npz")
    index_j.save(path)
    sharded_j = ShardedIndexJ.load(path)
    # fresh noisy copies as queries: no distance is an exact 0 that the
    # packages' ulp-apart embeddings would round apart
    qj = testing_j.noisy_copies(seeds, rng, 7, 0.05, 0.6)
    arrays = [np.asarray(getattr(qj, k)) for k in FIELDS]
    q = diagrams_from_numpy(*arrays, device="cpu")
    want = sharded_j.query(qj, k=5)
    for p in (1, 3):
        sharded = ShardedIndex.load(path, mesh=_mesh(p), device="cpu")
        got = sharded.query(q, k=5)
        assert got.stats["stage"] == want.stats["stage"]
        eq = sharded.embed(q).numpy()
        dist = ops.pairwise_l1(torch.from_numpy(eq),
                               sharded.base._emb_device).numpy()
        tol = l1_tol(eq, sharded.base._emb)
        a, b = np.asarray(got.rows), np.asarray(want.rows)
        qi, ri = np.nonzero(a != b)
        ra, rb = a[qi, ri], b[qi, ri]
        assert (np.abs(dist[qi, ra] - dist[qi, rb])
                <= np.maximum(tol[qi, ra], tol[qi, rb])).all()
        np.testing.assert_allclose(got.distances, want.distances, rtol=1e-5,
                                   atol=1e-6)
        rows = np.array([[0, 95], [17, 48]])
        cl, cl_j = sharded.clouds(rows), sharded_j.clouds(rows)
        assert diagrams_bitwise_equal(cl, cl_j)


def test_sharded_modules_import_neither_jax_nor_repro():
    code = ("import sys, repro_torch.launch, "
            "repro_torch.index.sharded_index, repro_torch.kernels.hamming\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'benchmarks')]\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
