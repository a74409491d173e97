"""The port's kernel layer against ``repro``'s kernels and references.

On the CPU the port's wrappers run their plain PyTorch versions; those are
held here against ``repro.kernels.ref``, ``repro``'s Pallas kernels in
interpret mode, and ``reduce_packed``: with zero tolerance where every
output is a bool mask, an integer or an integer ratio (clustering
coefficients), and for ``pairwise_l1`` within
|Δ| <= 1e-5 * Σ_d(|x_d| + |y_d|) + 1e-6, since its float32 sums of D terms
run in another order (the Pallas kernel sums per 128-wide D tile).  The hand-written CUDA kernels themselves are held
against the plain versions by ``tests/test_torch_cuda.py`` and by
``chip_smoke.py``, on a machine with the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.filtration import build_filtered_complex as build_fc_j
from repro.core.persistence_jax import (
    pack_boundary_blocks as pack_blocks_j,
    reduce_packed as reduce_packed_j,
)
from repro.core.prunit import domination_matrix as domination_matrix_j
from repro.kernels import ops as ops_j
from repro.kernels import ref as ref_j
from repro_torch import counters
from repro_torch.core.persistence import reduce_packed
from repro_torch.kernels import ops, ref
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


def _cpu(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _random_batch(b, n, p, seed):
    rng = np.random.default_rng(seed)
    adj = rng.random((b, n, n)) < p
    adj = np.triu(adj, 1)
    adj = adj | adj.transpose(0, 2, 1)
    mask = rng.random((b, n)) < 0.9
    mask[0] = False  # an empty graph
    adj = adj & mask[:, None, :] & mask[:, :, None]
    return adj, mask


def _u32_to_i32(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x).view(np.int32).copy())


@pytest.mark.parametrize("n,tile,k", [(24, 8, 1), (24, 8, 2), (40, 16, 3)])
def test_kcore_peel_ref_matches_repro(n, tile, k):
    g = graphs_to_batch(random_graphs("er", 3, seed=n + k), n_pad=n)
    out = ref.kcore_peel_ref(_cpu(g.adj), _cpu(g.mask), k)
    want_ref = jax.vmap(lambda a, al: ref_j.kcore_peel_ref(a, al, k))(
        g.adj, g.mask)
    want_pallas = ops_j.kcore_peel(g.adj, g.mask, k, tile=tile)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want_ref))
    np.testing.assert_array_equal(out.numpy(), np.asarray(want_pallas))


@pytest.mark.parametrize("sweeps", [1, 2, 0])
def test_kcore_peel_wrapper_sweeps(sweeps):
    """ops.kcore_peel runs ``sweeps`` plain sweeps on the CPU, 0 = fixpoint."""
    g = graphs_to_batch(random_graphs("ba", 4, seed=5), n_pad=24)
    adj, mask = _cpu(g.adj), _cpu(g.mask)
    want = mask
    for _ in range(sweeps or 24):
        want = ref.kcore_peel_ref(adj, want, 3)
    before = counters.snapshot()
    out = ops.kcore_peel(adj, mask, 3, sweeps=sweeps)
    assert counters.snapshot() == before  # the plain path launches nothing
    assert torch.equal(out, want)


@pytest.mark.parametrize("n,tile", [(8, 8), (20, 8), (33, 16), (64, 32)])
def test_domination_ref_matches_repro(n, tile):
    adj, mask = _random_batch(3, n, 0.3, seed=n * tile)
    adj_j, mask_j = jnp.asarray(adj), jnp.asarray(mask)
    out = ops.domination(_cpu(adj), _cpu(mask)).numpy()
    np.testing.assert_array_equal(
        out, np.asarray(jax.vmap(ref_j.domination_ref)(adj_j, mask_j)))
    np.testing.assert_array_equal(
        out, np.asarray(ops_j.domination(adj_j, mask_j, tile=tile)))
    np.testing.assert_array_equal(
        out, np.asarray(domination_matrix_j(adj_j, mask_j)))


def _real_blocks(kind, count, seed, n_pad=24, edge_cap=96, tri_cap=128):
    """repro's per-dimension blocks of real complexes, (G, S_d, W_d) each."""
    g = graphs_to_batch(random_graphs(kind, count, seed=seed), n_pad=n_pad)
    caps = [n_pad, edge_cap, tri_cap]

    @jax.jit
    @jax.vmap
    def blocks(adj, mask, f):
        fc = build_fc_j(adj, mask, f, 1, edge_cap, tri_cap)
        return pack_blocks_j(fc, caps)[0]

    return blocks(g.adj, g.mask, g.f), caps


@pytest.mark.parametrize("kind", ["er", "plc"])
def test_gf2_reduce_ref_matches_reduce_packed(kind):
    blocks, caps = _real_blocks(kind, 4, seed=11)
    for d, block in enumerate(blocks):
        reduced, owner, positive = ref.gf2_reduce_ref(_u32_to_i32(block),
                                                      caps[d])
        own_j, pos_j = jax.jit(jax.vmap(
            lambda b: reduce_packed_j(b, caps[d])))(block)
        np.testing.assert_array_equal(owner.numpy(), np.asarray(own_j))
        np.testing.assert_array_equal(positive.numpy(), np.asarray(pos_j))
        own_p, pos_p = reduce_packed(_u32_to_i32(block), caps[d])
        assert torch.equal(own_p, owner) and torch.equal(pos_p, positive)
        # each column that did not reduce to zero owns its own low row
        lows = ref.low(reduced.reshape(-1, reduced.shape[-1]))
        lows = lows.reshape(reduced.shape[:2])
        for i in range(block.shape[0]):
            for j in np.nonzero(~positive[i].numpy())[0]:
                assert owner[i, lows[i, j]] == j


def _bit31_blocks(g, s, r, seed):
    """Random sparse boundary-like columns, many with their low at a row
    31 mod 32 (bit 31 of a word: the sign bit of the int32 pattern)."""
    rng = np.random.default_rng(seed)
    w = (r + 31) // 32
    dense = np.zeros((g, s, w * 32), bool)
    for b in range(g):
        for j in range(s):
            faces = rng.choice(r, size=3, replace=False)
            dense[b, j, faces] = True
            if j % 3 == 0:
                dense[b, j, 31 + 32 * rng.integers(0, w)] = True
    bits = np.uint64(1) << np.arange(32, dtype=np.uint64)
    words = (dense.reshape(g, s, w, 32) * bits).sum(-1)
    return words.astype(np.uint32)


def test_gf2_reduce_ref_bit31_columns():
    u32 = _bit31_blocks(3, 80, 96, seed=7)
    assert (u32 >= 2 ** 31).any()
    reduced, owner, positive = ref.gf2_reduce_ref(_u32_to_i32(u32), 96)
    for i in range(u32.shape[0]):
        own_j, pos_j = reduce_packed_j(jnp.asarray(u32[i]), 96)
        np.testing.assert_array_equal(owner[i].numpy(), np.asarray(own_j))
        np.testing.assert_array_equal(positive[i].numpy(), np.asarray(pos_j))
    # some pivots sit on bit 31 of their word
    assert (owner[:, 31::32] >= 0).any()


def test_low_handles_the_sign_bit():
    w = torch.zeros((4, 3), dtype=torch.int32)
    w[0, 0] = -(2 ** 31)          # bit 31 of word 0
    w[1, 2] = -1                  # every bit of word 2
    w[2, 1] = 1                   # bit 0 of word 1
    assert ref.low(w).tolist() == [31, 95, 32, -1]


def test_gf2_wrappers_single_and_batch_forms():
    u32 = _bit31_blocks(2, 40, 64, seed=3)
    b = _u32_to_i32(u32)
    red_b, own_b, pos_b = ops.gf2_reduce_batch(b, 64)
    red_s, own_s, pos_s = ops.gf2_reduce(b[1], 64)
    assert torch.equal(red_b[1], red_s) and torch.equal(own_b[1], own_s)
    assert torch.equal(pos_b[1], pos_s)
    outs = ops.gf2_reduce_blocks([b, b[:, :20].contiguous()], [64, 64])
    assert torch.equal(outs[0][1], own_b)
    assert outs[1][1].shape == (2, 64)


def test_wrappers_check_their_inputs():
    adj = torch.zeros((2, 5, 5), dtype=torch.bool)
    mask = torch.ones((2, 5), dtype=torch.bool)
    with pytest.raises(TypeError):
        ops.domination(adj.int(), mask)
    with pytest.raises(ValueError):
        ops.kcore_peel(adj[:, :4], mask, 1)
    with pytest.raises(ValueError):
        ops.domination(adj.transpose(1, 2), mask)  # not contiguous
    with pytest.raises(ValueError):
        ops.gf2_reduce_batch(torch.zeros((1, 4, 1), dtype=torch.int32), 40)


def _raw_graphs(b, n, p, seed):
    """Symmetric adjacency with edges on padding vertices too: the
    clustering coefficients must mask before they count."""
    rng = np.random.default_rng(seed)
    adj = np.triu(rng.random((b, n, n)) < p, 1)
    adj = adj | adj.transpose(0, 2, 1)
    mask = rng.random((b, n)) < 0.8
    mask[0] = False  # an empty graph
    return adj, mask


@pytest.mark.parametrize("n,tile", [(8, 8), (20, 8), (33, 16), (48, 16)])
def test_common_neighbors_and_clustering_match_repro(n, tile):
    adj, mask = _raw_graphs(4, n, 0.35, seed=n + tile)
    adj_j, mask_j = jnp.asarray(adj), jnp.asarray(mask)
    before = counters.snapshot()
    cn = ops.common_neighbors(_cpu(adj)).numpy()
    np.testing.assert_array_equal(
        cn, np.asarray(jax.vmap(ref_j.common_neighbors_ref)(adj_j)))
    np.testing.assert_array_equal(
        cn, np.asarray(ops_j.common_neighbors(adj_j, tile=tile)))
    cc = ops.clustering_coefficients(_cpu(adj), _cpu(mask)).numpy()
    np.testing.assert_array_equal(
        cc, np.asarray(ops_j.clustering_coefficients(adj_j, mask_j,
                                                     tile=tile)))
    assert np.isfinite(cc).all() and (cc[~mask] == 0).all()
    assert counters.snapshot() == before  # the plain path launches nothing


@pytest.mark.parametrize("n,tile", [(8, 8), (20, 8), (33, 16), (48, 16)])
def test_common_neighbors_rowsums_match_repro_clustering(n, tile):
    # the fused epilogue's plain version: the row sums repro's
    # clustering_coefficients divides, and the same coefficients from them
    adj, mask = _raw_graphs(4, n, 0.35, seed=n + tile + 1)
    adj_j, mask_j = jnp.asarray(adj), jnp.asarray(mask)
    live = adj_j & mask_j[:, None, :] & mask_j[:, :, None]
    tri2, deg = ref.common_neighbors_rowsums_ref(_cpu(adj), _cpu(mask))
    assert tri2.dtype == deg.dtype == torch.int32
    np.testing.assert_array_equal(
        tri2.numpy(), np.asarray(ops_j.common_neighbors(live, tile=tile)
                                 .sum(-1)))
    np.testing.assert_array_equal(deg.numpy(), np.asarray(live.sum(-1)))
    np.testing.assert_array_equal(
        ops.clustering_from_sums(tri2, deg, _cpu(mask)).numpy(),
        np.asarray(ops_j.clustering_coefficients(adj_j, mask_j, tile=tile)))


def test_common_neighbors_complete_and_empty_graphs():
    n = 7
    full = ~torch.eye(n, dtype=torch.bool)
    adj = torch.stack([full, torch.zeros_like(full)])
    cn = ops.common_neighbors(adj)
    assert (cn[0][full] == n - 2).all() and not cn[0].diagonal().any()
    assert not cn[1].any()
    cc = ops.clustering_coefficients(adj, torch.ones((2, n), dtype=torch.bool))
    assert cc[0].tolist() == [1.0] * n and cc[1].tolist() == [0.0] * n
    assert ops.common_neighbors(torch.zeros((0, 4, 4), dtype=torch.bool)
                                ).shape == (0, 4, 4)


def _l1_tol(x, y):
    return (1e-5 * (np.abs(x).sum(1)[:, None] + np.abs(y).sum(1)[None, :])
            + 1e-6)


@pytest.mark.parametrize("m,n,d", [(1, 1, 1), (7, 5, 33), (16, 9, 130),
                                   (40, 24, 652)])
def test_pairwise_l1_matches_repro(m, n, d):
    rng = np.random.default_rng(m * n + d)
    x = rng.uniform(0, 64, (m, d)).astype(np.float32)
    y = rng.uniform(0, 64, (n, d)).astype(np.float32)
    got = ops.pairwise_l1(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    xj, yj = jnp.asarray(x), jnp.asarray(y)
    for want in (ref_j.pairwise_l1_ref(xj, yj), ops_j.pairwise_l1(xj, yj)):
        assert (np.abs(got - np.asarray(want)) <= _l1_tol(x, y)).all()
    same = ops.pairwise_l1(torch.from_numpy(x), torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(np.diagonal(same), 0.0)


def test_pairwise_l1_plain_version_chunks_rows(monkeypatch):
    """The plain version materializes (rows, N, D) blocks; the block size
    changes nothing but the peak memory."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.normal(size=(13, 70)).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=(6, 70)).astype(np.float32))
    whole = ref.pairwise_l1_ref(x, y)
    for chunk in (1, 70 * 6 * 4):
        monkeypatch.setattr(ref, "L1_CHUNK", chunk)
        np.testing.assert_allclose(ref.pairwise_l1_ref(x, y), whole,
                                   rtol=1e-6)
    assert ref.pairwise_l1_ref(x[:0], y).shape == (0, 6)


def test_new_wrappers_check_their_inputs():
    adj = torch.zeros((2, 5, 5), dtype=torch.bool)
    mask = torch.ones((2, 5), dtype=torch.bool)
    x = torch.zeros((3, 4))
    with pytest.raises(TypeError):
        ops.common_neighbors(adj.int())
    with pytest.raises(ValueError):
        ops.common_neighbors(adj[0])
    with pytest.raises(ValueError):
        ops.common_neighbors(adj.transpose(1, 2))  # not contiguous
    with pytest.raises(ValueError):
        ops.clustering_coefficients(adj, mask[:, :4])
    with pytest.raises(ValueError):
        ops.pairwise_l1(x, torch.zeros((3, 5)))
    with pytest.raises(TypeError):
        ops.pairwise_l1(x.double(), x.double())
    with pytest.raises(ValueError):
        ops.pairwise_l1(x.t(), x.t())
