"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one.  The file
imports neither JAX nor ``repro`` (the machine with the card may have
neither), so it also runs without ``tests/conftest.py``:

    python -m pytest --noconftest -m requires_cuda tests/test_torch_cuda.py

Tolerance is zero where every output is a bool mask or an integer; the
pairwise-L1 Gram is held within |Δ| <= 1e-5 * Σ_d(|x_d| + |y_d|) + 1e-6,
since the kernel sums its D terms in another order than the plain version.
The Sinkhorn kernels and ``sinkhorn_w2`` are held at rtol 1e-4, atol 1e-5:
the kernel's exponents are bitwise the plain version's, but CUDA's
``expf``/``logf`` and the sums' order differ by ulps, which the eps ladder
carries through its updates; -inf must sit exactly where the plain version
has it, and two launches on the same inputs must agree bitwise.
The auction kernels run the plain solvers' float operations round for
round, so assignments, prices, round counts and convergence flags are held
bitwise; the totals, f32 sums of the same terms in another order, within
``metrics.testing.AUCTION_TOTAL_TOLERANCE``.  The Hamming kernel and the
ShardedIndex's candidates, ids, distances and clouds are held bitwise.  ``exact_w`` on the card is
held against the CPU port within rtol 1e-6, atol 1e-5: the expanded totals
are f32 sums in another order, the collapsed W^q float64 sums in another
order rounded once, and a square root of a total near 0 magnifies an ulp.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import domination as dm
from repro_torch.kernels import gf2_reduce as gf2
from repro_torch.kernels import ops, ref
from repro_torch.kernels.common_neighbors import common_neighbors_cuda
from repro_torch.kernels.domination import domination_cuda
from repro_torch.kernels.gf2_reduce import gf2_reduce_cuda
from repro_torch.kernels.kcore_peel import kcore_peel_cuda
from repro_torch.kernels.pairwise_gram import pairwise_l1_cuda
from repro_torch.kernels.sinkhorn_lse import (
    pack_columns, sinkhorn_lse_cuda, sinkhorn_pair_sum_cuda)
from repro_torch.kernels.hamming import hamming_scan_cuda
from repro_torch.metrics.testing import (
    AUCTION_CASES, HAMMING_CASES, SINKHORN_CASES, auction_operands,
    hamming_operands, sinkhorn_operands)

pytestmark = pytest.mark.requires_cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _graphs(b, n, p, seed, device):
    rng = np.random.default_rng(seed)
    adj = np.triu(rng.random((b, n, n)) < p, 1)
    adj = adj | adj.transpose(0, 2, 1)
    mask = rng.random((b, n)) < 0.9
    mask[0] = False  # an empty graph
    adj &= mask[:, None, :] & mask[:, :, None]
    return (torch.from_numpy(adj).to(device),
            torch.from_numpy(mask).to(device))


def _plain_fixpoint(adj, alive, k):
    while True:
        nxt = ref.kcore_peel_ref(adj, alive, k)
        if torch.equal(nxt, alive):
            return nxt
        alive = nxt


@pytest.mark.parametrize("n,p", [(1, 0.5), (31, 0.2), (64, 0.1), (100, 0.05),
                                 (1000, 0.006), (2048, 0.003)])
def test_kcore_peel_kernel(cuda, n, p):
    adj, mask = _graphs(3, n, p, seed=n, device=cuda)
    for k in (1, 2, 3):
        assert torch.equal(kcore_peel_cuda(adj, mask, k, 1),
                           ref.kcore_peel_ref(adj, mask, k))
        assert torch.equal(kcore_peel_cuda(adj, mask, k, 0),
                           _plain_fixpoint(adj, mask, k))


def _sparse_graphs(b, n, deg, seed, device):
    """``_graphs`` at mean degree ~``deg``, drawn in float32 (large B*N*N);
    graph 0 is empty when B > 1."""
    rng = np.random.default_rng(seed)
    adj = np.triu(rng.random((b, n, n), dtype=np.float32) < deg / n, 1)
    adj = adj | adj.transpose(0, 2, 1)
    mask = rng.random((b, n)) < 0.9
    mask[0] &= b == 1
    adj &= mask[:, None, :] & mask[:, :, None]
    return (torch.from_numpy(adj).to(device),
            torch.from_numpy(mask).to(device))


def _check_kcore(adj, mask):
    """Sweeps 1, 2 and 0 at k 1-3 and past every degree, bitwise the plain
    sweeps; two launches bitwise equal."""
    for k in (1, 2, 3, adj.shape[-1] + 1):
        one = ref.kcore_peel_ref(adj, mask, k)
        assert torch.equal(kcore_peel_cuda(adj, mask, k, 1), one)
        assert torch.equal(kcore_peel_cuda(adj, mask, k, 2),
                           ref.kcore_peel_ref(adj, one, k))
        fix = kcore_peel_cuda(adj, mask, k, 0)
        assert torch.equal(fix, _plain_fixpoint(adj, mask, k))
        assert torch.equal(fix, kcore_peel_cuda(adj, mask, k, 0))
    assert not bool(kcore_peel_cuda(adj, mask, adj.shape[-1] + 1, 0).any())


@pytest.mark.parametrize("c", [1, 2, 4, 8])
def test_kcore_peel_every_cluster_size(cuda, c):
    # the batch the selector gives c CTAs per graph at N = 1024 on this card
    from repro_torch.kernels.kcore_peel import cluster_size

    sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    b = sm // c
    assert cluster_size(b, 1024, sm) == c
    _check_kcore(*_sparse_graphs(b, 1024, 5.0, seed=c, device=cuda))


@pytest.mark.parametrize("b,n", [(1, 1024), (5, 1000), (3, 1056), (17, 1024),
                                 (1, 96), (1, 128), (1, 45)])
def test_kcore_peel_cluster_shapes(cuda, b, n):
    # B = 1 and ragged B; ragged N (a byte per lane), N of 33 words, and
    # graphs of 3, 4 and 2 words (clusters of 2, 4 and 2 CTAs)
    _check_kcore(*_sparse_graphs(b, n, 6.0, seed=b + n, device=cuda))


@pytest.mark.parametrize("delta", [-1, 0, 1])
def test_kcore_peel_batch_around_the_sm_count(cuda, delta):
    sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    _check_kcore(*_sparse_graphs(sm + delta, 512, 4.0, seed=sm + delta,
                                 device=cuda))


@pytest.mark.parametrize("b,n", [(2, 4096), (67, 1500)])
def test_kcore_peel_rows_past_shared_memory(cuda, b, n):
    # a cluster of 8 whose CTA shares still exceed shared memory, and
    # one CTA per graph: both pack into the global scratch
    from repro_torch.kernels.kcore_peel import cluster_size, scratch_words

    sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert scratch_words(b, n, cluster_size(b, n, sm)) > 0
    _check_kcore(*_sparse_graphs(b, n, 4.0, seed=n, device=cuda))


def _check_domination(adj, mask):
    """The launch bitwise the plain version; two launches bitwise equal."""
    got = domination_cuda(adj, mask)
    assert torch.equal(got, ref.domination_ref(adj, mask))
    assert torch.equal(domination_cuda(adj, mask), got)


@pytest.mark.parametrize("n,p", [(1, 0.5), (33, 0.3), (64, 0.1), (65, 0.1),
                                 (128, 0.05), (129, 0.05), (257, 0.02),
                                 (320, 0.02), (417, 0.02), (1024, 0.005),
                                 (2048, 0.003)])
def test_domination_kernel(cuda, n, p):
    adj, mask = _graphs(3, n, p, seed=n, device=cuda)
    _check_domination(adj, mask)


@pytest.mark.parametrize("n", [7, 64, 96, 128, 129, 320])
def test_domination_kernel_edge_cases(cuda, n):
    # complete graphs, twins (mutual), isolated vertices, an all-dead
    # mask, half the vertices dead with their edges kept; B = 5 is not a
    # multiple of the graphs a CTA holds
    rng = np.random.default_rng(n)
    full = ~np.eye(n, dtype=bool)
    twins = np.triu(rng.random((n, n)) < 0.3, 1)
    twins = twins | twins.T
    twins[1], twins[:, 1] = twins[0], twins[:, 0]
    twins[0, 1] = twins[1, 0] = True
    twins[0, 0] = twins[1, 1] = False
    lonely = twins.copy()
    lonely[2:4] = False
    lonely[:, 2:4] = False
    adj = np.stack([full, twins, lonely, full, twins])
    mask = np.ones((5, n), bool)
    mask[3] = False
    mask[4, n // 2:] = False
    adj, mask = torch.from_numpy(adj).to(cuda), torch.from_numpy(mask).to(cuda)
    _check_domination(adj, mask)
    got = domination_cuda(adj, mask)
    assert torch.equal(got[0], ~torch.eye(n, dtype=torch.bool, device=cuda))
    assert bool(got[1, 0, 1]) and bool(got[1, 1, 0])
    assert not bool(got[3].any())


@pytest.mark.parametrize("b,n,deg", [(4096, 64, 3.0), (256, 320, 5.0),
                                     (16, 1024, 11.7)])
def test_domination_kernel_main_path_shapes(cuda, b, n, deg):
    # the n64 and n320 rungs and Table 1, at their mean degrees
    _check_domination(*_sparse_graphs(b, n, deg, seed=b + n, device=cuda))


def test_domination_smem_matches_layout(cuda):
    import ctypes

    from repro_torch.kernels import _build

    fn = _build.function("domination", "domination_smem_bytes",
                         [ctypes.c_int] * 2, ctypes.c_longlong)
    for n in (1, 33, 64, 96, 128, 129, 320, 1024, 2048):
        for sms in (1, 132):
            lay = dm.layout(64, n, sms)
            assert fn(n, lay.graphs_per_cta) == lay.smem_bytes
    assert fn(64, 8) == -1  # more graphs than a CTA's warps take
    assert fn(320, 2) == -1  # the tile mapping takes one graph a CTA


def _blocks(g, s, r, seed, device):
    """Sparse random columns; a third carry a row 31 mod 32 (the sign bit)."""
    rng = np.random.default_rng(seed)
    w = (r + 31) // 32
    dense = np.zeros((g, s, w * 32), bool)
    np.put_along_axis(dense, rng.integers(0, r, size=(g, s, 3)), True, axis=-1)
    hi = 31 + 32 * rng.integers(0, r // 32, size=(g, s))  # rows stay < r
    dense[:, ::3] |= np.eye(w * 32, dtype=bool)[hi[:, ::3]]
    words = (dense.reshape(g, s, w, 32).astype(np.uint64)
             << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)
    return torch.from_numpy(words.view(np.int32)).to(device)


def test_gf2_kernel_single_launch_of_several_blocks(cuda):
    blocks = [_blocks(3, 80, 96, seed=1, device=cuda),
              _blocks(3, 200, 80, seed=2, device=cuda),
              _blocks(3, 5, 40, seed=3, device=cuda)]
    rows = [96, 80, 40]
    for got, b, r in zip(gf2_reduce_cuda(blocks, rows), blocks, rows):
        for x, y in zip(got, ref.gf2_reduce_ref(b, r)):
            assert torch.equal(x, y)


def test_gf2_kernel_block_past_shared_memory(cuda):
    b = _blocks(2, 1024, 2048, seed=4, device=cuda)  # 256 KiB per matrix
    for x, y in zip(gf2_reduce_cuda([b], [2048])[0],
                    ref.gf2_reduce_ref(b, 2048)):
        assert torch.equal(x, y)


def _check_gf2(blocks, rows):
    for got, b, r in zip(gf2_reduce_cuda(blocks, rows), blocks, rows):
        for x, y in zip(got, ref.gf2_reduce_ref(b, r)):
            assert torch.equal(x, y)


def _gf2_blocks(g, s, r, seed, device):
    """``_blocks`` for any R: the sign-bit rows only where R reaches one."""
    if r >= 32:
        return _blocks(g, s, r, seed, device)
    rng = np.random.default_rng(seed)
    bits = np.zeros((g, s, 32), bool)
    np.put_along_axis(bits, rng.integers(0, r, size=(g, s, 3)), True, axis=-1)
    words = (bits.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(-1)
    return torch.from_numpy(words.astype(np.uint32).view(np.int32)[..., None]
                            .copy()).to(device)


@pytest.mark.parametrize("w", [1, 2, 4, 5, 8, 16, 32, 33])
def test_gf2_kernel_every_width(cuda, w):
    """W picks the layout: a thread per matrix to 4 words, segments of 8,
    16 and 32 lanes, a warp with the column in shared memory above; rows
    up to the top word, a third on a sign bit, and G past the SM count so
    CTAs hold several matrices."""
    r = 32 * w - 5
    _check_gf2([_gf2_blocks(300, 64, r, seed=w, device=cuda)], [r])


@pytest.mark.parametrize("g,s,w,r", [(5, 64, 2, 40), (1, 7, 1, 20),
                                     (140, 30, 4, 100), (3, 200, 40, 1270)])
def test_gf2_kernel_layouts_with_zero_matrices(cuda, g, s, w, r):
    """All-zero matrices beside random ones, R < S, a last nonzero column
    that is the matrix's last, and zero columns past a ragged end."""
    b = _gf2_blocks(g, s, r, seed=g + s, device=cuda)
    assert b.shape[-1] == w
    b[0] = 0
    if g > 1:
        top = (r - 1) % 32
        b[1, -1] = 0
        b[1, -1, (r - 1) // 32] = (1 << top) if top < 31 else -2 ** 31
    if g > 2:
        b[2, s // 2:] = 0
    _check_gf2([b], [r])


def test_gf2_kernel_rows_under_a_word_and_no_graphs(cuda):
    _check_gf2([_gf2_blocks(9, 40, 20, seed=8, device=cuda)], [20])
    outs = gf2_reduce_cuda([torch.zeros((0, 12, 2), dtype=torch.int32,
                                        device=cuda)], [40])
    assert [tuple(x.shape) for x in outs[0]] == [(0, 12, 2), (0, 40), (0, 12)]


def test_gf2_kernel_one_launch_of_four_layouts(cuda):
    """Thread, segment, warp and global blocks in one launch."""
    blocks = [_blocks(6, 90, 120, seed=11, device=cuda),
              _blocks(6, 60, 500, seed=12, device=cuda),
              _blocks(6, 50, 1200, seed=13, device=cuda),
              _blocks(6, 1024, 2048, seed=14, device=cuda)]
    rows = [120, 500, 1200, 2048]
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    kinds = [gf2.layout(6, b.shape[1], b.shape[2], r, sms).kind
             for b, r in zip(blocks, rows)]
    assert kinds == ["thread", "segment", "warp", "global"]
    _check_gf2(blocks, rows)


def test_gf2_smem_matches_layout(cuda):
    """The source's shared-memory size agrees with the selector's."""
    import ctypes

    from repro_torch.kernels import _build

    fn = _build.function("gf2_reduce", "gf2_reduce_smem_bytes",
                         [ctypes.c_int] * 5, restype=ctypes.c_longlong)
    for g, s, w, r in ((689, 128, 4, 120), (253, 128, 16, 512),
                       (35, 256, 8, 256), (4, 200, 40, 1280),
                       (8, 4096, 128, 4096), (3, 7, 1, 0)):
        lay = gf2.layout(g, s, w, r, 132)
        assert fn(gf2.KINDS.index(lay.kind), lay.matrices_per_cta, s, w,
                  r) == lay.smem_bytes


def test_wrappers_launch_and_count(cuda):
    from repro_torch import counters

    adj, mask = _graphs(2, 40, 0.2, seed=5, device=cuda)
    counters.reset()
    ops.kcore_peel(adj, mask, 2, sweeps=0)
    ops.domination(adj, mask)
    ops.gf2_reduce(_blocks(1, 10, 32, seed=6, device=cuda)[0], 32)
    snap = counters.snapshot()
    assert (snap["kcore_peel"], snap["domination"], snap["gf2_reduce"]) == (1, 1, 1)


@pytest.mark.parametrize("n", [1, 31, 32, 33, 64, 320, 1024, 2048])
def test_common_neighbors_kernel(cuda, n):
    adj, _ = _graphs(3, n, min(0.5, 8.0 / n), seed=n, device=cuda)
    assert torch.equal(common_neighbors_cuda(adj),
                       ref.common_neighbors_ref(adj))


def test_common_neighbors_kernel_complete_empty_and_no_graphs(cuda):
    n = 70
    full = ~torch.eye(n, dtype=torch.bool, device=cuda)
    adj = torch.stack([full, torch.zeros_like(full)])
    cn = common_neighbors_cuda(adj)
    assert bool((cn[0][full] == n - 2).all()) and not bool(cn[1].any())
    assert not bool(cn[0].diagonal().any())
    empty = torch.zeros((0, 9, 9), dtype=torch.bool, device=cuda)
    assert common_neighbors_cuda(empty).shape == (0, 9, 9)


def _raw_graphs(b, n, p, seed, device):
    """Symmetric graphs whose dead vertices keep their edges; the second
    graph is all dead, the third complete."""
    rng = np.random.default_rng(seed)
    adj = np.triu(rng.random((b, n, n)) < p, 1)
    adj = adj | adj.transpose(0, 2, 1)
    mask = rng.random((b, n)) < 0.8
    mask[1] = False
    adj[2] = ~np.eye(n, dtype=bool)
    return (torch.from_numpy(adj).to(device),
            torch.from_numpy(mask).to(device))


@pytest.mark.parametrize("n", [1, 31, 32, 33, 64, 128, 320, 1024, 2048])
def test_common_neighbors_rowsums_kernel(cuda, n):
    from repro_torch.kernels.common_neighbors import (
        common_neighbors_rowsums_cuda)

    adj, mask = _raw_graphs(4, n, min(0.5, 8.0 / n), seed=n + 3, device=cuda)
    got = common_neighbors_rowsums_cuda(adj, mask)
    want = ref.common_neighbors_rowsums_ref(adj, mask)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    again = common_neighbors_rowsums_cuda(adj, mask)
    assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])


@pytest.mark.parametrize("n", [65, 96, 128, 129, 257])
def test_common_neighbors_kernel_both_mappings(cuda, n):
    # the counts on each side of N = 128, where the graph mapping gives way
    # to mirrored tile pairs; a complete graph among random ones
    adj, _ = _raw_graphs(5, n, min(0.5, 8.0 / n), seed=n, device=cuda)
    got = common_neighbors_cuda(adj)
    assert torch.equal(got, ref.common_neighbors_ref(adj))
    assert torch.equal(common_neighbors_cuda(adj), got)


def test_common_neighbors_rowsums_kernel_edge_cases(cuda):
    from repro_torch.kernels.common_neighbors import (
        common_neighbors_rowsums_cuda)

    for n in (70, 200):
        full = ~torch.eye(n, dtype=torch.bool, device=cuda)
        adj = torch.stack([full, torch.zeros_like(full), full])
        mask = torch.ones((3, n), dtype=torch.bool, device=cuda)
        mask[2, n // 2:] = False
        tri2, deg = common_neighbors_rowsums_cuda(adj, mask)
        live = n // 2
        assert tri2[0].tolist() == [(n - 1) * (n - 2)] * n
        assert deg[0].tolist() == [n - 1] * n
        assert not bool(tri2[1].any()) and not bool(deg[1].any())
        assert tri2[2].tolist() == ([(live - 1) * (live - 2)] * live
                                    + [0] * (n - live))
    empty = torch.zeros((0, 9, 9), dtype=torch.bool, device=cuda)
    tri2, deg = common_neighbors_rowsums_cuda(empty, empty[:, 0])
    assert tri2.shape == deg.shape == (0, 9)


def test_common_neighbors_smem_matches_layout(cuda):
    import ctypes

    from repro_torch.kernels import _build
    from repro_torch.kernels import common_neighbors as cn

    fn = _build.function("common_neighbors", "common_neighbors_smem_bytes",
                         [ctypes.c_int] * 3, ctypes.c_longlong)
    for n in (1, 33, 64, 96, 128, 129, 320, 1024, 2048):
        for sms in (1, 132):
            for sums in (False, True):
                lay = cn.layout(64, n, sms, sums=sums)
                assert fn(n, lay.graphs_per_cta, sums) == lay.smem_bytes
    assert fn(64, 8, 0) == -1  # more graphs than a CTA's warps take
    assert fn(320, 2, 1) == -1  # the tile mapping takes one graph a CTA


def test_clustering_on_the_card_writes_no_count_tensor(cuda):
    # the fused epilogue: one launch, and no (B, N, N) int32 allocation
    from repro_torch import counters

    adj, mask = _raw_graphs(64, 256, 0.05, seed=9, device=cuda)
    ops.clustering_coefficients(adj, mask)
    torch.cuda.synchronize()
    counters.reset()
    base = torch.cuda.memory_allocated(cuda)
    torch.cuda.reset_peak_memory_stats(cuda)
    cc = ops.clustering_coefficients(adj, mask)
    torch.cuda.synchronize()
    assert counters.snapshot()["common_neighbors"] == 1
    assert torch.cuda.max_memory_allocated(cuda) - base < adj.numel()
    assert torch.equal(cc.cpu(), ops.clustering_coefficients(adj.cpu(),
                                                             mask.cpu()))


def _l1_ok(got, x, y):
    want = ref.pairwise_l1_ref(x, y)
    tol = (1e-5 * (x.abs().sum(1)[:, None] + y.abs().sum(1)[None, :])
           + 1e-6)
    return bool(((got - want).abs() <= tol).all())


@pytest.mark.parametrize("m,n,d", [(1, 1, 1), (7, 129, 33), (129, 7, 652),
                                   (300, 260, 652), (1000, 64, 17)])
def test_pairwise_l1_kernel(cuda, m, n, d):
    gen = torch.Generator().manual_seed(m + n + d)
    x = (torch.rand((m, d), generator=gen) * 64).to(cuda)
    y = (torch.rand((n, d), generator=gen) * 64).to(cuda)
    assert _l1_ok(pairwise_l1_cuda(x, y), x, y)
    same = pairwise_l1_cuda(x, x)
    assert _l1_ok(same, x, x) and not bool(same.diagonal().any())


@pytest.mark.parametrize("d", [1, 17, 372, 652])
def test_pairwise_l1_layouts_agree_bitwise(cuda, d):
    # small launches, on both sides of the switch to the small-grid layout,
    # hold the same bits as the same rows of one 64 x 64-tiled launch
    from repro_torch.kernels.pairwise_gram import small_grid

    rng = np.random.default_rng(d)
    x = torch.from_numpy(rng.uniform(0, 64, (4200, d)).astype(np.float32))
    y = torch.from_numpy(rng.uniform(0, 64, (4100, d)).astype(np.float32))
    x, y = x.to(cuda), y.to(cuda)
    assert not small_grid(4200, 4100)
    big = pairwise_l1_cuda(x, y)
    seen = set()
    for m, n in [(1, 1), (72, 72), (33, 129), (500, 500), (520, 520),
                 (4159, 1), (4161, 1), (65 * 64, 64), (4200, 64),
                 (100, 700)]:
        rows = torch.from_numpy(rng.choice(4200, m, replace=False)).to(cuda)
        cols = torch.from_numpy(rng.choice(4100, n, replace=False)).to(cuda)
        got = pairwise_l1_cuda(x[rows].contiguous(), y[cols].contiguous())
        assert torch.equal(got, big[rows][:, cols]), (m, n)
        seen.add(small_grid(m, n))
    assert seen == {True, False}


def test_clustering_and_index_on_the_card_match_the_cpu(cuda):
    from repro_torch.core.api import topological_signature
    from repro_torch.data.graphs import erdos_renyi, with_degree_filtration
    from repro_torch.index import TopoIndex, TopoIndexConfig

    g = with_degree_filtration(erdos_renyi(3, 24, 20, 18, 0.3, device=cuda))
    cc = ops.clustering_coefficients(g.adj, g.mask)
    assert torch.equal(cc.cpu(), ops.clustering_coefficients(g.adj.cpu(),
                                                             g.mask.cpu()))
    d = topological_signature(g, dim=1, method="both", edge_cap=96,
                              tri_cap=160)
    cfg = TopoIndexConfig(embedding="both", n_points=8, n_dirs=8, res=4)
    index, index_cpu = TopoIndex(cfg, device=cuda), TopoIndex(cfg,
                                                              device="cpu")
    index.add(d)
    index_cpu.add(d.to("cpu"))
    assert np.allclose(index._emb, index_cpu._emb, rtol=1e-5, atol=1e-6)
    e = torch.from_numpy(index_cpu._emb).to(cuda)
    assert _l1_ok(index.gram(), e, e)


def test_new_wrappers_launch_and_count(cuda):
    from repro_torch import counters

    adj, mask = _graphs(2, 40, 0.2, seed=7, device=cuda)
    x = torch.rand((5, 12), device=cuda)
    counters.reset()
    ops.clustering_coefficients(adj, mask)
    ops.pairwise_l1(x, x)
    snap = counters.snapshot()
    assert (snap["common_neighbors"], snap["pairwise_l1"]) == (1, 1)


def _close_with_inf(got, want):
    assert torch.equal(torch.isneginf(got), torch.isneginf(want))
    fin = torch.isfinite(want)
    assert bool(torch.isfinite(got[fin]).all())
    torch.testing.assert_close(got[fin], want[fin], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("b,m,n,v0", SINKHORN_CASES)
def test_sinkhorn_lse_kernel(cuda, b, m, n, v0):
    t = sinkhorn_operands(np.random.default_rng(m + n), b, m, n, v0, cuda)
    args = (t["xp"], t["yp"], t["g"], t["log_b"], t["e_t"])
    got = sinkhorn_lse_cuda(*args)
    _close_with_inf(got, ref.sinkhorn_lse_ref(*args))
    assert torch.equal(sinkhorn_lse_cuda(*args), got)  # bitwise repeatable
    # the columns packed once by the caller: the same launch, the same bits
    packed = pack_columns(t["yp"], t["log_b"])
    assert torch.equal(sinkhorn_lse_cuda(*args, packed), got)
    assert torch.equal(ops.sinkhorn_lse(*args, packed=packed), got)
    if v0 == 0:
        assert bool(torch.isneginf(got[0]).all())


@pytest.mark.parametrize("mode", ["plan", "cost"])
@pytest.mark.parametrize("b,m,n,v0", SINKHORN_CASES)
def test_sinkhorn_pair_sum_kernel(cuda, b, m, n, v0, mode):
    t = sinkhorn_operands(np.random.default_rng(m * n), b, m, n, v0, cuda)
    args = (t["xp"], t["yp"], t["f"], t["g"], t["log_a"], t["log_b"],
            t["e_t"])
    got = sinkhorn_pair_sum_cuda(*args, mode)
    torch.testing.assert_close(got, ref.sinkhorn_pair_sum_ref(*args, mode),
                               rtol=1e-4, atol=1e-5)
    assert torch.equal(sinkhorn_pair_sum_cuda(*args, mode), got)
    if v0 == 0:
        assert float(got[0]) == 0.0


def _random_pairs(seed, b, s, device):
    from repro_torch.core.persistence import Diagrams
    from repro_torch.metrics.testing import random_diagram

    rng = np.random.default_rng(seed)
    rows = [random_diagram(rng, s=s, essential=int(rng.integers(0, 3)),
                           device="cpu") for _ in range(2 * b)]
    stack = lambda ds: Diagrams(*(torch.stack([getattr(d, k) for d in ds])
                                  for k in ("birth", "death", "dim", "valid")
                                  )).to(device)
    return stack(rows[0::2]), stack(rows[1::2])


@pytest.mark.parametrize("n_points", [32, None], ids=["n32", "full"])
def test_sinkhorn_w2_blocked_on_the_card_matches_the_cpu(cuda, n_points):
    from repro_torch.metrics import sinkhorn_w2

    d1, d2 = _random_pairs(41, 8, 80, cuda)
    kw = dict(impl="blocked", n_points=n_points, n_iters=15, n_scales=3)
    got = sinkhorn_w2(d1, d2, **kw)
    want = sinkhorn_w2(d1.to("cpu"), d2.to("cpu"), **kw)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("impl", ["dense", "blocked"])
def test_sinkhorn_self_distance_is_zero_on_the_card(cuda, impl):
    from repro_torch.metrics import compare

    d1, _ = _random_pairs(42, 16, 40, cuda)
    got = compare(d1, d1, metric="sinkhorn", impl=impl)
    assert torch.equal(got, torch.zeros_like(got))


def test_sinkhorn_wrappers_launch_and_count(cuda):
    from repro_torch import counters
    from repro_torch.metrics import sinkhorn_w2

    d1, d2 = _random_pairs(43, 4, 12, cuda)
    counters.reset()
    sinkhorn_w2(d1, d2, impl="blocked", n_iters=2, n_scales=2)
    snap = counters.snapshot()
    # 2 stages x 2 iterations x 2 half-updates x 3 OT terms; the eps scale
    # and the three plan costs
    assert (snap["sinkhorn_lse"], snap["sinkhorn_pair_sum"]) == (24, 4)
    counters.reset()
    sinkhorn_w2(d1, d2, impl="dense", n_iters=2, n_scales=2)
    assert counters.snapshot()["sinkhorn_lse"] == 0


def _case_id(case):
    kind, b, m, opts, solver = case
    extra = "-".join(f"{k}{v}" for k, v in {**opts, **solver}.items())
    return f"{kind}-B{b}-M{m}" + (f"-{extra}" if extra else "")


@pytest.mark.parametrize("case", AUCTION_CASES, ids=_case_id)
def test_auction_kernel(cuda, case):
    from repro_torch.metrics.testing import (
        auction_agreement, auction_case, solve_auction_case)

    got = solve_auction_case(case, cuda, kernel=True)
    want = solve_auction_case(case, cuda, kernel=False)
    t, _ = auction_case(case, cuda)
    differ, err, ok = auction_agreement(got, want, t.get("cost", t.get("cbar")))
    assert differ == 0 and ok, (differ, err)
    again = solve_auction_case(case, cuda, kernel=True)
    assert all(torch.equal(a, g) for a, g in zip(again, got))


def test_auction_wrappers_launch_and_count(cuda):
    from repro_torch import counters

    t = auction_operands(np.random.default_rng(5), 3, 6, "collapsed", cuda)
    counters.reset()
    ops.auction_lap(t["cbar"].abs().contiguous(), n_scales=3)
    ops.auction_lap_collapsed(t["cbar"], t["keep1"], t["keep2"])
    snap = counters.snapshot()
    assert (snap["auction_lap"], snap["auction_lap_collapsed"]) == (1, 1)


@pytest.mark.parametrize("collapse", ["on", "off"])
def test_exact_w_on_the_card_matches_the_cpu(cuda, collapse):
    from repro_torch.metrics import compare_info

    d1, d2 = _random_pairs(44, 12, 12, cuda)
    got = compare_info(d1, d2, metric="exact_w", collapse=collapse)
    want = compare_info(d1.to("cpu"), d2.to("cpu"), metric="exact_w",
                        collapse=collapse)
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=1e-6, atol=1e-5)
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g.cpu(), w)
    if collapse == "on":  # a warm start from the returned prices
        warm = compare_info(d1, d2, metric="exact_w", prices=got[3])
        torch.testing.assert_close(warm[0], got[0], rtol=1e-6, atol=1e-5)


def test_bottleneck_and_self_distance_on_the_card(cuda):
    from repro_torch.metrics import compare

    d1, d2 = _random_pairs(45, 8, 12, cuda)
    got = compare(d1, d2, metric="bottleneck_approx")
    want = compare(d1.to("cpu"), d2.to("cpu"), metric="bottleneck_approx")
    assert torch.equal(got.cpu(), want)
    for collapse in ("on", "off"):
        self_ = compare(d1, d1, metric="exact_w", collapse=collapse)
        assert torch.equal(self_, torch.zeros_like(self_))


def _hamming_words(case, device):
    from repro_torch.kernels.hamming import as_int32_words, pack_codes_u32

    arrays = hamming_operands(np.random.default_rng(sum(case[:3])), *case)
    return [as_int32_words(pack_codes_u32(a)).to(device) for a in arrays]


@pytest.mark.parametrize("case", HAMMING_CASES + ((256, 262144, 16, "probe"),),
                         ids=lambda c: "q{}_n{}_b{}_{}".format(*c))
def test_hamming_scan_kernel(cuda, case):
    cq, cd, mq = _hamming_words(case, cuda)
    got = hamming_scan_cuda(cq, mq, cd)
    assert torch.equal(got, ref.hamming_scan_ref(cq, mq, cd))
    assert torch.equal(hamming_scan_cuda(cq, mq, cd), got)


def test_hamming_wrapper_launches_and_counts(cuda):
    from repro_torch import counters

    cq, cd, mq = _hamming_words(HAMMING_CASES[2], cuda)
    counters.reset()
    got = ops.hamming_scan(cq, cd, mq)
    assert counters.snapshot()["hamming_scan"] == 1
    assert torch.equal(got.cpu(), ops.hamming_scan(cq.cpu(), cd.cpu(),
                                                   mq.cpu()))
    assert ops.hamming_scan(cq[:0], cd).shape == (0, cd.shape[0])
    assert counters.snapshot()["hamming_scan"] == 1  # nothing to launch


@pytest.mark.parametrize("coarse", ["lsh", "none"])
def test_sharded_index_on_the_card_matches_the_cpu(cuda, coarse):
    """A 2-shard mesh on the card over the CPU port's stored embeddings:
    coarse candidates bitwise the CPU host scan's on the same query
    embeddings, query answers bitwise the card's single-host index's, clouds
    bitwise, and the SUMMA Gram within the pairwise-L1 tolerance."""
    from repro_torch import counters
    from repro_torch.core.persistence import Diagrams, diagrams_bitwise_equal
    from repro_torch.index import ShardedIndex, TopoIndex, TopoIndexConfig
    from repro_torch.launch import make_index_mesh
    from repro_torch.metrics.testing import noisy_copies, seed_diagram_arrays

    rng = np.random.default_rng(11)
    d = noisy_copies(seed_diagram_arrays(rng, 6, 16), rng, 97, 0.05, 0.6,
                     device="cpu")
    cfg = TopoIndexConfig(embedding="sw", n_points=8, n_dirs=8,
                          coarse=coarse, lsh_bits=64, lsh_overfetch=4)
    cpu = TopoIndex(cfg, device="cpu")
    cpu.add(d)
    card = TopoIndex(cfg, device=cuda)
    card._emb, card._ids, card._clouds = cpu._emb, cpu._ids, cpu._clouds
    card._codes = cpu._codes
    card._emb_device = torch.from_numpy(cpu._emb).to(cuda)
    sharded = ShardedIndex.from_index(
        card, mesh=make_index_mesh(devices=[cuda, cuda]))
    q = Diagrams(*(getattr(d, k)[:7] for k in ("birth", "death", "dim",
                                               "valid"))).to(cuda)
    counters.reset()
    got, want = sharded.query(q, k=5), card.query(q, k=5)
    if coarse == "lsh":
        assert counters.snapshot()["hamming_scan"] == 2  # one per shard
        assert got.ids == want.ids
        np.testing.assert_array_equal(got.distances, want.distances)
        emb_q = cpu.embed(q.to("cpu")).numpy()
        for m in (5, 20, 96):
            np.testing.assert_array_equal(
                sharded._coarse_candidates(emb_q, m),
                cpu._coarse_candidates(emb_q, m))
    else:
        assert got.stats["stage"] == "sharded_gram"
    e = torch.from_numpy(cpu._emb).to(cuda)
    assert _l1_ok(sharded.gram(), e, e)
    rows = np.array([[0, 96, 50], [3, 3, 48]])
    assert diagrams_bitwise_equal(sharded.clouds(rows), cpu.clouds(rows))
