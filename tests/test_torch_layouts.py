"""The kcore_peel, pairwise_l1, domination and common_neighbors kernels'
layouts, emulated on the CPU.

The CUDA kernels run only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).  What their layouts must preserve is checked here, in
torch, with zero tolerance:

* ``kcore_peel`` splits a graph over a thread-block cluster of c CTAs.
  Each CTA packs the rows of its own 32-vertex words, keeps a replicated,
  triple-buffered alive vector, sends its new words to every CTA once per
  sweep and decides alone when to stop.  The emulation follows that data
  flow (with the fastest CTA storing its next sweep's words before its
  peers compare) and is held against ``repro``'s ``kcore_peel_ref``
  iterated to its fixpoint and the port's plain fixpoint, on Table 1
  surrogates and on seeded random graphs of ragged N.  The pack's 16-byte
  arithmetic (four bytes to four bits, two lanes' halves to one word) is
  held against a direct packing.
* ``cluster_size``, the selector of c, at the main path's shapes.
* ``pairwise_l1`` forms each output as chunk partials (0 + 16 terms in d
  order) added to 0 in chunk order, in both its 64 x 64 layout and its
  small-grid layout (16 x 16 tiles, 8 chunks a round).  The two emulations
  agree bitwise, and with ``repro``'s reference within the L1 tolerance.
* ``domination`` stages raw adjacency bytes and sums in int32 on the
  tensor cores, over its K chunks, the Gram of the A side (the diagonal
  byte set, then every column masked, in the fragments) against the B side
  (the diagonal set, unmasked); d = the A side's row sums (an mma against
  ones).  It compares each sum with d of its row (or, in the mirrored
  block of an off-diagonal tile pair, of its column) under both live bits.
  The emulation follows the tile pairs and K chunks of the mapping
  ``layout`` picks and is held bitwise against the port's plain version,
  and that against ``repro``'s interpret-mode Pallas kernel (N <= 128) or
  its reference, on random graphs of ragged N, a Table 1 surrogate,
  complete graphs, twins, isolated vertices and an all-dead mask.  The
  CTAs and warp tiles of each mapping write every entry once, and the
  launch stays within shared memory.
* ``common_neighbors`` runs the same Gram over raw rows in the same two
  mappings, with two epilogues: the counts where the edge bit (read from
  the staged u rows) is set, mirrored off the diagonal pairs; or, with
  the mask in the A side, the row sums of the live-restricted counts
  (column sums for the mirrored block) and the degrees from the diagonal
  pairs.  The emulation of each, at the layout its selector picks, is
  held bitwise against the port's plain versions, and those against
  ``repro``'s interpret-mode Pallas kernel and ``clustering_coefficients``,
  on random graphs of ragged N with dead vertices whose edges are kept,
  complete, empty, half-dead, all-dead and star graphs; every pair is
  gathered once and every degree once, and both epilogues fit two CTAs an
  SM up to N = 2048.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.data.graphs import load_large_network
from repro.kernels import ops as ops_j
from repro.kernels import ref as ref_j
from repro_torch.kernels import common_neighbors as cn
from repro_torch.kernels import domination as dm
from repro_torch.kernels import ops, ref
from repro_torch.kernels.kcore_peel import MAX_CLUSTER, cluster_size

_POP8 = torch.tensor([bin(i).count("1") for i in range(256)],
                     dtype=torch.int64)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file: its thousands of small torch ops
    gain nothing from threads, and when test files run in parallel worker
    processes, threads in every worker oversubscribe the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _popcount(words):
    """Set bits of int64 tensors holding 32-bit words."""
    return sum(_POP8[(words >> s) & 0xFF] for s in (0, 8, 16, 24))


def _words(bits):
    """(..., N) bool -> (..., ceil(N/32)) int64 words: vertex 32x + j at bit
    j of word x, the kernel's packing."""
    n = bits.shape[-1]
    w = (n + 31) // 32
    pad = torch.zeros((*bits.shape[:-1], 32 * w), dtype=torch.int64)
    pad[..., :n] = bits.to(torch.int64)
    return (pad.view(*bits.shape[:-1], w, 32) << torch.arange(32)).sum(-1)


def _warps(n, c):
    """Warps per CTA, as ``csrc/kcore_peel.cu`` ``layout`` sets them."""
    w = (n + 31) // 32
    words_max = -(-w // c)
    return min(32, max(words_max, -(-(32 * words_max * w) // 64)))


def _cluster_peel(adj, alive, k, sweeps, c):
    """One graph through the kernel's cluster sweep: (N, N) bool adjacency,
    (N,) bool alive -> (N,) bool, and the sweeps run."""
    n = alive.shape[0]
    w = (n + 31) // 32
    warps = _warps(n, c)
    rows = _words(adj)  # row u, word y; CTA r reads only its own rows
    ctas = []
    for r in range(c):
        x0, x1 = r * w // c, (r + 1) * w // c
        lw = x1 - x0
        ctas.append({"x0": x0, "x1": x1,
                     "groups": max(1, min(warps // lw, w)) if lw else 1,
                     "bufs": [_words(alive), None, None]})

    def new_words(cta, cur):
        """The CTA's own new words from its buffer ``cur``: degrees as
        popcounts summed over ``groups`` word slices of each row."""
        alive_w = cta["bufs"][cur]
        out = {}
        for x in range(cta["x0"], cta["x1"]):
            u = torch.arange(32 * x, min(32 * x + 32, n))
            deg = torch.zeros(len(u), dtype=torch.int64)
            for p in range(cta["groups"]):
                y0 = p * w // cta["groups"]
                y1 = (p + 1) * w // cta["groups"]
                deg += _popcount(rows[u, y0:y1] & alive_w[y0:y1]).sum(-1)
            old = (alive_w[x] >> (u - 32 * x)) & 1
            keep = (old == 1) & (deg >= k)
            out[x] = int((keep.to(torch.int64) << (u - 32 * x)).sum())
        return out

    def exchange(words, buf):
        """Every CTA stores its words into buffer ``buf`` of every CTA."""
        for cta in ctas:
            if cta["bufs"][buf] is None:
                cta["bufs"][buf] = torch.zeros(w, dtype=torch.int64)
            for x, word in words.items():
                cta["bufs"][buf][x] = word

    cur, s = 0, 0
    words = [new_words(cta, cur) for cta in ctas]
    while True:
        nxt = (cur + 1) % 3
        for cw in words:
            exchange(cw, nxt)
        # the cluster barrier; then the fastest CTA decides and, going on,
        # stores its next sweep's words before its peers compare
        s += 1
        go_on = [bool((cta["bufs"][cur] != cta["bufs"][nxt]).any())
                 and (sweeps == 0 or s < sweeps) for cta in ctas[:1]]
        early = new_words(ctas[0], nxt) if go_on[0] else None
        if early is not None:
            exchange(early, (nxt + 1) % 3)
        go_on += [bool((cta["bufs"][cur] != cta["bufs"][nxt]).any())
                  and (sweeps == 0 or s < sweeps) for cta in ctas[1:]]
        assert len(set(go_on)) == 1, "the CTAs of a cluster disagree"
        for cta in ctas:
            assert torch.equal(cta["bufs"][nxt], ctas[0]["bufs"][nxt])
        cur = nxt
        if not go_on[0]:
            break
        words = [early] + [new_words(cta, cur) for cta in ctas[1:]]
        # the early words are final: the next exchange stores them again
    out = torch.zeros(n, dtype=torch.bool)
    for cta in ctas:
        for u in range(32 * cta["x0"], min(32 * cta["x1"], n)):
            out[u] = bool((cta["bufs"][cur][u // 32] >> (u % 32)) & 1)
    return out, s


def _repro_fixpoint(adj, alive, k):
    """``repro``'s one-sweep reference, iterated until nothing changes."""
    cur = jax.numpy.asarray(alive)
    a = jax.numpy.asarray(adj)
    while True:
        nxt = ref_j.kcore_peel_ref(a, cur, k)
        if bool((nxt == cur).all()):
            return np.asarray(nxt)
        cur = nxt


def _check_cluster_peel(adj, alive, k):
    """Every cluster size against repro's fixpoint and the port's plain
    fixpoint (and one sweep against one plain sweep), bitwise."""
    want = _repro_fixpoint(adj, alive, k)
    a, m = torch.from_numpy(adj), torch.from_numpy(alive)
    plain = ops.kcore_peel(a[None], m[None], k, sweeps=0)[0]
    np.testing.assert_array_equal(plain.numpy(), want)
    one = ref.kcore_peel_ref(a[None], m[None], k)[0]
    for c in (1, 2, 4, MAX_CLUSTER):
        got, _ = _cluster_peel(a, m, k, 0, c)
        np.testing.assert_array_equal(got.numpy(), want)
        assert torch.equal(_cluster_peel(a, m, k, 1, c)[0], one)


@functools.lru_cache(maxsize=None)
def _surrogate(name):
    """A Table 1 surrogate of 1024 vertices: (1, N, N) adj, (1, N) mask."""
    g = load_large_network(name, jax.random.PRNGKey(3), n_pad=1024)
    return np.array(g.adj), np.array(g.mask)


@pytest.mark.parametrize("name", ["com-youtube", "web-Stanford",
                                  "p2pGnutella31"])
def test_cluster_sweep_on_table1_surrogates(name):
    adj, alive = (x[0] for x in _surrogate(name))
    for k in (2, 3):
        _check_cluster_peel(adj, alive, k)


@pytest.mark.parametrize("n", [45, 100, 1000, 1056])
def test_cluster_sweep_on_ragged_random_graphs(n):
    rng = np.random.default_rng(n)
    adj = np.triu(rng.random((n, n)) < 5.0 / n, 1)
    adj = adj | adj.T
    alive = rng.random(n) < 0.9
    adj &= alive[:, None] & alive[None, :]
    for k in (2, 3, n + 1):
        _check_cluster_peel(adj, alive, k)


def test_cluster_sweep_sweeps_and_dead_graphs():
    rng = np.random.default_rng(5)
    n = 300
    adj = np.triu(rng.random((n, n)) < 4.0 / n, 1)
    adj = torch.from_numpy(adj | adj.T)
    alive = torch.ones(n, dtype=torch.bool)
    for c in (1, 2, 4, 8):
        # two sweeps are two plain sweeps; a converged mask stays as it is
        one = ref.kcore_peel_ref(adj[None], alive[None], 2)[0]
        two = ref.kcore_peel_ref(adj[None], one[None], 2)[0]
        assert torch.equal(_cluster_peel(adj, alive, 2, 2, c)[0], two)
        fix, s = _cluster_peel(adj, alive, 2, 0, c)
        again, s2 = _cluster_peel(adj, fix, 2, 5, c)
        assert torch.equal(again, fix) and s2 == 1 and s >= 2
        dead = torch.zeros(n, dtype=torch.bool)
        assert not bool(_cluster_peel(adj, dead, 2, 0, c)[0].any())
        assert not bool(_cluster_peel(adj, alive, n + 1, 0, c)[0].any())


def _nibble(v):
    """``csrc/kcore_peel.cu`` ``nibble``: the nonzero bytes of 32-bit words
    as 4 bits, through a per-byte compare (``__vcmpne4``) and a multiply
    that gathers the four byte flags into the top byte."""
    b = v.view(np.uint8).reshape(*v.shape, 4)
    ne = (b != 0).astype(np.uint32) * 0xFF
    flags = (ne[..., 0] | ne[..., 1] << 8 | ne[..., 2] << 16
             | ne[..., 3] << 24) & np.uint32(0x01010101)
    return (flags * np.uint32(0x01020408)) >> np.uint32(24)


@pytest.mark.parametrize("n", [16, 64, 320, 1040])
def test_pack_of_16_byte_loads_matches_the_rows(n):
    # two lanes read 16 columns each (four 32-bit words); their 16-bit
    # halves join into the row's 32-vertex word, bytes of any nonzero value
    # counting as edges; a half past N reads nothing
    rng = np.random.default_rng(n)
    rows = (rng.random((40, n)) < 0.3) * rng.integers(1, 256, (40, n))
    rows = rows.astype(np.uint8)
    w = (n + 31) // 32
    padded = np.zeros((40, 32 * w), np.uint8)
    padded[:, :n] = rows
    halves = []
    for half in range(2 * w):
        v = padded[:, 16 * half:16 * half + 16].copy().view(np.uint32)
        nib = _nibble(v)
        halves.append(nib[:, 0] | nib[:, 1] << 4 | nib[:, 2] << 8
                      | nib[:, 3] << 12)
    got = [halves[2 * x] | halves[2 * x + 1] << 16 for x in range(w)]
    want = _words(torch.from_numpy(rows != 0)).numpy()
    np.testing.assert_array_equal(np.stack(got, 1).astype(np.int64), want)


@pytest.mark.parametrize("b,n,sms,want", [
    (4096, 64, 132, 1),     # n64 serve rung: the batch fills the SMs
    (256, 320, 132, 1),     # DD rung
    (16, 1024, 132, 8),     # Table 1
    (17, 1024, 132, 4),
    (33, 1024, 132, 4),
    (66, 1024, 132, 2),
    (67, 1024, 132, 1),
    (1, 64, 132, 2),        # two words: a CTA keeps at least one
    (1, 32, 132, 1),
    (16, 1024, 8, 1),       # a card of 8 SMs
    (1, 1024, 8, 8),
    (2, 1024, 8, 4),
    (4096, 64, 8, 1),
])
def test_cluster_size_selector(b, n, sms, want):
    assert cluster_size(b, n, sms) == want


def _l1_layout(x, y, tile, chunks_per_round):
    """The kernel's L1 Gram in one layout: output tiles of ``tile`` rows and
    columns, zero-padded past M, N and D; each 16-wide D chunk's partial is
    0 plus its 16 terms in d order, and the partials are added to 0 in chunk
    order (``chunks_per_round`` = 1: after each chunk, as the 64 x 64
    layout does; 8: a round's partials stored, then added, as the
    small-grid layout does)."""
    (m, d), n = x.shape, y.shape[0]
    chunks = -(-d // 16)
    xp = torch.zeros((-(-m // tile) * tile, chunks * 16))
    yp = torch.zeros((-(-n // tile) * tile, chunks * 16))
    xp[:m, :d], yp[:n, :d] = x, y
    out = torch.empty((xp.shape[0], yp.shape[0]))
    for i0 in range(0, xp.shape[0], tile):
        for j0 in range(0, yp.shape[0], tile):
            a, b = xp[i0:i0 + tile], yp[j0:j0 + tile]
            acc = torch.zeros((tile, tile))
            for r0 in range(0, chunks, chunks_per_round):
                parts = []
                for q in range(r0, min(r0 + chunks_per_round, chunks)):
                    part = torch.zeros((tile, tile))
                    for c in range(16 * q, 16 * q + 16):
                        part = part + (a[:, None, c] - b[None, :, c]).abs()
                    parts.append(part)
                for part in parts:
                    acc = acc + part
            out[i0:i0 + tile, j0:j0 + tile] = acc
    return out[:m, :n]


@pytest.mark.parametrize("m,n,d", [(72, 72, 372), (33, 129, 17), (5, 70, 1),
                                   (65, 64, 200)])
def test_l1_chunk_order_is_the_same_in_both_layouts(m, n, d):
    rng = np.random.default_rng(m * n + d)
    x = torch.from_numpy(rng.uniform(0, 64, (m, d)).astype(np.float32))
    y = torch.from_numpy(rng.uniform(0, 64, (n, d)).astype(np.float32))
    big = _l1_layout(x, y, 64, 1)
    small = _l1_layout(x, y, 16, 8)
    assert torch.equal(big, small)
    # the same rows of a larger launch: an output depends on its rows only
    assert torch.equal(_l1_layout(x[m // 2:], y[:1], 16, 8),
                       big[m // 2:, :1])
    tol = 1e-5 * (x.abs().sum(1)[:, None] + y.abs().sum(1)[None, :]) + 1e-6
    want = torch.from_numpy(np.asarray(ref_j.pairwise_l1_ref(x.numpy(),
                                                             y.numpy())))
    assert bool(((big - want).abs() <= tol).all())
    assert bool(((big - ops.pairwise_l1(x, y)).abs() <= tol).all())


# ------------------------------------------------------------- domination

def _pair_of(p, tiles):
    """``csrc/domination.cu`` ``pair_of``: unordered tile pair p, iu <= iv."""
    iu, row = 0, tiles
    while p >= row:
        p, iu, row = p - row, iu + 1, row - 1
    return iu, iu + p


def _operands(adj, mask, np_):
    """The kernel's operands of each graph, zero past N: the (B, np, np)
    int8 A side, raw adjacency bytes with the diagonal byte set and then
    every column masked (the fragments after the diagonal byte and ``&
    m``), the B side, raw bytes with the diagonal set and no mask, and the
    (B, np) mask."""
    b, n = mask.shape
    raw = torch.zeros((b, np_, np_), dtype=torch.int8)
    raw[:, :n, :n] = adj.to(torch.int8)
    m = torch.zeros((b, np_), dtype=torch.int8)
    m[:, :n] = mask.to(torch.int8)
    side_b = raw | torch.eye(np_, dtype=torch.int8)
    return side_b & m[:, None, :], side_b, m


def _emulate_domination(adj, mask, lay):
    """One launch of the kernel at layout ``lay``, tile pair by tile pair:
    the int32 Gram of the masked A side against the raw B side over the
    kernel's K chunks (the whole padded K at once in the graph mapping,
    128 bytes a chunk in the tile mapping), d = the A side's row sums (the
    kernel's mma against ones) for the rows and, in the mirrored block of
    an off-diagonal pair, for the columns, and the comparison under both
    live bits.  The warp tiles split a pair without changing a sum."""
    b, n = mask.shape
    np_ = dm.padded(n)
    side_a, side_b, m = _operands(adj, mask, np_)
    live = m == 1
    k_chunk = np_ if lay.mapping == "graph" else dm.CHUNK
    tiles = -(-np_ // lay.tile)
    ones = torch.ones((b, 1, np_), dtype=torch.int8)
    vertex = torch.arange(np_)

    def gram(x, y):
        """int32 x @ y^T a graph, each K chunk's partial exact in float64
        (0/1 products, sums <= 1024), the partials added in int32."""
        acc = torch.zeros((b, x.shape[1], y.shape[1]), dtype=torch.int32)
        for k0 in range(0, np_, k_chunk):
            acc += torch.bmm(x[..., k0:k0 + k_chunk].double(),
                             y[..., k0:k0 + k_chunk].double().transpose(1, 2)
                             ).to(torch.int32)
        return acc

    out = torch.zeros((b, np_, np_), dtype=torch.bool)
    for p in range(tiles * (tiles + 1) // 2):
        iu, iv = _pair_of(p, tiles)
        us = slice(iu * lay.tile, min(np_, (iu + 1) * lay.tile))
        vs = slice(iv * lay.tile, min(np_, (iv + 1) * lay.tile))
        acc = gram(side_a[:, us], side_b[:, vs])
        both = (live[:, us, None] & live[:, None, vs]
                & (vertex[us, None] != vertex[None, vs]))
        out[:, us, vs] = both & (acc == gram(side_a[:, us], ones))
        if iu != iv:  # the mirrored block, against d of the v rows
            dv = gram(side_a[:, vs], ones)[..., 0]
            out[:, vs, us] = (both & (acc == dv[:, None, :])).transpose(1, 2)
    return out[:, :n, :n]


def _domination_writes(lay, b, n):
    """How often one launch at ``lay`` writes each (graph, u, v), CTA by
    CTA and warp tile by warp tile: the graph mapping's persistent CTAs
    take groups cta, cta + ctas, ... of ``graphs_per_cta`` graphs, a warp
    one 32 x 64 tile of one graph; the tile mapping's CTA one unordered
    tile pair, a warp one 32 x 64 tile of it, written twice (u, v) and
    (v, u) off the diagonal pairs."""
    np_ = dm.padded(n)
    writes = torch.zeros((b, n, n), dtype=torch.int32)

    def warp_tile(g, ra, rv, tv, mirror):
        us = torch.arange(ra, min(ra + 32, n))
        vs = torch.arange(rv, min(rv + (64 if rv + 32 < tv else 32), n))
        writes[g, us[:, None], vs[None, :]] += 1
        if mirror:
            writes[g, vs[:, None], us[None, :]] += 1

    if lay.mapping == "graph":
        gpc = lay.graphs_per_cta
        rbs, cbs = np_ // 32, -(-np_ // 64)
        assert gpc * rbs * cbs <= dm.WARPS  # one warp tile a warp
        for cta in range(lay.ctas):
            for grp in range(cta, -(-b // gpc), lay.ctas):
                for w in range(gpc * rbs * cbs):
                    s, r = divmod(w, rbs * cbs)
                    rb, cb = divmod(r, cbs)
                    if grp * gpc + s < b:
                        warp_tile(grp * gpc + s, rb * 32, cb * 64, np_, False)
        return writes
    tiles = -(-np_ // lay.tile)
    pairs = tiles * (tiles + 1) // 2
    assert lay.ctas == b * pairs
    for cta in range(lay.ctas):
        g, p = divmod(cta, pairs)
        iu, iv = _pair_of(p, tiles)
        tu = min(lay.tile, np_ - iu * lay.tile)
        tv = min(lay.tile, np_ - iv * lay.tile)
        rbs, cbs = tu // 32, -(-tv // 64)
        assert rbs * cbs <= dm.WARPS
        for w in range(rbs * cbs):
            rb, cb = divmod(w, cbs)
            warp_tile(g, iu * lay.tile + rb * 32, iv * lay.tile + cb * 64,
                      iv * lay.tile + tv, iu != iv)
    return writes


def _dom_graphs(b, n, p, seed, live=0.85):
    """Seeded symmetric graphs with dead vertices (edges at dead vertices
    kept: the kernel and the references mask them)."""
    rng = np.random.default_rng(seed)
    adj = np.triu(rng.random((b, n, n)) < p, 1)
    adj = adj | adj.transpose(0, 2, 1)
    mask = rng.random((b, n)) < live
    return adj, mask


def _dom_edge_graphs(n):
    """Five graphs of n vertices: complete (every live pair dominates both
    ways); twins 0 and 1 (a vertex and its copy, mutual); the twins with
    vertices 2 and 3 isolated (dominated by none, dominating none);
    complete with an all-dead mask (nothing); the twins with their upper
    half dead (edges to dead vertices kept)."""
    rng = np.random.default_rng(n)
    full = ~np.eye(n, dtype=bool)
    twins = np.triu(rng.random((n, n)) < 0.3, 1)
    twins = twins | twins.T
    twins[1] = twins[0]
    twins[:, 1] = twins[:, 0]
    twins[0, 1] = twins[1, 0] = True
    twins[0, 0] = twins[1, 1] = False
    lonely = twins.copy()
    lonely[2:4] = False
    lonely[:, 2:4] = False
    mask = np.ones((5, n), bool)
    mask[3] = False
    mask[4, n // 2:] = False
    return np.stack([full, twins, lonely, full, twins]), mask


_RANDOM_N = [1, 33, 64, 65, 128, 129, 320]
_EDGE_N = [7, 64, 96, 129]
_TABLE1 = "com-youtube"


@functools.lru_cache(maxsize=None)
def _dom_cases():
    """Every case by name: (adj, mask) numpy.  B = 5 is not a multiple of
    the graphs a CTA holds at N <= 64."""
    cases = {f"random{n}": _dom_graphs(5, n, min(0.5, 6.0 / n), seed=n)
             for n in _RANDOM_N}
    cases.update({f"edge{n}": _dom_edge_graphs(n) for n in _EDGE_N})
    cases[_TABLE1] = _surrogate(_TABLE1)
    return cases


@functools.lru_cache(maxsize=None)
def _repro_domination():
    """repro's answer on every case, by name.  The cases of N <= 128 go
    through one interpret-mode Pallas call at 128 vertices, the larger
    ones through one call of repro's reference at 1024: each graph padded
    with dead isolated vertices, which change no entry among its first N
    (every sum runs over live columns only), and the first N x N read
    back."""
    cases = _dom_cases()
    out = {}
    for small, pad in ((True, 128), (False, 1024)):
        names = [k for k, (_, m) in cases.items()
                 if (m.shape[1] <= 128) == small]
        total = sum(cases[k][1].shape[0] for k in names)
        adj = np.zeros((total, pad, pad), bool)
        mask = np.zeros((total, pad), bool)
        at = []
        for k in names:
            a, m = cases[k]
            b, n = m.shape
            i = sum(x[2] for x in at)
            adj[i:i + b, :n, :n], mask[i:i + b, :n] = a, m
            at.append((k, n, b))
        if small:
            got = np.asarray(ops_j.domination(
                jax.numpy.asarray(adj), jax.numpy.asarray(mask), tile=pad))
        else:
            got = np.asarray(jax.vmap(ref_j.domination_ref)(adj, mask))
        i = 0
        for k, n, b in at:
            out[k] = got[i:i + b, :n, :n]
            i += b
    return out


def _check_domination(name):
    """The emulated launch at the layout the selector picks, bitwise the
    port's plain version, which is bitwise repro's answer."""
    adj, mask = _dom_cases()[name]
    a, m = torch.from_numpy(adj), torch.from_numpy(mask)
    b, n = mask.shape
    want = ref.domination_ref(a, m)
    np.testing.assert_array_equal(want.numpy(), _repro_domination()[name])
    assert torch.equal(_emulate_domination(a, m, dm.layout(b, n, 132)),
                       want)
    return want


@pytest.mark.parametrize("n", _RANDOM_N)
def test_domination_gram_on_random_graphs(n):
    _check_domination(f"random{n}")


def test_domination_gram_on_a_table1_surrogate():
    _check_domination(_TABLE1)


@pytest.mark.parametrize("n", _EDGE_N)
def test_domination_gram_edge_cases(n):
    want = _check_domination(f"edge{n}")
    assert bool((want[0] == ~torch.eye(n, dtype=torch.bool)).all())
    assert bool(want[1, 0, 1]) and bool(want[1, 1, 0])
    assert not bool(want[2, 2].any()) and not bool(want[2, :, 3].any())
    assert not bool(want[3].any())


@pytest.mark.parametrize("b,n,sms,mapping,gpc,ctas", [
    (4096, 64, 132, "graph", 4, 264),  # n64 serve rung: 1024 groups
    (256, 320, 132, "tile", 1, 1536),  # DD rung: 6 pairs of 3 tiles
    (16, 1024, 132, "tile", 1, 576),   # Table 1: 36 pairs of 128 x 128
    (973, 128, 132, "graph", 1, 264),  # TWITTER
    (8, 128, 132, "graph", 1, 8),      # fig2
    (4096, 32, 132, "graph", 8, 264),
    (4096, 1, 132, "graph", 8, 264),
    (400, 64, 132, "graph", 2, 200),   # halved while groups < SMs
    (5, 64, 132, "graph", 1, 5),
    (3, 129, 132, "tile", 1, 9),       # past one tile
    (3, 2048, 132, "tile", 1, 408),
])
def test_domination_layout_selector(b, n, sms, mapping, gpc, ctas):
    lay = dm.layout(b, n, sms)
    assert (lay.mapping, lay.graphs_per_cta, lay.ctas) == (mapping, gpc,
                                                           ctas)
    assert lay.tile == (dm.padded(n) if mapping == "graph" else dm.TILE)
    assert lay.smem_bytes == dm.smem_bytes(n, gpc)
    assert lay.smem_bytes <= dm.DOUBLE_MAX  # two CTAs an SM


@pytest.mark.parametrize("b,n,sms", [
    (17, 32, 1),  # graph: a ragged last group, a CTA taking several
    (9, 64, 1),
    (3, 96, 1),
    (2, 129, 132),  # tile: ragged tiles, a mirrored pair
    (1, 320, 132),
])
def test_domination_layout_covers_every_entry_once(b, n, sms):
    lay = dm.layout(b, n, sms)
    if lay.mapping == "graph":
        assert lay.ctas < -(-b // lay.graphs_per_cta)
    assert bool((_domination_writes(lay, b, n) == 1).all())


def test_domination_smem_and_ctas():
    # every N the graph mapping takes, at the most graphs a CTA holds, and
    # the tile mapping past Table 1, fit two CTAs an SM
    for n in range(1, dm.GRAPH_MAX_NP + 1):
        lay = dm.layout(1 << 16, n, 132)
        assert lay.mapping == "graph" and lay.smem_bytes <= dm.DOUBLE_MAX
        per = lay.graphs_per_cta * dm.warp_tiles(lay.tile, lay.tile)
        assert per <= dm.WARPS < 2 * per  # as many graphs as the warps fit
    for n in (129, 1024, 4096):
        assert dm.layout(1, n, 132).smem_bytes <= dm.DOUBLE_MAX
    assert dm.layout(1, 8192, 132).smem_bytes <= dm.SMEM_MAX
    # the main path's shapes give a CTA an SM at least
    for b, n in ((4096, 64), (256, 320), (16, 1024)):
        assert dm.layout(b, n, 132).ctas >= 132


def _emulate_common_neighbors(adj, mask, lay, sums):
    """One launch of the common-neighbors kernel at layout ``lay``, tile
    pair by tile pair: the int32 Gram of the A side (raw adjacency bytes,
    every column masked with ``sums``) against the raw B side over the
    kernel's K chunks, and the edge bits A[u, v] read from the u rows at
    the v tile's columns.  The cn epilogue writes the counts where the bit
    is set, and their transpose in the mirrored block of an off-diagonal
    pair; the fused one adds each pair's row sums (bit, both live bits)
    into tri2 of its u rows and, off the diagonal, its column sums into
    tri2 of its v rows, and takes deg of a tile's rows (the masked A
    side's row sums, an mma against ones) from its diagonal pair.  Returns
    cn (B, N, N), or (tri2, deg) (B, N), int32."""
    b, n = mask.shape
    np_ = dm.padded(n)
    raw = torch.zeros((b, np_, np_), dtype=torch.int8)
    raw[:, :n, :n] = adj.to(torch.int8)
    m = torch.zeros((b, np_), dtype=torch.int8)
    m[:, :n] = mask.to(torch.int8)
    side_a = raw & m[:, None, :] if sums else raw
    k_chunk = np_ if lay.mapping == "graph" else dm.CHUNK
    tiles = -(-np_ // lay.tile)
    ones = torch.ones((b, 1, np_), dtype=torch.int8)

    def gram(x, y):
        acc = torch.zeros((b, x.shape[1], y.shape[1]), dtype=torch.int32)
        for k0 in range(0, np_, k_chunk):
            acc += torch.bmm(x[..., k0:k0 + k_chunk].double(),
                             y[..., k0:k0 + k_chunk].double().transpose(1, 2)
                             ).to(torch.int32)
        return acc

    out = torch.zeros((b, np_, np_), dtype=torch.int32)
    tri2 = torch.zeros((b, np_), dtype=torch.int32)
    deg = torch.zeros((b, np_), dtype=torch.int32)
    for p in range(tiles * (tiles + 1) // 2):
        iu, iv = _pair_of(p, tiles)
        us = slice(iu * lay.tile, min(np_, (iu + 1) * lay.tile))
        vs = slice(iv * lay.tile, min(np_, (iv + 1) * lay.tile))
        kept = torch.where(raw[:, us, vs] != 0,
                           gram(side_a[:, us], raw[:, vs]), 0)
        if not sums:
            out[:, us, vs] = kept
            if iu != iv:
                out[:, vs, us] = kept.transpose(1, 2)
            continue
        kept = kept * m[:, us, None] * m[:, None, vs]
        tri2[:, us] += kept.sum(-1, dtype=torch.int32)
        if iu != iv:
            tri2[:, vs] += kept.sum(-2, dtype=torch.int32)
        else:
            deg[:, us] = gram(side_a[:, us], ones)[..., 0] * m[:, us]
    if sums:
        return tri2[:, :n], deg[:, :n]
    return out[:, :n, :n]


def _cn_gathers(lay, b, n):
    """How often one fused launch at ``lay`` gathers each (graph, u, v)
    into a row sum, and writes each deg[u]: the pairs as the cn epilogue
    writes them (``_domination_writes``: the two kernels share their
    mappings), deg as the kernel's warps write it.  A CTA's warp w takes
    warp tile r = w - s rbs cbs of graph s = w // (rbs cbs) of its group
    (the tile mapping: of its pair, s = 0), rows 32 (r // cbs).., columns
    64 (r % cbs)..; rbs = rows / 32 and cbs = ceil(columns / 64) of the
    CTA's tile; warps past gpc rbs cbs idle.  Only the warps of column
    block 0 write deg, and in the tile mapping only in a diagonal pair
    (every pair of the graph mapping is one)."""
    np_ = dm.padded(n)
    degs = torch.zeros((b, np_), dtype=torch.int32)

    def warp_rows(gpc, tu, tv):
        """(s, first row) of each warp that writes deg, rows within the
        u tile."""
        rbs, cbs = tu // 32, -(-tv // 64)
        for w in range(dm.WARPS):
            if w < gpc * rbs * cbs:
                s, r = divmod(w, rbs * cbs)
                rb, cb = divmod(r, cbs)
                if cb == 0:
                    yield s, rb * 32

    if lay.mapping == "graph":
        gpc = lay.graphs_per_cta
        for cta in range(lay.ctas):
            for grp in range(cta, -(-b // gpc), lay.ctas):
                for s, ra in warp_rows(gpc, np_, np_):
                    if grp * gpc + s < b:
                        degs[grp * gpc + s, ra:ra + 32] += 1
    else:
        tiles = -(-np_ // lay.tile)
        pairs = tiles * (tiles + 1) // 2
        for cta in range(lay.ctas):
            g, p = divmod(cta, pairs)
            iu, iv = _pair_of(p, tiles)
            if iu == iv:
                tu = min(lay.tile, np_ - iu * lay.tile)
                for _, ra in warp_rows(1, tu, tu):
                    u0 = iu * lay.tile + ra
                    degs[g, u0:u0 + 32] += 1
    return _domination_writes(lay, b, n), degs[:, :n]


def _cn_edge_graphs(n):
    """Five graphs of n vertices: complete and empty with every vertex
    live, complete with its upper half dead, complete with every vertex
    dead, and a star (no triangle) with its centre live."""
    full = ~np.eye(n, dtype=bool)
    star = np.zeros((n, n), bool)
    star[0, 1:] = star[1:, 0] = True
    mask = np.ones((5, n), bool)
    mask[2, n // 2:] = False
    mask[3] = False
    return np.stack([full, np.zeros_like(full), full, full, star]), mask


_CN_EDGE_N = [7, 64, 129]


@functools.lru_cache(maxsize=None)
def _cn_cases():
    """Every case by name: (adj, mask) numpy, symmetric, with dead vertices
    whose edges are kept."""
    cases = {f"random{n}": _dom_graphs(5, n, min(0.5, 8.0 / n), seed=n + 7)
             for n in _RANDOM_N}
    cases.update({f"edge{n}": _cn_edge_graphs(n) for n in _CN_EDGE_N})
    return cases


@functools.lru_cache(maxsize=None)
def _repro_common_neighbors():
    """repro's answer on every case, by name: its interpret-mode Pallas
    kernel's counts of the raw adjacency, the same kernel's counts of the
    live-restricted adjacency summed over rows with its degrees (the sums
    ``repro``'s ``clustering_coefficients`` divides), and those
    coefficients.  The cases of N <= 128 run as one batch padded to 128
    vertices with dead isolated ones, which change no entry among the first
    N; the others at their own N."""
    cases = _cn_cases()
    out = {}
    small = [k for k, (_, m) in cases.items() if m.shape[1] <= 128]
    groups = [small] + [[k] for k in cases if k not in small]
    for names in groups:
        pad = max(cases[k][1].shape[1] for k in names)
        pad = 128 if names is small else pad
        total = sum(cases[k][1].shape[0] for k in names)
        adj = np.zeros((total, pad, pad), bool)
        mask = np.zeros((total, pad), bool)
        at, i = [], 0
        for k in names:
            a, m = cases[k]
            bk, n = m.shape
            adj[i:i + bk, :n, :n], mask[i:i + bk, :n] = a, m
            at.append((k, n, i, bk))
            i += bk
        aj, mj = jax.numpy.asarray(adj), jax.numpy.asarray(mask)
        live = aj & mj[:, None, :] & mj[:, :, None]
        cn = np.asarray(ops_j.common_neighbors(aj, tile=128))
        tri2 = np.asarray(ops_j.common_neighbors(live, tile=128).sum(-1))
        deg = np.asarray(live.sum(-1))
        cc = np.asarray(ops_j.clustering_coefficients(aj, mj, tile=128))
        for k, n, i, bk in at:
            out[k] = (cn[i:i + bk, :n, :n], tri2[i:i + bk, :n],
                      deg[i:i + bk, :n], cc[i:i + bk, :n])
    return out


def _check_common_neighbors(name):
    """Both epilogues, emulated at the layout the selector picks, bitwise
    the port's plain versions, which are bitwise repro's counts, sums and
    coefficients."""
    adj, mask = _cn_cases()[name]
    a, m = torch.from_numpy(adj), torch.from_numpy(mask)
    b, n = mask.shape
    cn_j, tri2_j, deg_j, cc_j = _repro_common_neighbors()[name]
    want = ref.common_neighbors_ref(a)
    np.testing.assert_array_equal(want.numpy(), cn_j)
    assert torch.equal(
        _emulate_common_neighbors(a, m, cn.layout(b, n, 132), False), want)
    tri2, deg = ref.common_neighbors_rowsums_ref(a, m)
    np.testing.assert_array_equal(tri2.numpy(), tri2_j)
    np.testing.assert_array_equal(deg.numpy(), deg_j)
    got = _emulate_common_neighbors(a, m, cn.layout(b, n, 132, sums=True),
                                    True)
    assert torch.equal(got[0], tri2) and torch.equal(got[1], deg)
    cc = ops.clustering_from_sums(*got, m)
    np.testing.assert_array_equal(cc.numpy(), cc_j)
    assert torch.equal(cc, ops.clustering_coefficients(a, m))
    return want, got


@pytest.mark.parametrize("n", _RANDOM_N)
def test_common_neighbors_gram_on_random_graphs(n):
    _check_common_neighbors(f"random{n}")


@pytest.mark.parametrize("n", _CN_EDGE_N)
def test_common_neighbors_gram_edge_cases(n):
    cn_, (tri2, deg) = _check_common_neighbors(f"edge{n}")
    full = ~torch.eye(n, dtype=torch.bool)
    assert bool((cn_[0][full] == n - 2).all()) and not bool(cn_[1].any())
    live = n // 2
    assert tri2[0].tolist() == [(n - 1) * (n - 2)] * n
    assert deg[0].tolist() == [n - 1] * n
    assert tri2[2, :live].tolist() == [(live - 1) * (live - 2)] * live
    assert not bool(tri2[2, live:].any()) and not bool(deg[2, live:].any())
    assert not bool(tri2[1].any()) and not bool(tri2[3].any())
    assert not bool(deg[3].any()) and not bool(tri2[4].any())
    assert deg[4].tolist() == [n - 1] + [1] * (n - 1)


@pytest.mark.parametrize("b,n,sms,mapping,gpc,ctas", [
    (4096, 64, 132, "graph", 4, 264),  # clustering_n64
    (16, 1024, 132, "tile", 1, 576),   # clustering_n1024 (Table 1)
    (973, 128, 132, "graph", 1, 264),  # clustering_twitter
    (8, 128, 132, "graph", 1, 8),      # fig2
    (4096, 32, 132, "graph", 8, 264),
    (5, 64, 132, "graph", 1, 5),
    (3, 129, 132, "tile", 1, 9),
    (3, 2048, 132, "tile", 1, 408),
])
def test_common_neighbors_layout_selector(b, n, sms, mapping, gpc, ctas):
    for sums in (False, True):
        lay = cn.layout(b, n, sms, sums=sums)
        assert (lay.mapping, lay.graphs_per_cta, lay.ctas) == (mapping, gpc,
                                                               ctas)
        assert lay.smem_bytes == cn.smem_bytes(n, gpc, sums)
        assert lay.smem_bytes <= dm.DOUBLE_MAX  # two CTAs an SM


def test_common_neighbors_smem_up_to_2048():
    # every N the graph mapping takes, at the most graphs a CTA holds, and
    # the tile mapping up to the card checks' 2048, fit two CTAs an SM in
    # both epilogues; the counts' staging fits the ring it reuses
    for sums in (False, True):
        for n in range(1, 2049):
            lay = cn.layout(1 << 16, n, 132, sums=sums)
            assert lay.smem_bytes <= dm.DOUBLE_MAX, (n, sums)
    ring = dm.STAGES * 2 * dm.TILE * (dm.CHUNK + dm.PAD)
    assert 4 * dm.TILE * (dm.TILE + cn.OUT_PAD) <= ring
    with pytest.raises(ValueError, match=r"\(1, 200000\)"):
        cn.layout(1, 200000, 132, sums=True)
    # past SUMS_MAX_N the fused epilogue's int32 tri2 could overflow
    assert cn.layout(1, cn.SUMS_MAX_N, 132, sums=True).mapping == "tile"
    with pytest.raises(ValueError, match=r"overflow.*\(1, 46341\)"):
        cn.layout(1, cn.SUMS_MAX_N + 1, 132, sums=True)
    assert cn.layout(1, cn.SUMS_MAX_N + 1, 132).mapping == "tile"


@pytest.mark.parametrize("b,n,sms", [
    (17, 32, 1),  # graph: a ragged last group, a CTA taking several
    (9, 64, 1),
    (3, 96, 1),
    (2, 129, 132),  # tile: ragged tiles, a mirrored pair
    (1, 320, 132),
])
def test_common_neighbors_layout_gathers_every_sum_once(b, n, sms):
    lay = cn.layout(b, n, sms, sums=True)
    pairs, degs = _cn_gathers(lay, b, n)
    assert bool((pairs == 1).all()) and bool((degs == 1).all())
    assert cn.layout(b, n, sms) == lay._replace(
        smem_bytes=cn.smem_bytes(n, lay.graphs_per_cta, False))
