"""The gf2_reduce kernel's step loop and layouts, emulated on the CPU.

The CUDA kernel (``src/repro_torch/csrc/gf2_reduce.cu``) runs only on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).  What its design
must preserve is checked here in torch, with zero tolerance:

* Staging finds one past each matrix's last nonzero column (``se``): per
  chunk of 4 words (or 1) the highest nonzero word, and in each aligned
  group of 32 chunks (a warp) one atomicMax per matrix, from the highest
  lane of that matrix whose chunk is nonzero.  The emulation follows the
  CTAs of the selector's layout and is held against a direct scan.
* The chase runs to ``se`` only, one step a loop iteration: a step takes
  low of the working column and reads the pivot table once, then XORs or
  ends the column (claims the row, or leaves an empty column positive) and
  advances.  "thread" (W <= 4) takes low as the top bit of the highest
  nonzero of four words and keeps a table of 4-word rows indexed by row
  (a column that claims nothing stores into a spare row); "segment" takes
  low by a ballot of nonzero words, the top lane and a shuffle of its bit,
  with a table of W-word rows; "warp" and "global" keep the column in
  memory and an owner-indexed table, low by a max over the lanes' words.
  Each emulation is held bitwise against ``ref.gf2_reduce_ref`` (reduced
  matrix, owner, positive) and, on ``repro``'s own blocks, against
  ``repro``'s ``reduce_packed``; its step count equals ``se`` + the
  additions ``ref.gf2_reduce_counted`` makes.
* ``layout`` picks each kind where it should, and its shared memory fits
  227 KB at the main path's recorded shapes.

Inputs: ``repro``'s ``pack_boundary_blocks`` on the complexes of each rung
that the n64 plan gives a small seeded batch, random sparse blocks with
bit-31 rows, zero matrices, R < S, W up to 33.  ``repro``'s interpret-mode
Pallas gf2 kernel is not used: it fails on this jax (``pl.load``).
"""
import jax
import numpy as np
import pytest
import torch

from repro.core.filtration import build_filtered_complex as build_fc_j
from repro.core.persistence_jax import (
    pack_boundary_blocks as pack_blocks_j,
    reduce_packed as reduce_packed_j,
)
from repro_torch.core import persistence
from repro_torch.core.api import make_topo_plan
from repro_torch.data.graphs import (
    attach_satellites, erdos_renyi, with_degree_filtration)
from repro_torch.kernels import gf2_reduce as gf2
from repro_torch.kernels import ref

MASK32 = 0xFFFFFFFF


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file: its many small torch ops gain
    nothing from threads, and when test files run in parallel worker
    processes, threads in every worker oversubscribe the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _u(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> their unsigned values as int64."""
    return x.to(torch.int64) & MASK32


def _i32(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def _hibit(v: torch.Tensor) -> torch.Tensor:
    """Highest set bit of unsigned 32-bit values in int64 (31 - __clz), or
    -1 for 0."""
    e = torch.frexp(v.to(torch.float64)).exponent.to(torch.int64) - 1
    return torch.where(v != 0, e, -1)


def _last_nonzero(b: torch.Tensor) -> torch.Tensor:
    """One past each matrix's last nonzero column, directly."""
    nz = (b != 0).any(-1)
    return torch.where(nz.any(-1), b.shape[1] - nz.flip(-1).int().argmax(-1),
                       0).long()


# ------------------------------------------------------------- staging

def _staged_se(b: torch.Tensor, lay: gf2.Layout) -> torch.Tensor:
    """``se`` as the kernel's staging finds it, CTA by CTA: chunks of 4
    words where S*W % 4 == 0 (else 1), aligned groups of 32 chunks, one
    atomicMax per (group, matrix) by the matrix's top nonzero lane."""
    g, s, w = b.shape
    sw = s * w
    v = 4 if sw % 4 == 0 else 1
    se = torch.zeros(g, dtype=torch.int64)
    for cta in range(lay.ctas):
        g0 = cta * lay.matrices_per_cta
        mm = min(lay.matrices_per_cta, g - g0)
        n = mm * sw // v
        if n == 0:
            continue
        chunks = _u(b[g0:g0 + mm]).reshape(n, v)
        nzw = chunks != 0
        hi = torch.where(nzw.any(-1), v - 1 - nzw.flip(-1).int().argmax(-1),
                         -1)
        pad = -n % 32
        i = torch.arange(n + pad)
        hi = torch.cat([hi, torch.full((pad,), -1)]).view(-1, 32)
        m = (i * v // sw).view(-1, 32)
        lanes = torch.arange(32)
        nz = hi >= 0
        # lane l is its matrix's top nonzero lane: no nonzero lane above it
        # in the group holds the same matrix
        same = m[:, :, None] == m[:, None, :]
        above = lanes[None, None, :] > lanes[None, :, None]
        top = nz & ~(same & above & nz[:, None, :]).any(-1)
        col = (i.view(-1, 32) * v + hi - m * sw) // max(w, 1)
        se[g0:g0 + mm] = se[g0:g0 + mm].scatter_reduce(
            0, m[top], col[top] + 1, "amax")
    return se


# ---------------------------------------------------------- the chases

def _low_thread(col: torch.Tensor) -> torch.Tensor:
    """low4: the top set bit of the highest nonzero of four words."""
    hb = _hibit(col)
    low = torch.full(col.shape[:1], -1, dtype=torch.int64)
    for k in range(4):  # later words win, as the select chain's order
        low = torch.where(col[:, k] != 0, 32 * k + hb[:, k], low)
    return low


def _low_segment(col: torch.Tensor) -> torch.Tensor:
    """A segment's low: lane k's bit (k << 5) + 31 - clz, the ballot of
    nonzero words, its top lane, and a shuffle from it (from the lane
    itself, whose bit is -1, when the ballot is empty)."""
    lanes = col.shape[1]
    k = torch.arange(lanes)
    best = torch.where(col != 0, (k << 5) + _hibit(col), -1)
    ballot = ((col != 0).long() << k).sum(-1)
    top = torch.where(ballot != 0, _hibit(ballot), 0)
    return best.gather(1, top[:, None]).squeeze(1)


def _chase_registers(b, r, se, kind, lanes):
    """The thread and segment layouts: the working column in registers (4
    words, or ``lanes`` words with W <= lanes), a table of reduced columns
    indexed by row, zero while the row is unclaimed, the next column
    prefetched.  Returns (reduced, owner, positive, steps) per matrix."""
    g, s, w = b.shape
    width = 4 if kind == "thread" else lanes
    assert w <= width
    low_of = _low_thread if kind == "thread" else _low_segment
    cols = torch.zeros((g, s + 2, width), dtype=torch.int64)
    cols[:, :s, :w] = _u(b)
    dst = _u(b).clone()
    piv = torch.zeros((g, r + 1, width), dtype=torch.int64)
    owner = torch.full((g, r), -1, dtype=torch.int64)
    pos = torch.ones((g, s), dtype=torch.bool)
    rows = torch.arange(g)
    j = torch.zeros(g, dtype=torch.int64)
    col = torch.where((se > 0)[:, None], cols[:, 0], 0)
    nxt = torch.where((se > 1)[:, None], cols[:, 1], 0)
    mod = torch.zeros(g, dtype=torch.bool)
    steps = torch.zeros(g, dtype=torch.int64)
    while True:
        act = j < se
        if not bool(act.any()):
            break
        steps += act
        low = low_of(col)
        live = act & (low >= 0) & (low < r)
        p = torch.where(live[:, None], piv[rows, low.clamp(0, r)], 0)
        claimed = (p != 0).any(-1)
        col = torch.where(claimed[:, None], col ^ p, col)
        mod |= claimed
        fin = act & ~claimed
        c = fin & live
        piv[rows[c], low[c]] = col[c]
        owner[rows[c], low[c]] = j[c]
        pos[rows[c], j[c]] = False
        wr = fin & mod
        dst[rows[wr], j[wr]] = col[wr, :w]
        j = j + fin
        col = torch.where(fin[:, None], nxt, col)
        mod &= ~fin
        ahead = fin & (j + 1 < se)
        nxt = torch.where(ahead[:, None],
                          cols[rows, (j + 1).clamp(max=s + 1)], nxt)
    return _i32(dst), owner.int(), pos, steps


def _chase_memory(b, r, se, in_place):
    """The warp and global layouts: the working column in memory (staged,
    or the output itself), lane i holding words i, i+32, ...; low the max
    of the lanes' bits; an owner-indexed table."""
    g, s, w = b.shape
    m = _u(b).clone()
    dst = m if in_place else _u(b).clone()
    table = torch.full((g, r + 1), -1, dtype=torch.int64)
    owner = torch.full((g, r), -1, dtype=torch.int64)
    pos = torch.ones((g, s), dtype=torch.bool)
    rows = torch.arange(g)
    x = -(-w // 32)
    word = torch.arange(32 * x).view(x, 32)  # word x*32 + lane
    j = torch.zeros(g, dtype=torch.int64)
    mod = torch.zeros(g, dtype=torch.bool)
    steps = torch.zeros(g, dtype=torch.int64)
    while s:
        act = j < se
        if not bool(act.any()):
            break
        steps += act
        jj = j.clamp(max=s - 1)
        col = torch.zeros((g, 32 * x), dtype=torch.int64)
        col[:, :w] = m[rows, jj]
        col = col.view(g, x, 32)
        bits = torch.where(col != 0, (word << 5) + _hibit(col), -1)
        low = bits.max(1).values.max(-1).values  # per lane, then the warp
        live = act & (low >= 0) & (low < r)
        piv = torch.where(live, table[rows, low.clamp(0, r)], -1)
        xor = act & (piv >= 0)
        m[rows[xor], jj[xor]] ^= m[rows[xor], piv[xor]]
        mod |= xor
        fin = act & ~xor
        c = fin & live
        table[rows[c], low[c]] = j[c]
        owner[rows[c], low[c]] = j[c]
        pos[rows[c], j[c]] = False
        wr = fin & mod
        if not in_place:
            dst[rows[wr], j[wr]] = m[rows[wr], j[wr]]
        j = j + fin
        mod &= ~fin
    return _i32(dst), owner.int(), pos, steps


def emulate(b: torch.Tensor, r: int, lay: gf2.Layout):
    """The kernel's outputs and step counts for one block at ``lay``."""
    se = _staged_se(b, lay)
    if lay.kind in ("thread", "segment"):
        return (*_chase_registers(b, r, se, lay.kind, lay.lanes), se)
    return (*_chase_memory(b, r, se, lay.kind == "global"), se)


def _check(b, r, lay):
    """The emulation at ``lay`` against the plain version, bitwise, and
    its steps against se + additions; returns its outputs."""
    red, owner, pos, steps, se = emulate(b, r, lay)
    want_red, want_owner, want_pos, adds = ref.gf2_reduce_counted(b, r)
    assert torch.equal(red, want_red)
    assert torch.equal(owner, want_owner)
    assert torch.equal(pos, want_pos)
    assert torch.equal(se, _last_nonzero(b))
    assert torch.equal(steps, se + adds)
    return owner, pos


def _kinds(w):
    """Every layout that can hold W words a column, with its lanes."""
    out = [("warp", 32), ("global", 32)]
    if w <= 4:
        out.append(("thread", 32))
    out += [("segment", lanes) for lanes in (8, 16, 32) if w <= lanes]
    return out


def _at(kind, lanes, g, mpc):
    return gf2.Layout(kind, lanes, mpc, -(-g // mpc), 0)


# ------------------------------------------------------------- inputs

def _sparse(g, s, w, r, seed, per_col=3, bit31=True, zero_from=None):
    """Sparse random packed columns with rows < r; a third carry a row
    31 mod 32 (the sign bit) where r allows; columns from ``zero_from``
    on are zero."""
    rng = np.random.default_rng(seed)
    dense = np.zeros((g, s, w * 32), bool)
    if r:
        np.put_along_axis(dense, rng.integers(0, r, size=(g, s, per_col)),
                          True, axis=-1)
        if bit31 and r >= 32:
            hi = 31 + 32 * rng.integers(0, r // 32, size=(g, s))
            dense[:, ::3] |= np.eye(w * 32, dtype=bool)[hi[:, ::3]]
    if zero_from is not None:
        dense[:, zero_from:] = False
    words = (dense.reshape(g, s, w, 32).astype(np.uint64)
             << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)
    return torch.from_numpy(words.view(np.int32))


def _rung_complexes():
    """(adj, mask, f, caps) of each rung the n64 plan (repack on, caps
    320/512) gives a small seeded ER(56, 0.05) + satellites batch on the
    CPU."""
    seen = []
    build = persistence.build_filtered_complex

    def record(adj, mask, f, max_dim, e, t, q, sub):
        seen.append((adj.clone(), mask.clone(), f.clone(),
                     [adj.shape[-1], e, t]))
        return build(adj, mask, f, max_dim, e, t, q, sub)

    core = erdos_renyi(7, 96, 64, 56, 0.05, device="cpu")
    g = with_degree_filtration(attach_satellites(8, core, 0.5))
    plan = make_topo_plan(dim=1, method="both", repack="on", edge_cap=320,
                          tri_cap=512)
    persistence.build_filtered_complex = record
    try:
        plan.execute_info(g)
    finally:
        persistence.build_filtered_complex = build
    return seen


_RUNGS = {}


def _rung_blocks():
    """repro's pack_boundary_blocks of every rung's complexes: a list of
    (name, u32 block, R), recomputed once per process."""
    if not _RUNGS:
        for adj, mask, f, caps in _rung_complexes():
            @jax.jit
            @jax.vmap
            def blocks(a, m, f_, caps=caps):
                fc = build_fc_j(a, m, f_, 1, caps[1], caps[2])
                return pack_blocks_j(fc, caps)[0]

            for d, blk in enumerate(blocks(adj.numpy(), mask.numpy(),
                                           f.numpy())):
                _RUNGS[f"n{caps[0]}_d{d + 1}"] = (np.asarray(blk), caps[d])
    return _RUNGS


# ---------------------------------------------------------------- tests

def test_rungs_cover_three_blocks_of_the_n64_plan():
    names = sorted(_rung_blocks())
    assert names == ["n16_d1", "n16_d2", "n32_d1", "n32_d2", "n8_d1",
                     "n8_d2"]
    widths = {name: blk.shape[-1] for name, (blk, _) in _rung_blocks().items()}
    assert widths == {"n8_d1": 1, "n8_d2": 1, "n16_d1": 1, "n16_d2": 4,
                      "n32_d1": 1, "n32_d2": 8}


@pytest.mark.parametrize("sms", [132, 8])
@pytest.mark.parametrize("name", ["n8_d1", "n8_d2", "n16_d1", "n16_d2",
                                  "n32_d1", "n32_d2"])
def test_step_loop_on_repro_rung_blocks(name, sms):
    """Each rung block of repro's packing, at the layout the selector picks
    and at every other layout that holds it: bitwise the plain version and
    repro's reduce_packed, steps = se + additions."""
    blk, r = _rung_blocks()[name]
    b = torch.from_numpy(blk.view(np.int32).copy())
    g, s, w = b.shape
    lay = gf2.layout(g, s, w, r, sms)
    assert lay.kind == ("thread" if w <= 4 else "segment")
    owner, pos = _check(b, r, lay)
    own_j, pos_j = jax.jit(jax.vmap(lambda x: reduce_packed_j(x, r)))(blk)
    np.testing.assert_array_equal(owner.numpy(), np.asarray(own_j))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(pos_j))
    for kind, lanes in _kinds(w):
        _check(b, r, _at(kind, lanes, g, lay.matrices_per_cta))


@pytest.mark.parametrize("w", [1, 2, 4, 5, 8, 16, 32, 33])
def test_step_loop_every_layout_of_each_width(w):
    """Random sparse blocks with bit-31 rows up to the top word, at every
    layout that can hold W words; staging with 1 and 3 matrices a CTA."""
    r = 32 * w - 5
    b = _sparse(5, 48, w, r, seed=w)
    for kind, lanes in _kinds(w):
        _check(b, r, _at(kind, lanes, 5, 1))
    assert torch.equal(_staged_se(b, _at("thread", 32, 5, 3)),
                       _last_nonzero(b))


def test_step_loop_bit31_columns_against_reduce_packed():
    """Every column's low on a sign bit: held against repro too."""
    g, s, w, r = 3, 40, 3, 96
    rng = np.random.default_rng(31)
    u32 = np.zeros((g, s, w), np.uint32)
    u32[:, :, :] = rng.integers(0, 2 ** 31, size=(g, s, w), dtype=np.uint32)
    u32[:, :, -1] |= np.uint32(1 << 31)
    b = torch.from_numpy(u32.view(np.int32).copy())
    lay = gf2.layout(g, s, w, r, 132)
    owner, pos = _check(b, r, lay)
    own_j, pos_j = jax.jit(jax.vmap(lambda x: reduce_packed_j(x, r)))(u32)
    np.testing.assert_array_equal(owner.numpy(), np.asarray(own_j))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(pos_j))
    for kind, lanes in _kinds(w):
        _check(b, r, _at(kind, lanes, g, 2))


@pytest.mark.parametrize("case", ["zero", "last_column", "one_column",
                                  "no_rows", "zero_tail"])
def test_step_loop_edge_matrices(case):
    """All-zero matrices, a last nonzero column that is the last, S = 1,
    R = 0 (every column empty), and zero columns past a ragged end."""
    if case == "zero":
        b = torch.zeros((4, 24, 2), dtype=torch.int32)
        r = 50
    elif case == "last_column":
        b = _sparse(4, 24, 2, 50, seed=2, zero_from=None)
        b[:, -1] = 0
        b[:, -1, 1] = 1 << 17  # row 49, claimed by the last column
        r = 50
    elif case == "one_column":
        b = _sparse(4, 1, 2, 50, seed=3)
        r = 50
    elif case == "no_rows":
        b = torch.zeros((4, 8, 1), dtype=torch.int32)
        r = 0
    else:
        b = _sparse(6, 30, 1, 20, seed=4, zero_from=11)
        b[2] = 0
        r = 20
    g, s, w = b.shape
    for kind, lanes in _kinds(w):
        for mpc in (1, 4):
            _check(b, r, _at(kind, lanes, g, mpc))
    if case == "last_column":
        assert torch.equal(_last_nonzero(b), torch.full((4,), 24))


def test_staging_groups_straddle_matrices():
    """Chunks of several matrices share a warp's group of 32 (S*W = 28
    words, 7 chunks a matrix; and S*W = 9, one word a chunk): the top-lane
    atomics still find every matrix's last nonzero column."""
    for g, s, w, r in ((40, 28, 1, 8), (40, 9, 1, 20)):
        b = _sparse(g, s, w, r, seed=s, per_col=1)
        keep = torch.from_numpy(np.random.default_rng(s).random((g, s))
                                < 0.4)
        b = torch.where(keep[..., None], b, 0)
        for mpc in (1, 5, 13, 40):
            lay = _at("thread", 32, g, mpc)
            assert torch.equal(_staged_se(b, lay), _last_nonzero(b))


# the main path's recorded blocks (G, S, W, R) and the layout each takes on
# 132 SMs: the n64 rungs 8, 16, 32, the n320 rung, the flat n64 reducer,
# a wide block, and chip_smoke's and the card tests' blocks past shared
# memory
_RECORDED = [
    ((3372, 28, 1, 8), ("thread", 32, 4, 843)),
    ((3372, 56, 1, 28), ("thread", 32, 4, 843)),
    ((689, 120, 1, 16), ("thread", 32, 4, 173)),
    ((689, 128, 4, 120), ("thread", 32, 4, 173)),
    ((35, 256, 1, 32), ("thread", 32, 1, 35)),
    ((35, 256, 8, 256), ("segment", 8, 1, 35)),
    ((253, 512, 4, 128), ("thread", 32, 2, 127)),
    ((253, 128, 16, 512), ("segment", 16, 2, 127)),
    ((64, 896, 28, 896), ("segment", 32, 1, 64)),
    ((4, 200, 40, 1280), ("warp", 32, 1, 4)),
    ((8, 4096, 128, 4096), ("global", 32, 1, 8)),
    ((2, 1024, 64, 2048), ("global", 32, 1, 2)),
]


@pytest.mark.parametrize("shape,want", _RECORDED,
                         ids=["x".join(map(str, s)) for s, _ in _RECORDED])
def test_layout_selector_and_shared_memory(shape, want):
    g, s, w, r = shape
    lay = gf2.layout(g, s, w, r, 132)
    assert (lay.kind, lay.lanes, lay.matrices_per_cta, lay.ctas) == want
    assert lay.smem_bytes == gf2.smem_bytes(lay.kind, lay.matrices_per_cta,
                                            s, w, r)
    assert lay.smem_bytes <= gf2.SMEM_MAX
    assert lay.matrices_per_cta * lay.lanes <= gf2.THREADS
    if lay.kind != "global":  # one more matrix would not fit, or not help
        more = gf2.smem_bytes(lay.kind, lay.matrices_per_cta + 1, s, w, r)
        assert (more > gf2.SMEM_MAX
                or lay.matrices_per_cta >= -(-g // 132)
                or (lay.matrices_per_cta + 1) * lay.lanes > gf2.THREADS)


def test_layout_global_past_shared_memory_emulated():
    """A block whose matrix alone passes 227 KB takes the global layout;
    its emulation (in place, owner as the table) is bitwise."""
    g, s, w, r = 2, 1024, 64, 2048
    lay = gf2.layout(g, s, w, r, 132)
    assert lay.kind == "global"
    _check(_sparse(g, s, w, r, seed=9, per_col=2), r, lay)
