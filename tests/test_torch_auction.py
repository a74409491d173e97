"""The port's auction solvers, exact Wasserstein and bottleneck distances
and price cache against ``repro``.

Both packages get the same numpy-made inputs and run on the CPU; ``repro``'s
solvers run under ``jax.vmap`` and its Pallas kernels in interpret mode, as
its own tests run them.

What is held bitwise and what within a tolerance, and why:

* bitwise: assignments, ``p2o``, prices, convergence flags and round
  counts of the plain solvers against ``repro``'s (the same float32
  operations in the same order, round for round), the expanded assignment,
  the cost surfaces against ``repro``'s jitted ``cloud_costs`` (the port
  forms XLA's fused multiply-add and reciprocal multiply itself), the price
  cache and the self-distance (0.0).
* totals within ``metrics.testing.AUCTION_TOTAL_TOLERANCE``: f32 sums of
  the same terms in another order.
* distances within 1e-5 of the Hungarian oracle (``metrics_bench``'s gate)
  and of ``repro`` where ``repro`` itself is within 1e-5 of the oracle: the
  port sums ``W^q`` from the matched costs in float64 where ``repro`` adds a
  float32 base to the reduced total; the bottleneck within max(1e-4,
  1e-4·ref) of the oracle, ``metrics_bench``'s gate.

``repro``'s ``ops.auction_lap_collapsed`` reads ``rev_every`` from its
tuned-tiles file, which pins 0 on the CPU, and the port's wrapper defaults
to 0 (``ops.AUCTION_REV_EVERY``); the solvers' own default is ``repro``'s
8.  The solver-level tests pass ``rev_every`` to both packages.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import auction_lap as auction_j
from repro.metrics import engine as engine_j
from repro.metrics import exact as exact_j
from repro.metrics import testing as testing_j
from repro_torch import counters
from repro_torch.core.persistence import Diagrams
from repro_torch.kernels import auction_lap, ops
from repro_torch.metrics import engine, exact, reference, testing
from repro_torch.metrics.price_cache import PriceCache

CAP = 64.0


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the solvers' hundreds of small rounds gain
    nothing from threads, and parallel test workers would oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return np.asarray(t.cpu() if isinstance(t, torch.Tensor) else t)


def _assert_solvers_agree(got, want, cost):
    """Every output but the totals equal; totals within the f32 bound."""
    for i, (g, w) in enumerate(zip(got, want)):
        if i != 1:
            np.testing.assert_array_equal(_np(g), _np(w))
    want_t = tuple(torch.from_numpy(np.array(_np(w))) for w in want)
    got_t = tuple(torch.from_numpy(np.array(_np(g))) for g in got)
    differ, err, ok = testing.auction_agreement(got_t, want_t, cost)
    assert differ == 0 and ok, err


# (B, M, operand options, solver options): small shapes of the shared
# kinds, each compiled once by JAX
EXPANDED = [(6, 1, {}, {}), (8, 12, {}, {}), (4, 17, {}, {"max_rounds": 2}),
            (3, 8, {"zero": True}, {}), (5, 9, {}, {"n_scales": 4})]
COLLAPSED = [
    ("collapsed", 8, 12, {}, {"rev_every": 0}),
    ("collapsed", 8, 12, {}, {"rev_every": 2}),
    ("collapsed", 8, 12, {}, {"rev_every": 8}),
    ("warm", 6, 12, {}, {"rev_every": 8}),
    ("warm", 6, 12, {}, {"rev_every": 0}),
    ("collapsed", 4, 8, {"scale": 1e6},
     {"eps0": 1e-12, "eps_factor": 1.0, "n_scales": 1, "rev_every": 8}),
    ("collapsed", 4, 10, {}, {"max_rounds": 1, "rev_every": 8}),
    ("collapsed", 3, 6, {"invalid": True}, {"rev_every": 8}),
    ("collapsed", 3, 7, {"zero": True}, {"rev_every": 0}),
    ("collapsed", 5, 1, {}, {"rev_every": 8}),
    ("collapsed", 4, 9, {"signed_zero": True}, {"rev_every": 0}),
    ("collapsed", 6, 8, {"mixed": True}, {"rev_every": 0}),
]


@pytest.mark.parametrize("b,m,opts,solver", EXPANDED)
def test_auction_solve_matches_repro(b, m, opts, solver):
    t = testing.auction_operands(np.random.default_rng(b + m), b, m,
                                 "expanded", "cpu", **opts)
    cost = t["cost"]
    got = auction_lap.auction_solve(cost, **solver)
    want = jax.vmap(functools.partial(auction_j.auction_solve, **solver))(
        jnp.asarray(cost.numpy()))
    _assert_solvers_agree(got, want, cost)
    if "max_rounds" in solver:
        assert not bool(got[2].any())  # no scale converged
    # the completion always returns a permutation
    assert torch.equal(got[0].sort(-1).values,
                       torch.arange(m, dtype=torch.int32).expand(b, m))


@pytest.mark.parametrize("kind,b,m,opts,solver", COLLAPSED)
def test_auction_solve_collapsed_matches_repro(kind, b, m, opts, solver):
    t = testing.auction_operands(np.random.default_rng(10 * b + m), b, m,
                                 kind, "cpu", **opts)
    got = auction_lap.auction_solve_collapsed(
        t["cbar"], t["keep1"], t["keep2"], t["price0"], **solver)
    want = jax.vmap(functools.partial(auction_j.auction_solve_collapsed,
                                      **solver))(
        *(jnp.asarray(t[k].numpy()) for k in ("cbar", "keep1", "keep2",
                                              "price0")))
    _assert_solvers_agree(got, want, t["cbar"])
    if opts.get("invalid"):
        assert not bool(got[3].any())  # every person starts at OUT
    if "eps0" in solver:  # the stall detector ended a livelocked scale
        assert bool((got[3] > 0).all())
    # a matching: every owned object has exactly one owner
    for row in got[0]:
        owned = row[row >= 0].tolist()
        assert len(owned) == len(set(owned))


def test_ops_wrappers_match_repro_interpret_mode_pallas():
    t = testing.auction_operands(np.random.default_rng(3), 4, 12, "warm",
                                 "cpu")
    cost = t["cbar"].abs().contiguous()
    got = ops.auction_lap(cost, n_scales=6)
    want = auction_j.auction_lap_pallas(jnp.asarray(cost.numpy()),
                                        n_scales=6, interpret=True)
    _assert_solvers_agree(got, want, cost)
    args = [t[k] for k in ("cbar", "keep1", "keep2", "price0")]
    got = ops.auction_lap_collapsed(*args, rev_every=2)
    want = auction_j.auction_lap_collapsed_pallas(
        *(jnp.asarray(a.numpy()) for a in args), rev_every=2,
        interpret=True)
    _assert_solvers_agree(got, want, t["cbar"])


def test_expand_collapsed_assignment_matches_repro():
    rng = np.random.default_rng(4)
    k = 9
    cases = [np.full(k, auction_lap.OUT), np.arange(k)[::-1],
             np.where(rng.random(k) < 0.5, rng.permutation(k), -1)]
    for _ in range(5):
        p = rng.permutation(k).astype(np.int64)
        p[rng.random(k) < 0.4] = auction_lap.OUT
        p[rng.random(k) < 0.2] = -1
        cases.append(p)
    keep = np.ones(k, bool)
    for p2o in cases:
        p2o = p2o.astype(np.int32)
        got = auction_lap.expand_collapsed_assignment(torch.from_numpy(p2o))
        want = auction_j.expand_collapsed_assignment(
            jnp.asarray(p2o), jnp.asarray(keep), jnp.asarray(keep))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert sorted(got.tolist()) == list(range(2 * k))


def test_eps_ladder_matches_repro():
    for n in (1, 3, 4, 6, 10):
        want = 0.25 * 5.0 ** -jnp.arange(n, dtype=jnp.float32)
        np.testing.assert_array_equal(
            auction_lap.eps_ladder(0.25, 5.0, n).numpy(), np.asarray(want))


def test_wrappers_check_their_operands():
    cost = torch.zeros((2, 3, 3))
    keep = torch.ones((2, 3), dtype=torch.bool)
    with pytest.raises(ValueError, match="want .B, M, M."):
        ops.auction_lap(torch.zeros((2, 3, 4)))
    with pytest.raises(TypeError, match="dtype"):
        ops.auction_lap(cost.double())
    with pytest.raises(ValueError, match="AUCTION_MAX_M"):
        ops.auction_lap(torch.zeros((0, 2049, 2049)))
    with pytest.raises(ValueError, match="keep2"):
        ops.auction_lap_collapsed(cost, keep, keep[:, :2])
    with pytest.raises(ValueError, match="rev_every"):
        ops.auction_lap_collapsed(cost, keep, keep, rev_every=-1)
    before = counters.snapshot()
    ops.auction_lap(cost)
    ops.auction_lap_collapsed(cost, keep, keep)
    assert counters.snapshot() == before  # the plain path launches nothing


# ------------------------------------------- the collapsed kernel's scans

def _serial_top2(v):
    """``csrc/auction_lap.cu``'s serial ``top2`` over float32 values: the
    first argmax, the maximum and the maximum over the other indices."""
    js, v1, v2 = 0, np.float32(-np.inf), np.float32(-np.inf)
    for j, x in enumerate(v):
        if x > v1:
            js, v1, v2 = j, x, v1
        elif x > v2:
            v2 = x
    return js, v1, v2


_NO_KEY = torch.iinfo(torch.int64).min


def _scan_keys(v):
    """The kernel's ``bid_key(v, ~j)`` as signed int64 keys in the same
    order: the order-preserving bits of v (±0 alike) above 2^32 - 1 - j."""
    u = torch.where(v == 0, 0.0, v).view(torch.int32).to(torch.int64)
    u = u & 0xFFFFFFFF
    o = torch.where(u >> 31 == 1, u ^ 0xFFFFFFFF, u ^ 0x80000000)
    j = torch.arange(v.shape[-1], dtype=torch.int64)
    return ((o - 2 ** 31) << 32) + (0xFFFFFFFF - j)


def _tree_top2(v, s):
    """``seg_top2`` of the collapsed kernel over an S-lane segment, in
    torch: lane l keeps the top two keys of j = l, l + S, ... in that order,
    then the lanes merge by xor shuffles; v1 and v2 are read back at the two
    indices (``_NO_KEY``: none, v2 = -inf)."""
    keys = _scan_keys(v)
    a = torch.full((s,), _NO_KEY, dtype=torch.int64)
    b = a.clone()
    for j in range(v.shape[-1]):
        lane, k = j % s, keys[j]
        if k > a[lane]:
            b[lane], a[lane] = a[lane].clone(), k
        elif k > b[lane]:
            b[lane] = k
    lanes = torch.arange(s)
    o = s // 2
    while o:
        pa, pb = a[lanes ^ o], b[lanes ^ o]
        mine = a > pa
        b = torch.maximum(torch.where(mine, b, pb), torch.where(mine, pa, a))
        a = torch.where(mine, a, pa)
        o //= 2
    assert bool((a == a[0]).all() and (b == b[0]).all())
    js = 0xFFFFFFFF - (int(a[0]) & 0xFFFFFFFF)
    v2 = (v[0xFFFFFFFF - (int(b[0]) & 0xFFFFFFFF)] if int(b[0]) != _NO_KEY
          else torch.tensor(float("-inf")))
    return js, v[js], v2


def _redux_top2(v):
    """``seg_top2`` at S = 32, in torch: each lane keeps the serial scan's
    top two (value bits and index) of j = l, l + 32, ...; warp-wide
    reductions then take the largest value bits, the lowest index holding
    them (js), and the same over every lane's best candidate but js."""
    bits = (_scan_keys(v) >> 32) + 2 ** 31  # the value's order bits, u32
    a = torch.zeros(32, dtype=torch.int64)
    b = a.clone()
    ia = torch.full((32,), 2 ** 32 - 1, dtype=torch.int64)
    ib = ia.clone()
    for j in range(v.shape[-1]):
        lane, k = j % 32, bits[j]
        if k > a[lane]:
            b[lane], ib[lane] = a[lane].clone(), ia[lane].clone()
            a[lane], ia[lane] = k, j
        elif k > b[lane]:
            b[lane], ib[lane] = k, j
    m1 = a.max()
    js = int(torch.where(a == m1, ia, 2 ** 32 - 1).min())
    top = ia == js
    c, ic = torch.where(top, b, a), torch.where(top, ib, ia)
    m2 = c.max()
    v2 = (v[int(torch.where(c == m2, ic, 2 ** 32 - 1).min())] if int(m2)
          else torch.tensor(float("-inf")))
    return js, v[js], v2


def _scan_rows(k, seed):
    """float32 rows of ``a - sub`` with equal maxima, ±0 ties, -inf masked
    entries and all -inf rows."""
    rng = np.random.default_rng(seed)
    pool = np.array([-0.0, 0.0, 1.0, 1.0, -1.0, 0.5, -np.inf], np.float32)
    rows = [rng.choice(pool, k), rng.choice(pool[[0, 1, 6]], k),
            np.full(k, -np.inf, np.float32), np.full(k, 1.0, np.float32),
            rng.uniform(-2, 2, k).astype(np.float32)]
    zeros = np.zeros(k, np.float32)
    zeros[::2] = -0.0
    rows.append(zeros)
    for _ in range(12):
        a = rng.choice(pool, k)
        sub = rng.choice(np.array([0.0, 1.0, 0.5], np.float32), k)
        rows.append(a - sub)  # x - x = +0, -0 - 0 = -0
    return [torch.from_numpy(np.ascontiguousarray(r, np.float32))
            for r in rows]


@pytest.mark.parametrize("s", [8, 16, 32, "redux"])
@pytest.mark.parametrize("k", [1, 31, 33, 64])
def test_segment_tree_top2_equals_the_serial_scan(k, s):
    # the kernel merges with xor shuffles at S = 8 and 16, with warp
    # reductions at S = 32 ("redux"); either must give the serial bits
    for v in _scan_rows(k, seed=100 * k + (32 if s == "redux" else s)):
        js, v1, v2 = _serial_top2(v.numpy())
        tjs, tv1, tv2 = _redux_top2(v) if s == "redux" else _tree_top2(v, s)
        assert tjs == js
        assert np.float32(tv1).tobytes() == v1.tobytes()
        assert np.float32(tv2).tobytes() == np.float32(v2).tobytes()


# ------------------------------------------------------------ cost surfaces

def _clouds(seed, b=16, k=16):
    rng = np.random.default_rng(seed)
    b1 = rng.uniform(0, 8, (b, k)).astype(np.float32)
    e1 = (b1 + rng.uniform(0.2, 6, (b, k))).astype(np.float32)
    b2 = rng.uniform(0, 8, (b, k)).astype(np.float32)
    e2 = (b2 + rng.uniform(0.2, 6, (b, k))).astype(np.float32)
    return b1, e1, rng.random((b, k)) < 0.7, b2, e2, rng.random((b, k)) < 0.7


@pytest.mark.parametrize("q,ground", [(2.0, "l2"), (1.0, "linf"),
                                      (2.0, "linf")])
def test_cost_surfaces_equal_repro_jitted(q, ground):
    arrays = _clouds(5)
    mine = [torch.from_numpy(a) for a in arrays]
    for name in ("cloud_costs", "augmented_cost", "collapsed_cost"):
        fn_j = jax.jit(getattr(exact_j, name), static_argnames=("q",
                                                                "ground"))
        want = fn_j(*arrays, q=q, ground=ground)
        got = getattr(exact, name)(*mine, q=q, ground=ground)
        if name == "augmented_cost":
            got, want = (got,), (want,)
        for i, (g, w) in enumerate(zip(got, want)):
            if name == "collapsed_cost" and i == 1:  # base: f32 sums
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=1e-6)
            else:
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(ValueError, match="unknown ground"):
        exact.cloud_costs(*mine, ground="l1")


# --------------------------------------------------------- metric backends

def _stack_j(rows):
    return jax.tree.map(lambda *x: jnp.stack(x), *rows)


def _to_port(dj) -> Diagrams:
    return Diagrams(*(torch.from_numpy(np.array(getattr(dj, k)))
                      for k in ("birth", "death", "dim", "valid")))


@pytest.fixture(scope="module")
def random_pairs():
    """24 pairs as metrics_bench draws them, both packages' batches, and
    the Hungarian W2 and bottleneck of each."""
    rng = np.random.default_rng(35)
    pairs = [(testing_j.random_diagram(rng, essential=int(rng.integers(0, 3))),
              testing_j.random_diagram(rng)) for _ in range(24)]
    j1, j2 = _stack_j([a for a, _ in pairs]), _stack_j([b for _, b in pairs])
    pts = [(testing_j.diagram_points(a, 1, CAP),
            testing_j.diagram_points(b, 1, CAP)) for a, b in pairs]
    w2 = np.array([reference.wasserstein_exact(a, b, q=2.0) for a, b in pts])
    w1 = np.array([reference.wasserstein_exact(a, b, q=1.0, ground="linf")
                   for a, b in pts])
    bn = np.array([reference.bottleneck_exact(a, b) for a, b in pts])
    return (j1, j2), (_to_port(j1), _to_port(j2)), w2, w1, bn


@pytest.mark.parametrize("collapse", ["on", "off"])
def test_exact_w_matches_oracle_and_repro(random_pairs, collapse):
    (j1, j2), (t1, t2), w2, _, _ = random_pairs
    w, conv, rounds = exact.exact_w_info(t1, t2, collapse=collapse)
    assert bool(conv.all())
    np.testing.assert_allclose(w.numpy(), w2, rtol=0, atol=1e-5)
    want = np.asarray(exact_j.exact_w(j1, j2, collapse=collapse))
    near = np.abs(want - w2) <= 1e-5  # where repro matches the oracle
    np.testing.assert_allclose(w.numpy()[near], want[near], rtol=0,
                               atol=1e-5)
    assert torch.equal(exact.exact_w(t1, t2, collapse=collapse), w)
    if collapse == "on":  # the collapse point: far fewer rounds
        w_off, _, r_off = exact.exact_w_info(t1, t2, collapse="off")
        np.testing.assert_allclose(w.numpy(), w_off.numpy(), atol=1e-5)
        assert float(rounds.float().mean()) * 5 < float(r_off.float().mean())


def test_exact_w_q1_linf_matches_oracle(random_pairs):
    _, (t1, t2), _, w1, _ = random_pairs
    w = exact.exact_w(t1, t2, q=1.0, ground="linf")
    np.testing.assert_allclose(w.numpy(), w1, rtol=1e-5, atol=1e-5)


def test_exact_w_full_warm_prices(random_pairs):
    _, (t1, t2), w2, _, _ = random_pairs
    w, conv, rounds, prices = exact.exact_w_full(t1, t2)
    assert prices.shape == (24, 16) and bool((prices >= 0).all())
    w_warm, conv_w, rounds_w, _ = exact.exact_w_full(t1, t2, prices=prices)
    assert bool(conv_w.all())
    np.testing.assert_allclose(w_warm.numpy(), w2, rtol=0, atol=1e-5)
    assert int(rounds_w.sum()) < int(rounds.sum())
    # any nonnegative vector is a safe warm start
    junk = torch.from_numpy(np.random.default_rng(6).uniform(
        0, 5, (24, 16)).astype(np.float32))
    w_junk = exact.exact_w_full(t1, t2, prices=junk)[0]
    np.testing.assert_allclose(w_junk.numpy(), w2, rtol=0, atol=1e-5)
    off = exact.exact_w_full(t1, t2, collapse="off", prices=junk)
    assert not bool(off[3].any())  # the expanded path returns zero prices


def test_bottleneck_approx_matches_oracle_and_repro(random_pairs):
    (j1, j2), (t1, t2), _, _, bn = random_pairs
    got = exact.bottleneck_approx(t1, t2).numpy()
    assert bool((np.abs(got - bn) <= np.maximum(1e-4, 1e-4 * bn)).all())
    want = np.asarray(exact_j.bottleneck_approx(j1, j2, k=1, cap=CAP))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_exact_w_degenerate_diagrams():
    # repro's seed-14 inputs: repro's collapsed path gives 0.015625 for the
    # self-distance of `many`; the oracle and the port give 0.0
    rng = np.random.default_rng(14)
    empty = _to_port(testing_j.random_diagram(rng, n=0))
    one = _to_port(testing_j.random_diagram(rng, n=1))
    many_j = testing_j.random_diagram(rng, n=6, essential=1)
    many = _to_port(many_j)
    for collapse in ("on", "off"):
        kw = dict(k=1, cap=CAP, collapse=collapse)
        assert float(exact.exact_w(empty, empty, **kw)) == 0.0
        assert float(exact.exact_w(many, many, **kw)) == 0.0
        got = float(exact.exact_w(empty, one, **kw))
        want = reference.wasserstein_exact(
            [], testing.diagram_points(one, 1, CAP), q=2.0)
        assert abs(got - want) <= 1e-5
        ab = float(exact.exact_w(many, one, **kw))
        ba = float(exact.exact_w(one, many, **kw))
        assert ab == pytest.approx(ba, abs=1e-5)
    assert float(exact_j.exact_w(many_j, many_j, k=1, cap=CAP)) == 0.015625
    with pytest.raises(ValueError, match="unknown collapse"):
        exact.exact_w(one, one, collapse="bogus")


def test_exact_w_self_distance_is_exactly_zero(random_pairs):
    _, (t1, _), _, _, _ = random_pairs
    assert not bool(exact.exact_w(t1, t1).any())
    # the expanded plain solver runs ~1,300 rounds a pair: eight pairs
    t8 = Diagrams(*(getattr(t1, k)[:8] for k in ("birth", "death", "dim",
                                                   "valid")))
    assert not bool(exact.exact_w(t8, t8, collapse="off").any())
    # the bisection's upper bound stops max_cost * 2^-24 above 0
    assert float(exact.bottleneck_approx(t1, t1).max()) <= 1e-4


def test_engine_entry_points(random_pairs):
    (j1, j2), (t1, t2), w2, _, bn = random_pairs
    counters.reset()
    w = engine.compare(t1, t2, metric="exact_w")
    assert counters.METRIC_CALLS[("exact_w", "compare")] == 1
    np.testing.assert_allclose(w.numpy(), w2, atol=1e-5)
    w_i, conv, rounds, prices = engine.compare_info(t1, t2, metric="exact_w")
    assert torch.equal(w_i, w) and prices.shape == (24, 16)
    w_warm = engine.compare_info(t1, t2, metric="exact_w", prices=prices)[0]
    np.testing.assert_allclose(w_warm.numpy(), w2, atol=1e-5)
    b = engine.compare(t1, t2, metric="bottleneck_approx", n_iters=20)
    assert bool((np.abs(b.numpy() - bn) <= 1e-4 * np.maximum(bn, 1) * 16
                 ).all())
    with pytest.raises(ValueError, match="does not accept"):
        engine.compare_info(t1, t2, metric="exact_w", n_dirs=4)
    with pytest.raises(ValueError, match="no diagnostics"):
        engine.compare_info(t1, t2, metric="bottleneck_approx")


@pytest.mark.parametrize("metric", ["exact_w", "bottleneck_approx"])
def test_pairwise_matches_repro_and_oracle(random_pairs, metric):
    (j1, j2), (t1, t2), _, _, _ = random_pairs
    q = Diagrams(*(getattr(t1, k)[:3] for k in ("birth", "death", "dim",
                                                  "valid")))
    r = Diagrams(*(getattr(t2, k)[:5] for k in ("birth", "death", "dim",
                                                  "valid")))
    full = engine.pairwise(q, r, metric=metric)
    assert full.shape == (3, 5)
    assert torch.equal(engine.pairwise(q, r, metric=metric, block_rows=2),
                       full)
    want = np.asarray(engine_j.pairwise(jax.tree.map(lambda x: x[:3], j1),
                                        jax.tree.map(lambda x: x[:5], j2),
                                        metric=metric))
    np.testing.assert_allclose(full.numpy(), want, rtol=1e-5, atol=1e-5)
    tq = [testing.diagram_points(Diagrams(*(getattr(q, k)[i] for k in (
        "birth", "death", "dim", "valid"))), 1, CAP) for i in range(3)]
    tr = [testing.diagram_points(Diagrams(*(getattr(r, k)[j] for k in (
        "birth", "death", "dim", "valid"))), 1, CAP) for j in range(5)]
    oracle = (reference.wasserstein_exact if metric == "exact_w"
              else reference.bottleneck_exact)
    want = np.array([[oracle(a, b) for b in tr] for a in tq])
    np.testing.assert_allclose(full.numpy(), want, rtol=1e-4, atol=1e-5)
    diagonal = engine.pairwise(q, metric=metric).diagonal()
    if metric == "exact_w":
        assert not bool(diagonal.any())
    else:  # the bisection's upper bound stops max_cost * 2^-24 above 0
        assert float(diagonal.max()) <= 1e-4


@pytest.mark.parametrize("metric", ["exact_w", "bottleneck_approx"])
def test_registry_contract_equals_repro(metric):
    mine, theirs = engine.get_metric(metric), engine_j.get_metric(metric)
    for field in ("exact", "error_bound", "cost_class", "description",
                  "defaults", "params", "info_params"):
        assert getattr(mine, field) == getattr(theirs, field), field
    assert (mine.info_fn is None) == (theirs.info_fn is None)


# --------------------------------------------------------------- PriceCache

def test_price_cache_lru_roundtrip():
    counters.reset()
    cache = PriceCache(capacity=3, instance="test-pc")
    codes = np.asarray([[1, 2], [3, 4]], np.uint8)       # 2 queries
    rows = np.asarray([[0, 1], [0, 2]])                  # 2 candidates each
    p0, hits, misses = cache.lookup(codes, rows, 4)
    assert p0.shape == (2, 2, 4) and hits == 0 and misses == 4
    assert not p0.any()
    prices = np.arange(16, dtype=np.float32).reshape(2, 2, 4)
    conv = np.asarray([[True, True], [True, False]])
    assert cache.store(codes, rows, prices, conv) == 3   # unconverged skipped
    p1, hits, misses = cache.lookup(codes, rows, 4)
    assert hits == 3 and misses == 1
    np.testing.assert_array_equal(p1[0], prices[0])
    np.testing.assert_array_equal(p1[1, 0], prices[1, 0])
    np.testing.assert_array_equal(p1[1, 1], 0.0)         # never stored
    assert (cache.hits, cache.misses) == (3, 5)
    assert counters.AUCTION[("warm_start_hits", "test-pc")] == 3
    # a vector of another width is a miss
    assert cache.lookup(codes[:1], rows[:1, :1], 8)[1:] == (0, 1)
    # capacity eviction: a fourth distinct key evicts the least recently
    # used entry, (query 0, row 0), looked up before the others
    cache.lookup(codes[1:], rows[1:], 4)
    cache.lookup(codes[:1], rows[:1, 1:], 4)
    cache.store(np.asarray([[9, 9]], np.uint8), np.asarray([[7]]),
                np.ones((1, 1, 4), np.float32), np.asarray([[True]]))
    assert len(cache) == 3
    assert cache.lookup(codes[:1], rows[:1, :1], 4)[1] == 0
    other = PriceCache(capacity=2, instance="other")
    assert (other.hits, other.misses) == (0, 0)          # per instance
    with pytest.raises(ValueError, match="capacity"):
        PriceCache(capacity=0)
