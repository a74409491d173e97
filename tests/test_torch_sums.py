"""Launch shapes and summation order of the port's redesigned pair-sum and
Hamming kernels, on the CPU.

The CUDA kernels run only on the card (``tests/test_torch_cuda.py``).  Here:

* both ``layout`` functions on a table of (shape, SM count) -> layout;
* a plain PyTorch model of the order in which the ``sinkhorn_pair_sum``
  kernel adds its terms: its rows and columns of finite log weight staged
  ``stage`` at a time, pair p of a row stage x column stage going to thread
  p mod T, each thread's terms summed in order across the stages, a
  halving tree over the T thread sums, and the CTAs' sums of an item added
  in CTA order.  The model is held within rtol 1e-4, atol 1e-5 of the
  plain version on every ``SINKHORN_CASES`` entry, and of ``repro``'s
  ``ops.sinkhorn_pair_sum`` (interpret-mode Pallas, as
  ``tests/test_torch_metrics.py`` runs it) on the cases small enough for
  it there: its ``KERNEL_CASES``, which leave out (2048, 64, 64, 3) and the
  five (2, 3200, 3200, .) cases.  Every term is the plain version's float;
  only the order of the f32 sums differs, so the tolerance is the Sinkhorn
  kernels' own.  Items with no weighted pair must give exactly 0.0.
* the Hamming kernel's carry-save popcount identity, bitwise, and its work
  mapping: every output written once, in 16-byte groups of 4 rows.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as kops_j
from repro_torch.kernels import hamming as hm
from repro_torch.kernels import ref
from repro_torch.kernels import sinkhorn_lse as sk
from repro_torch.metrics import testing

H100_SMS = 132

# the shared edge cases small enough for interpret-mode Pallas on the CPU
# (tests/test_torch_metrics.py::KERNEL_CASES)
KERNEL_CASES = [c for c in testing.SINKHORN_CASES if c[0] * c[1] * c[2] < 1e5]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file: its small sums gain nothing from
    threads, and when test files run in parallel worker processes, threads
    in every worker oversubscribe the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ layouts

PAIR_LAYOUTS = [
    # the main path: sinkhorn_full_n320's 128 items fill the card, one CTA
    # an item; sinkhorn_n64's 2048 small items
    ((128, 3200, 3200, 132), (512, 1, 3200, 1024, 128)),
    ((2048, 64, 64, 132), (64, 1, 64, 128, 2048)),
    # a small batch splits each item's rows over SMs // B CTAs
    ((2, 3200, 3200, 132), (512, 66, 49, 1024, 132)),
    ((67, 3200, 3200, 132), (512, 1, 3200, 1024, 67)),
    ((66, 3200, 3200, 132), (512, 2, 1600, 1024, 132)),
    # ... but never under 32 rows a CTA
    ((3, 37, 150, 132), (64, 2, 19, 128, 6)),
    ((2, 130, 257, 132), (64, 5, 26, 128, 10)),
    ((2, 1, 5, 132), (64, 1, 1, 128, 2)),
    # threads: the fewest whose 8-slot compaction step covers a CTA's rows
    # and the columns
    ((200, 600, 40, 132), (128, 1, 600, 256, 200)),
    ((200, 1500, 40, 132), (256, 1, 1500, 512, 200)),
    ((200, 64, 5000, 132), (512, 1, 64, 1024, 200)),
    ((1, 5000, 64, 1), (512, 1, 5000, 1024, 1)),
    ((4, 64, 64, 78), (64, 2, 32, 128, 8)),
]


@pytest.mark.parametrize("args,want", PAIR_LAYOUTS,
                         ids=lambda v: "x".join(map(str, v)))
def test_pair_sum_layout(args, want):
    lay = sk.layout(*args)
    assert tuple(lay) == want
    b, m = args[:2]
    # every CTA owns at least one row, and the shares cover the rows
    assert (lay.ctas_per_item - 1) * lay.rows_per_cta < m
    assert lay.ctas_per_item * lay.rows_per_cta >= m
    assert lay.ctas == b * lay.ctas_per_item


HAMMING_LAYOUTS = [
    # the index's main path (lsh_bits 128), 4096, 65,536 and 262,144 rows
    ((256, 4096, 4, 132), ("registers", 4, 64, 8, 512)),
    ((256, 65536, 4, 132), ("registers", 4, 64, 128, 8192)),
    ((256, 262144, 4, 132), ("registers", 4, 64, 512, 32768)),
    # a 4-shard mesh's scans, 1024 rows each: groups of 2 fill the SMs
    ((256, 1024, 4, 132), ("registers", 2, 128, 2, 256)),
    ((256, 1024, 4, 128), ("registers", 4, 64, 2, 128)),
    ((256, 4096, 8, 132), ("registers", 4, 64, 8, 512)),
    ((256, 4096, 9, 132), ("chunked", 16, 16, 8, 128)),
    ((1, 1, 1, 132), ("registers", 1, 1, 1, 1)),
    ((9, 257, 5, 132), ("registers", 1, 9, 1, 9)),
    ((20, 1000, 3, 8), ("registers", 4, 5, 2, 10)),
]


@pytest.mark.parametrize("args,want", HAMMING_LAYOUTS,
                         ids=lambda v: "x".join(map(str, v)))
def test_hamming_layout(args, want):
    lay = hm.layout(*args)
    assert tuple(lay) == want
    q, n = args[:2]
    assert lay.query_groups * lay.query_group >= q
    assert (lay.query_groups - 1) * lay.query_group < q
    assert lay.row_blocks * hm.TILE_N >= n


# ------------------------------------------------------ pair-sum order

def _terms(x, la, f, y, lb, g, e, mode):
    """(R, C) terms of staged rows x (3, R) and columns y (3, C), formed as
    the kernel forms them: no fused multiply-add, the same order of
    operations (la + lb) + ((f + g) - c) / e."""
    dx = x[0][:, None] - y[0][None]
    dy = x[1][:, None] - y[1][None]
    c = dx * dx + dy * dy
    c = torch.where((x[2][:, None] > 0) & (y[2][None] > 0), 0.0, c)
    if mode == "cost":
        return c
    z = (la[:, None] + lb[None]) + ((f[:, None] + g[None]) - c) / e
    return torch.exp(z) * c


def pair_sum_model(xp, yp, f, g, log_a, log_b, e_t, mode, lay):
    """The kernel's summation order in the launch ``lay``, item by item;
    the CTAs of an item side by side (a CTA with fewer staged rows than
    another pads its pairs with zero terms at the end, which add +0.0)."""
    b, _, m = xp.shape
    t, stage, per, share = (lay.threads, lay.stage, lay.ctas_per_item,
                            lay.rows_per_cta)
    out = torch.empty((b,), dtype=torch.float32)
    for k in range(b):
        cols = torch.nonzero(torch.isfinite(log_b[k])).flatten()
        rows = [torch.nonzero(torch.isfinite(
            log_a[k, c * share:min(m, (c + 1) * share)])).flatten()
            + c * share for c in range(per)]
        acc = torch.zeros((per, t), dtype=torch.float32)
        n_row_stages = max(-(-len(r) // stage) for r in rows)
        for rs in range(n_row_stages):
            staged = [r[rs * stage:(rs + 1) * stage] for r in rows]
            nr = max(len(r) for r in staged)
            idx = torch.stack([torch.nn.functional.pad(r, (0, nr - len(r)),
                                                       value=-1)
                               for r in staged])          # (per, nr)
            live = idx >= 0
            idx = idx.clamp(min=0)
            for c0 in range(0, len(cols), stage):
                cs = cols[c0:c0 + stage]
                y = yp[k][:, cs]
                terms = torch.stack([
                    _terms(xp[k][:, idx[c]], log_a[k, idx[c]], f[k, idx[c]],
                           y, log_b[k, cs], g[k, cs], e_t[k, 0], mode)
                    for c in range(per)])                 # (per, nr, nc)
                terms = torch.where(live[:, :, None], terms, 0.0)
                flat = terms.reshape(per, -1)
                steps = -(-flat.shape[1] // t)
                flat = torch.nn.functional.pad(
                    flat, (0, steps * t - flat.shape[1])).reshape(per, steps, t)
                for s in range(steps):  # pair p goes to thread p mod t
                    acc = acc + flat[:, s]
        h = t // 2
        while h >= 1:  # the CTA's halving tree
            acc = acc[:, :h] + acc[:, h:2 * h]
            h //= 2
        sums = torch.where(torch.tensor([len(r) > 0 for r in rows]),
                           acc[:, 0], 0.0)
        total = torch.zeros((), dtype=torch.float32)
        for c in range(per):  # the partials in CTA order
            total = total + sums[c]
        out[k] = total
    return out


def _operands(case, seed):
    t = testing.sinkhorn_operands(np.random.default_rng(seed), *case,
                                  device="cpu")
    return [t[k] for k in ("xp", "yp", "f", "g", "log_a", "log_b", "e_t")]


@pytest.mark.parametrize("mode", ["plan", "cost"])
@pytest.mark.parametrize("case", testing.SINKHORN_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_pair_sum_order_matches_the_plain_version(case, mode):
    b, m, n, v0 = case
    args = _operands(case, seed=m * n)
    lay = sk.layout(b, m, n, H100_SMS)
    got = pair_sum_model(*args, mode, lay)
    want = ref.sinkhorn_pair_sum_ref(*args, mode)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    if v0 == 0:  # batch item 0 has no weighted pair
        assert got[0].item() == 0.0


def _pad8(p):
    """repro's (B, 8, M) layout: five zero planes of TPU sublane padding."""
    return np.concatenate([p, np.zeros((p.shape[0], 5, p.shape[2]),
                                       np.float32)], axis=1)


@pytest.mark.parametrize("mode", ["plan", "cost"])
@pytest.mark.parametrize("case", KERNEL_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_pair_sum_order_matches_repro(case, mode):
    b, m, n, _ = case
    args = _operands(case, seed=1)
    got = pair_sum_model(*args, mode, sk.layout(b, m, n, H100_SMS))
    xp, yp, *rest = (a.numpy() for a in args)
    want = kops_j.sinkhorn_pair_sum(
        *(jnp.asarray(a) for a in (_pad8(xp), _pad8(yp), *rest)), mode=mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("sms", [1, 8, 132])
@pytest.mark.parametrize("case", testing.PAIR_SUM_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_pair_sum_order_every_branch(case, sms):
    """``testing.PAIR_SUM_CASES``: several row stages in one CTA, several
    column stages, weights only in the last slots beside an item with no
    weight at all, at SM counts that give one CTA an item or several."""
    b, m, n, weights = case
    t = testing.pair_sum_operands(np.random.default_rng(b + m + n), *case,
                                  device="cpu")
    args = [t[k] for k in ("xp", "yp", "f", "g", "log_a", "log_b", "e_t")]
    lay = sk.layout(b, m, n, sms)
    for mode in ("plan", "cost"):
        got = pair_sum_model(*args, mode, lay)
        torch.testing.assert_close(
            got, ref.sinkhorn_pair_sum_ref(*args, mode), rtol=1e-4,
            atol=1e-5)
        if weights == "last":  # the last slots count; the empty item is 0.0
            assert got[0].item() == 0.0
            assert mode == "plan" or bool((got[1:] > 0).all())


# ------------------------------------------------------------- Hamming

def test_hamming_carry_save_popcount_is_exact():
    """popc(a) + popc(b) + popc(c) == 2 popc(maj(a, b, c)) + popc(a^b^c),
    with bit 31 set in about half the words."""
    rng = np.random.default_rng(3)
    a, b, c = rng.integers(0, 2 ** 32, (3, 100_000), dtype=np.uint64).astype(
        np.uint32)
    c[:4] = [0, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF]

    def popc(x):
        return np.unpackbits(x.view(np.uint8)).reshape(len(x), 32).sum(1)

    maj = (a & b) | (a & c) | (b & c)
    np.testing.assert_array_equal(popc(a) + popc(b) + popc(c),
                                  2 * popc(maj) + popc(a ^ b ^ c))


@pytest.mark.parametrize("q,n,w", [(256, 4096, 4), (9, 257, 5), (20, 1003, 3),
                                   (33, 700, 12), (1, 1, 1)])
def test_hamming_work_mapping_writes_every_output_once(q, n, w):
    """Walk the launch's CTAs and threads: CTA k takes query group k mod
    groups and row block k div groups; a thread's 4 rows and the group's
    queries cover the (Q, N) output exactly once."""
    lay = hm.layout(q, n, w, H100_SMS)
    hits = np.zeros((q, n), np.int64)
    for k in range(lay.ctas):
        gq, rb = k % lay.query_groups, k // lay.query_groups
        q0 = gq * lay.query_group
        nqg = min(lay.query_group, q - q0)
        for tid in range(hm.THREADS):
            j0 = (rb * hm.THREADS + tid) * hm.ROWS_PER_THREAD
            if j0 < n:
                hits[q0:q0 + nqg, j0:min(n, j0 + hm.ROWS_PER_THREAD)] += 1
    assert (hits == 1).all()
