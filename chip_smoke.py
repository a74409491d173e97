#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py

Builds the ten hand-written kernels from the eight sources in
``src/repro_torch/csrc`` (one nvcc per source, in parallel), holds each
kernel against its plain PyTorch version on the card, then drives the
port's nine paths:

* reduce -> repack -> persist through ``make_topo_plan`` at three sizes: the
  n64 serve rung (4096 graphs), the DD rung of Table 2 (256 graphs of 320
  vertices) and Table 1's protocol (16 graphs of 1024 vertices);
* the paper's Fig 2 path: clustering coefficients (one launch of the
  common-neighbors kernel's fused row-sum epilogue) on the n64 batch, on
  Table 1's batch and on the TWITTER surrogate;
  a TopoIndex over the n64 diagrams (embedding, the pairwise-L1 Gram,
  kNN queries without and with the LSH stage, whose coarse scan is one
  ``hamming_scan`` launch, a save/load round trip); and
  the three probes of ``benchmarks/fig2_clustering.py``, whose persistence-
  kernel clustering must reach purity and accuracy >= 0.66;
* retrieval through a ShardedIndex (the ``hamming_scan`` kernel): the LSH
  index of the n64 diagrams wrapped on the mesh (1, 1) and on a 4-shard
  mesh that repeats the one card, and a 65,536-row corpus of noisy copies
  on the mesh (1, 1); candidates, answers and gathered clouds bitwise the
  single-host index's (whose coarse stage runs the same device scan), the
  candidates and the single-host answers also bitwise those of the host
  numpy scan over host copies of the same codes, the SUMMA Gram within the
  pairwise-L1 tolerance;
* the entropic Sinkhorn-W2 path of the MetricEngine: 2048 row-aligned n64
  pairs through ``compare(metric="sinkhorn")``, dense and blocked (the
  ``sinkhorn_lse`` and ``sinkhorn_pair_sum`` kernels); the DD rung's
  diagrams as 128 pairs on the full tensor (clouds of 3200 slots, blocked);
  a 64 x 64 ``pairwise`` matrix; and a parity gate of 200 random pairs,
  each within 5% of the exact W2 of ``metrics/reference.py``, with
  self-distance exactly 0;
* the exact half of the MetricEngine (the ``auction_lap`` and
  ``auction_lap_collapsed`` kernels): the 2048 n64 pairs through
  ``compare(metric="exact_w")`` collapsed and expanded, ``compare_info``
  cold and warm, and ``bottleneck_approx``; the DD rung's diagrams as 128
  pairs at ``n_points=64`` in both layouts, against the Hungarian oracle
  where the compaction is exact; a 64 x 64 ``pairwise``; and
  ``metrics_bench``'s auction parity gate of 200 random pairs;
* the paper's last two reductions: Table 3's strong collapse (the
  Email-Enron surrogate, every superlevel complex at step sizes 4 and 12,
  one ``domination`` launch a round for every threshold) and Fig 5b's ego
  nets (every 1-hop ego net of a BA(192, 3) host at n_pad 64, then PD_0
  through the plan with and without PrunIT);
* TopoStream over 4096 graphs of n_pad 64: an ego-decay stream (the
  hit-heavy regime) and a community-churn stream scoring drift with
  ``exact_w`` at ``auto:q0.99`` (the recompute-bound regime).  Each step's
  verdict launches ``kcore_peel`` and ``domination``, and its recompute runs
  the plan on a power-of-two sub-batch of the misses; after every step the
  streamed pairs are bitwise a direct ``topological_signature``, and a CPU
  stream over the first 64 graphs has the same verdicts and Diagrams;
* the serving layer: TopoServe at ``serve_bench``'s configuration over the
  default bucket ladder (4096 requests of 6-55 vertices; every served
  Diagrams bitwise a direct execution of its recorded batch, one batch per
  bucket bitwise a CPU TopoServe's; then ``repack="on"`` with
  ``method="both"``), the same round behind the SLO engine, the scrape
  exporter and a ``serve_forever`` thread (``watch_overhead_pct``),
  SimilarityServe over the n64 index with the exact re-rank (4096 corpus
  graphs, 256 queries; sharded on ``make_index_mesh()``; the exact stage 1
  on 512 graphs; 64 sampled distances against the Hungarian oracle), and
  StreamServe with four ego-decay sessions of 1024 graphs, every step
  bitwise a direct TopoStream;
* the trace report: one step of each path above with tracing on, the
  Chrome trace through ``python -m repro_torch.obs report`` (a subprocess),
  every launched kernel's ``kernels.*`` rows holding its launch count and
  a cost cell of the card; ``python -m repro_torch.obs slo check`` also
  runs against the exporter of the watched round.

CUDA results are compared with the same functions run on the CPU: bitwise
where the computation is exact, within a stated tolerance where float sums
run in another order.  The kernel checks also run ``kcore_peel`` at every
cluster size its selector returns on this card, ``domination`` on each
side of the N = 128 that divides its two work mappings, both epilogues of
``common_neighbors`` there too, ``sinkhorn_pair_sum`` in every branch of
its layout (and three launches interleaved with others, bitwise) and
``hamming_scan`` on both its paths and an unaligned corpus, and hold both
``pairwise_l1`` layouts against each other bitwise.  Then one n64
execution, one n64 clustering call, one index run (and the sharded LSH
query alone), one full-tensor Sinkhorn call and DD-rung exact_w calls in
both layouts, and one step of each stream, are profiled for device time
by kernel, and each kernel is
timed at the largest input each phase gave it (every kernel also on the
device, behind a sleep that keeps the host out of the time, and all but
the auction kernels for the wrapper's host time a call, with the cluster
size, mapping or layout the launch took; ``common_neighbors`` in both epilogues; the auction kernels
also per round of their slowest problem; ``sinkhorn_pair_sum`` and
``hamming_scan`` with ptxas's registers and spills).  Each phase prints one JSON line; any failure exits
non-zero.  The last two lines are the ``kernels`` summary (launches on the
main path, error against the plain version, times and bounds) after the
card's name and power limit, and the ``ok`` line.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# The card's peaks and every kernel row's bound come from
# repro_torch.launch.roofline (imported where used: src/ joins sys.path in
# main).
# one dependent shared-memory load on Hopper, assumed: ~30 cycles at the
# 1.98 GHz boost clock (the gf2 chain floor's unit)
SMEM_ROUND_TRIP_NS = 30 / 1.98

REPLACES = {
    "kcore_peel": "src/repro/kernels/kcore_peel.py:42",
    "domination": "src/repro/kernels/domination.py:49",
    "gf2_reduce": "src/repro/kernels/gf2_reduce.py:136",
    "common_neighbors": "src/repro/kernels/common_neighbors.py:37",
    "pairwise_l1": "src/repro/kernels/pairwise_gram.py:45",
    "sinkhorn_lse": "src/repro/kernels/sinkhorn_lse.py:97",
    "sinkhorn_pair_sum": "src/repro/kernels/sinkhorn_lse.py:173",
    "auction_lap": "src/repro/kernels/auction_lap.py:479",
    "auction_lap_collapsed": "src/repro/kernels/auction_lap.py:548",
    "hamming_scan": "src/repro/kernels/hamming.py:61",
}
# the batched Pallas form, gf2_reduce_batch_pallas, is the same CUDA kernel
ALSO_REPLACES = {"gf2_reduce": "src/repro/kernels/gf2_reduce.py:167"}
SOURCE = {k: f"src/repro_torch/csrc/{k}.cu" for k in REPLACES}
SOURCE["sinkhorn_pair_sum"] = SOURCE["sinkhorn_lse"]  # one source, both
SOURCE["auction_lap_collapsed"] = SOURCE["auction_lap"]
SOURCE["hamming_scan"] = "src/repro_torch/csrc/hamming.cu"
N64_CAPS = dict(edge_cap=320, tri_cap=512)
# Table 3's filtration step sizes, and Fig 5b's caps (dim 0, superlevel)
TABLE3_DELTAS = (4, 12)
FIG5B_CAPS = dict(edge_cap=192, tri_cap=8)
# the stream cells: 4096 graphs filling n_pad 64.  The ego-decay layout
# (2 hubs + 14 core, 24 double and 24 pendant satellites, a core edge
# toggled in a quarter of the graphs a step) reaches 186 edges and 503
# triangles over 4096 graphs and 24 steps (a CPU draw), the churn layout
# (8 communities of 8, p_in 0.5, p_out 0.02, 2 + 2 edges a step) 171 and
# 186; the caps leave room for the card's draws, and check_caps holds them
STREAM_BATCH = 4096
STREAM_CPU_GRAPHS = 64
# (one step more than the phase applies: profile_stream takes the last)
STREAM_EGO = dict(n_core=16, n_double=24, n_pendant=24, steps=25, toggles=1,
                  p_core_edge=0.25)
STREAM_EGO_CFG = dict(dim=1, method="both", edge_cap=256, tri_cap=1024)
STREAM_CHURN = dict(n_vertices=64, n_comm=8, p_in=0.5, p_out=0.02, steps=17,
                    churn=2)
STREAM_CHURN_CFG = dict(dim=1, method="both", drift_metric="exact_w",
                        drift_threshold="auto:q0.99", **N64_CAPS)
N320_CAPS = dict(edge_cap=1024, tri_cap=256)
# the serving cells: serve_bench's TopoServe configuration over the default
# bucket ladder at 4096 requests; SimilarityServe over index_n64's index
# (4096 corpus graphs, 256 queries; the exact stage 1 on 512 and 32); four
# StreamServe sessions of the ego-decay stream (1024 graphs, 16 steps each)
SERVE_REQUESTS = 4096
SERVE_TOPO_CFG = dict(dim=1, method="prunit", sublevel=False, max_batch=128,
                      pad_batch_to=128, record_batches=True)
SERVE_SIM_CORPUS, SERVE_SIM_QUERIES = 4096, 256
SERVE_SIM_EXACT = (512, 32)
SERVE_ORACLE_SAMPLES, SERVE_ORACLE_SEED = 64, 29
SERVE_STREAM = (4, 1024, 16)
# the caps benchmarks/fig2_clustering.py gives each probe
FIG2_ER_CAPS = dict(edge_cap=128, tri_cap=512)
FIG2_TWITTER_CAPS = dict(edge_cap=192, tri_cap=192)
FIG2_FAMILY_CAPS = dict(edge_cap=160, tri_cap=384)
L1_TOLERANCE = "1e-5 * sum_d(|x_d| + |y_d|) + 1e-6"
# Sinkhorn kernels against their plain versions, and sinkhorn_w2 on CUDA
# against the CPU port: the exponents are the same floats, CUDA's expf/logf
# and the sums' order differ by ulps, which the eps ladder carries along
SK_RTOL, SK_ATOL = 1e-4, 1e-5
SK_TOLERANCE = "rtol 1e-4, atol 1e-5; -inf exactly where the plain one has it"
# the full-tensor settings of benchmarks/metrics_bench.py
SK_FULL = dict(metric="sinkhorn", impl="blocked", n_points=None, n_iters=15,
               n_scales=3)
# Work that one (row, column) pair of nonzero weight needs: (f32/integer
# lane instructions, multi-function-unit operations), counted from the
# instructions nvcc 12.8 emits for sm_90a (cuobjdump -sass) for each step;
# register moves, shared-memory loads and branches are left out.  The LSE
# needs each pair once: the cost (2 FADD, 2 FMUL, FADD, FSETP, FSEL) 7, z
# (the subtraction, the IEEE division 6 + MUFU.RCP, the add) 8 + RCP, the
# running maximum 1, the shift by it 1, the NaN test 1, expf (5 FFMA/FADD,
# SHF, FMUL) 7 + MUFU.EX2 and the add 1: 26 + 2.  The kernel keeps each
# chunk's z in registers, so its second pass is only the shift, the NaN
# test, expf and the add; per chunk of 16 columns it also merges its running
# (max, sum) (two more expf), which the bound does not count.
SK_LSE_WORK = (26, 2)
# the pair sum needs each pair of nonzero weight once: the cost 7, z 11
# (f + g, la + lb, the subtraction, the division 6 + RCP, the add), expf
# 7 + EX2, the product and the add ("plan"); the cost and the add ("cost")
SK_PAIR_WORK = {"plan": (27, 2), "cost": (8, 0)}
# exact_w on CUDA against the CPU port: converged flags and rounds bitwise;
# the distances within rtol 1e-6, atol 1e-5 (the expanded totals are f32
# sums in another order, the collapsed W^q float64 sums in another order
# rounded once, and a square root of a total near 0 magnifies an ulp)
EX_RTOL, EX_ATOL = 1e-6, 1e-5
EX_TOLERANCE = "rtol 1e-6, atol 1e-5; converged and rounds bitwise"
# lane operations of one row (or column) scan of an M-wide auction: M
# subtractions and two max passes (the best and the second best)
AUCTION_SCAN_OPS = 3
# the fixed rows whose clouds the sharded phases gather
CLOUD_ROWS_SEED = 23


class SmokeFailure(RuntimeError):
    pass


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def max_abs_err(got, want) -> int:
    """Largest |kernel - plain| over tensors of ints or bools (0 = equal)."""
    err = 0
    for a, b in zip(got, want):
        check(a.shape == b.shape, f"shape {tuple(a.shape)} vs {tuple(b.shape)}")
        if a.numel():
            err = max(err, int((a.long() - b.long()).abs().max()))
    return err


def cuda_ms(fn, reps: int = 10) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` runs, after one
    warm-up, between CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 20) -> float:
    """Mean device milliseconds per call of ``fn()`` with the host out of
    the way: a sleep kernel holds the stream while the host queues ``reps``
    calls, then CUDA events time them back to back on the device (the gaps
    between launches included).  Where back-to-back calls between plain
    events wait on the host, this reads the kernel.  The sleep doubles
    until it outlasts the queueing.  (Not torch.profiler: after a few
    sessions in one process it can miss every launch of a short window.)"""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    cycles = 4_000_000  # ~2 ms at the H100's 1.98 GHz
    for _ in range(6):
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        held = not start.query()  # the sleep still ran once all were queued
        torch.cuda.synchronize()
        if held:
            return start.elapsed_time(end) / reps
        cycles *= 2
    raise SmokeFailure("device_ms: the host could not queue the calls "
                       "within the sleep")


def host_ms_per_call(fn, reps: int = 50) -> float:
    """Mean host-clock milliseconds one call of ``fn()`` takes to return
    (the wrapper's host work and the launch, not the kernel), after one
    warm-up call and a synchronise."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / reps * 1e3


def l1_tolerance(x, y):
    """(M, N) bound on |kernel - plain| of a pairwise-L1 Gram: f32 sums of
    D nonnegative terms in another order (L1_TOLERANCE)."""
    return (1e-5 * (x.abs().sum(1)[:, None] + y.abs().sum(1)[None, :])
            + 1e-6)


def sinkhorn_error(got, want, rtol=SK_RTOL,
                   atol=SK_ATOL) -> tuple[float, bool]:
    """Largest |got - want| over the finite entries of ``want``, and whether
    every one is within atol + rtol * |want| with -inf in the same places
    (compared on the host, so ``got`` and ``want`` may sit on two devices).
    """
    import torch

    got, want = got.cpu(), want.cpu()
    same_inf = torch.equal(torch.isneginf(got), torch.isneginf(want))
    fin = torch.isfinite(want)
    err = (got[fin] - want[fin]).abs()
    if not bool(torch.isfinite(err).all()):
        return float("inf"), False
    ok = same_inf and bool((err <= atol + rtol * want[fin].abs()).all())
    return (float(err.max()) if err.numel() else 0.0), ok


# --------------------------------------------------------------- inputs

def n64_batch(device, batch=4096, seed=7):
    """The serve n64 rung in the coral_heavy regime: ER(56, 0.05) cores
    with half the vertices rewired into satellites, degree filtration."""
    from repro_torch.data.graphs import (
        attach_satellites, erdos_renyi, with_degree_filtration)

    core = erdos_renyi(seed, batch, 64, 56, 0.05, device=device)
    return with_degree_filtration(attach_satellites(seed + 1, core, 0.5))


def n320_batch(device, batch=256, seed=11):
    """Table 2's DD rung: ER(284, average degree 5) plus satellites."""
    from repro_torch.data.graphs import (
        attach_satellites, erdos_renyi, with_degree_filtration)

    core = erdos_renyi(seed, batch, 320, 284, 5.0 / 283, device=device)
    return with_degree_filtration(attach_satellites(seed + 1, core, 0.5))


def n1024_batch(device, batch=16, seed=13, sat_frac=0.55):
    """Table 1's protocol for com-youtube (2|E|/|V| = 5.27, satellite tail
    0.55): the ER core's mean degree is 5.27 / (1 - 0.55), as in repro's
    load_large_network; the phase reports the resulting mean degree."""
    from repro_torch.data.graphs import (
        attach_satellites, erdos_renyi, with_degree_filtration)

    avg_deg = 2.0 * 2_987_624 / 1_134_890 / (1.0 - sat_frac)
    core = erdos_renyi(seed, batch, 1024, 1024, avg_deg / 1023, device=device)
    return with_degree_filtration(attach_satellites(seed + 1, core, sat_frac))


# --------------------------------------------------------------- phases

def _demangle(names):
    """C++ names of mangled kernel symbols (c++filt), or the symbols."""
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True, timeout=60,
                             check=True).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        return list(names)
    return out if len(out) == len(names) else list(names)


def ptxas(source: str, prefix: str = "") -> dict:
    """ptxas's registers, static shared memory and spill bytes for each
    kernel of the built library ``source`` whose C++ name starts with
    ``prefix``, by that name."""
    from repro_torch.kernels import _build

    report = _build.ptxas_report(source)
    out = {}
    for full, info in zip(_demangle(list(report)), report.values()):
        full = full.replace("(anonymous namespace)::", "")
        name = full.removeprefix("void ").split("(")[0]
        if name.startswith(prefix):
            out[name] = info
    return out


def phase_build() -> dict:
    """Build every source (one nvcc each, in parallel) and report ptxas's
    registers, static shared memory and spill bytes for every kernel."""
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    per_source = _build.build()
    seconds = time.perf_counter() - t0
    return {"phase": "build", "seconds": seconds,
            "per_source_seconds": per_source,
            "ptxas": {k: v for name in _build.SOURCES
                      for k, v in ptxas(name).items()}}


def _random_graphs(b, n, p, seed, device):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    adj = np.triu(rng.random((b, n, n), dtype=np.float32) < p, 1)
    adj = adj | adj.transpose(0, 2, 1)
    mask = rng.random((b, n)) < 0.9
    mask[0] &= b == 1  # an empty graph, unless it is the only one
    adj &= mask[:, None, :] & mask[:, :, None]
    return (torch.from_numpy(adj).to(device),
            torch.from_numpy(mask).to(device))


def _raw_graphs(b, n, p, seed, device):
    """Symmetric graphs whose dead vertices keep their edges (the fused
    clustering epilogue masks them); graph 1 is all dead, unless it is
    the only one."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    adj = np.triu(rng.random((b, n, n), dtype=np.float32) < p, 1)
    adj = adj | adj.transpose(0, 2, 1)
    mask = rng.random((b, n)) < 0.8
    mask[min(1, b - 1)] &= b == 1
    return (torch.from_numpy(adj).to(device),
            torch.from_numpy(mask).to(device))


def _bit31_blocks(g, s, r, seed, device):
    """Sparse random columns, a third of them with a row 31 mod 32."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    w = (r + 31) // 32
    dense = np.zeros((g, s, w * 32), bool)
    rows = rng.integers(0, r, size=(g, s, 3))
    np.put_along_axis(dense, rows, True, axis=-1)
    hi = 31 + 32 * rng.integers(0, r // 32, size=(g, s, 1))  # rows < r
    dense[:, ::3] |= np.eye(w * 32, dtype=bool)[hi[:, ::3, 0]]
    words = (dense.reshape(g, s, w, 32).astype(np.uint64)
             << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)
    return torch.from_numpy(words.view(np.int32)).to(device)


def _check_gf2_layouts(record, dev, sms):
    """gf2_reduce at every layout against its plain version: W = 1, 2, 4,
    5, 8, 16, 32, 33 (rows to the top word, G past the SM count), an
    all-zero block, all-zero matrices beside a last nonzero column that is
    the matrix's last and a ragged zero tail, R < 32, G = 0, and one
    launch of four blocks of the four layouts."""
    import torch
    from repro_torch.kernels import gf2_reduce as gf2
    from repro_torch.kernels import ref

    def run(name, blocks, rows):
        got = gf2.gf2_reduce_cuda(blocks, rows)
        for b, r, out in zip(blocks, rows, got):
            lay = gf2.layout(*b.shape, r, sms)
            record("gf2_reduce", [*b.shape, r, name, lay.kind, lay.lanes],
                   max_abs_err(out, ref.gf2_reduce_ref(b, r)))

    for w in (1, 2, 4, 5, 8, 16, 32, 33):
        r = 32 * w - (5 if w > 1 else 0)
        run("width", [_bit31_blocks(300, 64, r, seed=w, device=dev)], [r])
    run("zero block", [torch.zeros((5, 30, 2), dtype=torch.int32,
                                   device=dev)], [50])
    edge = _bit31_blocks(7, 48, 100, seed=21, device=dev)
    edge[0] = 0
    edge[1, -1] = 0
    edge[1, -1, 3] = 1 << 3  # row 99: claimed by the last column
    edge[2, 20:] = 0
    run("zero, last column, zero tail", [edge], [100])
    small = _bit31_blocks(9, 40, 32, seed=22, device=dev) & ((1 << 20) - 1)
    run("R < 32", [small], [20])
    none = gf2.gf2_reduce_cuda([torch.zeros((0, 12, 2), dtype=torch.int32,
                                            device=dev)], [40])
    check([tuple(x.shape) for x in none[0]] == [(0, 12, 2), (0, 40), (0, 12)],
          "gf2_reduce on G = 0")
    mixed = [_bit31_blocks(6, s, r, seed=s, device=dev)
             for s, r in ((90, 120), (60, 500), (50, 1200), (1024, 2048))]
    rows = [120, 500, 1200, 2048]
    check([gf2.layout(*b.shape, r, sms).kind for b, r in zip(mixed, rows)]
          == ["thread", "segment", "warp", "global"],
          "gf2_reduce: the mixed launch's layouts")
    run("mixed launch", mixed, rows)


def _kcore_cluster_cases(dev):
    """(B, N, mean degree) of the cluster checks: the batch that gets each
    cluster size the selector returns at N = 1024 on this card, B = 1 and
    a ragged B, B around the SM count, ragged and 33-word N, and packed
    rows past shared memory (global scratch) at c = 8 and c = 1."""
    import torch

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return ([(sms // c, 1024, 5.0) for c in (1, 2, 4, 8)]
            + [(1, 1024, 5.0), (17, 1024, 5.0), (sms - 1, 512, 4.0),
               (sms + 1, 512, 4.0), (5, 1000, 6.0), (3, 1056, 6.0),
               (1, 96, 6.0), (2, 4096, 4.0), (67, 1500, 4.0)])


def _check_domination(record, adj, mask, shape):
    """The domination kernel bitwise the plain version, with the work
    mapping its selector took; two launches equal.  Returns the output."""
    import torch
    from repro_torch.kernels import domination as dm
    from repro_torch.kernels import ref

    got = dm.domination_cuda(adj, mask)
    check(torch.equal(got, dm.domination_cuda(adj, mask)),
          f"domination {shape}: two launches differ")
    sms = torch.cuda.get_device_properties(adj.device).multi_processor_count
    record("domination", shape + [dm.layout(*mask.shape, sms).mapping],
           max_abs_err([got], [ref.domination_ref(adj, mask)]))
    return got


def _domination_edge_graphs(n, dev):
    """Five graphs of n vertices: complete; twins 0 and 1 (each dominates
    the other); the twins with vertices 2 and 3 isolated; complete with
    every vertex dead; the twins with the upper half dead (edges kept)."""
    import numpy as np
    import torch

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
    mask = np.ones((5, n), bool)
    mask[3] = False
    mask[4, n // 2:] = False
    return (torch.from_numpy(np.stack([full, twins, lonely, full,
                                       twins])).to(dev),
            torch.from_numpy(mask).to(dev))


def _l1_layout(m, n) -> str:
    from repro_torch.kernels.pairwise_gram import small_grid

    return "small-grid 16x16" if small_grid(m, n) else "64x64"


def phase_kernel_checks(dev) -> dict:
    """Every kernel against its plain version at edge-case shapes: ragged
    N, empty graphs and batches, complete graphs, rows past shared memory,
    bit-31 lows, a gf2 block far larger than a CTA's shared memory, Gram
    shapes that leave ragged tiles, with x = y, and Sinkhorn rows with no,
    one or a few valid columns, M = 1 and ragged column tiles."""
    import numpy as np
    import torch
    from repro_torch.core.filtration import build_filtered_complex
    from repro_torch.core.persistence import _block_caps, pack_boundary_blocks
    from repro_torch.kernels import ref
    from repro_torch.kernels.common_neighbors import (
        common_neighbors_cuda, common_neighbors_rowsums_cuda)
    from repro_torch.kernels.common_neighbors import layout as cn_layout
    from repro_torch.kernels.domination import domination_cuda
    from repro_torch.kernels.gf2_reduce import gf2_reduce_cuda
    from repro_torch.kernels.kcore_peel import cluster_size, kcore_peel_cuda
    from repro_torch.kernels.pairwise_gram import pairwise_l1_cuda, small_grid

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cases = []

    def record(name, shape, err):
        cases.append({"kernel": name, "shape": shape, "max_abs_err": err})
        check(err == 0, f"{name} {shape}: kernel disagrees with plain "
                        f"version (max_abs_err {err})")

    for b, n, p in ((3, 1, 0.5), (5, 45, 0.2), (4, 100, 0.05), (2, 1000, 0.01),
                    (2, 2048, 0.004)):
        adj, mask = _random_graphs(b, n, p, seed=n, device=dev)
        for k, sweeps in ((2, 1), (2, 0), (3, 0)):
            want = mask
            while True:  # plain fixpoint (or one sweep)
                nxt = ref.kcore_peel_ref(adj, want, k)
                done = sweeps == 1 or torch.equal(nxt, want)
                want = nxt
                if done:
                    break
            got = kcore_peel_cuda(adj, mask, k, sweeps)
            record("kcore_peel", [b, n, k, sweeps], max_abs_err([got], [want]))
        _check_domination(record, adj, mask, [b, n])
    for b, n, deg in _kcore_cluster_cases(dev):
        adj, mask = _random_graphs(b, n, deg / n, seed=b + n, device=dev)
        c = cluster_size(b, n, sms)
        for k in (2, n + 1):  # n + 1: past every degree, all die
            one = ref.kcore_peel_ref(adj, mask, k)
            fix = one
            while True:
                nxt = ref.kcore_peel_ref(adj, fix, k)
                if torch.equal(nxt, fix):
                    break
                fix = nxt
            got = kcore_peel_cuda(adj, mask, k, 0)
            for sweeps, want, out in (
                    (1, one, kcore_peel_cuda(adj, mask, k, 1)),
                    (2, ref.kcore_peel_ref(adj, one, k),
                     kcore_peel_cuda(adj, mask, k, 2)),
                    (0, fix, got)):
                record("kcore_peel", [b, n, k, sweeps, f"cluster {c}"],
                       max_abs_err([out], [want]))
            check(torch.equal(got, kcore_peel_cuda(adj, mask, k, 0)),
                  f"kcore_peel {[b, n, k]}: two launches differ")
            check(k <= n or not bool(got.any()),
                  f"kcore_peel {[b, n, k]}: a vertex survived k past n")
    empty = torch.zeros((0, 8, 8), dtype=torch.bool, device=dev)
    check(kcore_peel_cuda(empty, empty[:, 0], 1, 0).shape == (0, 8),
          "kcore_peel on an empty batch")
    check(domination_cuda(empty, empty[:, 0]).shape == (0, 8, 8),
          "domination on an empty batch")
    # domination: complete graphs, twins, isolated vertices, an all-dead
    # mask and half-dead graphs, at sizes of both mappings
    for n in (7, 64, 96, 128, 129, 320, 1024):
        adj, mask = _domination_edge_graphs(n, dev)
        got = _check_domination(record, adj, mask, [5, n, "edge cases"])
        check(torch.equal(got[0], ~torch.eye(n, dtype=torch.bool,
                                             device=dev))
              and bool(got[1, 0, 1]) and bool(got[1, 1, 0])
              and not bool(got[3].any()),
              f"domination {n}: complete graph, twins or dead mask wrong")

    blocks = _bit31_blocks(4, 96, 128, seed=5, device=dev)
    want = ref.gf2_reduce_ref(blocks, 128)
    check(bool((want[1][:, 31::32] >= 0).any()), "no bit-31 pivot in the test")
    record("gf2_reduce", [4, 96, 4, "bit31"],
           max_abs_err(gf2_reduce_cuda([blocks], [128])[0], want))

    # caps that make the triangle block (8, 4096, 128) words: 2 MiB per
    # graph, the global layout (the edge block, 128 KiB a matrix, takes the
    # 8-lane segment layout in shared memory above the 48 KiB default)
    adj, mask = _random_graphs(8, 256, 0.06, seed=3, device=dev)
    mask[0] = True
    adj[0] = adj[1]
    f = torch.where(mask, adj.sum(-1).float(), float("inf"))
    fc = build_filtered_complex(adj, mask, f, 1, 4096, 4096)
    caps = _block_caps(256, 4096, 4096, 0)
    big, _, _ = pack_boundary_blocks(fc, caps)
    check(tuple(big[1].shape) == (8, 4096, 128), f"big block {big[1].shape}")
    got = gf2_reduce_cuda(big, caps[:-1])
    for d in range(2):
        record("gf2_reduce", list(big[d].shape),
               max_abs_err(got[d], ref.gf2_reduce_ref(big[d], caps[d])))
    _check_gf2_layouts(record, dev, sms)

    # common_neighbors: ragged N up to 2048, an empty batch, and complete
    # (every edge counts N - 2) and empty graphs
    for n in (1, 31, 32, 33, 64, 320, 1024, 2048):
        adj, _ = _random_graphs(3, n, min(0.5, 8.0 / n), seed=n + 1,
                                device=dev)
        record("common_neighbors", [3, n], max_abs_err(
            [common_neighbors_cuda(adj)], [ref.common_neighbors_ref(adj)]))
    for n in (5, 100):
        full = ~torch.eye(n, dtype=torch.bool, device=dev)[None]
        none = torch.zeros_like(full)
        got = common_neighbors_cuda(torch.cat([full, none]).contiguous())
        check(bool((got[0][full[0]] == n - 2).all())
              and not bool(got[0].diagonal().any()) and not bool(got[1].any()),
              f"common_neighbors: complete/empty graphs of {n}")
        record("common_neighbors", [2, n, "complete+empty"], max_abs_err(
            [got], [ref.common_neighbors_ref(torch.cat([full, none]))]))
    check(common_neighbors_cuda(torch.zeros((0, 8, 8), dtype=torch.bool,
                                            device=dev)).shape == (0, 8, 8),
          "common_neighbors on an empty batch")
    # its fused clustering epilogue: ragged N up to 2048 on both mappings,
    # dead vertices with their edges kept, an all-dead graph, complete and
    # empty graphs; two launches equal
    for b, n in ((5, 1), (5, 31), (5, 33), (17, 64), (5, 96), (5, 128),
                 (5, 129), (3, 320), (3, 1000), (2, 2048)):
        adj, mask = _raw_graphs(b, n, min(0.5, 8.0 / n), seed=n + 2,
                                device=dev)
        got = common_neighbors_rowsums_cuda(adj, mask)
        again = common_neighbors_rowsums_cuda(adj, mask)
        check(all(torch.equal(x, y) for x, y in zip(got, again)),
              f"common_neighbors row sums {[b, n]}: two launches differ")
        record("common_neighbors",
               [b, n, "rowsums", cn_layout(b, n, sms, sums=True).mapping],
               max_abs_err(got, ref.common_neighbors_rowsums_ref(adj, mask)))
    for n in (7, 100, 200):
        full = ~torch.eye(n, dtype=torch.bool, device=dev)
        adj = torch.stack([full, torch.zeros_like(full), full]).contiguous()
        mask = torch.ones((3, n), dtype=torch.bool, device=dev)
        mask[2, n // 2:] = False
        tri2, deg = common_neighbors_rowsums_cuda(adj, mask)
        half = n // 2
        check(tri2[0].tolist() == [(n - 1) * (n - 2)] * n
              and deg[0].tolist() == [n - 1] * n and not bool(tri2[1].any())
              and tri2[2].tolist() == [(half - 1) * (half - 2)] * half
              + [0] * (n - half),
              f"common_neighbors row sums: complete/empty graphs of {n}")
        record("common_neighbors", [3, n, "rowsums complete+empty"],
               max_abs_err([tri2, deg],
                           ref.common_neighbors_rowsums_ref(adj, mask)))
    tri2, deg = common_neighbors_rowsums_cuda(
        torch.zeros((0, 8, 8), dtype=torch.bool, device=dev),
        torch.zeros((0, 8), dtype=torch.bool, device=dev))
    check(tri2.shape == deg.shape == (0, 8),
          "common_neighbors row sums on an empty batch")

    # pairwise_l1: ragged M, N (M != N and x = y) and D, values up to 64
    gen = torch.Generator(device="cpu").manual_seed(17)
    for d in (1, 33, 652):
        rows = {m: (torch.rand((m, d), generator=gen) * 64).to(dev)
                for m in (1, 7, 129, 4096)}
        for m, x in rows.items():
            for n, y in rows.items():
                got = pairwise_l1_cuda(x, y)
                err = (got - ref.pairwise_l1_ref(x, y)).abs()
                ok = bool((err <= l1_tolerance(x, y)).all())
                if m == n:  # x = y: the diagonal is exactly 0
                    ok = ok and not bool(got.diagonal().any())
                cases.append({"kernel": "pairwise_l1", "shape": [m, n, d],
                              "max_abs_err": float(err.max()),
                              "within_tolerance": ok})
                check(ok, f"pairwise_l1 {[m, n, d]}: kernel outside "
                          f"{L1_TOLERANCE} of the plain version")
    # both layouts: every output of a small launch, on either side of the
    # switch to the small-grid layout, bitwise the same rows of one launch
    # of 64 x 64 tiles
    rng = np.random.default_rng(19)
    for d in (372, 652):
        x = torch.from_numpy(rng.uniform(0, 64, (4200, d)).astype(
            np.float32)).to(dev)
        y = torch.from_numpy(rng.uniform(0, 64, (4100, d)).astype(
            np.float32)).to(dev)
        check(not small_grid(4200, 4100), "pairwise_l1: 4200 x 4100 small")
        big = pairwise_l1_cuda(x, y)
        for m, n in ((72, 72), (1, 1), (33, 129), (500, 500), (520, 520),
                     (4159, 1), (4161, 1), (100, 700)):
            rows = torch.from_numpy(rng.choice(4200, m, replace=False)).to(dev)
            cols = torch.from_numpy(rng.choice(4100, n, replace=False)).to(dev)
            got = pairwise_l1_cuda(x[rows].contiguous(), y[cols].contiguous())
            differ = int((got != big[rows][:, cols]).sum())
            cases.append({"kernel": "pairwise_l1", "shape": [m, n, d],
                          "layout": _l1_layout(m, n),
                          "outputs_differing_from_64x64": differ})
            check(differ == 0, f"pairwise_l1 {[m, n, d]}: the "
                               f"{_l1_layout(m, n)} layout differs bitwise "
                               "from the 64 x 64 launch")

    # sinkhorn_lse and sinkhorn_pair_sum in both modes; a second launch on
    # the same inputs must give the same bits
    from repro_torch.kernels.sinkhorn_lse import (
        pack_columns, sinkhorn_lse_cuda, sinkhorn_pair_sum_cuda)
    from repro_torch.metrics.testing import SINKHORN_CASES, sinkhorn_operands

    def sk_record(name, shape, got, again, want):
        err, ok = sinkhorn_error(got, want)
        ok = ok and torch.equal(got, again)
        cases.append({"kernel": name, "shape": shape, "max_abs_err": err,
                      "within_tolerance": ok})
        check(ok, f"{name} {shape}: kernel outside {SK_TOLERANCE} of the "
                  "plain version, or two launches differ")

    for b, m, n, v0 in SINKHORN_CASES:
        t = sinkhorn_operands(np.random.default_rng(m + n), b, m, n, v0, dev)
        xp, yp, f, g, la, lb, e_t = (t[k] for k in (
            "xp", "yp", "f", "g", "log_a", "log_b", "e_t"))
        got = sinkhorn_lse_cuda(xp, yp, g, lb, e_t)
        # a second launch from a pack made by the caller, as the main path
        # makes it once per side and call: the same bits
        sk_record("sinkhorn_lse", [b, m, n, v0], got,
                  sinkhorn_lse_cuda(xp, yp, g, lb, e_t,
                                    pack_columns(yp, lb)),
                  ref.sinkhorn_lse_ref(xp, yp, g, lb, e_t))
        check(v0 or bool(torch.isneginf(got[0]).all()),
              "sinkhorn_lse: a row with no valid column is not -inf")
        for mode in ("plan", "cost"):
            args = (xp, yp, f, g, la, lb, e_t, mode)
            got = sinkhorn_pair_sum_cuda(*args)
            sk_record("sinkhorn_pair_sum", [b, m, n, v0, mode], got,
                      sinkhorn_pair_sum_cuda(*args),
                      ref.sinkhorn_pair_sum_ref(*args))
            check(v0 or float(got[0]) == 0.0,
                  "sinkhorn_pair_sum: an item with no valid pair is not 0")
    # the pair sum's layout branches, and three launches on one input
    # interleaved with launches on another: equal bits, so every launch
    # leaves its tickets at 0
    from repro_torch.kernels.sinkhorn_lse import layout as pair_layout
    from repro_torch.metrics.testing import PAIR_SUM_CASES, pair_sum_operands

    keys = ("xp", "yp", "f", "g", "log_a", "log_b", "e_t")
    for case in PAIR_SUM_CASES:
        t = pair_sum_operands(np.random.default_rng(sum(case[:3])), *case,
                              dev)
        lay = pair_layout(*case[:3], sms)
        for mode in ("plan", "cost"):
            args = (*(t[k] for k in keys), mode)
            got = sinkhorn_pair_sum_cuda(*args)
            sk_record("sinkhorn_pair_sum",
                      [*case, mode, f"{lay.ctas_per_item} CTAs an item"],
                      got, sinkhorn_pair_sum_cuda(*args),
                      ref.sinkhorn_pair_sum_ref(*args))
            check(case[3] != "last" or float(got[0]) == 0.0,
                  "sinkhorn_pair_sum: an item with no weight is not 0")
    t = sinkhorn_operands(np.random.default_rng(3), 2, 3200, 3200, 40, dev)
    one = (*(t[k] for k in keys), "plan")
    t = pair_sum_operands(np.random.default_rng(4), 3, 300, 700, "last", dev)
    other = [t[k] for k in keys]
    first = sinkhorn_pair_sum_cuda(*one)
    again = []
    for mode in ("plan", "cost"):
        sinkhorn_pair_sum_cuda(*other, mode)
        again.append(sinkhorn_pair_sum_cuda(*one))
    check(all(torch.equal(first, a) for a in again),
          "sinkhorn_pair_sum: launches interleaved with others differ")
    record("sinkhorn_pair_sum", [2, 3200, 3200, "interleaved x3"], 0)

    # the auction kernels over the shared case list: everything bitwise but
    # the totals
    from repro_torch.metrics.testing import (
        AUCTION_CASES, AUCTION_TOTAL_TOLERANCE, auction_agreement,
        auction_case, solve_auction_case)

    for case in AUCTION_CASES:
        kind, b, m, opts, solver = case
        name = "auction_lap" if kind == "expanded" else "auction_lap_collapsed"
        got = solve_auction_case(case, dev, kernel=True)
        want = solve_auction_case(case, dev, kernel=False)
        t, _ = auction_case(case, dev)
        differ, err, ok = auction_agreement(got, want,
                                            t.get("cost", t.get("cbar")))
        cases.append({"kernel": name, "shape": [kind, b, m, opts, solver],
                      "outputs_differing": differ, "max_abs_err": err,
                      "within_tolerance": differ == 0 and ok,
                      "converged": int(want[2].sum()),
                      "rounds_max": int(want[3].max())})
        check(differ == 0 and ok, f"{name} {cases[-1]['shape']}: {differ} "
                                  f"outputs differ from the plain version, "
                                  f"or a total is outside "
                                  f"{AUCTION_TOTAL_TOLERANCE}")
    # hamming_scan: W 1..5 words, ragged Q and N, N = 1, bit-31 words,
    # all-ones and multi-probe masks; a second launch gives the same bits
    from repro_torch.kernels.hamming import (
        as_int32_words, hamming_scan_cuda, pack_codes_u32)
    from repro_torch.kernels.hamming import layout as hamming_layout
    from repro_torch.metrics.testing import (
        HAMMING_CASES, HAMMING_KERNEL_CASES, hamming_operands)

    for case in HAMMING_CASES + HAMMING_KERNEL_CASES:
        cq, cd, mq = (as_int32_words(pack_codes_u32(a)).to(dev)
                      for a in hamming_operands(
                          np.random.default_rng(sum(case[:3])), *case))
        check(bool((cd < 0).any()), f"hamming_scan {case}: no bit-31 word")
        got = hamming_scan_cuda(cq, mq, cd)
        want = ref.hamming_scan_ref(cq, mq, cd)
        check(torch.equal(got, hamming_scan_cuda(cq, mq, cd)),
              f"hamming_scan {case}: two launches differ")
        path = hamming_layout(cq.shape[0], cd.shape[0], cq.shape[1],
                              sms).path
        record("hamming_scan", [*case, path], max_abs_err([got], [want]))
        # the corpus one word into its storage: no 16-byte loads
        shifted = torch.cat([cd.new_zeros(1), cd.flatten()])[1:].view(
            cd.shape)
        record("hamming_scan", [*case, path, "unaligned corpus"],
               max_abs_err([hamming_scan_cuda(cq, mq, shifted)], [want]))
    return {"phase": "kernels_check", "cases": len(cases),
            "mismatches": 0, "l1_tolerance": L1_TOLERANCE,
            "sinkhorn_tolerance": SK_TOLERANCE,
            "auction_tolerance": "bitwise but the totals: "
                                 + AUCTION_TOTAL_TOLERANCE,
            "detail": cases}


class Recorder:
    """Keeps a copy of the largest input each kernel saw on the main path,
    so the timings run at shapes the main path really gives the kernel."""

    def __init__(self):
        self.inputs = {}
        self.phase = None  # recording while set

    def install(self):
        from repro_torch.kernels import ops

        # each wrapper's attribute in ops -> its kernel's name; the
        # clustering path launches common_neighbors through its fused
        # epilogue
        names = {f"{name}_cuda": name for name in REPLACES}
        names["common_neighbors_rowsums_cuda"] = "common_neighbors"
        originals = {attr: getattr(ops, attr) for attr in names}
        sizes = {"kcore_peel": lambda adj, *a: adj.numel(),
                 "domination": lambda adj, *a: adj.numel(),
                 "gf2_reduce": lambda blocks, *a: sum(b.numel()
                                                      for b in blocks),
                 "common_neighbors": lambda adj, *a: adj.numel(),
                 "pairwise_l1": lambda x, y, *a: x.shape[0] * y.numel(),
                 # B * M * N; the pair sum's "plan" mode ahead of "cost"
                 "sinkhorn_lse": lambda xp, yp, *a: xp.numel() // 3
                 * yp.shape[-1],
                 "sinkhorn_pair_sum": lambda xp, yp, *a: (
                     xp.numel() // 3 * yp.shape[-1], a[-1] == "plan"),
                 "auction_lap": lambda cost, *a: cost.numel(),
                 "auction_lap_collapsed": lambda cbar, *a: cbar.numel(),
                 "hamming_scan": lambda q, m, c: q.shape[0] * c.numel()}

        def wrap(name, fn, size_of):
            def recorded(*args):
                if self.phase is not None:
                    size = size_of(*args)
                    best = self.inputs.get((self.phase, name))
                    if best is None or size > best[0]:
                        self.inputs[(self.phase, name)] = (size, _clone(args))
                return fn(*args)
            return recorded

        for attr, fn in originals.items():
            setattr(ops, attr, wrap(names[attr], fn, sizes[names[attr]]))
        return originals

    @staticmethod
    def uninstall(originals):
        from repro_torch.kernels import ops

        for attr, fn in originals.items():
            setattr(ops, attr, fn)


def _clone(args):
    import torch

    out = []
    for a in args:
        if isinstance(a, torch.Tensor):
            out.append(a.clone())
        elif isinstance(a, list):
            out.append([x.clone() if isinstance(x, torch.Tensor) else x
                        for x in a])
        else:
            out.append(a)
    return tuple(out)


def _drive(recorder, phase, fn, *args):
    """One main-path call with every count set to 0 just before it and the
    kernels' inputs recorded; returns (result, counts, seconds)."""
    import torch
    from repro_torch import counters

    torch.cuda.synchronize()
    counters.reset()
    recorder.phase = phase
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    recorder.phase = None
    return out, counters.snapshot(), seconds


def _pairs_equal(d1, d2, rows, dim) -> bool:
    from repro_torch.core.persistence import diagrams_to_numpy

    return all(diagrams_to_numpy(d1, i, dim)[dim]
               == diagrams_to_numpy(d2, i, dim)[dim] for i in rows)


def _subset(g, idx):
    import torch

    return g.index(torch.as_tensor(idx, device=g.device))


def phase_signature(name, g, caps, n_cpu, n_off, launches, recorder):
    """Drive the two-phase plan on CUDA; check it against the CPU port and
    against the single-phase plan; time reduce and persist.  Returns the
    phase's record and the Diagrams of its main-path run."""
    import torch
    from repro_torch.core.api import make_topo_plan
    from repro_torch.core.persistence import diagrams_bitwise_equal

    plan = make_topo_plan(dim=1, method="both", repack="on", **caps)
    (d, report), counts, first_s = _drive(recorder, name, plan.execute_info,
                                          g)
    for k in launches:
        launches[k] += counts[k]
    check(torch.isfinite(d.birth[d.valid]).all().item(), "non-finite births")
    check(bool((d.dim[d.valid] <= 1).all()), "dimension above 1")

    # CPU port on the first graphs: bitwise equal Diagrams
    sub = list(range(n_cpu))
    d_cpu = plan.execute(_subset(g, sub).to("cpu"))
    cpu_equal = diagrams_bitwise_equal(
        d_cpu, type(d)(*(getattr(d, k)[:n_cpu] for k in
                         ("birth", "death", "dim", "valid"))))
    check(cpu_equal, f"{name}: CUDA and CPU Diagrams differ")
    # single-phase plan on CUDA: the same PD_1 pairs graph by graph
    single = make_topo_plan(dim=1, method="both", repack="off", **caps)
    d_off = single.execute(_subset(g, list(range(n_off))))
    check(_pairs_equal(d, d_off, range(n_off), 1),
          f"{name}: repack on/off PD_1 pairs differ")

    # steady-state times (the kernels are built and loaded by now)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plan.reduce_phase(g)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    plan.execute_info(g)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    v0 = max(int(g.n_vertices().sum()), 1)
    e0 = max(int(g.n_edges().sum()), 1)
    total_ms = (t2 - t1) * 1e3
    reduce_ms = (t1 - t0) * 1e3
    return d, {"phase": name, "graphs": g.batch, "n_pad": g.n, **caps,
            "v_reduction_pct": 100.0 * (v0 - int(report.n_vertices.sum())) / v0,
            "e_reduction_pct": 100.0 * (e0 - int(report.n_edges.sum())) / e0,
            "rung_histogram": {f"n{k}": v for k, v in
                               sorted(report.rung_histogram().items())},
            "first_run_ms": first_s * 1e3, "reduce_ms": reduce_ms,
            "persist_ms": total_ms - reduce_ms, "total_ms": total_ms,
            "graphs_per_s": g.batch / (total_ms / 1e3),
            "prune_rounds": counts["prune_rounds"],
            "fixpoint_sweeps": counts["fixpoint_sweeps"],
            "launches": {k: counts[k] for k in launches},
            "cpu_bitwise_equal_graphs": n_cpu,
            "repack_off_pairs_equal_graphs": n_off}


def phase_table1(g, launches, recorder) -> dict:
    """Table 1's protocol through the kernels: ``reduction_stats`` (the
    mean per-graph reduction %, as benchmarks/table1_large_networks.py
    reports it), with the reduced masks held bitwise against the CPU port."""
    import torch
    from repro_torch.core.api import reduce_graphs, reduction_stats

    out = {"phase": "table1_n1024", "graphs": g.batch, "n_pad": g.n,
           "mean_degree": float(g.degrees().float().sum()
                                / g.n_vertices().sum())}
    g_cpu = g.to("cpu")
    for dim, method, sub in ((0, "prunit", False), (1, "both", True)):
        st, counts, seconds = _drive(recorder, "table1_n1024", reduction_stats,
                                     g, dim, method, sub)
        for k in launches:
            launches[k] += counts[k]
        mask = reduce_graphs(g, dim, method, sub).mask
        want = reduce_graphs(g_cpu, dim, method, sub).mask
        check(torch.equal(mask.cpu(), want),
              f"table1 dim{dim} {method}: masks differ")
        out[f"dim{dim}_{method}"] = {
            "sublevel": sub,
            "v_reduction_pct": st.v_reduction_pct().mean().item(),
            "e_reduction_pct": st.e_reduction_pct().mean().item(),
            "reduce_ms": seconds * 1e3, "prune_rounds": counts["prune_rounds"],
            "launches": {k: counts[k] for k in launches},
            "cpu_masks_equal": True}
    return out


def _host_ms(fn, reps: int = 5) -> float:
    """Mean host-clock milliseconds of ``fn()``, device-synchronised, after
    one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def _mean_cc(cc, mask):
    """(B,) mean clustering coefficient of each graph's live vertices."""
    return cc.sum(-1) / mask.sum(-1).clamp(min=1)


def _add_counts(launches, counts) -> dict:
    for k in launches:
        launches[k] += counts[k]
    return {k: counts[k] for k in launches}


def phase_clustering(name, g, launches, recorder) -> dict:
    """``clustering_coefficients`` through the common-neighbors kernel,
    held bitwise against the CPU port; host-clock time of a steady call."""
    import torch
    from repro_torch.kernels.ops import clustering_coefficients

    cc, counts, first_s = _drive(recorder, name, clustering_coefficients,
                                 g.adj, g.mask)
    want = clustering_coefficients(g.adj.cpu(), g.mask.cpu())
    check(torch.equal(cc.cpu(), want),
          f"{name}: CUDA and CPU clustering coefficients differ")
    check(bool(((cc >= 0) & (cc <= 1)).all()), f"{name}: cc outside [0, 1]")
    ms = _host_ms(lambda: clustering_coefficients(g.adj, g.mask))
    return {"phase": name, "graphs": g.batch, "n_pad": g.n,
            "mean_clustering": float(_mean_cc(cc, g.mask).mean()),
            "first_run_ms": first_s * 1e3, "ms": ms,
            "graphs_per_s": g.batch / (ms / 1e3),
            "launches": _add_counts(launches, counts),
            "cpu_bitwise_equal": True}


def phase_clustering_twitter(dev, launches, recorder, n_cpu=64) -> dict:
    """The TWITTER surrogate whole (973 graphs, n_pad 128): its mean
    clustering, and its mean PD_1 count through ``topological_signature``
    with fig2's caps; the Diagrams of the first graphs are held bitwise
    against the CPU port."""
    from repro_torch.core.api import topological_signature
    from repro_torch.core.persistence import Diagrams, diagrams_bitwise_equal
    from repro_torch.data.graphs import TABLE2, load_dataset

    g = load_dataset("TWITTER", 31, batch=TABLE2["TWITTER"].n_graphs,
                     device=dev)
    out = phase_clustering("clustering_twitter", g, launches, recorder)

    def signature(gb):
        return topological_signature(gb, dim=1, method="both",
                                     **FIG2_TWITTER_CAPS)

    d, counts, seconds = _drive(recorder, "clustering_twitter", signature, g)
    d_cpu = signature(_subset(g, list(range(n_cpu))).to("cpu"))
    check(diagrams_bitwise_equal(d_cpu, Diagrams(*(
        getattr(d, k)[:n_cpu] for k in ("birth", "death", "dim", "valid")))),
        "clustering_twitter: CUDA and CPU Diagrams differ")
    out.update(mean_pd1_features=float(d.count(1).float().mean()),
               **FIG2_TWITTER_CAPS, signature_ms=seconds * 1e3,
               signature_launches=_add_counts(launches, counts),
               cpu_bitwise_equal_diagrams=n_cpu)
    return out


def _rank_mismatches(rows_a, rows_b, dist, tol) -> tuple[int, int]:
    """Ranks where two k-NN answers name different rows: (how many are not
    explained by a near tie, how many are: the two rows' distances, in
    ``dist``, lie within ``tol`` of each other)."""
    import numpy as np

    qi, ri = np.nonzero(rows_a != rows_b)
    a, b = rows_a[qi, ri], rows_b[qi, ri]
    near = (np.abs(dist[qi, a] - dist[qi, b])
            <= np.maximum(tol[qi, a], tol[qi, b]))
    return int((~near).sum()), int(near.sum())


def phase_index(d64, dev, launches, recorder, n_queries=256, k=10,
                n_cpu_rows=512) -> dict:
    """TopoIndex(embedding="both") at the default widths over the n64
    diagrams: add, the 4096 x 4096 Gram, k-NN queries without and with the
    LSH stage (its coarse scan one ``hamming_scan`` launch), and a
    save/load round trip, each held against the CPU port (the Gram on a
    slice of ``n_cpu_rows`` rows)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.core.api import make_topo_plan
    from repro_torch.index import TopoIndex, TopoIndexConfig
    from repro_torch.kernels import ops

    cfg = TopoIndexConfig(embedding="both")
    cfg_lsh = dataclasses.replace(cfg, coarse="lsh")
    plan = make_topo_plan(dim=1, method="both", repack="on", **N64_CAPS)
    dq = plan.execute(n64_batch(dev, batch=n_queries, seed=101))
    index = TopoIndex(cfg, device=dev)
    index_lsh = TopoIndex(cfg_lsh, device=dev)

    def run():
        index.add(d64)
        index_lsh.add(d64)
        return index.gram(), index.query(dq, k), index_lsh.query(dq, k)

    (gram, q_none, q_lsh), counts, first_s = _drive(recorder, "index_n64",
                                                    run)
    out = {"phase": "index_n64", "rows": len(index), "width": cfg.width,
           "queries": n_queries, "k": k, "first_run_ms": first_s * 1e3,
           "launches": _add_counts(launches, counts)}
    check(counts["hamming_scan"] == 1,
          f"index_n64: the LSH query launched hamming_scan "
          f"{counts['hamming_scan']} times, not once")
    check(bool(torch.isfinite(gram).all()) and not bool(gram.diagonal().any()),
          "index_n64: Gram not finite or its diagonal not 0")

    # the CPU port on the same diagrams
    cpu = TopoIndex(cfg, device="cpu")
    cpu_lsh = TopoIndex(cfg_lsh, device="cpu")
    d_cpu, dq_cpu = d64.to("cpu"), dq.to("cpu")
    cpu.add(d_cpu)
    cpu_lsh.add(d_cpu)
    check(np.allclose(index._emb, cpu._emb, rtol=1e-5, atol=1e-6),
          "index_n64: CUDA and CPU embeddings differ beyond rtol 1e-5")
    e_cpu = torch.from_numpy(cpu._emb)
    g_cpu = ops.pairwise_l1(e_cpu[:n_cpu_rows].contiguous(), e_cpu)
    gram_err = (gram[:n_cpu_rows].cpu() - g_cpu).abs()
    check(bool((gram_err <= l1_tolerance(e_cpu[:n_cpu_rows], e_cpu)).all()),
          f"index_n64: Gram outside {L1_TOLERANCE} of the CPU port")
    eq_cpu = cpu.embed(dq_cpu)
    dist = ops.pairwise_l1(eq_cpu, e_cpu).numpy()
    tol = l1_tolerance(eq_cpu, e_cpu).numpy()
    for mode, idx, idx_cpu, got in (("none", index, cpu, q_none),
                                    ("lsh", index_lsh, cpu_lsh, q_lsh)):
        want = idx_cpu.query(dq_cpu, k)
        bad, near = _rank_mismatches(np.asarray(got.rows),
                                     np.asarray(want.rows), dist, tol)
        check(bad == 0, f"index_n64 coarse={mode}: {bad} ids differ from the "
                        "CPU port beyond a near tie")
        out[f"query_{mode}"] = {"near_tie_swaps": near,
                                "stage": got.stats["stage"],
                                "ms": _host_ms(lambda: idx.query(dq, k))}
    recall = np.mean([len(set(a) & set(b)) / k
                      for a, b in zip(q_lsh.ids, q_none.ids)])

    # save -> load: the same answers from the loaded index
    path = ROOT / "build" / "chip_smoke_index.npz"
    path.parent.mkdir(exist_ok=True)
    try:
        index_lsh.save(str(path))
        loaded = TopoIndex.load(str(path), device=dev)
    finally:
        path.unlink(missing_ok=True)
    q2 = loaded.query(dq, k)
    check(q2.ids == q_lsh.ids and np.array_equal(q2.distances, q_lsh.distances)
          and np.array_equal(loaded._codes, index_lsh._codes)
          and torch.equal(loaded._device_codes(), index_lsh._device_codes()),
          "index_n64: save/load changed the answers or the device codes")
    out.update(
        embeddings_bitwise_equal_share=float(
            (index._emb == cpu._emb).mean()),
        lsh_codes_equal=bool(np.array_equal(index_lsh._codes,
                                            cpu_lsh._codes)),
        gram_max_abs_err_vs_cpu=float(gram_err.max()),
        cpu_gram_rows=n_cpu_rows, l1_tolerance=L1_TOLERANCE,
        lsh_recall_at_k=float(recall), save_load_equal=True,
        add_ms=_host_ms(lambda: TopoIndex(cfg, device=dev).add(d64), reps=3),
        gram_ms=_host_ms(index.gram))
    return out, (index, index_lsh, dq, k)


def _gram_against_one_call(gram, emb, chunk=8192):
    """``gram`` against ``pairwise_l1(emb, emb)`` built ``chunk`` rows at a
    time (each entry is its own sum, so a row block gives the same bits):
    the largest |difference|, whether every entry is within L1_TOLERANCE,
    and whether all are bitwise equal."""
    import torch
    from repro_torch.kernels import ops

    err, ok, same = 0.0, True, True
    for i in range(0, emb.shape[0], chunk):
        x = emb[i:i + chunk]
        want = ops.pairwise_l1(x, emb)
        diff = (gram[i:i + chunk] - want).abs()
        err = max(err, float(diff.max()))
        ok = ok and bool((diff <= l1_tolerance(x, emb)).all())
        same = same and bool(torch.equal(gram[i:i + chunk], want))
    return err, ok, same


def _host_candidates(index, emb_q_np, m, probes=None):
    """The host numpy scan of ``repro``'s single-host index over host copies
    of ``index``'s codes: (Q, m) rows by (distance, row)."""
    from repro_torch.index.topo_index import host_scan

    codes_q, mask_q = index._query_codes(emb_q_np, probes)
    return host_scan(codes_q, index._codes, mask_q, m)


def _single_host_lsh(index_lsh, dq, k, emb_q, emb_q_np, host_reps):
    """The single-host index's LSH query on the card (its coarse stage the
    ``hamming_scan`` kernel): candidates (probes 1 and 4) bitwise the host
    numpy scan's on host copies of the same codes, and its ids and
    distances bitwise a query ranked from the host scan's candidates; the
    query and coarse times of both routes."""
    import numpy as np

    m = k * index_lsh.config.lsh_overfetch
    for probes in (1, 4):
        check(np.array_equal(
            index_lsh._coarse_candidates(emb_q_np, m * probes, probes),
            _host_candidates(index_lsh, emb_q_np, m * probes, probes)),
            f"single-host index, probes {probes}: the device scan's "
            "candidates differ from the host scan's")
    got = index_lsh.query(dq, k)

    def host_query():
        return index_lsh._rank_candidates(
            emb_q, _host_candidates(index_lsh, emb_q_np, m), k)

    dist, rows = host_query()
    check(np.array_equal(np.asarray(got.rows), rows)
          and np.array_equal(got.distances, dist),
          "single-host index: the device-scan query's answers differ from "
          "the host scan's")
    return got, {
        "query_lsh_ms": _host_ms(lambda: index_lsh.query(dq, k),
                                 reps=host_reps),
        "coarse_ms": _host_ms(
            lambda: index_lsh._coarse_candidates(emb_q_np, m),
            reps=host_reps),
        "host_scan_query_lsh_ms": _host_ms(host_query, reps=host_reps),
        "host_scan_ms": _host_ms(
            lambda: _host_candidates(index_lsh, emb_q_np, m),
            reps=host_reps),
        "candidates_bitwise_host_scan": True,
        "query_bitwise_host_scan": True}


def phase_sharded_index(name, index_lsh, dq, k, meshes, launches, recorder,
                        index_none=None, host_reps=3) -> tuple[dict, object]:
    """``index_lsh`` wrapped in a ShardedIndex on each of ``meshes``: one
    main-path run (LSH query, SUMMA Gram, cloud gather) per mesh, the
    coarse candidates (probes 1 and 4) bitwise the host scan's, the query
    ids and distances bitwise ``index_lsh.query``'s, the clouds bitwise
    ``index_lsh.clouds``', the SUMMA Gram and the SUMMA query Gram within
    L1_TOLERANCE; and the sharded LSH query's time beside the single-host
    index's (``_single_host_lsh``: on the kernel, and from the host numpy
    scan).  ``index_none``, where given, is the same corpus without the
    LSH stage: its sharded query goes through the SUMMA Gram and must name
    the same rows but for near ties.  Returns the record and the first
    sharded index."""
    import numpy as np
    from repro_torch.core.persistence import diagrams_bitwise_equal
    from repro_torch.index import ShardedIndex
    from repro_torch.kernels import ops

    cfg = index_lsh.config
    n = len(index_lsh)
    emb_q = index_lsh.embed(dq)
    emb_q_np = emb_q.cpu().numpy()
    m = k * cfg.lsh_overfetch
    rows = np.random.default_rng(CLOUD_ROWS_SEED).integers(0, n, (64, k))
    want, single = _single_host_lsh(index_lsh, dq, k, emb_q, emb_q_np,
                                    host_reps)
    want_clouds = index_lsh.clouds(rows)
    e = index_lsh._emb_device
    q_dist = ops.pairwise_l1(emb_q, e)
    q_tol = l1_tolerance(emb_q, e)
    out = {"phase": name, "rows": n, "width": cfg.width,
           "queries": emb_q.shape[0], "k": k, "lsh_bits": cfg.lsh_bits,
           "coarse_candidates": m, "l1_tolerance": L1_TOLERANCE,
           "single_host": single, "meshes": []}
    first = None
    for mesh in meshes:
        sharded = ShardedIndex.from_index(index_lsh, mesh=mesh)
        if first is None:
            first = sharded

        def run():
            return sharded.query(dq, k), sharded.gram(), sharded.clouds(rows)

        (got, gram, clouds), counts, first_s = _drive(recorder, name, run)
        tag = f"{name} mesh {mesh.shape}"
        check(counts["hamming_scan"] >= mesh.size,
              f"{tag}: hamming_scan launched {counts['hamming_scan']} times")
        check(np.array_equal(np.asarray(got.rows), np.asarray(want.rows))
              and got.ids == want.ids
              and np.array_equal(got.distances, want.distances),
              f"{tag}: query answers differ from the single-host index")
        check(diagrams_bitwise_equal(clouds, want_clouds),
              f"{tag}: gathered clouds differ")
        for probes in (1, 4):
            cand = sharded._coarse_candidates(emb_q_np, m * probes, probes)
            check(np.array_equal(cand, _host_candidates(
                index_lsh, emb_q_np, m * probes, probes)),
                f"{tag}: probes {probes}: candidates differ from the host "
                "scan's")
        gram_err, gram_ok, gram_bitwise = _gram_against_one_call(gram, e)
        check(gram_ok, f"{tag}: SUMMA Gram outside {L1_TOLERANCE}")
        del gram
        g_q = sharded._summa_gram(emb_q)
        check(bool(((g_q - q_dist).abs() <= q_tol).all()),
              f"{tag}: SUMMA query Gram outside {L1_TOLERANCE}")
        rec = {"mesh": mesh.shape, "shards": mesh.size,
               "first_run_ms": first_s * 1e3,
               "launches": _add_counts(launches, counts),
               "candidates_bitwise_equal": True, "query_bitwise_equal": True,
               "clouds_bitwise_equal": True,
               "gram_max_abs_err": gram_err, "gram_bitwise_equal":
               gram_bitwise,
               "summa_query_max_abs_err": float((g_q - q_dist).abs().max()),
               "query_lsh_ms": _host_ms(lambda: sharded.query(dq, k)),
               "coarse_ms": _host_ms(
                   lambda: sharded._coarse_candidates(emb_q_np, m)),
               "gram_ms": _host_ms(sharded.gram, reps=2)}
        del g_q
        if index_none is not None:
            dense = ShardedIndex.from_index(index_none, mesh=mesh)
            got_none = dense.query(dq, k)
            want_none = index_none.query(dq, k)
            dist, tol = q_dist.cpu().numpy(), q_tol.cpu().numpy()
            bad, near = _rank_mismatches(np.asarray(got_none.rows),
                                         np.asarray(want_none.rows), dist,
                                         tol)
            check(bad == 0 and got_none.stats["stage"] == "sharded_gram",
                  f"{tag}: {bad} SUMMA-query ids differ beyond a near tie")
            rec["query_none"] = {"near_tie_swaps": near,
                                 "ms": _host_ms(lambda: dense.query(dq, k))}
        out["meshes"].append(rec)
    return out, first


def phase_sharded_index_n65536(dev, launches, recorder, n=65536,
                               n_queries=256, k=10) -> dict:
    """``phase_sharded_index`` at 65,536 rows on the mesh (1, 1): noisy
    copies of 64 seed diagrams (1024 each, so codes tie in crowds), at
    ``index_n64``'s configuration, queried with 256 fresh copies."""
    import dataclasses

    import numpy as np
    from repro_torch.index import TopoIndex, TopoIndexConfig
    from repro_torch.launch import make_index_mesh
    from repro_torch.metrics.testing import noisy_copies, seed_diagram_arrays

    rng = np.random.default_rng(65536)
    seeds = seed_diagram_arrays(rng, 64, 16)
    corpus = noisy_copies(seeds, rng, n, 0.05, 0.6, device=dev)
    dq = noisy_copies(seeds, rng, n_queries, 0.05, 0.6, device=dev)
    cfg = dataclasses.replace(TopoIndexConfig(embedding="both"),
                              coarse="lsh")
    index_lsh = TopoIndex(cfg, device=dev)
    t0 = time.perf_counter()
    index_lsh.add(corpus)
    add_s = time.perf_counter() - t0
    out, _ = phase_sharded_index("sharded_index_n65536", index_lsh, dq, k,
                                 [make_index_mesh()], launches, recorder,
                                 host_reps=1)
    out["add_ms"] = add_s * 1e3
    return out


def kernel_kmeans(kmat, n_clusters: int, seed: int = 0, n_iters: int = 30):
    """Kernel k-means on a precomputed PSD kernel matrix (numpy; the copy
    of ``benchmarks/fig2_clustering.py``'s)."""
    import numpy as np

    n = kmat.shape[0]
    rng = np.random.default_rng(seed)
    assign = rng.integers(0, n_clusters, n)
    diag = np.diag(kmat)
    for _ in range(n_iters):
        dist = np.empty((n, n_clusters))
        for c in range(n_clusters):
            in_c = assign == c
            if not in_c.any():  # reseed an empty cluster
                far = int(np.argmax(dist[:, :c].min(axis=1))) if c else 0
                in_c = np.zeros(n, bool)
                in_c[far] = True
            kc = kmat[:, in_c]
            dist[:, c] = (diag - 2.0 * kc.mean(axis=1)
                          + kmat[np.ix_(in_c, in_c)].mean())
        new = dist.argmin(axis=1)
        if (new == assign).all():
            break
        assign = new
    return assign


def cluster_purity(assign, labels) -> float:
    """Majority-label purity of a clustering against the families."""
    import numpy as np

    correct = sum(np.bincount(labels[assign == c]).max()
                  for c in np.unique(assign))
    return correct / len(labels)


def kernel_ncc_accuracy(kmat, labels, train) -> float:
    """Held-out accuracy of a kernel nearest-centroid classifier."""
    import numpy as np

    test = ~train
    classes = np.unique(labels[train])
    diag = np.diag(kmat)[test]
    dist = np.empty((test.sum(), len(classes)))
    for ci, c in enumerate(classes):
        in_c = train & (labels == c)
        dist[:, ci] = (diag - 2.0 * kmat[np.ix_(test, in_c)].mean(axis=1)
                       + kmat[np.ix_(in_c, in_c)].mean())
    pred = classes[dist.argmin(axis=1)]
    return float((pred == labels[test]).mean())


def _fig2_probe3(dev, per_family, seed=5):
    """Probe 3's diagrams (three families, ``per_family`` graphs each),
    family labels, and a TopoIndex over them."""
    import numpy as np
    import torch
    from repro_torch.core.api import topological_signature
    from repro_torch.core.persistence import Diagrams
    from repro_torch.data import graphs as gd
    from repro_torch.index import TopoIndex, TopoIndexConfig

    families = (lambda s: gd.watts_strogatz(s, per_family, 24, 20, 4, 0.1,
                                            device=dev),
                lambda s: gd.erdos_renyi(s, per_family, 24, 20, 0.45,
                                         device=dev),
                lambda s: gd.barabasi_albert(s, per_family, 24, 20, 1,
                                             device=dev))
    ds = [topological_signature(gd.with_degree_filtration(gen(seed + i)),
                                dim=1, method="both", **FIG2_FAMILY_CAPS)
          for i, gen in enumerate(families)]
    d = Diagrams(*(torch.cat([getattr(x, k) for x in ds])
                   for k in ("birth", "death", "dim", "valid")))
    # "both": tree-like and dense families both have near-empty PD_1, so
    # PD_0 statistics must help separate them (the benchmark's setting)
    index = TopoIndex(TopoIndexConfig(embedding="both", k=1, n_points=12,
                                      n_dirs=12, res=6), device=dev)
    index.add(d)
    return d, np.repeat(np.arange(len(families)), per_family), index


def _kernel_scores(dist, labels):
    """The benchmark's SW-kernel k-means purity and nearest-centroid
    accuracy from an L1 distance matrix."""
    import numpy as np

    gamma = 1.0 / max(np.median(dist[dist > 0]), 1e-9)
    kmat = np.exp(-gamma * dist)
    assign = kernel_kmeans(kmat, n_clusters=3, seed=3)
    train = (np.arange(len(labels)) % 3) != 2
    return (assign, cluster_purity(assign, labels),
            kernel_ncc_accuracy(kmat, labels, train))


def phase_fig2(dev, launches, recorder, per_family=24) -> dict:
    """The three probes of benchmarks/fig2_clustering.py through the port:
    (1) an ER density sweep of mean clustering vs mean PD_1 count, (2) the
    TWITTER surrogate, (3) SW-kernel k-means and nearest-centroid over three
    graph families, which must reach purity and accuracy >= 0.66; probe 3
    is held against the CPU port (Diagrams bitwise, Gram within
    tolerance, the same k-means assignment)."""
    import numpy as np
    import torch
    from repro_torch.core.api import topological_signature
    from repro_torch.core.persistence import diagrams_bitwise_equal
    from repro_torch.data.graphs import (
        erdos_renyi, load_dataset, with_degree_filtration)
    from repro_torch.kernels.ops import clustering_coefficients

    def mean_cc(g):
        return float(_mean_cc(clustering_coefficients(g.adj, g.mask),
                              g.mask).mean())

    def run():
        band = {}
        for p in (0.05, 0.12, 0.25, 0.45, 0.7, 0.9):
            # N=14 keeps the whole clique complex inside the caps
            g = with_degree_filtration(
                erdos_renyi(31 + int(p * 100), 8, 14, 14, p, device=dev))
            d = topological_signature(g, dim=1, method="both", **FIG2_ER_CAPS)
            band[p] = (mean_cc(g), float(d.count(1).float().mean()))
        g = load_dataset("TWITTER", 31, batch=8, device=dev)
        d = topological_signature(g, dim=1, method="both",
                                  **FIG2_TWITTER_CAPS)
        twitter = (mean_cc(g), float(d.count(1).float().mean()))
        d, labels, index = _fig2_probe3(dev, per_family)
        return band, twitter, d, labels, index.gram()

    (band, twitter, d, labels, gram), counts, seconds = _drive(
        recorder, "fig2", run)
    assign, purity, acc = _kernel_scores(gram.cpu().numpy(), labels)
    check(purity >= 0.66 and acc >= 0.66,
          f"fig2: persistence-kernel clustering degraded: purity {purity}, "
          f"accuracy {acc} (want >= 0.66)")
    d_cpu, _, index_cpu = _fig2_probe3("cpu", per_family)
    check(diagrams_bitwise_equal(d, d_cpu),
          "fig2: CUDA and CPU probe-3 Diagrams differ")
    e_cpu = torch.from_numpy(index_cpu._emb)
    gram_cpu = index_cpu.gram()
    check(bool(((gram.cpu() - gram_cpu).abs()
                <= l1_tolerance(e_cpu, e_cpu)).all()),
          f"fig2: probe-3 Gram outside {L1_TOLERANCE} of the CPU port")
    check(np.array_equal(assign, _kernel_scores(gram_cpu.numpy(), labels)[0]),
          "fig2: CUDA and CPU k-means assignments differ")
    return {"phase": "fig2", "per_family": per_family,
            "er_mean_clustering": {str(p): v[0] for p, v in band.items()},
            "er_mean_pd1_features": {str(p): v[1] for p, v in band.items()},
            "mid_band_mean_pd1": float(np.mean([band[p][1]
                                                for p in (0.12, 0.25, 0.45)])),
            "extreme_band_mean_pd1": float(np.mean([band[p][1]
                                                    for p in (0.05, 0.9)])),
            "twitter_mean_clustering": twitter[0],
            "twitter_mean_pd1_features": twitter[1],
            "graphs": len(labels), "kmeans_purity": purity,
            "ncc_holdout_accuracy": acc, "seconds": seconds,
            "launches": _add_counts(launches, counts)}


def _rows(d, idx):
    """The Diagrams rows ``idx`` of ``d``."""
    return type(d)(*(getattr(d, k)[idx]
                     for k in ("birth", "death", "dim", "valid")))


def _distances_ok(name, w, shape):
    import torch

    check(tuple(w.shape) == tuple(shape) and bool(torch.isfinite(w).all())
          and bool((w >= 0).all()),
          f"{name}: distances not finite and >= 0 of shape {shape}")


def phase_sinkhorn_n64(d64, launches, recorder, n_cpu=64,
                       n_self=256) -> dict:
    """2048 row-aligned pairs of the n64 diagrams (rows 0::2 against 1::2)
    through ``compare(metric="sinkhorn")`` at the registry defaults (dense,
    n_points 32) and again with ``impl="blocked"`` (clouds of 64 slots, one
    column tile).  Blocked must equal dense within rtol 1e-4; each is held
    against the CPU port on ``n_cpu`` pairs; self-distance is exactly 0."""
    from repro_torch.metrics import compare

    d1, d2 = _rows(d64, slice(0, None, 2)), _rows(d64, slice(1, None, 2))
    pairs = d1.birth.shape[0]
    out = {"phase": "sinkhorn_n64", "pairs": pairs, "n_points": 32,
           "mean_pd1_points": float(d64.count(1).float().mean()),
           "tolerance": SK_TOLERANCE}
    got = {}
    for impl in ("dense", "blocked"):
        def run():
            return compare(d1, d2, metric="sinkhorn", impl=impl)

        w, counts, first_s = _drive(recorder, "sinkhorn_n64", run)
        _distances_ok(f"sinkhorn_n64 {impl}", w, (pairs,))
        got[impl] = w
        w_cpu = compare(_rows(d1, slice(0, n_cpu)).to("cpu"),
                        _rows(d2, slice(0, n_cpu)).to("cpu"),
                        metric="sinkhorn", impl=impl)
        err, ok = sinkhorn_error(w[:n_cpu], w_cpu)
        check(ok, f"sinkhorn_n64 {impl}: CUDA and CPU differ beyond "
                  f"{SK_TOLERANCE} (max {err})")
        sub = _rows(d1, slice(0, n_self))
        check(not bool(compare(sub, sub, metric="sinkhorn", impl=impl).any()),
              f"sinkhorn_n64 {impl}: a self-distance is not 0")
        ms = _host_ms(run, reps=3)
        out[impl] = {"first_run_ms": first_s * 1e3, "ms": ms,
                     "pairs_per_s": pairs / (ms / 1e3),
                     "cpu_max_abs_err": err, "cpu_pairs": n_cpu,
                     "self_distance_zero_pairs": n_self,
                     "mean_distance": float(w.mean()),
                     "launches": _add_counts(launches, counts)}
    err, ok = sinkhorn_error(got["blocked"], got["dense"])
    check(ok, f"sinkhorn_n64: blocked and dense differ beyond rtol 1e-4 "
              f"(max {err})")
    out["blocked_vs_dense_max_abs_err"] = err
    return out


def phase_sinkhorn_full_n320(d320, launches, recorder, n_cpu=1,
                             n_dense=8) -> dict:
    """The DD rung's 256 diagrams as 128 pairs (rows 0::2 against 1::2) on
    the full tensor: ``compare(**SK_FULL)``, blocked, clouds of 2S slots.
    Held against the CPU port on ``n_cpu`` pairs (the plain version's
    (2S)^2 blocks take seconds per pair there) and against the dense form
    on ``n_dense`` pairs on the card within repro's full-tensor bound
    (rtol 1e-3, atol 1e-4).  Returns the record and the pairs."""
    import torch
    from repro_torch.metrics import compare

    d1, d2 = _rows(d320, slice(0, None, 2)), _rows(d320, slice(1, None, 2))
    pairs, s = d1.birth.shape
    cloud = 2 * s

    def run():
        return compare(d1, d2, **SK_FULL)

    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    w, counts, first_s = _drive(recorder, "sinkhorn_full_n320", run)
    peak = torch.cuda.max_memory_allocated() - base
    _distances_ok("sinkhorn_full_n320", w, (pairs,))
    t0 = time.perf_counter()
    w_cpu = compare(_rows(d1, slice(0, n_cpu)).to("cpu"),
                    _rows(d2, slice(0, n_cpu)).to("cpu"), **SK_FULL)
    cpu_s = time.perf_counter() - t0
    err, ok = sinkhorn_error(w[:n_cpu], w_cpu)
    check(ok, f"sinkhorn_full_n320: CUDA and CPU differ beyond "
              f"{SK_TOLERANCE} (max {err})")
    dense = compare(_rows(d1, slice(0, n_dense)), _rows(d2, slice(0, n_dense)),
                    **{**SK_FULL, "impl": "dense"})
    derr, ok = sinkhorn_error(w[:n_dense], dense, 1e-3, 1e-4)
    check(ok, f"sinkhorn_full_n320: blocked and dense differ beyond rtol "
              f"1e-3 (max {derr})")
    ms = _host_ms(run, reps=1)
    return {"phase": "sinkhorn_full_n320", "pairs": pairs, "cloud_slots": cloud,
            "mean_pd1_points": float(d320.count(1).float().mean()),
            **{k: v for k, v in SK_FULL.items() if k != "metric"},
            "first_run_ms": first_s * 1e3, "ms": ms,
            "pairs_per_s": pairs / (ms / 1e3),
            "blocked_peak_bytes": peak,
            # what impl="dense" would hold: three (2S)^2 f32 cost matrices
            # per pair (computed from the shapes, not allocated)
            "dense_cost_bytes": 3 * cloud ** 2 * 4 * pairs,
            "cpu_pairs": n_cpu, "cpu_seconds": cpu_s, "cpu_max_abs_err": err,
            "dense_pairs": n_dense, "dense_max_abs_err": derr,
            "mean_distance": float(w.mean()),
            "launches": _add_counts(launches, counts)}, (d1, d2)


def phase_sinkhorn_pairwise(d64, launches, recorder, n_cpu_rows=2) -> dict:
    """``pairwise(d64[:64], d64[64:128], metric="sinkhorn", block_rows=16)``
    through the engine: a 64 x 64 matrix, four compare calls, held against
    the CPU port on its first ``n_cpu_rows`` rows."""
    from repro_torch import counters
    from repro_torch.metrics import pairwise

    q, r = _rows(d64, slice(0, 64)), _rows(d64, slice(64, 128))

    def run():
        return pairwise(q, r, metric="sinkhorn", block_rows=16)

    mat, counts, first_s = _drive(recorder, "sinkhorn_pairwise", run)
    calls = {f"{b}.{e}": c for (b, e), c in counters.METRIC_CALLS.items()}
    _distances_ok("sinkhorn_pairwise", mat, (64, 64))
    check(calls == {"sinkhorn.pairwise": 1, "sinkhorn.compare": 4},
          f"sinkhorn_pairwise: engine calls {calls}")
    want = pairwise(_rows(q, slice(0, n_cpu_rows)).to("cpu"), r.to("cpu"),
                    metric="sinkhorn")
    err, ok = sinkhorn_error(mat[:n_cpu_rows], want)
    check(ok, f"sinkhorn_pairwise: CUDA and CPU differ beyond {SK_TOLERANCE}"
              f" (max {err})")
    ms = _host_ms(run, reps=3)
    return {"phase": "sinkhorn_pairwise", "shape": [64, 64], "block_rows": 16,
            "engine_calls": calls, "first_run_ms": first_s * 1e3, "ms": ms,
            "pairs_per_s": 64 * 64 / (ms / 1e3), "cpu_rows": n_cpu_rows,
            "cpu_max_abs_err": err,
            "launches": _add_counts(launches, counts)}


def phase_sinkhorn_parity(dev, launches, recorder, n_pairs=200) -> dict:
    """The correctness gate of benchmarks/metrics_bench.py's parity sweep:
    200 pairs of ``random_diagram`` from ``default_rng(33)``, each Sinkhorn
    value (dense and blocked) within 5% of ``wasserstein_exact(q=2)`` (or
    below 1e-4 where that is 0), the registry's error bound; self-distance
    exactly 0.0 for both forms."""
    import numpy as np
    import torch
    from repro_torch.metrics import compare
    from repro_torch.metrics.reference import wasserstein_exact
    from repro_torch.metrics.testing import diagram_points, random_diagram

    rng = np.random.default_rng(33)
    pairs = [(random_diagram(rng, essential=int(rng.integers(0, 3)),
                             device="cpu"), random_diagram(rng, device="cpu"))
             for _ in range(n_pairs)]

    def stack(ds):
        return type(ds[0])(*(torch.stack([getattr(d, k) for d in ds])
                             for k in ("birth", "death", "dim",
                                       "valid"))).to(dev)

    d1, d2 = stack([a for a, _ in pairs]), stack([b for _, b in pairs])
    exact = np.array([wasserstein_exact(diagram_points(a, 1, 64.0),
                                        diagram_points(b, 1, 64.0), q=2.0)
                      for a, b in pairs])
    out = {"phase": "sinkhorn_parity", "pairs": n_pairs,
           "gate": "|w - W2| / W2 <= 0.05 (|w| < 1e-4 where W2 = 0)"}
    for impl in ("dense", "blocked"):
        w, counts, _ = _drive(
            recorder, "sinkhorn_parity",
            lambda: compare(d1, d2, metric="sinkhorn", k=1, cap=64.0,
                            impl=impl))
        w = w.cpu().numpy()
        zero = exact == 0
        rel = np.abs(w - exact) / np.where(zero, 1.0, exact)
        failed = int((np.abs(w[zero]) >= 1e-4).sum()
                     + (rel[~zero] > 0.05).sum())
        check(failed == 0, f"sinkhorn_parity {impl}: {failed} of {n_pairs} "
                           "pairs outside 5% of the exact W2")
        self_d = compare(d1, d1, metric="sinkhorn", impl=impl)
        check(not bool(self_d.any()),
              f"sinkhorn_parity {impl}: a self-distance is not 0.0")
        out[impl] = {"failed": failed,
                     "max_rel_err": float(rel[~zero].max()),
                     "mean_rel_err": float(rel[~zero].mean()),
                     "self_distance_max": float(self_d.max()),
                     "launches": _add_counts(launches, counts)}
    return out


def _exact_vs_cpu(name, d1, d2, n, got, **kw) -> float:
    """``compare_info(metric="exact_w", **kw)`` of the first ``n`` pairs on
    the CPU port against ``got``, the CUDA run's ``(w, converged, rounds,
    ...)``: the distances within EX_TOLERANCE, the rest bitwise.  Returns
    the largest |difference| of the distances."""
    import torch
    from repro_torch.metrics import compare_info

    want = compare_info(_rows(d1, slice(0, n)).to("cpu"),
                        _rows(d2, slice(0, n)).to("cpu"), metric="exact_w",
                        **kw)
    w = got[0][:n].cpu()
    ok = (torch.allclose(w, want[0], rtol=EX_RTOL, atol=EX_ATOL)
          and all(torch.equal(g[:n].cpu(), x)
                  for g, x in zip(got[1:3], want[1:3])))
    check(ok, f"{name}: CUDA and CPU differ beyond {EX_TOLERANCE}")
    return float((w - want[0]).abs().max()) if n else 0.0


def _rounds(rounds) -> dict:
    return {"rounds_mean": float(rounds.float().mean()),
            "rounds_max": int(rounds.max())}


def phase_exact_n64(d64, launches, recorder, n_cpu=64, n_cpu_off=16,
                    n_self=256) -> dict:
    """2048 row-aligned n64 pairs (rows 0::2 against 1::2) through the exact
    backends: ``compare(metric="exact_w")`` at the registry defaults
    (collapsed, n_points 16), ``compare_info`` with ``collapse="off"``,
    ``compare_info`` cold and then warm from the prices it returned, and
    ``bottleneck_approx``.  Each is held against the CPU port on its first
    pairs (``n_cpu_off`` for the expanded form, whose plain solver runs
    ~1,400 rounds a pair); every pair converges in both layouts, the two
    layouts agree within 1e-4, the warm start keeps the distances (1e-5)
    and saves rounds, and the self-distance is exactly 0."""
    import torch
    from repro_torch.metrics import compare, compare_info

    d1, d2 = _rows(d64, slice(0, None, 2)), _rows(d64, slice(1, None, 2))
    pairs = d1.birth.shape[0]
    out = {"phase": "exact_n64", "pairs": pairs, "n_points": 16,
           "mean_pd1_points": float(d64.count(1).float().mean()),
           "tolerance": EX_TOLERANCE}
    runs = {
        "on": lambda: compare(d1, d2, metric="exact_w"),
        "off": lambda: compare_info(d1, d2, metric="exact_w",
                                    collapse="off"),
        "cold": lambda: compare_info(d1, d2, metric="exact_w"),
        "bottleneck": lambda: compare(d1, d2, metric="bottleneck_approx"),
    }
    got = {}
    for key, run in runs.items():
        res, counts, first_s = _drive(recorder, "exact_n64", run)
        got[key] = res
        w = res[0] if isinstance(res, tuple) else res
        _distances_ok(f"exact_n64 {key}", w, (pairs,))
        ms = _host_ms(run, reps=3)
        out[key] = {"first_run_ms": first_s * 1e3, "ms": ms,
                    "pairs_per_s": pairs / (ms / 1e3),
                    "mean_distance": float(w.mean()),
                    "launches": _add_counts(launches, counts)}
        if isinstance(res, tuple):
            check(bool(res[1].all()), f"exact_n64 {key}: a pair did not "
                                      "converge")
            out[key].update(_rounds(res[2]))
    prices = got["cold"][3]
    warm, counts, first_s = _drive(
        recorder, "exact_n64",
        lambda: compare_info(d1, d2, metric="exact_w", prices=prices))
    check(bool(warm[1].all()), "exact_n64 warm: a pair did not converge")
    warm_err = float((warm[0] - got["cold"][0]).abs().max())
    check(warm_err <= 1e-5, f"exact_n64: warm and cold differ by {warm_err}")
    check(int(warm[2].sum()) < int(got["cold"][2].sum()),
          "exact_n64: the warm start saved no rounds")
    out["warm"] = {"first_run_ms": first_s * 1e3, **_rounds(warm[2]),
                   "max_abs_diff_vs_cold": warm_err,
                   "launches": _add_counts(launches, counts)}
    check(torch.equal(got["cold"][0], got["on"]),
          "exact_n64: compare and compare_info differ")
    layout_err = float((got["on"] - got["off"][0]).abs().max())
    check(layout_err <= 1e-4, f"exact_n64: collapsed and expanded differ by "
                              f"{layout_err}")
    out["collapsed_vs_expanded_max_abs_diff"] = layout_err
    out["on"]["cpu_pairs"], out["off"]["cpu_pairs"] = n_cpu, n_cpu_off
    out["on"]["cpu_max_abs_err"] = _exact_vs_cpu(
        "exact_n64 on", d1, d2, n_cpu, got["cold"])
    off = compare_info(_rows(d1, slice(0, n_cpu_off)),
                       _rows(d2, slice(0, n_cpu_off)), metric="exact_w",
                       collapse="off")
    out["off"]["cpu_max_abs_err"] = _exact_vs_cpu(
        "exact_n64 off", d1, d2, n_cpu_off, off, collapse="off")
    bn_cpu = compare(_rows(d1, slice(0, n_cpu)).to("cpu"),
                     _rows(d2, slice(0, n_cpu)).to("cpu"),
                     metric="bottleneck_approx")
    check(torch.equal(got["bottleneck"][:n_cpu].cpu(), bn_cpu),
          "exact_n64: bottleneck_approx on CUDA and CPU differ")
    out["bottleneck"]["cpu_pairs_bitwise"] = n_cpu
    sub = _rows(d1, slice(0, n_self))
    for collapse in ("on", "off"):
        check(not bool(compare(sub, sub, metric="exact_w",
                               collapse=collapse).any()),
              f"exact_n64 {collapse}: a self-distance is not 0")
    out["self_distance_zero_pairs"] = n_self
    return out


def phase_exact_n320(d320, launches, recorder, n_points=64, n_cpu=2,
                     n_oracle=16) -> tuple[dict, tuple]:
    """The DD rung's 256 diagrams as 128 pairs (rows 0::2 against 1::2) at
    ``n_points=64``: collapsed (K = 64) and expanded (M = 128) through
    ``compare_info(metric="exact_w")``, the regime in which the kernels do
    real work.  Every pair converges; the layouts agree within 1e-4; each is
    held against the CPU port on ``n_cpu`` pairs; and the first
    ``n_oracle`` pairs whose diagrams have at most ``n_points`` PD_1 points
    (so the compaction drops nothing) are held within 1e-5 (relative above
    1) of the Hungarian W2 of ``metrics/reference.py``.  The record also
    holds ``_rev_every_sweep``.  Returns the record and the pairs."""
    import numpy as np
    from repro_torch.metrics import compare_info
    from repro_torch.metrics.reference import wasserstein_exact
    from repro_torch.metrics.testing import diagram_points

    d1, d2 = _rows(d320, slice(0, None, 2)), _rows(d320, slice(1, None, 2))
    pairs = d1.birth.shape[0]
    out = {"phase": "exact_n320", "pairs": pairs, "n_points": n_points,
           "mean_pd1_points": float(d320.count(1).float().mean()),
           "max_pd1_points": int(d320.count(1).max()),
           "tolerance": EX_TOLERANCE}
    got = {}
    for collapse in ("on", "off"):
        def run():
            return compare_info(d1, d2, metric="exact_w", n_points=n_points,
                                collapse=collapse)

        info, counts, first_s = _drive(recorder, "exact_n320", run)
        got[collapse] = info
        _distances_ok(f"exact_n320 {collapse}", info[0], (pairs,))
        check(bool(info[1].all()),
              f"exact_n320 {collapse}: a pair did not converge")
        ms = _host_ms(run, reps=3)
        out[collapse] = {
            "first_run_ms": first_s * 1e3, "ms": ms,
            "pairs_per_s": pairs / (ms / 1e3), **_rounds(info[2]),
            "mean_distance": float(info[0].mean()), "cpu_pairs": n_cpu,
            "cpu_max_abs_err": _exact_vs_cpu(
                f"exact_n320 {collapse}", d1, d2, n_cpu, info,
                n_points=n_points, collapse=collapse),
            "launches": _add_counts(launches, counts)}
    layout_err = float((got["on"][0] - got["off"][0]).abs().max())
    check(layout_err <= 1e-4, f"exact_n320: collapsed and expanded differ "
                              f"by {layout_err}")
    n1, n2 = d1.count(1).cpu(), d2.count(1).cpu()
    exact_rows = [i for i in range(pairs)
                  if n1[i] <= n_points and n2[i] <= n_points][:n_oracle]
    d1c, d2c = d1.to("cpu"), d2.to("cpu")
    errs = []
    for i in exact_rows:
        want = wasserstein_exact(diagram_points(_rows(d1c, i), 1, 64.0),
                                 diagram_points(_rows(d2c, i), 1, 64.0),
                                 q=2.0)
        for collapse in ("on", "off"):
            w = float(got[collapse][0][i])
            errs.append(abs(w - want) / max(1.0, want))
    worst = float(np.max(errs)) if errs else 0.0
    check(worst <= 1e-5, f"exact_n320: {worst} from the Hungarian W2")
    out.update(collapsed_vs_expanded_max_abs_diff=layout_err,
               oracle_pairs=len(exact_rows), oracle_max_rel_err=worst)
    out["rev_every_8"] = _rev_every_sweep(d1, d2, got["on"][0])
    return out, (d1, d2)


def _rev_every_sweep(d1, d2, w_default) -> dict:
    """The collapsed kernel on these pairs at n_points 16 and 64 with the
    wrapper's rev_every (0) and with repro's untuned default (8): pairs left
    unconverged, rounds, and at n_points 64 how far rev_every 8 moves the
    distances from the default run's."""
    from repro_torch.kernels import ops
    from repro_torch.metrics import compact_top_k
    from repro_torch.metrics.exact import (
        cloud_costs, collapsed_cost, matched_cost)

    out = {}
    for k in (16, 64):
        b1, e1, k1 = compact_top_k(d1, 1, k, 64.0)
        b2, e2, k2 = compact_top_k(d2, 1, k, 64.0)
        k1, k2 = k1.contiguous(), k2.contiguous()
        cbar = collapsed_cost(b1, e1, k1, b2, e2, k2)[0].contiguous()
        for rev in (ops.AUCTION_REV_EVERY, 8):
            p2o, _, conv, rounds, _ = ops.auction_lap_collapsed(
                cbar, k1, k2, rev_every=rev)
            row = {"unconverged": int((~conv).sum()), **_rounds(rounds)}
            if k == 64 and rev == 8:
                pp, diag1, diag2 = cloud_costs(b1, e1, k1, b2, e2, k2)
                w = matched_cost(pp, diag1, diag2, k1, k2, p2o).sqrt()
                row["max_abs_diff_vs_default"] = float(
                    (w - w_default).abs().max())
            out[f"n_points{k}_rev_every{rev}"] = row
    return out


def phase_exact_pairwise(d64, launches, recorder, n_cpu_rows=2) -> dict:
    """``pairwise(d64[:64], d64[64:128], metric="exact_w", block_rows=16)``
    through the engine: a 64 x 64 matrix, four compare calls, held against
    the CPU port on its first ``n_cpu_rows`` rows."""
    import torch
    from repro_torch import counters
    from repro_torch.metrics import pairwise

    q, r = _rows(d64, slice(0, 64)), _rows(d64, slice(64, 128))

    def run():
        return pairwise(q, r, metric="exact_w", block_rows=16)

    mat, counts, first_s = _drive(recorder, "exact_pairwise", run)
    calls = {f"{b}.{e}": c for (b, e), c in counters.METRIC_CALLS.items()}
    _distances_ok("exact_pairwise", mat, (64, 64))
    check(calls == {"exact_w.pairwise": 1, "exact_w.compare": 4},
          f"exact_pairwise: engine calls {calls}")
    want = pairwise(_rows(q, slice(0, n_cpu_rows)).to("cpu"), r.to("cpu"),
                    metric="exact_w")
    got = mat[:n_cpu_rows].cpu()
    check(torch.allclose(got, want, rtol=EX_RTOL, atol=EX_ATOL),
          f"exact_pairwise: CUDA and CPU differ beyond {EX_TOLERANCE}")
    ms = _host_ms(run, reps=3)
    return {"phase": "exact_pairwise", "shape": [64, 64], "block_rows": 16,
            "engine_calls": calls, "first_run_ms": first_s * 1e3, "ms": ms,
            "pairs_per_s": 64 * 64 / (ms / 1e3), "cpu_rows": n_cpu_rows,
            "cpu_max_abs_err": float((got - want).abs().max()),
            "launches": _add_counts(launches, counts)}


def phase_auction_parity(dev, launches, recorder, n_pairs=200) -> dict:
    """The auction parity sweep of benchmarks/metrics_bench.py through the
    port, with its gates: 200 pairs of ``random_diagram`` from
    ``default_rng(35)`` at n_points 16; ``exact_w`` within 1e-5 of
    ``wasserstein_exact(q=2)`` in both layouts, ``bottleneck_approx``
    within max(1e-4, 1e-4 * ref) of ``bottleneck_exact``, every pair
    converged, the layouts within 1e-4 of each other, collapsed rounds at
    least 5x fewer than expanded; and the port's own gate, the exact_w
    self-distance exactly 0.0 in both layouts."""
    import numpy as np
    import torch
    from repro_torch.metrics import compare, compare_info
    from repro_torch.metrics.reference import (
        bottleneck_exact, wasserstein_exact)
    from repro_torch.metrics.testing import diagram_points, random_diagram

    rng = np.random.default_rng(35)
    pairs = [(random_diagram(rng, essential=int(rng.integers(0, 3)),
                             device="cpu"), random_diagram(rng, device="cpu"))
             for _ in range(n_pairs)]

    def stack(ds):
        return type(ds[0])(*(torch.stack([getattr(d, k) for d in ds])
                             for k in ("birth", "death", "dim",
                                       "valid"))).to(dev)

    d1, d2 = stack([a for a, _ in pairs]), stack([b for _, b in pairs])
    pts = [(diagram_points(a, 1, 64.0), diagram_points(b, 1, 64.0))
           for a, b in pairs]
    w2 = np.array([wasserstein_exact(a, b, q=2.0) for a, b in pts])
    bn_ref = np.array([bottleneck_exact(a, b) for a, b in pts])
    out = {"phase": "auction_parity", "pairs": n_pairs, "n_points": 16,
           "gate": "|w - W2| <= 1e-5 (both layouts), |bn - W_inf| <= "
                   "max(1e-4, 1e-4 W_inf), all converged, layouts within "
                   "1e-4, rounds reduction >= 5, self-distance 0.0"}
    info = {}
    for collapse in ("on", "off"):
        res, counts, _ = _drive(
            recorder, "auction_parity",
            lambda: compare_info(d1, d2, metric="exact_w",
                                 collapse=collapse))
        info[collapse] = res
        w = res[0].cpu().numpy()
        failed = int((np.abs(w - w2) > 1e-5).sum())
        check(failed == 0, f"auction_parity {collapse}: {failed} of "
                           f"{n_pairs} pairs beyond 1e-5 of the exact W2")
        check(bool(res[1].all()),
              f"auction_parity {collapse}: a pair did not converge")
        self_d = compare(d1, d1, metric="exact_w", collapse=collapse)
        check(not bool(self_d.any()),
              f"auction_parity {collapse}: a self-distance is not 0.0")
        out[collapse] = {"failed": failed,
                         "max_abs_err": float(np.abs(w - w2).max()),
                         **_rounds(res[2]),
                         "self_distance_max": float(self_d.max()),
                         "launches": _add_counts(launches, counts)}
    bn, counts, _ = _drive(
        recorder, "auction_parity",
        lambda: compare(d1, d2, metric="bottleneck_approx"))
    bn = bn.cpu().numpy()
    bn_failed = int((np.abs(bn - bn_ref)
                     > np.maximum(1e-4, 1e-4 * bn_ref)).sum())
    check(bn_failed == 0, f"auction_parity: {bn_failed} bottleneck misses")
    layout = float((info["on"][0] - info["off"][0]).abs().max())
    check(layout <= 1e-4, f"auction_parity: layouts differ by {layout}")
    reduction = (float(info["off"][2].float().mean())
                 / max(float(info["on"][2].float().mean()), 1e-9))
    check(reduction >= 5.0, f"auction_parity: rounds reduction {reduction}")
    out.update(bottleneck_failed=bn_failed,
               bottleneck_max_abs_err=float(np.abs(bn - bn_ref).max()),
               bottleneck_launches=_add_counts(launches, counts),
               collapse_vs_expanded_max_diff=layout,
               rounds_reduction=reduction)
    return out


def phase_strong_collapse_table3(dev, launches, recorder) -> dict:
    """Table 3's strong collapse on the card: the Email-Enron surrogate at
    n_pad 512, superlevel, every filtration complex collapsed at the step
    sizes 4 and 12; the masks held bitwise against the CPU port."""
    import math

    import torch
    from repro_torch.core.strong_collapse import (
        strong_collapse_filtration_masks)
    from repro_torch.data.graphs import load_large_network

    g = load_large_network("Email-Enron", 29, n_pad=512, device=dev)
    g_cpu = g.to("cpu")
    fmax = float(g.f[g.mask].max())
    out = {"phase": "strong_collapse_table3", "graphs": g.batch, "n_pad": g.n,
           "n_vertices": int(g.n_vertices().sum()),
           "n_edges": int(g.n_edges().sum()), "f_max": fmax}
    for delta in TABLE3_DELTAS:
        n_steps = max(2, math.ceil(fmax / delta))
        th = torch.arange(1, n_steps + 1, dtype=torch.float32,
                          device=dev) * delta
        (sub, col), counts, first_s = _drive(
            recorder, "strong_collapse_table3",
            strong_collapse_filtration_masks, g, th, n_steps, False)
        sub_c, col_c = strong_collapse_filtration_masks(
            g_cpu, th.cpu(), n_steps, sublevel=False)
        check(torch.equal(sub.cpu(), sub_c) and torch.equal(col.cpu(), col_c),
              f"strong_collapse_table3 delta {delta}: CUDA and CPU masks "
              "differ")
        ms = _host_ms(lambda: strong_collapse_filtration_masks(
            g, th, n_steps, sublevel=False))
        out[f"delta{delta}"] = {
            "n_filtration_steps": n_steps,
            "vertices_in_complexes": int(sub.sum()),
            "vertices_after_collapse": int(col.sum()),
            "domination_launches": counts["domination"],
            "first_run_ms": first_s * 1e3, "ms": ms,
            "launches": _add_counts(launches, counts),
            "cpu_masks_equal": True}
    return out


def phase_ego_fig5b(dev, launches, recorder) -> dict:
    """Fig 5b on the card: every 1-hop ego net of a BA(192, 3) host graph
    with degree filtering, at n_pad 64, held bitwise against the CPU port;
    then PD_0 of every ego net through the plan for "none" and "prunit" at
    the benchmark's caps (superlevel), Diagrams bitwise the CPU port's."""
    import torch
    from repro_torch.core.api import make_topo_plan
    from repro_torch.core.persistence import diagrams_bitwise_equal
    from repro_torch.data.ego import ego_batch, ego_sizes
    from repro_torch.data.graphs import barabasi_albert

    host = barabasi_albert(3, 1, 192, 192, 3, device=dev)
    f = host.degrees()[0].to(torch.float32)
    egos, _, first_s = _drive(recorder, "ego_fig5b", ego_batch, host.adj[0],
                              f, 64)
    want = ego_batch(host.adj[0].cpu(), f.cpu(), 64, device="cpu")
    check(all(torch.equal(getattr(egos, k).cpu(), getattr(want, k))
              for k in ("adj", "mask", "f")),
          "ego_fig5b: CUDA and CPU ego nets differ")
    sizes = ego_sizes(host.adj[0])
    out = {"phase": "ego_fig5b", "host_vertices": 192, "egos": egos.batch,
           "n_pad": egos.n, "ego_size_max": int(sizes.max()),
           "ego_size_mean": float(sizes.float().mean()),
           "extract_first_ms": first_s * 1e3,
           "extract_ms": _host_ms(lambda: ego_batch(host.adj[0], f, 64)),
           "cpu_egos_equal": True}
    for method in ("none", "prunit"):
        plan = make_topo_plan(dim=0, method=method, sublevel=False,
                              **FIG5B_CAPS)
        d, counts, first_s = _drive(recorder, "ego_fig5b", plan.execute, egos)
        check(diagrams_bitwise_equal(plan.execute(want), type(d)(
            *(getattr(d, k).cpu() for k in ("birth", "death", "dim",
                                            "valid")))),
              f"ego_fig5b {method}: CUDA and CPU Diagrams differ")
        out[method] = {"pd0_first_ms": first_s * 1e3,
                       "pd0_ms": _host_ms(lambda: plan.execute(egos)),
                       "mean_betti0": float(d.betti(0).float().mean()),
                       "launches": _add_counts(launches, counts),
                       "cpu_bitwise_equal": True}
    out["time_reduction_pct"] = (100.0 * (out["none"]["pd0_ms"]
                                          - out["prunit"]["pd0_ms"])
                                 / out["none"]["pd0_ms"])
    return out


def _sorted_pairs(d, dims):
    """Per graph and dimension, the (birth, death) pairs sorted by birth
    then death (absent rows as (inf, inf)) and their count: the tensors
    ``dim_pairs`` compares, for the whole batch at once."""
    import torch

    out = []
    for k in dims:
        sel = d.valid & (d.dim == k)
        b = torch.where(sel, d.birth, float("inf"))
        de = torch.where(sel, d.death, float("inf"))
        o = torch.sort(de, dim=-1, stable=True).indices
        b, de = b.gather(1, o), de.gather(1, o)
        o = torch.sort(b, dim=-1, stable=True).indices
        out += [b.gather(1, o), de.gather(1, o), sel.sum(-1)]
    return out


def _same_pairs(d1, d2, dims) -> bool:
    import torch

    return all(torch.equal(x, y) for x, y in
               zip(_sorted_pairs(d1, dims), _sorted_pairs(d2, dims)))


def _counting_syncs(fn, *args):
    """``fn(*args)`` with CUDA's sync debug mode on; returns (result, the
    number of synchronizing calls it warned about)."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message).lower() for w in caught)


def phase_stream(name, make_stream, cfg, launches, recorder,
                 n_cpu=STREAM_CPU_GRAPHS) -> tuple[dict, tuple]:
    """A TopoStream over the stream ``make_stream()`` gives (on the card):
    after every step the guaranteed dims' pairs are bitwise a direct
    ``topological_signature`` of the current state, and a CPU stream over
    the same deltas of the first ``n_cpu`` graphs has the same per-graph
    verdicts and bitwise the same Diagrams (and drift within the exact
    tolerance).  A second replay is timed: updates/s, verdict and
    recompute ms a step from the stream's own spans."""
    import numpy as np
    import torch
    from repro_torch import obs
    from repro_torch.core.api import make_topo_plan
    from repro_torch.core.delta import delta_step
    from repro_torch.core.persistence import Diagrams, diagrams_bitwise_equal
    from repro_torch.stream import TopoStream, TopoStreamConfig

    g0, deltas = make_stream()
    steps = deltas.steps - 1  # the last step is left for profile_stream
    config = TopoStreamConfig(**cfg)
    dims = (tuple(range(config.dim + 1)) if config.exact_dims == "all"
            else (config.dim,))
    scratch = make_topo_plan(dim=config.dim, method=config.method,
                             sublevel=config.sublevel,
                             edge_cap=config.edge_cap,
                             tri_cap=config.tri_cap,
                             quad_cap=config.quad_cap,
                             reducer=config.reducer)
    rows = slice(0, n_cpu)

    stream, counts, init_s = _drive(recorder, name, TopoStream, g0, config)
    phase_counts = dict(counts)
    cpu = TopoStream(g0.index(torch.arange(n_cpu, device=g0.device)),
                     config, device="cpu")
    syncs, apply_ms, scratch_ms = [], [], []
    drift_err = 0.0
    for t in range(steps):
        delta = delta_step(deltas, t)
        (d, n_sync), counts, seconds = _drive(
            recorder, name, _counting_syncs, stream.apply, delta)
        for k, v in counts.items():
            phase_counts[k] += v
        syncs.append(n_sync)
        apply_ms.append(seconds * 1e3)
        t0 = time.perf_counter()
        ref = scratch.execute(stream.graph)
        torch.cuda.synchronize()
        scratch_ms.append((time.perf_counter() - t0) * 1e3)
        check(_same_pairs(d, ref, dims),
              f"{name} step {t}: streamed pairs differ from a direct "
              "topological_signature")
        d_cpu = cpu.apply(delta.index(rows).to("cpu"))
        for flag, v in cpu.last_flags.items():
            check(np.array_equal(stream.last_flags[flag][rows], v),
                  f"{name} step {t}: CUDA and CPU verdicts differ ({flag})")
        check(diagrams_bitwise_equal(d_cpu, Diagrams(
            *(getattr(d, k)[rows].cpu() for k in ("birth", "death", "dim",
                                                  "valid")))),
              f"{name} step {t}: CUDA and CPU Diagrams differ")
        if config.drift_metric is not None:
            got, want = stream.last_drift[rows], cpu.last_drift
            check(bool(np.all(np.abs(got - want)
                              <= EX_ATOL + EX_RTOL * np.abs(want))),
                  f"{name} step {t}: CUDA and CPU drift differ")
            drift_err = max(drift_err, float(np.abs(got - want).max()))
    sizes = sorted(set(stream.recompute_sizes))
    s = stream.stats
    out = {"phase": name, "graphs": g0.batch, "n_pad": g0.n, "steps": steps,
           **{k: v for k, v in cfg.items() if k != "drift_threshold"},
           "drift_threshold": str(config.drift_threshold),
           "graph_updates": s["graph_updates"], "skip_rate": stream.skip_rate(),
           "hits": s["hits"], "coral_hits": s["coral_hits"],
           "prunit_hits": s["prunit_hits"], "recomputes": s["recomputes"],
           "recompute_batches": s["recompute_batches"],
           "recomputed_rows": s["recomputed_rows"],
           "anomalies": s["anomalies"],
           "recompute_sizes": sizes,
           "recompute_size_counts": {str(k): stream.recompute_sizes.count(k)
                                     for k in sizes},
           "host_syncs_per_step": float(np.mean(syncs)),
           "host_syncs_max": int(max(syncs)),
           "main_run_apply_ms_per_step": float(np.mean(apply_ms)),
           "scratch_plan_ms_per_step": float(np.mean(scratch_ms)),
           "init_ms": init_s * 1e3,
           "launches": _add_counts(launches, phase_counts),
           "parity_steps": steps, "cpu_graphs": n_cpu,
           "cpu_drift_max_abs_err": drift_err}

    # timed replay from g0: no checks, tracing on for the stream's spans
    obs.reset()
    obs.configure(enabled=True)
    try:
        timed = TopoStream(g0, config)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(steps):
            timed.apply(delta_step(deltas, t))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        obs.configure(enabled=False)
    spans = obs.get_instrument("obs.span_seconds")
    for span_name in ("stream.verdict", "stream.recompute", "stream.drift"):
        st = spans.series().get((("span", span_name),))
        out[f"{span_name.split('.')[1]}_ms_per_step"] = (
            st.sum / steps * 1e3 if st is not None else 0.0)
    check(timed.stats == s, f"{name}: the timed replay's stats differ")
    out.update(wall_ms=wall * 1e3, ms_per_step=wall / steps * 1e3,
               updates_per_s=s["graph_updates"] / wall,
               scratch_updates_per_s=g0.batch / (np.mean(scratch_ms) / 1e3))
    obs.reset()
    return out, (stream, deltas)


# --------------------------------------------------------------- serving

def serve_traffic(count, seed, n_pad=56):
    """``serve_bench``'s request stream: graphs of 6-55 vertices, a third
    each ER(p 0.1-0.3), BA(m 3) and powerlaw-cluster(m 2, p 0.4), drawn by
    the port's generators on the host; ``[(edges, n_vertices)]``."""
    import numpy as np
    from repro_torch.data.graphs import (
        barabasi_albert, erdos_renyi, powerlaw_cluster)

    rng = np.random.default_rng(seed)
    n = rng.integers(6, 56, count)
    kind = rng.integers(0, 3, count)
    p = rng.uniform(0.1, 0.3, count).astype(np.float32)
    adj = np.zeros((count, n_pad, n_pad), bool)
    for k in range(3):
        sel = np.nonzero(kind == k)[0]
        if k == 0:
            g = erdos_renyi((seed, k), len(sel), n_pad, n[sel], p[sel],
                            device="cpu")
        elif k == 1:
            g = barabasi_albert((seed, k), len(sel), n_pad, n[sel], 3,
                                device="cpu")
        else:
            g = powerlaw_cluster((seed, k), len(sel), n_pad, n[sel], 2, 0.4,
                                 device="cpu")
        adj[sel] = g.adj.numpy()
    return [(list(zip(*(x.tolist() for x in np.nonzero(np.triu(a))))),
             int(nv)) for a, nv in zip(adj, n)]


def _edge_lists(g):
    """A GraphBatch with prefix masks as ``[(edges, n_vertices)]``."""
    import numpy as np

    adj = g.adj.cpu().numpy()
    nv = g.mask.sum(-1).cpu().numpy()
    return [(list(zip(*(x.tolist() for x in np.nonzero(np.triu(a))))),
             int(n)) for a, n in zip(adj, nv)]


def _bits(x):
    """A float tensor's bit patterns (so NaN rows compare equal)."""
    import torch

    return x.view(torch.int32) if x.is_floating_point() else x


def _diagrams_bitwise(a, b) -> bool:
    """Every field of two Diagrams bit for bit (NaN rows included), on
    their device."""
    import torch

    return all(torch.equal(_bits(getattr(a, k)), _bits(getattr(b, k)))
               for k in ("birth", "death", "dim", "valid"))


def _stacked(rows):
    """Per-graph Diagrams rows stacked into one batch."""
    import torch
    from repro_torch.core.persistence import Diagrams

    return Diagrams(*(torch.stack([getattr(r, k) for r in rows])
                      for k in ("birth", "death", "dim", "valid")))


def _serve_round(srv, reqs):
    """Submit every request, drain, collect: (futures, submit s, drain s)."""
    t0 = time.perf_counter()
    futs = [srv.submit(edges=e, n_vertices=n) for e, n in reqs]
    t1 = time.perf_counter()
    srv.drain()
    for f in futs:
        f.result(timeout=0)
    return futs, t1 - t0, time.perf_counter() - t1


def _latency_by_bucket(futs) -> dict:
    import numpy as np

    by = {}
    for f in futs:
        by.setdefault(f"n{f.bucket.n_pad}", []).append(f.latency_s() * 1e3)
    return {b: {"graphs": len(v), "p50_ms": float(np.percentile(v, 50)),
                "p99_ms": float(np.percentile(v, 99))}
            for b, v in sorted(by.items(), key=lambda kv: int(kv[0][1:]))}


def _served_parity(srv, dev) -> int:
    """Every executed batch's served rows bitwise a direct plan execution of
    the same packed batch (``topological_signature``, or with repack on the
    two-phase plan on the serve-wide ladder); returns the rows checked."""
    from repro_torch.core.api import make_topo_plan, topological_signature
    from repro_torch.serve import pack_requests
    from repro_torch.serve.topo_serve import repack_ladder_for

    c = srv.config
    checked = 0
    for bucket, reqs, futs in srv.executed_batches:
        g = pack_requests(reqs, bucket, dev)
        if c.repack == "off":
            direct = topological_signature(
                g, dim=c.dim, method=c.method, sublevel=c.sublevel,
                edge_cap=bucket.edge_cap, tri_cap=bucket.tri_cap,
                quad_cap=c.quad_cap)
        else:
            direct = make_topo_plan(
                dim=c.dim, method=c.method, sublevel=c.sublevel,
                edge_cap=bucket.edge_cap, tri_cap=bucket.tri_cap,
                quad_cap=c.quad_cap, repack="on",
                ladder=repack_ladder_for(tuple(sorted(c.buckets)),
                                         c.quad_cap)).execute(g)
        check(_diagrams_bitwise(_stacked([f.result(timeout=0)
                                          for f in futs]),
                                _rows(direct, slice(0, len(futs)))),
              f"served Diagrams differ from a direct execution of their "
              f"batch (bucket n{bucket.n_pad}, {len(futs)} graphs)")
        checked += len(futs)
    return checked


def _cpu_parity(srv) -> dict:
    """The first executed batch of each bucket through a CPU TopoServe of
    the same configuration: bitwise the card's rows."""
    from repro_torch.serve import TopoServe

    seen = {}
    for bucket, reqs, futs in srv.executed_batches:
        if bucket in seen:
            continue
        cpu = TopoServe(srv.config, device="cpu")
        cpu_futs = [cpu.submit(edges=r.edges, n_vertices=r.n_vertices,
                               f=r.f) for r in reqs]
        cpu.drain()
        got = _stacked([f.result(timeout=0) for f in futs])
        check(_diagrams_bitwise(_stacked([f.result(timeout=0)
                                          for f in cpu_futs]),
                                got.to("cpu")),
              f"bucket n{bucket.n_pad}: CUDA and CPU TopoServe differ")
        seen[bucket] = len(futs)
    return {f"n{b.n_pad}": n for b, n in sorted(seen.items())}


def phase_serve_topo(dev, launches, recorder) -> tuple[dict, tuple]:
    """TopoServe at ``serve_bench``'s configuration over the default bucket
    ladder: 4096 requests, a warm round, then the timed round (the main
    path's run); every served Diagrams bitwise a direct execution of its
    recorded batch, one batch per bucket bitwise a CPU TopoServe's.  Then
    the same traffic with ``repack="on"`` and ``method="both"``."""
    import dataclasses
    import gc

    from repro_torch.core.api import plan_cache_info
    from repro_torch.serve import TopoServe, TopoServeConfig

    reqs = serve_traffic(SERVE_REQUESTS, seed=0)
    base = TopoServeConfig(**SERVE_TOPO_CFG)
    out = {"phase": "serve_topo", "requests": len(reqs),
           "buckets": [f"n{b.n_pad}" for b in base.buckets],
           "config": SERVE_TOPO_CFG}
    phase_counts = {k: 0 for k in launches}
    bare = None
    for label, cfg in (("prunit", base),
                       ("both_repack", dataclasses.replace(
                           base, method="both", repack="on"))):
        srv = TopoServe(cfg)
        _serve_round(srv, reqs)              # warm round
        srv.executed_batches.clear()
        batches0 = srv.stats["batches"]
        cache0 = plan_cache_info()
        rungs0 = dict(srv.stats["repack_rungs"])
        gc.collect()
        (futs, submit_s, drain_s), counts, seconds = _drive(
            recorder, "serve_topo", _serve_round, srv, reqs)
        for k in launches:
            phase_counts[k] += counts[k]
        cache = plan_cache_info()
        rungs = {f"n{b}->n{r}": v - rungs0.get((b, r), 0)
                 for (b, r), v in sorted(srv.stats["repack_rungs"].items())}
        out[label] = {
            "method": cfg.method, "repack": cfg.repack,
            "wall_ms": seconds * 1e3, "submit_ms": submit_s * 1e3,
            "drain_ms": drain_s * 1e3, "graphs_per_s": len(reqs) / seconds,
            "batches": srv.stats["batches"] - batches0,
            "plan_cache_hits": cache["hits"] - cache0["hits"],
            "plan_cache_misses": cache["misses"] - cache0["misses"],
            "latency_by_bucket": _latency_by_bucket(futs),
            "rung_histogram": rungs,
            "launches": {k: counts[k] for k in launches},
            "parity_rows": _served_parity(srv, dev),
            "cpu_parity_rows": _cpu_parity(srv)}
        check(out[label]["parity_rows"] == len(reqs),
              f"serve_topo {label}: not every request was served")
        if bare is None:
            bare = (reqs, cfg, seconds)
    check(phase_counts["kcore_peel"] > 0 and phase_counts["domination"] > 0
          and phase_counts["gf2_reduce"] > 0,
          "serve_topo: a main-path kernel was never launched")
    out["launches"] = _add_counts(launches, phase_counts)
    return out, bare


def _http_get(url):
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=30) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _cli_env() -> dict:
    """The environment of a ``python -m repro_torch.obs`` subprocess: this
    checkout's ``src`` first on PYTHONPATH."""
    import os

    path = os.environ.get("PYTHONPATH")
    return dict(os.environ, PYTHONPATH=str(ROOT / "src")
                + (os.pathsep + path if path else ""))


def _slo_check_cli(url) -> dict:
    """``python -m repro_torch.obs slo check --url`` against a live
    exporter: its exit code must be 1 where the verdict block it printed
    shows a breach, else 0."""
    import re

    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs", "slo", "check", "--url",
         url], capture_output=True, text=True, timeout=300, env=_cli_env())
    printed = {}
    for line in out.stdout.splitlines():
        hit = re.match(r"^ +(ok|breach|no_data|\?) {2}(\S+)", line)
        if hit:
            printed[hit.group(2)] = hit.group(1)
    breach = "breach" in printed.values()
    check(bool(printed) and out.returncode == (1 if breach else 0),
          f"serve_watched: slo check exited {out.returncode} on "
          f"{printed}: {out.stdout[-400:]} {out.stderr[-400:]}")
    return {"exit_code": out.returncode, "printed": printed,
            "breached": sorted(k for k, v in printed.items()
                               if v == "breach")}


def phase_serve_watched(dev, launches, recorder, reqs, cfg, bare_s) -> dict:
    """The serve_topo round behind the TopoWatch layer: the default serving
    SLOs installed, the scrape exporter on 127.0.0.1 and ``serve_forever``
    draining on its own thread while this thread submits; one scrape of
    /metrics, /healthz, /readyz and /slo, each status 200 with its keys;
    ``watch_overhead_pct`` against the bare round."""
    import gc
    import threading

    from repro_torch import obs
    from repro_torch.obs import slo
    from repro_torch.serve import TopoServe

    engine = slo.SLOEngine(slo.default_serve_slos())
    prev = slo.install(engine)
    http = obs.start_http_server(port=0)
    srv = TopoServe(cfg)
    loop = threading.Thread(target=srv.serve_forever, name="serve-watched",
                            daemon=True)
    ready = obs.gauge("serve.ready")

    def watched_round():
        t0 = time.perf_counter()
        futs = [srv.submit(edges=e, n_vertices=n) for e, n in reqs]
        for f in futs:
            f.result(timeout=600)
        return futs, time.perf_counter() - t0

    scrapes = {}
    try:
        loop.start()
        deadline = time.monotonic() + 120
        while ready.value(frontend="topo", instance=srv._obs_instance) != 1:
            check(time.monotonic() < deadline and loop.is_alive(),
                  "serve_watched: the drain loop never became ready")
            time.sleep(0.01)
        watched_round()                      # warm round
        engine.tick()
        gc.collect()
        (futs, wall), counts, _ = _drive(recorder, "serve_watched",
                                         watched_round)
        engine.tick()
        for path, keys in (("/metrics", None),
                           ("/healthz", {"status", "loops"}),
                           ("/readyz", {"status", "ready"}),
                           ("/slo", {"ts", "status", "breaches"})):
            code, body = _http_get(http.url + path)
            check(code == 200, f"serve_watched: {path} answered {code}")
            if keys is None:
                text = body.decode()
                check("serve_request_latency_seconds_bucket" in text
                      and "slo_status" in text,
                      "serve_watched: /metrics lacks the serving series")
                scrapes[path] = {"status": code, "bytes": len(body)}
            else:
                doc = json.loads(body)
                check(keys <= set(doc), f"serve_watched: {path} keys "
                                        f"{sorted(doc)}")
                scrapes[path] = {"status": code,
                                 "doc_status": doc.get("status")
                                 if path != "/slo" else None}
        verdicts = slo.slo_status(tick=True)
        slo_check = _slo_check_cli(http.url)
    finally:
        srv.stop()
        loop.join(timeout=60)
        http.stop()
        slo.install(prev)
    check(not loop.is_alive(), "serve_watched: the drain loop did not stop")
    check(set(slo_check["printed"]) == set(verdicts),
          f"serve_watched: slo check printed {sorted(slo_check['printed'])}"
          f", the engine holds {sorted(verdicts)}")
    return {"phase": "serve_watched", "requests": len(reqs),
            "wall_ms": wall * 1e3, "graphs_per_s": len(reqs) / wall,
            "bare_wall_ms": bare_s * 1e3,
            "watch_overhead_pct": 100.0 * (wall - bare_s) / bare_s,
            "batches": srv.stats["batches"],
            "latency_by_bucket": _latency_by_bucket(futs),
            "scrapes": scrapes,
            "slo_objectives": len(verdicts), "slo_check_cli": slo_check,
            "slo_status": {k: v["status"] for k, v in sorted(
                verdicts.items())},
            "launches": _add_counts(launches, counts)}


def _oracle_w2(index, row, gid):
    """Hungarian W2 between a query row's compacted cloud and the stored
    cloud of ``gid`` (``metrics/reference.py``)."""
    from repro_torch.core.persistence import Diagrams
    from repro_torch.metrics import compact_top_k, reference

    cfg = index.config
    b, e, keep = compact_top_k(
        Diagrams(*(getattr(row, k)[None] for k in ("birth", "death", "dim",
                                                    "valid"))),
        cfg.k, cfg.n_points, cfg.cap)
    p1 = [(x, y) for x, y, kk in zip(b[0].tolist(), e[0].tolist(),
                                     keep[0].tolist()) if kk]
    base = getattr(index, "base", index)
    cl = base._clouds[list(base.ids).index(gid)]
    p2 = [(x, y) for x, y, kk in zip(*cl.tolist()) if kk > 0]
    return reference.wasserstein_exact(p1, p2)


def phase_serve_similarity_n64(dev, launches, recorder) -> dict:
    """SimilarityServe over index_n64's index (embedding "both", LSH 128
    bits, overfetch 8, k 10) with the exact re-rank: 4096 n64 corpus
    graphs added through ``add``, then 256 queries, drained twice (the
    second drain warm from the price cache); the same queries through a
    ``sharded=True`` wrap of the index on ``make_index_mesh()`` (same ids);
    then ``stage1_backend="exact_w"`` on a 512-graph corpus with 32
    queries.  64 sampled exact distances within 1e-5 of the Hungarian
    oracle."""
    import numpy as np

    from repro_torch.index import TopoIndexConfig
    from repro_torch.launch import make_index_mesh
    from repro_torch.serve import SimilarityServe

    corpus = _edge_lists(n64_batch(dev, batch=SERVE_SIM_CORPUS, seed=7))
    queries = _edge_lists(n64_batch(dev, batch=SERVE_SIM_QUERIES, seed=101))
    index_cfg = TopoIndexConfig(embedding="both", coarse="lsh")
    k = 10
    sim = SimilarityServe(index_config=index_cfg, default_k=k,
                          rerank="exact_w")
    for i, (e, n) in enumerate(corpus):
        sim.add(edges=e, n_vertices=n, gid=f"c{i}")
    t0 = time.perf_counter()
    sim.drain()
    add_s = time.perf_counter() - t0
    check(len(sim.index) == len(corpus), "serve_similarity_n64: adds lost")

    def query_round(server, qs):
        futs = [server.submit(edges=e, n_vertices=n) for e, n in qs]
        server.drain()
        return [f.result(timeout=0) for f in futs]

    phase_counts = {kk: 0 for kk in launches}
    runs = {}
    res = None
    for label in ("cold", "warm"):
        st0 = sim.stats
        got, counts, seconds = _drive(recorder, "serve_similarity_n64",
                                      query_round, sim, queries)
        for kk in launches:
            phase_counts[kk] += counts[kk]
        st = sim.stats
        runs[label] = {
            "query_ms": seconds * 1e3,
            "stage1_ms": (st["stage1_s"] - st0["stage1_s"]) * 1e3,
            "stage2_ms": (st["stage2_s"] - st0["stage2_s"]) * 1e3,
            "stage1_candidates": st["stage1_candidates"]
            - st0["stage1_candidates"],
            "stage2_pairs": st["stage2_pairs"] - st0["stage2_pairs"],
            "auction_rounds": st["auction_rounds"] - st0["auction_rounds"],
            # the price cache counts in repro_torch.counters, which _drive
            # set to 0 just before this run
            "warm_start_hits": st["warm_start_hits"],
            "warm_start_misses": st["warm_start_misses"]}
        if res is None:
            res = got
        else:
            check([r.ids for r in got] == [r.ids for r in res],
                  "serve_similarity_n64: the warm drain changed the ids")

    sharded = SimilarityServe(index=sim.index, default_k=k, rerank="exact_w",
                              sharded=True, index_mesh=make_index_mesh())
    got_sh, counts, seconds = _drive(recorder, "serve_similarity_n64",
                                     query_round, sharded, queries)
    for kk in launches:
        phase_counts[kk] += counts[kk]
    check([r.ids for r in got_sh] == [r.ids for r in res],
          "serve_similarity_n64: sharded and single-host ids differ")
    sh_err = max(abs(a - b) for r, r2 in zip(got_sh, res)
                 for a, b in zip(r.distances, r2.distances))
    runs["sharded"] = {"query_ms": seconds * 1e3,
                       "shards": sharded.index.n_shards,
                       "max_abs_diff_vs_single_host": sh_err}

    n_ex, q_ex = SERVE_SIM_EXACT
    exact = SimilarityServe(index_config=index_cfg, default_k=k,
                            stage1_backend="exact_w")
    for i, (e, n) in enumerate(corpus[:n_ex]):
        exact.add(edges=e, n_vertices=n, gid=f"c{i}")
    exact.drain()
    res_ex, counts, seconds = _drive(recorder, "serve_similarity_n64",
                                     query_round, exact, queries[:q_ex])
    for kk in launches:
        phase_counts[kk] += counts[kk]
    st = exact.stats
    runs["stage1_exact"] = {
        "corpus": n_ex, "queries": q_ex, "query_ms": seconds * 1e3,
        "stage1_candidates": st["stage1_candidates"],
        "auction_rounds": st["auction_rounds"]}

    rng = np.random.default_rng(SERVE_ORACLE_SEED)
    err = 0.0
    for server, results in ((sim, res), (exact, res_ex)):
        picks = rng.choice(len(results) * k, SERVE_ORACLE_SAMPLES // 2,
                           replace=False)
        for p in picks.tolist():
            r = results[p // k]
            want = _oracle_w2(server.index, r.diagrams, r.ids[p % k])
            err = max(err, abs(r.distances[p % k] - want))
    check(err <= EX_ATOL, f"serve_similarity_n64: an exact distance is "
                          f"{err} from the Hungarian oracle")
    for name in ("pairwise_l1", "auction_lap_collapsed", "hamming_scan",
                 "domination", "gf2_reduce"):
        check(phase_counts[name] > 0,
              f"serve_similarity_n64: {name} was never launched")
    return {"phase": "serve_similarity_n64", "corpus": len(corpus),
            "queries": len(queries), "k": k,
            "index": {"embedding": index_cfg.embedding,
                      "coarse": index_cfg.coarse,
                      "lsh_bits": index_cfg.lsh_bits,
                      "lsh_overfetch": index_cfg.lsh_overfetch,
                      "rerank_overfetch": sim.overfetch},
            "add_ms": add_s * 1e3, **runs,
            "oracle_samples": SERVE_ORACLE_SAMPLES,
            "oracle_max_abs_err": err,
            "launches": _add_counts(launches, phase_counts)}


def phase_serve_stream(dev, launches, recorder) -> dict:
    """StreamServe with 4 sessions of the ego-decay stream (1024 graphs of
    n_pad 64 each), 16 steps each, all submitted and then drained; each
    step's Diagrams bitwise a direct TopoStream fed the same deltas."""
    from repro_torch.core.delta import delta_step
    from repro_torch.data.temporal import ego_decay_stream
    from repro_torch.serve import StreamServe
    from repro_torch.stream import TopoStream, TopoStreamConfig

    n_sessions, graphs, steps = SERVE_STREAM
    ego = dict(STREAM_EGO, steps=steps)
    cfg = TopoStreamConfig(**STREAM_EGO_CFG)
    streams = [ego_decay_stream(51 + s, graphs, 64, **ego, device=dev)
               for s in range(n_sessions)]
    srv = StreamServe(cfg)
    sids = [srv.create_session(g0) for g0, _ in streams]

    def run():
        futs = [[srv.submit(sid, delta_step(ds, t)) for t in range(steps)]
                for sid, (_, ds) in zip(sids, streams)]
        return futs, srv.drain()

    (futs, applied), counts, seconds = _drive(recorder, "serve_stream", run)
    check(applied == n_sessions * steps, "serve_stream: steps not applied")
    for (g0, ds), sfuts in zip(streams, futs):
        direct = TopoStream(g0, cfg)
        for t, f in enumerate(sfuts):
            before = dict(direct.stats)
            d = direct.apply(delta_step(ds, t))
            check(_diagrams_bitwise(f.result(timeout=0), d),
                  f"serve_stream step {t}: served Diagrams differ from a "
                  "direct TopoStream")
            check(f.info["graph_updates"] == direct.stats["graph_updates"]
                  - before["graph_updates"] and f.info["hits"]
                  == direct.stats["hits"] - before["hits"],
                  f"serve_stream step {t}: step info differs")
    st = srv.stats()
    return {"phase": "serve_stream", "sessions": n_sessions,
            "graphs_per_session": graphs, "n_pad": 64, "steps": steps,
            "config": STREAM_EGO_CFG, "graph_updates": st["graph_updates"],
            "skip_rate": st["skip_rate"], "recomputes": st["recomputes"],
            "drain_ms": seconds * 1e3,
            "updates_per_s": st["graph_updates"] / seconds,
            "parity_steps": n_sessions * steps,
            "launches": _add_counts(launches, counts)}


def _kernel_key(span: str) -> str:
    """The ``counters.KERNEL_LAUNCHES`` key of a ``kernels.*`` span."""
    name = span.split(".", 1)[1]
    return "gf2_reduce" if name == "gf2_reduce_batch" else name


def phase_trace_report(g64, d64, index_run, dev, top=25) -> dict:
    """The port's trace-report path: with tracing on, one step each of the
    main paths (a ``signature_n64`` execution, one ``ops.gf2_reduce`` on a
    single block, an n64 clustering call, a blocked ``sinkhorn_n64``
    compare, ``exact_n64`` compares collapsed and with ``collapse="off"``,
    and an LSH ``index_n64`` query), each in a ``chip_smoke.<step>`` span
    whose self-time is its host work outside the kernel wrappers.  The
    Chrome trace goes through ``python -m repro_torch.obs report`` (exit 0,
    its table printed); every kernel launched in the window has
    ``kernels.*`` rows whose calls equal its ``KERNEL_LAUNCHES`` delta and
    its ``kernels.calls`` delta; the summed self-times stay within the
    trace's wall; every mapped kernel row carries a modeled cost cell.
    Kernel spans time the host wrapper around an asynchronous launch, not
    the device."""
    import os
    import tempfile

    import torch
    from repro_torch import counters, obs
    from repro_torch.core.api import make_topo_plan
    from repro_torch.kernels import ops
    from repro_torch.metrics import compare, compare_info
    from repro_torch.obs.report import KERNEL_CELLS, aggregate, load_trace

    _, index_lsh, dq, k = index_run
    plan = make_topo_plan(dim=1, method="both", repack="on", **N64_CAPS)
    block = _bit31_blocks(1, 128, 128, 5, dev)[0]
    d1, d2 = _rows(d64, slice(0, None, 2)), _rows(d64, slice(1, None, 2))
    steps = (
        ("signature_n64", lambda: plan.execute(g64)),
        ("gf2_reduce", lambda: ops.gf2_reduce(block)),
        ("clustering_n64",
         lambda: ops.clustering_coefficients(g64.adj, g64.mask)),
        ("sinkhorn_n64",
         lambda: compare(d1, d2, metric="sinkhorn", impl="blocked")),
        ("exact_n64", lambda: compare(d1, d2, metric="exact_w")),
        ("exact_n64_off",
         lambda: compare_info(d1, d2, metric="exact_w", collapse="off")),
        ("index_n64", lambda: index_lsh.query(dq, k)))
    calls = obs.get_instrument("kernels.calls")
    before = calls.labeled("kernel")
    torch.cuda.synchronize()
    was = obs.enabled()
    obs.configure(enabled=True)
    obs.clear_trace()
    counters.reset()
    try:
        t0 = time.perf_counter()
        for name, fn in steps:
            with obs.span(f"chip_smoke.{name}"):
                fn()
                torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        obs.configure(enabled=was)
    launches = {k_: v for k_, v in counters.KERNEL_LAUNCHES.items() if v}
    after = calls.labeled("kernel")
    labels = {k_: after[k_] - before.get(k_, 0) for k_ in after
              if after[k_] != before.get(k_, 0)}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        obs.export_chrome_trace(path)
        obs.clear_trace()
        cli = subprocess.run(
            [sys.executable, "-m", "repro_torch.obs", "report", path,
             "--top", str(top)], capture_output=True, text=True,
            timeout=300, env=_cli_env())
        events = load_trace(path)
    check(cli.returncode == 0, f"trace_report: the report CLI exited "
                               f"{cli.returncode}: {cli.stderr[-600:]}")
    print(cli.stdout.rstrip(), flush=True)
    rows = aggregate(events)
    kernel_rows = [r for r in rows if r["span"].startswith("kernels.")]
    spans = {}
    for r in kernel_rows:
        key = _kernel_key(r["span"])
        spans[key] = spans.get(key, 0) + r["calls"]
    by_label = {}
    for label, n in labels.items():
        key = _kernel_key("kernels." + label)
        by_label[key] = by_label.get(key, 0) + int(n)
    check(sorted(launches) == sorted(REPLACES),
          f"trace_report: launched only {sorted(launches)}")
    check({"gf2_reduce", "gf2_reduce_batch"} <= set(labels),
          f"trace_report: kernels.calls labels {sorted(labels)}")
    check(spans == launches, f"trace_report: kernel rows' calls {spans} "
                             f"against launches {launches}")
    check(by_label == launches, f"trace_report: kernels.calls deltas "
                                f"{by_label} against launches {launches}")
    trace_wall_us = (max(e["ts"] + e["dur"] for e in events)
                     - min(e["ts"] for e in events))
    self_us = sum(r["self_us"] for r in rows)
    check(self_us <= trace_wall_us * (1 + 1e-9),
          f"trace_report: self-times {self_us} us exceed the wall "
          f"{trace_wall_us} us")
    unmodeled = [r["span"] for r in kernel_rows if r["span"] in KERNEL_CELLS
                 and not (r["cost_cell"] or {}).get("modeled")]
    check(not unmodeled, f"trace_report: rows without a modeled cell "
                         f"{unmodeled}")

    def brief(r):
        cell = r["cost_cell"]
        return {"span": r["span"], "shape": r["shape"], "calls": r["calls"],
                "total_ms": r["total_us"] / 1e3, "self_ms": r["self_us"] / 1e3,
                "bound_ms": cell["bound_s"] * 1e3 if cell else None,
                "bound": cell["bound"] if cell else None}

    return {"phase": "trace_report", "wall_ms": wall_ms,
            "trace_wall_ms": trace_wall_us / 1e3, "self_ms": self_us / 1e3,
            "spans": len(events), "rows": len(rows), "launches": launches,
            "kernels_calls": labels, "report_exit_code": cli.returncode,
            "note": "kernel spans time the host wrapper around an "
                    "asynchronous launch, not the device",
            "top": [brief(r) for r in rows[:top]]}


def _profile_stream_step(name, stream, deltas, t) -> dict:
    """``_profile`` of step ``t`` applied to copies of ``stream``'s state,
    which must be the state before step ``t`` (the stream itself is left
    as it is)."""
    import copy

    from repro_torch.core.delta import delta_step

    delta = delta_step(deltas, t)

    def step():
        s = copy.copy(stream)
        s.stats = dict(stream.stats)
        s.recompute_sizes = []
        s._all_dims_exact = stream._all_dims_exact.copy()
        s._drift_calibrator = copy.deepcopy(stream._drift_calibrator)
        s.apply(delta)

    return _profile(name, step)


def phase_profile_stream(runs) -> dict:
    """One step of each stream phase profiled: the step its phase left
    unapplied, on the state the phase ended in (device busy and idle
    share, and each kernel's device time)."""
    return {"phase": "profile_stream",
            "steps": {name: _profile_stream_step(name, stream, deltas,
                                                 deltas.steps - 1)
                      for name, (stream, deltas) in runs.items()}}


def _profile(name, fn, reps: int = 1) -> dict:
    """Device time by kernel over ``reps`` steady ``fn()`` calls
    (torch.profiler, CUDA activity), the device's idle share of the wall
    time, and the time of the ported kernels.  Runs after the timed runs:
    the profiler's own cost is in its wall time, not in theirs."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        # kernels only: an aten op's row repeats its kernels' device time
        if e.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((dev_us / 1e3, e.key, e.count))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    ported = ("kcore_peel_kernel", "domination_gram_kernel",
              "gf2_reduce_kernel",
              "common_neighbors_gram_kernel",
              "pairwise_l1_kernel", "pairwise_l1_small_kernel",
              "sinkhorn_lse_kernel", "sinkhorn_pair_sum_kernel",
              "auction_lap_kernel", "auction_collapsed_kernel",
              "hamming_scan_regs_kernel", "hamming_scan_chunked_kernel")
    ported_ms = sum(r[0] for r in rows if any(p in r[1] for p in ported))
    check(busy_ms > 0, f"{name}: no device time recorded")
    return {"phase": name, "reps": reps, "wall_ms": wall_ms,
            "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "ported_kernels_ms": ported_ms,
            "top": [{"name": k[:80], "ms": ms, "count": c}
                    for ms, k, c in rows[:15]]}


def phase_profile(g, caps) -> dict:
    """``_profile`` of one steady n64 execution."""
    from repro_torch.core.api import make_topo_plan

    plan = make_topo_plan(dim=1, method="both", repack="on", **caps)
    return _profile("profile_n64", lambda: plan.execute_info(g))


def phase_profile_clustering(g, reps: int = 20) -> dict:
    """``_profile`` of ``reps`` steady n64 clustering calls: the
    common-neighbors kernel's fused epilogue (one launch a call) against
    PyTorch's ops around it."""
    from repro_torch.kernels.ops import clustering_coefficients

    return _profile("profile_clustering_n64",
                    lambda: clustering_coefficients(g.adj, g.mask), reps)


def phase_profile_index(index, index_lsh, dq, k, sharded) -> dict:
    """``_profile`` of the index's steady work: the Gram and one batch of
    queries without and with the LSH stage; then, alone, one LSH batch
    through the single-host index (host scan) and through ``sharded`` (the
    ShardedIndex over the same rows: the scan on the card)."""
    def run():
        index.gram()
        index.query(dq, k)
        index_lsh.query(dq, k)

    out = _profile("profile_index_n64", run)
    out["host_lsh_query"] = _profile("profile_host_lsh_query_n64",
                                     lambda: index_lsh.query(dq, k))
    out["sharded_lsh_query"] = _profile("profile_sharded_lsh_query_n64",
                                        lambda: sharded.query(dq, k), reps=5)
    return out


def phase_profile_sinkhorn(d1, d2) -> dict:
    """``_profile`` of one steady ``sinkhorn_full_n320`` call."""
    from repro_torch.metrics import compare

    return _profile("profile_sinkhorn", lambda: compare(d1, d2, **SK_FULL))


def phase_profile_exact(d1, d2) -> dict:
    """``_profile`` of one steady ``exact_n320`` call at the registry's
    default layout (collapsed, K = 64), and of three in the expanded one
    (``collapse="off"``, M = 128)."""
    from repro_torch.metrics import compare

    out = _profile("profile_exact", lambda: compare(
        d1, d2, metric="exact_w", n_points=64))
    out["expanded"] = _profile("profile_exact_expanded", lambda: compare(
        d1, d2, metric="exact_w", n_points=64, collapse="off"), reps=3)
    return out


def _time_kcore(adj, alive, k, sweeps) -> dict:
    """The fixpoint launch: kernel (between events and on the device),
    plain loop (one sync per sweep), and torch.bmm sweeps, as many as this
    input needs; and the cluster size the launch takes."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.kcore_peel import cluster_size, kcore_peel_cuda
    from repro_torch.launch.roofline import bound_ms

    b, n = alive.shape

    def plain_fixpoint():
        cur, count = alive, 0
        while True:
            nxt = ref.kcore_peel_ref(adj, cur, k)
            count += 1
            if torch.equal(nxt, cur):
                return nxt, count
            cur = nxt

    want, n_sweeps = plain_fixpoint()
    af = adj.float()

    def library():
        cur = alive
        for _ in range(n_sweeps):
            cur = cur & (torch.bmm(af, cur.float()[:, :, None])[:, :, 0] >= k)
        return cur

    def kernel():
        return kcore_peel_cuda(adj, alive, k, sweeps)

    bt, by = bound_ms(adj.numel() + 2 * alive.numel(),
                      {"lane": 3.0 * n_sweeps * b * n * ((n + 31) // 32)})
    sms = torch.cuda.get_device_properties(adj.device).multi_processor_count
    return {"name": "kcore_peel", "shape": [b, n, n], "k": k,
            "sweeps_needed": n_sweeps, "cluster": cluster_size(b, n, sms),
            "max_abs_err": max_abs_err([kernel()], [want]),
            "ms": cuda_ms(kernel),
            "device_ms": device_ms(kernel),
            "host_ms": host_ms_per_call(kernel),
            "plain_ms": cuda_ms(plain_fixpoint, reps=3),
            "library_ms": cuda_ms(library), "bound_ms": bt, "bound_by": by}


def _domination_bounds(b, n) -> dict:
    """The least time any implementation could take, the larger of one
    read of adj and mask and one write of out over HBM and the int8
    operations of the Gram on the tensor cores: G is symmetric, so a graph
    needs its N(N+1)/2 distinct inner products of N products each,
    B*N^2*(N+1) operations with an FMA as two.  Beside it, the popcount
    floor of a packed AND-NOT form, B*N^2*ceil(N/32) popcounts on the
    multi-function units."""
    from repro_torch.launch.roofline import MUFU_OPS_PER_S, bound_ms

    bt, by = bound_ms(2 * b * n * n + b * n,
                      {"int8_tc": float(b) * n * n * (n + 1)})
    return {"bound_ms": bt, "bound_by": by,
            "popcount_floor_ms": b * n * n * ((n + 31) // 32)
            / MUFU_OPS_PER_S * 1e3}


def _time_domination(adj, mask) -> dict:
    """Kernel (between events, on the device, and the wrapper's host time
    a call), plain version, and one f32 torch.bmm of the 0/1 matrices with
    the same epilogue; the work mapping the launch took."""
    import torch
    from repro_torch.kernels import domination as dm
    from repro_torch.kernels import ref

    b, n = mask.shape
    eye = torch.eye(n, dtype=torch.bool, device=adj.device)

    def library():
        live = mask[:, None, :] & mask[:, :, None]
        nc = (adj | eye) & live
        viol = torch.bmm(nc.float(), ((~nc) & mask[:, None, :]).float()
                         .transpose(1, 2))
        return (viol == 0) & ~eye & live

    def kernel():
        return dm.domination_cuda(adj, mask)

    sms = torch.cuda.get_device_properties(adj.device).multi_processor_count
    lay = dm.layout(b, n, sms)
    return {"name": "domination", "shape": [b, n, n],
            "mapping": lay.mapping, "graphs_per_cta": lay.graphs_per_cta,
            "ctas": lay.ctas,
            "max_abs_err": max_abs_err([kernel()],
                                       [ref.domination_ref(adj, mask)]),
            "ms": cuda_ms(kernel), "device_ms": device_ms(kernel),
            "host_ms": host_ms_per_call(kernel),
            "plain_ms": cuda_ms(lambda: ref.domination_ref(adj, mask)),
            "library_ms": cuda_ms(library), **_domination_bounds(b, n)}


def _gf2_chains(blocks, n_rows, got):
    """Per block: max |kernel - plain| over the three outputs, and the
    chase's length per matrix from the plain version's counts.  A step is
    one XOR or the claim or emptying that ends a column, so a matrix takes
    se + additions steps, se one past its last nonzero column; a sweep
    over every column takes S + additions iterations."""
    import torch
    from repro_torch.kernels import ref

    out = []
    for blk, r, res in zip(blocks, n_rows, got):
        red, owner, positive, adds = ref.gf2_reduce_counted(blk, r)
        g, s, w = blk.shape
        nz = (blk != 0).any(-1)
        se = torch.where(nz.any(-1), s - nz.flip(-1).int().argmax(-1), 0)
        steps = se.long() + adds
        out.append({"err": max_abs_err(res, (red, owner, positive)),
                    "shape": [g, s, w], "n_rows": r,
                    "se_max": int(se.max()) if g else 0,
                    "adds_max": int(adds.max()) if g else 0,
                    "adds": int(adds.sum()), "se": int(se.sum()),
                    "steps": steps})
    return out


def _time_gf2(blocks, n_rows) -> dict:
    """Kernel (between events, on the device, and the wrapper's host time
    a call) and plain version; each block's layout and the chase's steps
    (max and mean over matrices), the device time a step of the slowest
    matrix, and the chain floor: its steps at one shared-memory round
    trip each (SMEM_ROUND_TRIP_NS).  The bound counts the words the steps
    this input needs touch (low and XOR, W each) and the bytes."""
    import torch
    from repro_torch.kernels import gf2_reduce as gf2
    from repro_torch.kernels import ref
    from repro_torch.launch.roofline import bound_ms

    def kernel():
        return gf2.gf2_reduce_cuda(blocks, n_rows)

    chains = _gf2_chains(blocks, n_rows, kernel())
    moved, ops = 0, 0.0
    for blk, r, c in zip(blocks, n_rows, chains):
        g_, s_, w_ = blk.shape
        moved += 2 * blk.numel() * 4 + g_ * r * 4 + g_ * s_
        ops += 2.0 * w_ * (c["se"] + c["adds"])
    bt, by = bound_ms(moved, {"lane": ops})
    steps = torch.cat([c["steps"] for c in chains])
    steps_max = int(steps.max()) if steps.numel() else 0
    dev_ms = device_ms(kernel)
    layout = getattr(gf2, "layout", None)  # (older checkouts have none)
    sms = torch.cuda.get_device_properties(
        blocks[0].device).multi_processor_count
    per_block = []
    for blk, r, c in zip(blocks, n_rows, chains):
        st = c.pop("steps")
        c.update(steps_max=int(st.max()) if st.numel() else 0,
                 steps_mean=float(st.float().mean()) if st.numel() else 0.0,
                 sweep_iterations_max=(blk.shape[1] + c["adds_max"]
                                       if st.numel() else 0))
        if layout is not None:
            c["layout"] = layout(*c["shape"], r, sms)._asdict()
        per_block.append(c)
    return {"name": "gf2_reduce",
            "shape": [list(b.shape) for b in blocks], "n_rows": n_rows,
            "max_abs_err": max(c.pop("err") for c in per_block),
            "ms": cuda_ms(kernel), "device_ms": dev_ms,
            "host_ms": host_ms_per_call(kernel),
            "steps_max": steps_max,
            "steps_mean": float(steps.float().mean()) if steps.numel()
            else 0.0,
            "ns_per_step": dev_ms * 1e6 / steps_max if steps_max else None,
            "chain_floor_ms": steps_max * SMEM_ROUND_TRIP_NS * 1e-6,
            "blocks": per_block,
            "plain_ms": cuda_ms(lambda: [ref.gf2_reduce_ref(b, r) for b, r
                                         in zip(blocks, n_rows)], reps=1),
            "library_ms": None, "bound_ms": bt, "bound_by": by}


def _common_neighbors_bounds(b, n, edges, sums) -> dict:
    """The least time either epilogue could take, the larger of its bytes
    over HBM (one read of adj; the (B, N, N) int32 counts, or the mask
    and the two (B, N) int32 sums) and the int8 operations this input
    needs on the tensor cores: a count is needed on each of the
    ``edges`` nonzeros of the (live-restricted) adjacency only, and G is
    symmetric, so one inner product of N products per unordered edge,
    edges * N operations with an FMA as two."""
    from repro_torch.launch.roofline import bound_ms

    moved = b * n * n + (9 * b * n if sums else 4 * b * n * n)
    bt, by = bound_ms(moved, {"int8_tc": float(edges) * n})
    return {"bound_ms": bt, "bound_by": by}


def _time_common_neighbors(adj, mask=None) -> dict:
    """Both epilogues of the one kernel at the recorded input (adj and the
    live mask the clustering path gave the fused one; all live when the
    counts were recorded): each between events and on the device, its
    plain version, one bf16 torch.bmm of the 0/1 matrices with the same
    epilogue (exact while counts stay <= 256, which the run checks; for
    the fused form also the masking and both row sums), and its bound.
    The counts run on the live-restricted adjacency, the input the
    clustering path gave them before the fused epilogue.  The row's own
    numbers are the fused epilogue's, which the main path launches; the
    counts' are under "cn"."""
    import torch
    from repro_torch.kernels import common_neighbors as cn
    from repro_torch.kernels import ref

    b, n, _ = adj.shape
    if mask is None:
        mask = torch.ones((b, n), dtype=torch.bool, device=adj.device)
    live = (adj & mask[:, None, :] & mask[:, :, None]).contiguous()
    sms = torch.cuda.get_device_properties(adj.device).multi_processor_count
    lay = cn.layout(b, n, sms, sums=True)
    want_cn = ref.common_neighbors_ref(live)
    want = ref.common_neighbors_rowsums_ref(adj, mask)

    def library_cn():
        a = live.to(torch.bfloat16)
        return (torch.bmm(a, a) * a).to(torch.int32)

    def library():
        a = (adj & mask[:, None, :] & mask[:, :, None]).to(torch.bfloat16)
        c = torch.bmm(a, a) * a
        return (c.sum(-1, dtype=torch.float32).to(torch.int32),
                a.sum(-1, dtype=torch.float32).to(torch.int32))

    def counts():
        return cn.common_neighbors_cuda(live)

    def sums():
        return cn.common_neighbors_rowsums_cuda(adj, mask)

    lib_cn = library_cn()
    lib = library()
    edges = int(live.sum())
    return {"name": "common_neighbors", "shape": [b, n, n],
            "epilogue": "rowsums", "mapping": lay.mapping,
            "graphs_per_cta": lay.graphs_per_cta, "ctas": lay.ctas,
            "nonzeros": int(adj.sum()), "live_nonzeros": edges,
            "live": int(mask.sum()),
            "max_abs_err": max(max_abs_err(sums(), want),
                               max_abs_err([counts()], [want_cn])),
            "ms": cuda_ms(sums), "device_ms": device_ms(sums),
            "host_ms": host_ms_per_call(sums),
            "plain_ms": cuda_ms(lambda: ref.common_neighbors_rowsums_ref(
                adj, mask)),
            "library_ms": cuda_ms(library),
            "library_exact": bool(torch.equal(lib[0], want[0])
                                  and torch.equal(lib[1], want[1])),
            **_common_neighbors_bounds(b, n, edges, True),
            "cn": {"ms": cuda_ms(counts), "device_ms": device_ms(counts),
                   "plain_ms": cuda_ms(
                       lambda: ref.common_neighbors_ref(live)),
                   "library_ms": cuda_ms(library_cn),
                   "library_exact": bool(torch.equal(lib_cn, want_cn)),
                   **_common_neighbors_bounds(b, n, edges, False)}}


def _time_pairwise_l1(x, y) -> dict:
    """Kernel and torch.cdist(p=1) (between events and on the device), the
    plain version, and the layout the launch takes; the bound counts two
    f32 instructions (subtract, add with |.|) per (i, j, d)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.pairwise_gram import pairwise_l1_cuda
    from repro_torch.launch.roofline import bound_ms

    (m, d), n = x.shape, y.shape[0]

    def kernel():
        return pairwise_l1_cuda(x, y)

    def library():
        return torch.cdist(x, y, p=1)

    err = (kernel() - ref.pairwise_l1_ref(x, y)).abs()
    bt, by = bound_ms(4.0 * (m * d + n * d + m * n),
                      {"lane": 2.0 * m * n * d})
    return {"name": "pairwise_l1", "shape": [m, n, d],
            "layout": _l1_layout(m, n),
            "max_abs_err": float(err.max()), "tolerance": L1_TOLERANCE,
            "within_tolerance": bool((err <= l1_tolerance(x, y)).all()),
            # 50 launches a side: at fig2's size both sides are host-bound
            "ms": cuda_ms(kernel, reps=50),
            "device_ms": device_ms(kernel),
            "host_ms": host_ms_per_call(kernel),
            "plain_ms": cuda_ms(lambda: ref.pairwise_l1_ref(x, y), reps=3),
            "library_ms": cuda_ms(library, reps=50),
            "library_device_ms": device_ms(library),
            "bound_ms": bt, "bound_by": by}


def _time_hamming(codes_q, mask_q, codes_db) -> dict:
    """Kernel (between events, on the device, and the wrapper's host time
    a call), plain version, and a byte-table lookup in one expression as
    the library yardstick (torch has no popcount); the launch's layout and
    ptxas's report.  The bound is the largest of the bytes (each word in
    once, the int32 output out once), 3 lane instructions (XOR, AND, add)
    and one popcount per (i, j, w).  Beside it, ``fill_ms``: the device
    time of PyTorch's fill of an int32 tensor of the output's shape, the
    write rate the card reaches on these bytes with nothing to compute."""
    import torch
    from repro_torch.kernels import hamming as hm
    from repro_torch.kernels import ref
    from repro_torch.launch.roofline import bound_ms

    (q, w), n = codes_q.shape, codes_db.shape[0]
    table = torch.tensor([bin(i).count("1") for i in range(256)],
                         dtype=torch.uint8, device=codes_q.device)

    def library():
        x = (codes_q[:, None, :] ^ codes_db[None]) & mask_q[:, None, :]
        return table[x.view(torch.uint8).int()].sum(-1, dtype=torch.int32)

    def kernel():
        return hm.hamming_scan_cuda(codes_q, mask_q, codes_db)

    want = ref.hamming_scan_ref(codes_q, mask_q, codes_db)
    got = kernel()
    check(torch.equal(library(), want), "hamming_scan: the byte-table "
                                        "yardstick disagrees")
    filled = torch.empty_like(want)
    bt, by = bound_ms(4.0 * (2 * q * w + n * w + q * n),
                      {"lane": 3.0 * q * n * w, "mufu": float(q * n * w)})
    layout = getattr(hm, "layout", None)  # (older checkouts have none)
    sms = torch.cuda.get_device_properties(
        codes_q.device).multi_processor_count
    return {"name": "hamming_scan", "shape": [q, n, w],
            "layout": layout(q, n, w, sms)._asdict() if layout else None,
            "max_abs_err": max(max_abs_err([got], [want]),
                               max_abs_err([kernel()], [got])),
            "ms": cuda_ms(kernel), "device_ms": device_ms(kernel),
            "host_ms": host_ms_per_call(kernel),
            "plain_ms": cuda_ms(lambda: ref.hamming_scan_ref(
                codes_q, mask_q, codes_db), reps=3),
            "library_ms": cuda_ms(library, reps=3),
            "library": "byte-table lookup (torch has no popcount)",
            "bound_ms": bt, "bound_by": by,
            "fill_ms": device_ms(lambda: filled.fill_(0)),
            "ptxas": ptxas("hamming", "hamming_scan")}


def phase_hamming_large(dev, q=256, n=262144, nbytes=16) -> dict:
    """``_time_hamming`` at 256 queries of 128 bits against 262,144 rows:
    the int32 output alone is 268 MB."""
    import numpy as np
    from repro_torch.kernels.hamming import as_int32_words, pack_codes_u32
    from repro_torch.metrics.testing import hamming_operands

    cq, cd, mq = (as_int32_words(pack_codes_u32(a)).to(dev)
                  for a in hamming_operands(np.random.default_rng(7), q, n,
                                            nbytes, "probe"))
    row = _time_hamming(cq, mq, cd)
    check(row["max_abs_err"] == 0, "hamming_scan (large): kernel disagrees "
                                   "with its plain version")
    return {"phase": "hamming_large", **row}


def _time_sinkhorn_lse(xp, yp, dual, logw, e_t, packed=None) -> dict:
    """Kernel (from the main path's pack of the weighted columns, made once
    per side and call, which ``pack_ms`` times apart; between events, on
    the device, and the wrapper's host time a call), plain version, and
    torch.logsumexp over the materialized exponents (cost build included).
    The bound counts SK_LSE_WORK for every row and column of nonzero weight
    (the others add nothing), and the bytes the function needs: every row's
    planes and output, every log weight, and the planes and dual of the
    columns of nonzero weight."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.sinkhorn_lse import (
        pack_columns, sinkhorn_lse_cuda)
    from repro_torch.launch.roofline import bound_ms

    (b, _, m), n = xp.shape, yp.shape[-1]
    if packed is None:
        packed = pack_columns(yp, logw)
    args = (xp, yp, dual, logw, e_t)
    err, ok = sinkhorn_error(sinkhorn_lse_cuda(*args, packed),
                             ref.sinkhorn_lse_ref(*args))

    def library():
        c = ref.sinkhorn_cost(xp, yp)
        z = logw[:, None, :] + (dual[:, None, :] - c) / e_t[:, :, None]
        return torch.logsumexp(z, -1)

    def kernel():
        return sinkhorn_lse_cuda(*args, packed)

    cols = int((logw != float("-inf")).sum())
    visited = m * cols
    lane, mufu = SK_LSE_WORK
    bt, by = bound_ms(4.0 * (4 * b * m + b * n + 4 * cols + b),
                      {"lane": lane * visited, "mufu": mufu * visited})
    return {"name": "sinkhorn_lse", "shape": [b, m, n],
            # one thread a row, 128 a CTA (csrc/sinkhorn_lse.cu)
            "layout": {"grid": [b, -(-m // 128)], "threads": 128},
            "visited_pairs": visited, "max_abs_err": err,
            "tolerance": SK_TOLERANCE, "within_tolerance": ok,
            "ms": cuda_ms(kernel), "device_ms": device_ms(kernel),
            "host_ms": host_ms_per_call(kernel),
            "pack_ms": cuda_ms(lambda: pack_columns(yp, logw)),
            "plain_ms": cuda_ms(lambda: ref.sinkhorn_lse_ref(*args), reps=3),
            "library_ms": cuda_ms(library, reps=3), "bound_ms": bt,
            "bound_by": by}


def _time_sinkhorn_pair_sum(xp, yp, f, g, log_a, log_b, e_t, mode) -> dict:
    """Kernel (between events, on the device, and the wrapper's host time
    a call; equal bits on a repeat launch) and plain version, the launch's
    layout and ptxas's report; no single PyTorch call computes the masked
    pair sum.  The bound counts SK_PAIR_WORK[mode] for every pair of
    nonzero weight, and the bytes the function needs: every log weight,
    and the planes (and, for "plan", the potential) of the slots of
    nonzero weight."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import sinkhorn_lse as sk
    from repro_torch.launch.roofline import bound_ms

    (b, _, m), n = xp.shape, yp.shape[-1]
    args = (xp, yp, f, g, log_a, log_b, e_t, mode)

    def kernel():
        return sk.sinkhorn_pair_sum_cuda(*args)

    got = kernel()
    err, ok = sinkhorn_error(got, ref.sinkhorn_pair_sum_ref(*args))
    repeat = torch.equal(got, kernel())
    rows, cols = torch.isfinite(log_a).sum(-1), torch.isfinite(log_b).sum(-1)
    visited = int((rows * cols).sum())
    slot_bytes = 16 if mode == "plan" else 12
    lane, mufu = SK_PAIR_WORK[mode]
    bt, by = bound_ms(4.0 * b * (m + n + 2)
                      + slot_bytes * int(rows.sum() + cols.sum()),
                      {"lane": lane * visited, "mufu": mufu * visited})
    layout = getattr(sk, "layout", None)  # (older checkouts have none)
    sms = torch.cuda.get_device_properties(xp.device).multi_processor_count
    return {"name": "sinkhorn_pair_sum", "shape": [b, m, n], "mode": mode,
            "layout": layout(b, m, n, sms)._asdict() if layout else None,
            "visited_pairs": visited, "max_abs_err": err,
            "tolerance": SK_TOLERANCE + "; a repeat launch bitwise",
            "within_tolerance": ok and repeat,
            "ms": cuda_ms(kernel), "device_ms": device_ms(kernel),
            "host_ms": host_ms_per_call(kernel),
            "plain_ms": cuda_ms(lambda: ref.sinkhorn_pair_sum_ref(*args),
                                reps=3),
            "library_ms": None, "bound_ms": bt, "bound_by": by,
            "ptxas": ptxas("sinkhorn_lse", "sinkhorn_pair_sum")}


def _auction_row(name, cost, got, want, scans, io_bytes, kernel, plain):
    """A timer row of an auction kernel on (B, M, M) ``cost``: agreement
    with the plain version, rounds, kernel (between events and on the
    device, and the device time over the slowest problem's rounds) and
    plain times, and the bound:
    ``io_bytes`` (costs and inputs in, outputs out) against
    AUCTION_SCAN_OPS * M lane operations for each row or column scan this
    input needs (counted by the plain solver, which makes the kernel's
    rounds)."""
    from repro_torch.launch.roofline import bound_ms
    from repro_torch.metrics.testing import (
        AUCTION_TOTAL_TOLERANCE, auction_agreement)

    differ, err, ok = auction_agreement(got, want, cost)
    rounds = want[3]
    m = cost.shape[-1]
    bt, by = bound_ms(io_bytes,
                      {"lane": AUCTION_SCAN_OPS * m * int(scans.sum())})
    ms, dev_ms = cuda_ms(kernel), device_ms(kernel)
    return {"name": name, "shape": list(cost.shape), "max_abs_err": err,
            "outputs_differing": differ,
            "tolerance": "bitwise but the totals: " + AUCTION_TOTAL_TOLERANCE,
            "within_tolerance": differ == 0 and ok,
            "rounds_sum": int(rounds.sum()), "rounds_max": int(rounds.max()),
            "scans": int(scans.sum()), "ms": ms, "device_ms": dev_ms,
            # a launch lasts as long as its slowest problem's rounds
            "us_per_round": dev_ms * 1e3 / max(1, int(rounds.max())),
            "plain_ms": cuda_ms(plain, reps=1), "library_ms": None,
            "bound_ms": bt, "bound_by": by}


def _default_ladder(name, ladder) -> int:
    import torch
    from repro_torch.kernels import auction_lap as al

    n = ladder.numel()
    check(torch.equal(ladder, al.eps_ladder(
        al.DEFAULT_EPS0, al.DEFAULT_EPS_FACTOR, n, ladder.device)),
        f"{name}: the main path ran another eps ladder")
    return n


def _time_auction_lap(cost, ladder, max_rounds) -> dict:
    """Kernel and plain solver; no PyTorch call solves an assignment."""
    from repro_torch.kernels import auction_lap as al

    b, m, _ = cost.shape
    kw = dict(n_scales=_default_ladder("auction_lap", ladder),
              max_rounds=max_rounds)
    *want, scans = al.auction_solve_counted(cost, **kw)
    got = al.auction_lap_cuda(cost, ladder, max_rounds)
    return _auction_row(
        "auction_lap", cost, got, want, scans,
        4.0 * b * m * m + 4.0 * b * m + 9.0 * b,
        lambda: al.auction_lap_cuda(cost, ladder, max_rounds),
        lambda: al.auction_solve(cost, **kw))


def _time_auction_collapsed(cbar, keep1, keep2, price0, ladder, max_rounds,
                            rev_every) -> dict:
    """Kernel and plain solver; no PyTorch call solves an assignment."""
    from repro_torch.kernels import auction_lap as al

    b, k, _ = cbar.shape
    kw = dict(n_scales=_default_ladder("auction_lap_collapsed", ladder),
              max_rounds=max_rounds, rev_every=rev_every)
    args = (cbar, keep1, keep2, price0)
    *want, scans = al.auction_solve_collapsed_counted(*args, **kw)
    got = al.auction_lap_collapsed_cuda(*args, ladder, max_rounds, rev_every)
    row = _auction_row(
        "auction_lap_collapsed", cbar, got, want, scans,
        4.0 * b * k * k + 14.0 * b * k + 9.0 * b,
        lambda: al.auction_lap_collapsed_cuda(*args, ladder, max_rounds,
                                              rev_every),
        lambda: al.auction_solve_collapsed(*args, **kw))
    row["rev_every"] = rev_every
    return row


TIMERS = {"kcore_peel": _time_kcore, "domination": _time_domination,
          "gf2_reduce": _time_gf2, "common_neighbors": _time_common_neighbors,
          "pairwise_l1": _time_pairwise_l1,
          "sinkhorn_lse": _time_sinkhorn_lse,
          "sinkhorn_pair_sum": _time_sinkhorn_pair_sum,
          "auction_lap": _time_auction_lap,
          "auction_lap_collapsed": _time_auction_collapsed,
          "hamming_scan": _time_hamming}


def kernel_rows(recorder, phase, only=None) -> list[dict]:
    """Each kernel (of ``only``, default all) at its largest input in
    ``phase``: error against the plain version, kernel / plain / library
    times, and the bound."""
    rows = []
    for name, timer in TIMERS.items():
        if only is not None and name not in only:
            continue
        recorded = recorder.inputs.get((phase, name))
        if recorded is None:
            continue
        row = timer(*recorded[1])
        row.setdefault("within_tolerance", row["max_abs_err"] == 0)
        check(row["within_tolerance"], f"{name} ({phase}): kernel disagrees "
                                       "with its plain version")
        rows.append(row)
    return rows


def contract_rows(rows, launches) -> list[dict]:
    """The kernels line: every kernel, with its main-path launch count."""
    check(sorted(r["name"] for r in rows) == sorted(TIMERS),
          "a kernel was never recorded on the main path")
    for row in rows:
        name = row["name"]
        if name in ALSO_REPLACES:
            row["also_replaces"] = ALSO_REPLACES[name]
        row.update(route="cuda", source=SOURCE[name],
                   replaces=REPLACES[name], launches=launches[name])
        check(row["launches"] > 0, f"{name}: the main path never launched it")
    return rows


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke.py: run it from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.data.temporal import (community_churn_stream,
                                           ego_decay_stream)
    from repro_torch.launch import make_index_mesh

    dev = torch.device("cuda")
    launches = {k: 0 for k in REPLACES}
    t_start = time.perf_counter()
    try:
        emit(phase_build())
        emit(phase_kernel_checks(dev))
        n64 = n64_batch(dev)
        n1024 = n1024_batch(dev)
        recorder = Recorder()
        originals = recorder.install()
        try:
            d64, record = phase_signature("signature_n64", n64, N64_CAPS, 64,
                                          256, launches, recorder)
            emit(record)
            d320, record = phase_signature("signature_n320", n320_batch(dev),
                                           N320_CAPS, 16, 64, launches,
                                           recorder)
            emit(record)
            emit(phase_table1(n1024, launches, recorder))
            emit(phase_clustering("clustering_n64", n64, launches, recorder))
            emit(phase_clustering("clustering_n1024", n1024, launches,
                                  recorder))
            emit(phase_clustering_twitter(dev, launches, recorder))
            record, index_run = phase_index(d64, dev, launches, recorder)
            emit(record)
            index, index_lsh, dq, k = index_run
            record, sharded = phase_sharded_index(
                "sharded_index_n64", index_lsh, dq, k,
                [make_index_mesh(), make_index_mesh(devices=[dev] * 4)],
                launches, recorder, index_none=index)
            emit(record)
            emit(phase_sharded_index_n65536(dev, launches, recorder))
            emit(phase_fig2(dev, launches, recorder))
            emit(phase_sinkhorn_n64(d64, launches, recorder))
            record, sk_pairs = phase_sinkhorn_full_n320(d320, launches,
                                                        recorder)
            emit(record)
            emit(phase_sinkhorn_pairwise(d64, launches, recorder))
            emit(phase_sinkhorn_parity(dev, launches, recorder))
            emit(phase_exact_n64(d64, launches, recorder))
            record, ex_pairs = phase_exact_n320(d320, launches, recorder)
            emit(record)
            emit(phase_exact_pairwise(d64, launches, recorder))
            emit(phase_auction_parity(dev, launches, recorder))
            emit(phase_strong_collapse_table3(dev, launches, recorder))
            emit(phase_ego_fig5b(dev, launches, recorder))
            streams = {}
            for name, make, cfg in (
                    ("stream_ego_decay_n64",
                     lambda: ego_decay_stream(31, STREAM_BATCH, 64,
                                              **STREAM_EGO, device=dev),
                     STREAM_EGO_CFG),
                    ("stream_churn_n64",
                     lambda: community_churn_stream(37, STREAM_BATCH, 64,
                                                    **STREAM_CHURN,
                                                    device=dev),
                     STREAM_CHURN_CFG)):
                record, streams[name] = phase_stream(name, make, cfg,
                                                     launches, recorder)
                emit(record)
            sizes = {n for stream, _ in streams.values()
                     for n in stream.recompute_sizes}
            check(len(sizes) >= 3, f"the stream phases recomputed at only "
                                   f"{sorted(sizes)} graphs a batch")
            record, (reqs, serve_cfg, bare_s) = phase_serve_topo(
                dev, launches, recorder)
            emit(record)
            emit(phase_serve_watched(dev, launches, recorder, reqs,
                                     serve_cfg, bare_s))
            emit(phase_serve_similarity_n64(dev, launches, recorder))
            emit(phase_serve_stream(dev, launches, recorder))
        finally:
            Recorder.uninstall(originals)
        emit(phase_trace_report(n64, d64, index_run, dev))
        emit(phase_profile(n64, N64_CAPS))
        emit(phase_profile_clustering(n64))
        emit(phase_profile_index(*index_run, sharded))
        emit(phase_profile_sinkhorn(*sk_pairs))
        emit(phase_profile_exact(*ex_pairs))
        emit(phase_profile_stream(streams))
        rows = contract_rows(
            [r for ph in ("signature_n64", "clustering_n64", "index_n64",
                          "sinkhorn_full_n320", "exact_n320")
             for r in kernel_rows(recorder, ph)], launches)
        at = {ph: kernel_rows(recorder, ph)
              for ph in ("signature_n320", "table1_n1024", "clustering_n1024",
                         "clustering_twitter", "fig2", "sinkhorn_n64",
                         "sinkhorn_parity", "exact_n64",
                         "strong_collapse_table3", "ego_fig5b",
                         "stream_ego_decay_n64", "stream_churn_n64",
                         "serve_topo", "serve_watched",
                         "serve_similarity_n64", "serve_stream")}
        # the 65,536-row Gram is index_n64's 256-fold: its plain version
        # and cdist would take minutes, so only the scan is timed there
        at["sharded_index_n65536"] = kernel_rows(
            recorder, "sharded_index_n65536", only=("hamming_scan",))
        emit({"phase": "kernel_times", "at": at})
        emit(phase_hamming_large(dev))
        card = card_line()
    except SmokeFailure as e:
        print(f"chip_smoke.py: FAILED: {e}", file=sys.stderr)
        return 1
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(card, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
