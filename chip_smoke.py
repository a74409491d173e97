#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py

Builds the three hand-written kernels from ``src/repro_torch/csrc`` (one
nvcc per source, in parallel), holds each kernel against its plain PyTorch
version on the card, then drives reduce -> repack -> persist through
``make_topo_plan`` at three sizes: the n64 serve rung (4096 graphs), the DD
rung of Table 2 (256 graphs of 320 vertices) and Table 1's protocol (16
graphs of 1024 vertices).  CUDA diagrams and masks are compared bitwise
with the same functions run on the CPU.  Then each kernel is timed at the
largest input each phase gave it, and one n64 execution is profiled for
device time by kernel.  Each phase prints one JSON line; any failure exits
non-zero.  The last two lines are the ``kernels`` summary
(launches on the main path, error against the plain version, times and
bounds) after the card's name and power limit, and the ``ok`` line.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, and the CUDA-core
# (non-tensor) f32 rate, used as the rate of the integer word ops
HBM_BYTES_PER_S = 3.35e12
CUDA_CORE_OPS_PER_S = 67e12

REPLACES = {
    "kcore_peel": "src/repro/kernels/kcore_peel.py:42",
    "domination": "src/repro/kernels/domination.py:49",
    "gf2_reduce": "src/repro/kernels/gf2_reduce.py:136",
}
# the batched Pallas form, gf2_reduce_batch_pallas, is the same CUDA kernel
ALSO_REPLACES = {"gf2_reduce": "src/repro/kernels/gf2_reduce.py:167"}
SOURCE = {k: f"src/repro_torch/csrc/{k}.cu" for k in REPLACES}
N64_CAPS = dict(edge_cap=320, tri_cap=512)
N320_CAPS = dict(edge_cap=1024, tri_cap=256)


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


def bound(bytes_moved: float, ops: float) -> tuple[float, str]:
    """Least time in ms the card could take, and what bounds it."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / CUDA_CORE_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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

def phase_build() -> dict:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    per_source = _build.build()
    return {"phase": "build", "seconds": time.perf_counter() - t0,
            "per_source_seconds": per_source}


def _random_graphs(b, n, p, seed, device):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    adj = np.triu(rng.random((b, n, n), dtype=np.float32) < p, 1)
    adj = adj | adj.transpose(0, 2, 1)
    mask = rng.random((b, n)) < 0.9
    mask[0] = False  # an empty graph
    adj &= mask[:, None, :] & mask[:, :, None]
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


def phase_kernel_checks(dev) -> dict:
    """Every kernel against its plain version at edge-case shapes: ragged
    N, empty graphs, rows past shared memory, bit-31 lows, and a gf2 block
    far larger than a CTA's shared memory."""
    import torch
    from repro_torch.core.filtration import build_filtered_complex
    from repro_torch.core.persistence import _block_caps, pack_boundary_blocks
    from repro_torch.kernels import ref
    from repro_torch.kernels.domination import domination_cuda
    from repro_torch.kernels.gf2_reduce import gf2_reduce_cuda
    from repro_torch.kernels.kcore_peel import kcore_peel_cuda

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
        if n <= 1000:
            record("domination", [b, n], max_abs_err(
                [domination_cuda(adj, mask)], [ref.domination_ref(adj, mask)]))
    empty = torch.zeros((0, 8, 8), dtype=torch.bool, device=dev)
    check(kcore_peel_cuda(empty, empty[:, 0], 1, 0).shape == (0, 8),
          "kcore_peel on an empty batch")

    blocks = _bit31_blocks(4, 96, 128, seed=5, device=dev)
    want = ref.gf2_reduce_ref(blocks, 128)
    check(bool((want[1][:, 31::32] >= 0).any()), "no bit-31 pivot in the test")
    record("gf2_reduce", [4, 96, 4, "bit31"],
           max_abs_err(gf2_reduce_cuda([blocks], [128])[0], want))

    # caps that make the triangle block (8, 4096, 128) words: 2 MiB per
    # graph, reduced in global memory (the edge block, 128 KiB, is staged
    # in shared memory above the 48 KiB default)
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
    return {"phase": "kernels_check", "cases": len(cases),
            "mismatches": 0, "detail": cases}


class Recorder:
    """Keeps a copy of the largest input each kernel saw on the main path,
    so the timings run at shapes the main path really gives the kernel."""

    def __init__(self):
        self.inputs = {}
        self.phase = None  # recording while set

    def install(self):
        from repro_torch.kernels import ops

        originals = {"kcore_peel": ops.kcore_peel_cuda,
                     "domination": ops.domination_cuda,
                     "gf2_reduce": ops.gf2_reduce_cuda}

        def wrap(name, fn, size_of):
            def recorded(*args):
                if self.phase is not None:
                    size = size_of(*args)
                    best = self.inputs.get((self.phase, name))
                    if best is None or size > best[0]:
                        self.inputs[(self.phase, name)] = (size, _clone(args))
                return fn(*args)
            return recorded

        ops.kcore_peel_cuda = wrap("kcore_peel", originals["kcore_peel"],
                                   lambda adj, *a: adj.numel())
        ops.domination_cuda = wrap("domination", originals["domination"],
                                   lambda adj, *a: adj.numel())
        ops.gf2_reduce_cuda = wrap("gf2_reduce", originals["gf2_reduce"],
                                   lambda blocks, *a: sum(b.numel()
                                                          for b in blocks))
        return originals

    @staticmethod
    def uninstall(originals):
        from repro_torch.kernels import ops

        ops.kcore_peel_cuda = originals["kcore_peel"]
        ops.domination_cuda = originals["domination"]
        ops.gf2_reduce_cuda = originals["gf2_reduce"]


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
    against the single-phase plan; time reduce and persist."""
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
    return {"phase": name, "graphs": g.batch, "n_pad": g.n, **caps,
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


def phase_profile(g, caps) -> dict:
    """Device time by kernel over one steady n64 execution (torch.profiler,
    CUDA activity), the device's idle share of the wall time, and the time
    of the three ported kernels.  Runs after the timed executions: the
    profiler's own cost is in its wall time, not in theirs."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.api import make_topo_plan

    plan = make_topo_plan(dim=1, method="both", repack="on", **caps)
    plan.execute_info(g)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        plan.execute_info(g)
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
    ported = ("kcore_peel_kernel", "pack_closed_nbhd_kernel",
              "domination_tile_kernel", "gf2_reduce_kernel")
    ported_ms = sum(r[0] for r in rows if any(p in r[1] for p in ported))
    check(busy_ms > 0, "profile: no device time recorded")
    return {"phase": "profile_n64", "wall_ms": wall_ms,
            "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "ported_kernels_ms": ported_ms,
            "top": [{"name": k[:80], "ms": ms, "count": c}
                    for ms, k, c in rows[:15]]}


def _time_kcore(adj, alive, k, sweeps) -> dict:
    """The fixpoint launch: kernel, plain loop (one sync per sweep), and
    torch.bmm sweeps, as many as this input needs."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.kcore_peel import kcore_peel_cuda

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

    bt, by = bound(adj.numel() + 2 * alive.numel(),
                   3.0 * n_sweeps * b * n * ((n + 31) // 32))
    return {"name": "kcore_peel", "shape": [b, n, n], "k": k,
            "sweeps_needed": n_sweeps,
            "max_abs_err": max_abs_err([kcore_peel_cuda(adj, alive, k, sweeps)],
                                       [want]),
            "ms": cuda_ms(lambda: kcore_peel_cuda(adj, alive, k, sweeps)),
            "plain_ms": cuda_ms(plain_fixpoint, reps=3),
            "library_ms": cuda_ms(library), "bound_ms": bt, "bound_by": by}


def _time_domination(adj, mask) -> dict:
    """Kernel, plain version, and one f32 torch.bmm of the 0/1 matrices
    with the same epilogue."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.domination import domination_cuda

    b, n = mask.shape
    eye = torch.eye(n, dtype=torch.bool, device=adj.device)

    def library():
        live = mask[:, None, :] & mask[:, :, None]
        nc = (adj | eye) & live
        viol = torch.bmm(nc.float(), ((~nc) & mask[:, None, :]).float()
                         .transpose(1, 2))
        return (viol == 0) & ~eye & live

    bt, by = bound(2 * adj.numel() + mask.numel(),
                   3.0 * b * n * n * ((n + 31) // 32))
    return {"name": "domination", "shape": [b, n, n],
            "max_abs_err": max_abs_err([domination_cuda(adj, mask)],
                                       [ref.domination_ref(adj, mask)]),
            "ms": cuda_ms(lambda: domination_cuda(adj, mask)),
            "plain_ms": cuda_ms(lambda: ref.domination_ref(adj, mask)),
            "library_ms": cuda_ms(library), "bound_ms": bt, "bound_by": by}


def _time_gf2(blocks, n_rows) -> dict:
    """Kernel and plain version; the bound counts the column additions
    this input's pivot chases need."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.gf2_reduce import gf2_reduce_cuda

    got = gf2_reduce_cuda(blocks, n_rows)
    err, moved, ops = 0, 0, 0.0
    for blk, r, out in zip(blocks, n_rows, got):
        red, owner, positive, adds = ref.gf2_reduce_counted(blk, r)
        err = max(err, max_abs_err(out, (red, owner, positive)))
        g_, s_, w_ = blk.shape
        moved += 2 * blk.numel() * 4 + g_ * r * 4 + g_ * s_
        ops += 2.0 * w_ * (g_ * s_ + int(adds.sum()))  # scan + XOR words
    bt, by = bound(moved, ops)
    return {"name": "gf2_reduce",
            "shape": [list(b.shape) for b in blocks], "n_rows": n_rows,
            "max_abs_err": err,
            "ms": cuda_ms(lambda: gf2_reduce_cuda(blocks, n_rows)),
            "plain_ms": cuda_ms(lambda: [ref.gf2_reduce_ref(b, r) for b, r
                                         in zip(blocks, n_rows)], reps=1),
            "library_ms": None, "bound_ms": bt, "bound_by": by}


TIMERS = {"kcore_peel": _time_kcore, "domination": _time_domination,
          "gf2_reduce": _time_gf2}


def kernel_rows(recorder, phase) -> list[dict]:
    """Each kernel at its largest input in ``phase``: error against the
    plain version, kernel / plain / library times, and the bound."""
    rows = []
    for name, timer in TIMERS.items():
        recorded = recorder.inputs.get((phase, name))
        if recorded is None:
            continue
        row = timer(*recorded[1])
        check(row["max_abs_err"] == 0, f"{name} ({phase}): kernel disagrees "
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
    dev = torch.device("cuda")
    launches = {"kcore_peel": 0, "domination": 0, "gf2_reduce": 0}
    t_start = time.perf_counter()
    try:
        emit(phase_build())
        emit(phase_kernel_checks(dev))
        n64 = n64_batch(dev)
        recorder = Recorder()
        originals = recorder.install()
        try:
            emit(phase_signature("signature_n64", n64, N64_CAPS, 64, 256,
                                 launches, recorder))
            emit(phase_signature("signature_n320", n320_batch(dev),
                                 N320_CAPS, 16, 64, launches, recorder))
            emit(phase_table1(n1024_batch(dev), launches, recorder))
        finally:
            Recorder.uninstall(originals)
        rows = contract_rows(kernel_rows(recorder, "signature_n64"), launches)
        emit({"phase": "kernel_times", "at": {
            ph: kernel_rows(recorder, ph)
            for ph in ("signature_n320", "table1_n1024")}})
        emit(phase_profile(n64, N64_CAPS))
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
