"""Dry run: count every (arch x shape) cell on the production meshes, prove
memory fit, and derive roofline terms (counterpart of
``repro.launch.dryrun``).

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k [--multipod]
  python -m repro_torch.launch.dryrun --all [--multipod] [--xcost] [--device cpu]
  python -m repro_torch.launch.dryrun --arch tda_ego --shape ego_pd_reduce --graphs 4096

The LM cells need no card.  ``repro`` lowers and compiles each step for a
mesh of 256 (or 512) XLA host devices and reads ``memory_analysis()`` and
``cost_analysis()``; eager PyTorch compiles nothing, so here the mesh is
laid over meta devices (``make_production_mesh(devices=["meta"] * n)``),
the model, AdamW state, caches and batch are built on meta at the cell's
global shapes, and the step runs once under
:func:`repro_torch.launch.roofline.count_step`:

* ``memory``: the per-device argument and output bytes of the specs of
  :mod:`repro_torch.launch.sharding` (exact); ``temp_bytes`` and
  ``peak_bytes`` are ``None`` (meta tensors have no allocator); ``fits``
  compares the argument bytes with the card's memory.
* ``roofline``: the global step's counts divided by the mesh size
  (``"per_device": "global/chips"``): the port has no SPMD partitioner, so
  this is the ideal share of the unpartitioned program, not a partitioned
  program's own count.

Every layer dispatches its own ops, so a full-depth count is already what
``repro``'s ``--unroll`` lowering gets (``unrolled_costs`` is always true
and ``--unroll`` changes nothing); ``--xcost`` counts two shallow probes
and extrapolates in depth, which only saves counting time.

The ``tda_ego`` cells run for real, on ``make_serve_mesh()`` over the
machine's devices (``--device cpu`` for the CPU): their fixpoint loops
branch on the data, which meta tensors do not hold.  Each reports its time,
peak memory, kernel launches and a bound: the launches' bounds at the
inputs they took plus the roofline of the PyTorch ops around them.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

import torch

from repro_torch import counters
from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.launch import roofline as rl
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import make_production_mesh, make_serve_mesh
from repro_torch.models import transformer as tf
from repro_torch.models.config import SHAPES
from repro_torch.perfgate import cost_cells
from repro_torch.serve.serve_step import make_decode_step, make_prefill_step
from repro_torch.train.optimizer import adamw_init
from repro_torch.train.train_step import TrainState, make_train_step

TDA_SHAPES = ("ego_pd", "ego_pd_reduce", "ego_pd_persist")
# the ego nets of the tda_ego cells: one a vertex of a BA(4096, 3) host
# (more vertices when more graphs are asked for), degree filtration
TDA_EGO_HOST, TDA_EGO_SEED = 4096, 5
# steady timing of a TDA cell: the mean of this many runs after a warm-up
TDA_TIMED_RUNS = 3


def production_mesh(multi_pod: bool = False):
    """The production mesh, (16, 16) or (2, 16, 16), over meta devices."""
    n = 512 if multi_pod else 256
    return make_production_mesh(multi_pod=multi_pod, devices=["meta"] * n)


def _micro(sc):
    """One grad-accum microbatch of a train shape (others unchanged)."""
    if sc.kind == "train" and sc.grad_accum > 1:
        return dataclasses.replace(
            sc, global_batch=sc.global_batch // sc.grad_accum, grad_accum=1)
    return sc


def input_specs(arch: str, shape: str, mesh, micro: bool = False, cfg=None):
    """Meta stand-ins (no allocation) for every input of this cell, at
    its global shapes, with their specs and the step callable.

    Returns ``((step, args, specs), None)``, ``specs`` shaped as ``args``
    with a spec tuple at each tensor (the port's tensors carry no
    sharding), or ``(None, reason)`` for a skipped cell.  Decode's ``pos``
    is a Python int (the last cache slot).

    micro=True builds ONE microbatch (grad_accum=1, batch/ga); cfg
    overrides the registry config (depth probes for --xcost).
    """
    cfg = cfg if cfg is not None else get_config(arch)
    sc = SHAPES[shape]
    if micro:
        sc = _micro(sc)
    if shape == "long_500k" and not cfg.supports_long_context:
        return None, f"{arch} is full-attention; long_500k requires sub-quadratic"

    meta = torch.device("meta")
    params = tf.Model(cfg, None, meta)
    pspecs = sh.param_specs(params)
    bspec = sh.batch_spec(sc.global_batch, mesh)

    def tok(b, s):
        return torch.zeros((b, s), dtype=torch.int32, device=meta)

    extras = {}
    if cfg.family == "encdec":
        extras["frames"] = torch.zeros(
            (sc.global_batch, cfg.enc_seq, cfg.d_model),
            dtype=torch.bfloat16, device=meta)
    if cfg.family == "vlm":
        extras["vision"] = torch.zeros(
            (sc.global_batch, cfg.vision_tokens, cfg.d_model),
            dtype=torch.bfloat16, device=meta)
        s_pos = 1 if sc.kind == "decode" else sc.seq_len
        extras["mrope_positions"] = torch.zeros(
            (sc.global_batch, s_pos, 3), dtype=torch.int32, device=meta)
    especs = {k: bspec for k in extras}

    if sc.kind == "train":
        state = TrainState(params=params, opt=adamw_init(params))
        sspecs = TrainState(params=pspecs, opt=sh.opt_specs(pspecs))
        batch = {"tokens": tok(sc.global_batch, sc.seq_len), **extras}
        step = make_train_step(cfg, grad_accum=sc.grad_accum,
                               extra_keys=tuple(extras))
        return (step, (state, batch),
                (sspecs, {"tokens": bspec, **especs})), None

    caches = tf.init_caches(cfg, sc.global_batch, sc.seq_len, device=meta)
    cspecs = sh.cache_specs(caches, cfg, mesh, sc.global_batch)
    if sc.kind == "prefill":
        step = make_prefill_step(cfg, extra_keys=tuple(extras))
        return (step, (params, tok(sc.global_batch, sc.seq_len), caches,
                       extras), (pspecs, bspec, cspecs, especs)), None
    step = make_decode_step(cfg, extra_keys=tuple(extras))
    return (step, (params, tok(sc.global_batch, 1), caches, sc.seq_len - 1,
                   extras), (pspecs, bspec, cspecs, None, especs)), None


def _out_specs(out, specs):
    """Specs of a step's outputs: the train state keeps its specs (metrics
    replicated); a serving step's tokens or logits take the batch spec,
    its caches theirs."""
    if isinstance(out[0], TrainState):
        return specs[0], {k: () for k in out[1]}
    return specs[1], specs[2]


def _memory(args, specs, out, mesh) -> dict:
    arg_bytes = sh.shard_bytes(args, specs, mesh)
    return {"argument_bytes": arg_bytes,
            "output_bytes": sh.shard_bytes(out, _out_specs(out, specs),
                                           mesh),
            "temp_bytes": None, "peak_bytes": None,
            "fits": arg_bytes <= rl.HBM_CAPACITY_BYTES}


def _per_device(colls: dict, chips: int) -> dict:
    return {k: {f: v[f] / chips for f in ("count", "bytes", "traffic")}
            for k, v in colls.items()}


def _terms(flops, bts, adj, colls, mf, chips) -> dict:
    """The step form's terms per device from global counts."""
    terms = rl.step_roofline_terms(flops / chips, bts / chips,
                                   _per_device(colls, chips), mf, chips)
    terms["memory_adjusted_s"] = adj / chips / rl.HBM_BYTES_PER_S
    terms["hlo_bytes_adjusted_per_device"] = adj / chips
    terms["per_device"] = "global/chips"
    return terms


# ------------------------------------------------------------- TDA cells ---

def tda_graphs(n_graphs: int, device):
    """The first ``n_graphs`` 1-hop ego nets (tda_ego's n_pad, degree
    filtration) of a BA(max(n_graphs, 4096), 3) host drawn from seed 5,
    built on ``device``."""
    from repro_torch.configs.tda_ego import config as tda_config
    from repro_torch.data.ego import ego_batch
    from repro_torch.data.graphs import barabasi_albert

    n_host = max(int(n_graphs), TDA_EGO_HOST)
    host = barabasi_albert(TDA_EGO_SEED, 1, n_host, n_host, 3, device=device)
    f = host.degrees()[0].to(torch.float32)
    centers = torch.arange(int(n_graphs), device=host.adj.device)
    return ego_batch(host.adj[0], f, tda_config().n_pad, centers=centers,
                     device=device)


def tda_batch_size(mesh, graphs=None) -> int:
    """``graphs``, or tda_ego's ``graphs_per_device`` a device of
    ``mesh``."""
    from repro_torch.configs.tda_ego import config as tda_config

    return (tda_config().graphs_per_device * mesh.size if graphs is None
            else int(graphs))


def tda_input_specs(mesh, graphs=None):
    """The paper's own workload: batched ego-net PDs sharded over the mesh
    (``graphs_per_device`` a device unless ``graphs`` is given).

    Returns ``(step, (g,))``."""
    from repro_torch.configs.tda_ego import config as tda_config
    from repro_torch.core.api import topological_signature_sharded

    tcfg = tda_config()
    g = tda_graphs(tda_batch_size(mesh, graphs), mesh.flat[0])

    def tda_step(g):
        return topological_signature_sharded(
            g, mesh, dim=tcfg.max_dim, method="both", sublevel=tcfg.sublevel,
            edge_cap=tcfg.edge_cap, tri_cap=tcfg.tri_cap)

    return tda_step, (g,)


def middle_rung():
    """The persist cell's shape class: the middle rung of tda_ego's
    default repack ladder."""
    from repro_torch.configs.tda_ego import config as tda_config
    from repro_torch.core.repack import default_ladder

    tcfg = tda_config()
    ladder = default_ladder(tcfg.n_pad, tcfg.edge_cap, tcfg.tri_cap)
    return ladder[len(ladder) // 2]


def reduce_phase(g, mesh):
    """Per shard: the fixpoint of ("prunit", "kcore"), vertex compaction
    and the simplex counts; returns (adj, mask, f, nv, ne, nt), the
    shards concatenated on ``g``'s device."""
    from repro_torch.configs.tda_ego import config as tda_config
    from repro_torch.core.api import map_shards
    from repro_torch.core.reduction import reduce_fixpoint
    from repro_torch.core.repack import compact_batch, measure_counts

    tcfg = tda_config()

    def per_device(shard):
        gr = reduce_fixpoint(shard, ("prunit", "kcore"), tcfg.max_dim,
                             tcfg.sublevel)
        gc, _ = compact_batch(gr)
        nv, ne, nt = measure_counts(gc)
        return gc.adj, gc.mask, gc.f, nv, ne, nt

    parts = map_shards(g, mesh, per_device)
    return tuple(torch.cat([part[i].to(g.device) for part in parts])
                 for i in range(len(parts[0])))


def persist_input(reduced, mesh):
    """The reduce phase's compacted graphs that fit the middle rung,
    sliced to its order and padded with empty graphs to a multiple of the
    mesh size; returns (that batch, the fitting graphs' indices)."""
    from repro_torch.core.graph import INF, GraphBatch
    from repro_torch.core.repack import slice_to

    adj, mask, f, nv, ne, nt = reduced
    mid = middle_rung()
    fit = (nv <= mid.n_pad) & (ne <= mid.edge_cap) & (nt <= mid.tri_cap)
    idx = torch.nonzero(fit)[:, 0]
    g = slice_to(GraphBatch(adj=adj[idx], mask=mask[idx], f=f[idx]),
                 mid.n_pad)
    pad = -idx.numel() % mesh.size
    if pad:
        n, dev = mid.n_pad, adj.device
        g = GraphBatch(
            adj=torch.cat([g.adj, torch.zeros((pad, n, n), dtype=torch.bool,
                                              device=dev)]),
            mask=torch.cat([g.mask, torch.zeros((pad, n), dtype=torch.bool,
                                                device=dev)]),
            f=torch.cat([g.f, torch.full((pad, n), INF, device=dev)]))
    return g, idx


def tda_two_phase_specs(mesh, phase: str, graphs=None):
    """The two-phase plan (``repack="on"``) as two cells, so the roofline
    separates them:

    * ``phase="reduce"`` — fixpoint pass iteration + vertex compaction +
      simplex counts at the input caps, per shard (:func:`reduce_phase`);
    * ``phase="persist"`` — the ``method="none"`` pipeline at the default
      repack ladder's middle rung, over the reduce phase's compacted
      graphs that fit it (:func:`persist_input`, which runs the reduce
      phase first, untimed).

    Returns ``(step, args, info)``: ``info`` holds the ego nets drawn
    (``graphs_in``) and, for persist, the rung, how many fit it and the
    empty graphs padded on."""
    from repro_torch.configs.tda_ego import config as tda_config
    from repro_torch.core.api import topological_signature_sharded

    tcfg = tda_config()
    g = tda_graphs(tda_batch_size(mesh, graphs), mesh.flat[0])
    info = {"graphs_in": g.batch}
    if phase == "reduce":
        return (lambda g: reduce_phase(g, mesh)), (g,), info
    if phase == "persist":
        mid = middle_rung()
        gm, idx = persist_input(reduce_phase(g, mesh), mesh)
        info.update(rung=dataclasses.asdict(mid), fit=int(idx.numel()),
                    padded=gm.batch - int(idx.numel()))

        def persist_step(g):
            return topological_signature_sharded(
                g, mesh, dim=tcfg.max_dim, method="none",
                sublevel=tcfg.sublevel, edge_cap=mid.edge_cap,
                tri_cap=mid.tri_cap)

        return persist_step, (gm,), info
    raise ValueError(f"phase must be 'reduce' or 'persist', got {phase!r}")


def _kcore_cost(adj, alive, k, sweeps):
    """``kcore_peel``'s launch cost at the sweeps this input needs (the
    plain version's fixpoint, capped at ``sweeps`` when it is not 0)."""
    from repro_torch.kernels import ref

    b, n = alive.shape
    cur, needed = alive, 0
    while sweeps == 0 or needed < sweeps:
        nxt = ref.kcore_peel_ref(adj, cur, k)
        needed += 1
        if torch.equal(nxt, cur):
            break
        cur = nxt
    return cost_cells.kcore_cost(b, n, needed)


def _domination_cost(adj, mask):
    return cost_cells.domination_cost(*mask.shape)


def _gf2_cost(blocks, n_rows):
    """``gf2_reduce``'s launch cost at the chase's steps this input needs:
    each matrix's last nonzero column plus its additions (counted by the
    plain version)."""
    from repro_torch.kernels import ref

    counted = []
    for blk, r in zip(blocks, n_rows):
        g, s, w = blk.shape
        adds = ref.gf2_reduce_counted(blk, r)[3]
        nz = (blk != 0).any(-1)
        se = torch.where(nz.any(-1), s - nz.flip(-1).int().argmax(-1), 0)
        counted.append((g, s, w, r, int(se.sum()) + int(adds.sum())))
    return cost_cells.gf2_cost(counted)


# kernel -> (ops.py attribute, cost of one launch from its arguments)
_LAUNCH_COSTS = {"kcore_peel": ("kcore_peel_cuda", _kcore_cost),
                 "domination": ("domination_cuda", _domination_cost),
                 "gf2_reduce": ("gf2_reduce_cuda", _gf2_cost)}


@contextlib.contextmanager
def launch_costs():
    """Record ``(kernel, bound_ms)`` for every launch of the three TDA
    kernels while open, from the inputs each launch took: the counts of
    ``chip_smoke.py``'s kernel rows (``perfgate.cost_cells``), the
    data-dependent ones counted by the plain versions before the launch."""
    from repro_torch.kernels import ops

    costs: list[tuple[str, float]] = []
    originals = {}
    for name, (attr, cost) in _LAUNCH_COSTS.items():
        fn = originals[attr] = getattr(ops, attr)

        def counted(*args, _name=name, _fn=fn, _cost=cost):
            costs.append((_name, rl.bound_ms(*_cost(*args))[0]))
            return _fn(*args)

        setattr(ops, attr, counted)
    try:
        yield costs
    finally:
        for attr, fn in originals.items():
            setattr(ops, attr, fn)


def _timed(fn, dev, runs: int) -> float:
    """Mean seconds of ``runs`` calls: CUDA events on a card, the host
    clock elsewhere."""
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(runs):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / runs
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
    return (time.perf_counter() - t0) / runs


def tda_mesh(multi_pod: bool = False, device=None):
    """``make_serve_mesh()`` over the machine's CUDA devices, or over
    ``device`` alone when one is given (``"cpu"`` for the CPU)."""
    return make_serve_mesh(multi_pod=multi_pod,
                           devices=None if device is None else [device])


def run_tda_cell(shape: str, multi_pod: bool = False, device=None,
                 graphs=None) -> dict:
    """One tda_ego cell run for real on :func:`tda_mesh`: a warm-up that
    counts the launches and their bounds, one run under ``count_step``
    for the PyTorch ops around the kernels, then the steady mean of
    ``TDA_TIMED_RUNS`` runs and the peak memory over them."""
    try:
        mesh = tda_mesh(multi_pod, device)
    except ValueError as e:  # a multi-pod serve mesh wants an even count
        return {"arch": "tda_ego", "shape": shape, "multi_pod": multi_pod,
                "skipped": str(e)}
    t0 = time.time()
    if shape == "ego_pd":
        step, args = tda_input_specs(mesh, graphs=graphs)
        info = {"graphs_in": args[0].batch}
    else:
        step, args, info = tda_two_phase_specs(
            mesh, phase=shape.removeprefix("ego_pd_"), graphs=graphs)
    dev = args[0].adj.device
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    set_up_s = time.time() - t0

    counters.reset()
    with launch_costs() as costs:
        step(*args)
        sync()
    launches = {k: v for k, v in counters.KERNEL_LAUNCHES.items() if v}
    rounds = dict(counters.LOOP_ROUNDS)
    c = rl.count_step(step, *args)
    sync()
    if cuda:
        held = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    seconds = _timed(lambda: step(*args), dev, TDA_TIMED_RUNS)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else None

    kernel_ms = {}
    for name, ms in costs:
        kernel_ms[name] = kernel_ms.get(name, 0.0) + ms
    ops = _ops_roofline(c)
    bound = sum(kernel_ms.values()) + ops["bound_s"] * 1e3
    return {
        "arch": "tda_ego", "shape": shape, "multi_pod": multi_pod,
        "chips": mesh.size, "mesh": mesh.shape,
        "device": str(dev), **info, "graphs": int(args[0].batch),
        "unrolled_costs": True, "microbatch_costs": False,
        "grad_accum_lowered": None, "global_batch_lowered": None,
        "compile_s": round(set_up_s, 1),
        "ms": seconds * 1e3, "timed_runs": TDA_TIMED_RUNS,
        "memory": {"argument_bytes": sum(
                       t.numel() * t.element_size()
                       for t in (args[0].adj, args[0].mask, args[0].f)),
                   "output_bytes": None, "temp_bytes": None,
                   "peak_bytes": peak,
                   "peak_bytes_of_cell": None if peak is None
                   else peak - held},
        "launches": launches, "loop_rounds": rounds,
        "bound_ms": bound,
        "bound_parts_ms": {"kernels": kernel_ms,
                           "torch_ops": ops["bound_s"] * 1e3},
        "aten_ops": c["aten_ops"],
        "roofline": ops,
    }


def _ops_roofline(c: dict) -> dict:
    """The roofline of a TDA cell's PyTorch ops (``count_step``'s counts,
    the whole cell): f32 matmul FLOPs over the CUDA cores' peak, the
    fusion-adjusted bytes over HBM, transfers over the host link."""
    compute_s = c["flops"] / rl.F32_FLOPS_PER_S
    memory_s = c["fusion_adjusted_bytes"] / rl.HBM_BYTES_PER_S
    traffic = sum(v["traffic"] for v in c["collectives"].values())
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": (traffic / rl.HOST_LINK_BYTES_PER_S
                              if traffic else None)}
    dom = max(((k.removesuffix("_s"), v) for k, v in terms.items()
               if v is not None), key=lambda kv: kv[1])
    return {**terms, "dominant": dom[0], "bound_s": dom[1],
            "hlo_flops_per_device": c["flops"],
            "hlo_bytes_per_device": c["bytes_accessed"],
            "hlo_bytes_adjusted_per_device": c["fusion_adjusted_bytes"],
            "collectives": c["collectives"],
            "per_device": "whole cell: the PyTorch ops around the kernels, "
                          "whose bounds are in bound_parts_ms"}


# ------------------------------------------------------------- LM cells ----

def _depth_period(cfg) -> int:
    """Layer-count granularity at which the block pattern repeats exactly."""
    if cfg.family == "hybrid":
        return cfg.attn_period
    if cfg.local_global_pattern != (0, 0):
        return sum(cfg.local_global_pattern)
    return 1


def _probe_config(cfg, n_layers: int):
    reps = {"n_layers": n_layers}
    if cfg.family == "encdec":
        # encoder depth scales with decoder depth (whisper: 6 == 6)
        reps["n_enc_layers"] = max(1, round(cfg.n_enc_layers * n_layers
                                            / cfg.n_layers))
    return dataclasses.replace(cfg, **reps)


def _count_cost(arch, shape, mesh, cfg):
    """(flops, bytes, collectives, fusion-adjusted bytes) of one micro
    step at ``cfg``'s depth, global."""
    spec, skip = input_specs(arch, shape, mesh, micro=True, cfg=cfg)
    if skip:
        return None
    step, args, _ = spec
    c = rl.count_step(step, *args)
    return (c["flops"], c["bytes_accessed"], c["collectives"],
            c["fusion_adjusted_bytes"])


def _extrapolate(c1, c2, l1, l2, L):
    """Linear depth extrapolation of (flops, bytes, collectives)."""
    slope = (L - l1) / (l2 - l1)

    def lin(a, b):
        return a + slope * (b - a)

    flops = lin(c1[0], c2[0])
    bts = lin(c1[1], c2[1])
    kinds = set(c1[2]) | set(c2[2])
    zero = {"count": 0, "bytes": 0.0, "traffic": 0.0}
    colls = {
        k: {f: lin(c1[2].get(k, zero)[f], c2[2].get(k, zero)[f])
            for f in ("count", "bytes", "traffic")}
        for k in kinds
    }
    return flops, bts, colls


def run_cell_xcost(arch: str, shape: str, multi_pod: bool, device=None,
                   graphs=None) -> dict:
    """Roofline terms by depth-probe extrapolation.

    Cost is linear in depth for a homogeneous (periodic) stack: count
    probes at 1 and 2 pattern periods and extrapolate to the real depth.
    A full-depth count gives the same terms (the port counts every layer's
    ops); the probes only save counting time.  Train cells count one
    grad-accum microbatch (a full step is grad_accum x this plus one
    clip and optimizer epilogue, present once in the probe).  The memory
    is the full-depth model's, from its specs.
    """
    if arch == "tda_ego":
        return run_cell(arch, shape, multi_pod, device=device, graphs=graphs)

    mesh = production_mesh(multi_pod)
    chips = mesh.size
    cfg = get_config(arch)
    sc = _micro(SHAPES[shape])
    per = _depth_period(cfg)
    l1, l2 = per, 2 * per

    t0 = time.time()
    c1 = _count_cost(arch, shape, mesh, _probe_config(cfg, l1))
    if c1 is None:
        return {"arch": arch, "shape": shape, "multi_pod": multi_pod,
                "skipped": f"{arch}/{shape} skipped (see baseline cell)"}
    c2 = _count_cost(arch, shape, mesh, _probe_config(cfg, l2))
    t_count = time.time() - t0

    flops, bts, colls = _extrapolate(c1[:3], c2[:3], l1, l2, cfg.n_layers)
    slope = (cfg.n_layers - l1) / (l2 - l1)
    adj = c1[3] + slope * (c2[3] - c1[3])
    mf = rl.model_flops_for(cfg, sc)
    (_, args, specs), _ = input_specs(arch, shape, mesh, micro=True)
    out = _meta_outputs(args, sc)
    return {
        "arch": arch, "shape": shape, "multi_pod": multi_pod, "chips": chips,
        "method": "xcost-depth-extrapolation",
        "probe_layers": [l1, l2], "true_layers": cfg.n_layers,
        "unrolled_costs": True,
        "grad_accum_lowered": sc.grad_accum,
        "global_batch_lowered": sc.global_batch,
        "compile_s": round(t_count, 1),
        "probe1": {"flops": c1[0], "bytes": c1[1]},
        "probe2": {"flops": c2[0], "bytes": c2[1]},
        "memory": _memory(args, specs, out, mesh),
        "roofline": _terms(flops, bts, adj, colls, mf, chips),
    }


def _meta_outputs(args, sc):
    """A step's outputs without running it: the train step returns its
    state and three scalar metrics; a serving step its next tokens
    (decode) or last logits (prefill) and its caches."""
    if sc.kind == "train":
        return args[0], {k: torch.zeros((), device="meta")
                         for k in ("loss", "grad_norm", "lr")}
    params, tokens, caches = args[:3]
    b = tokens.shape[0]
    if sc.kind == "decode":
        return torch.zeros((b,), dtype=torch.int64, device="meta"), caches
    vocab = params.embed.shape[0]
    return (torch.zeros((b, vocab), dtype=torch.bfloat16, device="meta"),
            caches)


def run_cell(arch: str, shape: str, multi_pod: bool, unroll: bool = False,
             micro: bool = False, device=None, graphs=None) -> dict:
    """One cell counted at full depth (LM, on meta), or run (tda_ego).
    ``unroll`` is accepted for ``repro``'s signature and changes nothing:
    eager PyTorch dispatches every layer."""
    if arch == "tda_ego":
        return run_tda_cell(shape, multi_pod, device=device, graphs=graphs)
    mesh = production_mesh(multi_pod)
    chips = mesh.size
    t0 = time.time()
    spec, skip = input_specs(arch, shape, mesh, micro=micro)
    if skip:
        return {"arch": arch, "shape": shape, "multi_pod": multi_pod,
                "skipped": skip}
    step, args, specs = spec
    cfg = get_config(arch)
    sc = _micro(SHAPES[shape]) if micro else SHAPES[shape]
    c = rl.count_step(step, *args)
    t_count = time.time() - t0
    mf = rl.model_flops_for(cfg, sc)
    return {
        "arch": arch, "shape": shape, "multi_pod": multi_pod, "chips": chips,
        "unrolled_costs": True, "microbatch_costs": micro,
        "grad_accum_lowered": sc.grad_accum,
        "global_batch_lowered": sc.global_batch,
        "compile_s": round(t_count, 1),
        "aten_ops": c["aten_ops"],
        "memory": _memory(args, specs, c["out"], mesh),
        "roofline": _terms(c["flops"], c["bytes_accessed"],
                           c["fusion_adjusted_bytes"], c["collectives"], mf,
                           chips),
    }


def cells() -> list[tuple[str, str]]:
    """Every (arch, shape) cell of ``--all``: the LM archs x SHAPES, then
    the three tda_ego cells."""
    out = [(a, s) for a in ARCHS if a != "tda_ego" for s in SHAPES]
    out.extend(("tda_ego", s) for s in TDA_SHAPES)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--unroll", action="store_true",
                    help="accepted for repro's CLI; every count is already "
                         "per layer")
    ap.add_argument("--micro", action="store_true",
                    help="count one grad-accum microbatch")
    ap.add_argument("--xcost", action="store_true",
                    help="roofline terms by depth-probe extrapolation "
                         "(faster counting, the same terms)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out-dir", default="build/dryrun")
    ap.add_argument("--device", default=None,
                    help="where the tda_ego cells run: 'cpu', or by "
                         "default every CUDA device")
    ap.add_argument("--graphs", type=int, default=None,
                    help="tda_ego graphs (default: graphs_per_device a "
                         "device of the mesh)")
    args = ap.parse_args(argv)
    suffix = "2pod" if args.multipod else "1pod"

    if args.all:
        os.makedirs(args.out_dir, exist_ok=True)
        failures = []
        for arch, shape in cells():
            tag = f"{arch}__{shape}__{suffix}"
            out_path = os.path.join(args.out_dir, tag + ".json")
            if os.path.exists(out_path):
                print(f"[skip-cached] {tag}")
                continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--out-dir",
                   args.out_dir]
            for flag in ("multipod", "unroll", "micro", "xcost"):
                if getattr(args, flag):
                    cmd.append(f"--{flag}")
            for opt in ("device", "graphs"):
                if getattr(args, opt) is not None:
                    cmd += [f"--{opt}", str(getattr(args, opt))]
            r = subprocess.run(cmd, capture_output=True, text=True)
            if r.returncode != 0:
                failures.append(tag)
                print(f"[FAIL] {tag}\n{r.stdout[-2000:]}\n{r.stderr[-2000:]}")
            else:
                print(f"[ok] {tag}")
        print(f"done; {len(failures)} failures: {failures}")
        sys.exit(1 if failures else 0)

    if args.arch is None or args.shape is None:
        ap.error("--arch and --shape (or --all) are required")
    if args.xcost:
        out = run_cell_xcost(args.arch, args.shape, args.multipod,
                             device=args.device, graphs=args.graphs)
    else:
        out = run_cell(args.arch, args.shape, args.multipod,
                       unroll=args.unroll, micro=args.micro,
                       device=args.device, graphs=args.graphs)
    os.makedirs(args.out_dir, exist_ok=True)
    tag = f"{args.arch}__{args.shape}__{suffix}"
    with open(os.path.join(args.out_dir, tag + ".json"), "w") as f:
        json.dump(out, f, indent=2, default=str)
    print(json.dumps(
        {k: out[k] for k in out if k != "roofline"} |
        {"dominant": out.get("roofline", {}).get("dominant"),
         "terms_s": {t: out.get("roofline", {}).get(f"{t}_s")
                     for t in ("compute", "memory", "collective")}},
        indent=2, default=str))


if __name__ == "__main__":
    main()
