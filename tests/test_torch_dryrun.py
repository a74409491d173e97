"""The port's dry run (``launch/dryrun.py``), the step form of
``launch/roofline.py`` and ``launch/roofline_report.py`` against
``repro``'s.

``model_flops_for`` bitwise ``repro``'s for every arch x shape;
``_depth_period``, ``_probe_config``, ``_extrapolate`` and the long_500k
skip rule equal ``repro``'s, whose side runs in a subprocess (importing
``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 host devices);
``count_step`` on meta gives exactly the FLOPs and bytes it gives on CPU
tensors for reduced qwen3 and olmoe steps; ``run_cell_xcost`` equals a
full-depth ``run_cell`` of a reduced config (rtol 1e-9); the port's FLOPs
beside XLA's ``cost_analysis()`` of ``repro``'s unrolled steps on one CPU
device (a subprocess; XLA also counts elementwise FLOPs and shares the
prefill's recomputed K/V projections, so the ratio is held to a band);
the report's strings equal ``repro``'s on the same cells; the CLI writes
a cell; and the tda_ego two-phase cells on 2 CPU shards bitwise
``repro``'s reduce phase and persist pipeline.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as get_config_j
from repro.core import api as api_j
from repro.core.graph import GraphBatch as GraphBatchJ
from repro.core.reduction import reduce_fixpoint as reduce_fixpoint_j
from repro.core.repack import compact_batch as compact_batch_j
from repro.core.repack import measure_counts as measure_counts_j
from repro.launch import roofline as rl_j
from repro.launch import roofline_report as rr_j
from repro.models.config import SHAPES as SHAPES_J
from repro_torch.configs.registry import ARCHS, get_config, reduced_config
from repro_torch.configs.tda_ego import config as tda_config
from repro_torch.convert import graph_batch_to_numpy
from repro_torch.core.api import make_topo_plan
from repro_torch.core.persistence import diagrams_bitwise_equal
from repro_torch.launch import dryrun as dr
from repro_torch.launch import roofline as rl
from repro_torch.launch import roofline_report as rr
from repro_torch.launch.mesh import make_serve_mesh
from repro_torch.models import transformer as tf
from repro_torch.models.config import SHAPES
from repro_torch.serve.serve_step import make_decode_step, make_prefill_step
from repro_torch.train.optimizer import adamw_init
from repro_torch.train.train_step import TrainState, make_train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LM_ARCHS = [a for a in ARCHS if a != "tda_ego"]
# the port's counted FLOPs over XLA's cost_analysis() of repro's unrolled
# steps, reduced qwen3 at 4 x 16 tokens (prefill into a cache of 24):
# prefill 1.1188 (XLA shares the prefill's recomputed K/V projections),
# train 0.8636 (XLA also counts elementwise FLOPs)
XLA_FLOP_RATIO_BAND = (0.8, 1.2)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: these tests run many small torch ops, and
    parallel test workers would oversubscribe the CPUs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run_repro(code: str, timeout: int = 300) -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         env=env, capture_output=True, text=True,
                         timeout=timeout)
    assert out.returncode == 0, out.stdout + out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


# ---------------------------------------------------- roofline, step form

@pytest.mark.parametrize("arch", LM_ARCHS)
def test_model_flops_for_is_repros(arch):
    for shape in SHAPES:
        got = rl.model_flops_for(get_config(arch), SHAPES[shape])
        want = rl_j.model_flops_for(get_config_j(arch), SHAPES_J[shape])
        assert got == want and type(got) is type(want)


def test_step_roofline_terms():
    t = rl.step_roofline_terms(1e12, 6.7e9, {}, model_flops_global=128e12,
                               chips=256)
    assert t["collective_s"] is None and t["dominant"] == "memory"
    assert t["compute_s"] == 1e12 / rl.BF16_TC_FLOPS_PER_S
    assert t["memory_s"] == t["bound_s"] == 6.7e9 / rl.HBM_BYTES_PER_S
    assert t["useful_flop_ratio"] == 0.5
    coll = {"transfer": {"count": 2, "bytes": 1e9, "traffic": 1e9}}
    t = rl.step_roofline_terms(1e12, 6.7e9, coll)
    assert t["collective_s"] == 1e9 / rl.HOST_LINK_BYTES_PER_S
    assert t["dominant"] == "collective"
    assert t["collective_traffic_per_device"] == 1e9


def test_count_step_sees_transfers_and_skips_views():
    x = torch.ones((4, 8))

    def step(x):
        y = x.view(2, 16).t()  # views
        return (y * 2).to("meta"), x.sum()

    c = rl.count_step(step, x)
    assert c["collectives"] == {"transfer": {"count": 1, "bytes": 128.0,
                                             "traffic": 128.0}}
    # mul: 128 in + 128 out; the copy: 128 + 128; sum: 128 + 4
    assert c["bytes_accessed"] == 128 * 5 + 4
    assert c["fusion_adjusted_bytes"] == 2 * 128 + 2 * 4  # copy, sum
    assert c["flops"] == 0.0


def _lm_steps(cfg, dev):
    """(name, step, args) of a prefill, a decode and a train step (batch
    4 x 16, grad_accum 2) of ``cfg`` on ``dev``, from a seeded init."""
    if dev == "meta":
        model = tf.Model(cfg, None, torch.device("meta"))
    else:
        model = tf.init_params(cfg, torch.Generator().manual_seed(0),
                               device=dev)
    toks = torch.zeros((4, 16), dtype=torch.int32, device=dev)
    caches = tf.init_caches(cfg, 4, 24, device=dev)
    return [("prefill", make_prefill_step(cfg), (model, toks, caches, {})),
            ("decode", make_decode_step(cfg),
             (model, toks[:, :1], caches, 16, {})),
            ("train", make_train_step(cfg, grad_accum=2),
             (TrainState(params=model, opt=adamw_init(model)),
              {"tokens": toks}))]


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "olmoe-1b-7b"])
def test_count_step_on_meta_equals_cpu(arch):
    cfg = reduced_config(arch)
    for (name, step, args), (_, step_m, args_m) in zip(
            _lm_steps(cfg, "cpu"), _lm_steps(cfg, "meta")):
        got, want = rl.count_step(step_m, *args_m), rl.count_step(step, *args)
        for k in ("flops", "bytes_accessed", "fusion_adjusted_bytes"):
            assert got[k] == want[k], (name, k)
        assert got["flops"] > 0 and got["collectives"] == {}


_XLA_FLOPS = """
    import json
    import jax, jax.numpy as jnp
    from repro.configs.registry import reduced_config
    from repro.models import transformer as tf
    from repro.models.unroll import set_unroll
    from repro.train.optimizer import adamw_init
    from repro.train.train_step import TrainState, make_train_step

    set_unroll(True)
    cfg = reduced_config("qwen3-1.7b")
    params = jax.eval_shape(lambda: tf.init_params(cfg, jax.random.PRNGKey(0)))
    toks = jax.ShapeDtypeStruct((4, 16), jnp.int32)
    caches = jax.eval_shape(lambda: tf.init_caches(cfg, 4, 24))

    def prefill(p, t, c):
        lg, nc = tf.forward(p, cfg, t, mode="prefill", caches=c)
        return lg[:, -1, :], nc

    def flops(fn, *args):
        return jax.jit(fn).lower(*args).compile().cost_analysis()["flops"]

    state = TrainState(params=params, opt=jax.eval_shape(adamw_init, params))
    print(json.dumps({
        "prefill": flops(prefill, params, toks, caches),
        "train": flops(make_train_step(cfg, grad_accum=1), state,
                       {"tokens": toks})}))
"""


def test_flops_beside_xla_cost_analysis():
    want = _run_repro(_XLA_FLOPS)
    cfg = reduced_config("qwen3-1.7b")
    _, prefill, args = _lm_steps(cfg, "meta")[0]
    model, toks = args[:2]
    got = {"prefill": rl.count_step(prefill, *args)["flops"],
           "train": rl.count_step(
               make_train_step(cfg, grad_accum=1),
               TrainState(params=model, opt=adamw_init(model)),
               {"tokens": toks})["flops"]}
    lo, hi = XLA_FLOP_RATIO_BAND
    for k in got:
        assert lo <= got[k] / want[k] <= hi, (k, got[k], want[k])


# ------------------------------------------------- dry-run helpers, skips

_REPRO_HELPERS = """
    import dataclasses, json
    from repro.configs.registry import ARCHS, get_config
    from repro.launch import dryrun

    out = {"cells": {}, "extrapolate": []}
    for arch in ARCHS:
        if arch == "tda_ego":
            continue
        cfg = get_config(arch)
        per = dryrun._depth_period(cfg)
        try:
            skip = dryrun.input_specs(arch, "long_500k", None)[1]
        except Exception:  # went past the skip rule
            skip = None
        out["cells"][arch] = {
            "period": per, "skip": skip,
            "probes": [dataclasses.asdict(dryrun._probe_config(cfg, n))
                       for n in (per, 2 * per, 3)]}
    for c1, c2, l1, l2, L in json.loads(%r):
        f, b, colls = dryrun._extrapolate(c1, c2, l1, l2, L)
        out["extrapolate"].append([f, b, colls])
    print(json.dumps(out))
"""

_EXTRAPOLATE_CASES = [
    [[1.5e9, 2.5e8, {}], [2.75e9, 4.0e8, {}], 1, 2, 28],
    [[3.0e12, 1.0e11, {"all-reduce": {"count": 2, "bytes": 8.0,
                                      "traffic": 16.0}}],
     [5.5e12, 1.9e11, {"all-reduce": {"count": 3, "bytes": 12.0,
                                      "traffic": 24.0},
                       "transfer": {"count": 1, "bytes": 4.0,
                                    "traffic": 4.0}}], 6, 12, 81],
]


def _as_lists(x):
    return json.loads(json.dumps(x))


def test_dryrun_helpers_and_skips_equal_repros():
    want = _run_repro(_REPRO_HELPERS % json.dumps(_EXTRAPOLATE_CASES))
    mesh = dr.production_mesh()
    for arch in LM_ARCHS:
        cfg = get_config(arch)
        w = want["cells"][arch]
        per = dr._depth_period(cfg)
        assert per == w["period"], arch
        assert [_as_lists(dataclasses.asdict(dr._probe_config(cfg, n)))
                for n in (per, 2 * per, 3)] == w["probes"], arch
        spec, skip = dr.input_specs(arch, "long_500k", mesh)
        assert skip == w["skip"], arch
        assert (spec is None) == (skip is not None)
    for case, w in zip(_EXTRAPOLATE_CASES, want["extrapolate"]):
        assert _as_lists(list(dr._extrapolate(*case))) == w


def _reduced_for_mesh(arch):
    """``reduced_config`` with 16 experts (the "model" axis splits them 16
    ways) and the full configs' attention chunk (the reduced 64 would walk
    32k-token prefills in 512 chunks a layer)."""
    cfg = reduced_config(arch)
    extra = {"n_experts": 16} if cfg.family == "moe" else {}
    return dataclasses.replace(cfg, attn_chunk=1024, **extra)


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "olmoe-1b-7b"])
def test_xcost_equals_full_depth_run_cell(arch, shape, monkeypatch):
    monkeypatch.setattr(dr, "get_config", _reduced_for_mesh)
    full = dr.run_cell(arch, shape, False, micro=True)
    x = dr.run_cell_xcost(arch, shape, False)
    assert x["memory"] == full["memory"]
    assert x["true_layers"] == reduced_config(arch).n_layers
    for k in ("hlo_flops_per_device", "hlo_bytes_per_device",
              "hlo_bytes_adjusted_per_device", "compute_s", "memory_s",
              "model_flops_per_device", "roofline_fraction"):
        np.testing.assert_allclose(x["roofline"][k], full["roofline"][k],
                                   rtol=1e-9, err_msg=k)
    assert x["roofline"]["dominant"] == full["roofline"]["dominant"]


def test_run_cell_memory_and_terms():
    out = dr.run_cell("qwen3-1.7b", "decode_32k", False)
    assert out["chips"] == 256 and out["unrolled_costs"]
    mem = out["memory"]
    assert mem["temp_bytes"] is None and mem["peak_bytes"] is None
    assert mem["fits"] and 0 < mem["argument_bytes"] < rl.HBM_CAPACITY_BYTES
    r = out["roofline"]
    assert r["per_device"] == "global/chips" and r["collective_s"] is None
    assert r["model_flops_per_device"] == rl.model_flops_for(
        get_config("qwen3-1.7b"), SHAPES["decode_32k"]) / 256
    skipped = dr.run_cell("qwen3-1.7b", "long_500k", True)
    assert set(skipped) == {"arch", "shape", "multi_pod", "skipped"}


# ---------------------------------------------------------------- report

def _cells():
    tda = {"arch": "tda_ego", "shape": "ego_pd", "chips": 1,
           "compile_s": 0.3, "memory": {"peak_bytes": 3 * 2**30},
           "roofline": {"compute_s": 2e-5, "memory_s": 3e-4,
                        "collective_s": None, "dominant": "memory",
                        "collectives": {"transfer": {"count": 2.0}}}}
    return {("qwen3-1.7b", "decode_32k"):
            dr.run_cell_xcost("qwen3-1.7b", "decode_32k", False),
            ("qwen3-1.7b", "long_500k"):
            dr.run_cell_xcost("qwen3-1.7b", "long_500k", False),
            ("tda_ego", "ego_pd"): tda}


def test_report_strings_equal_repros():
    cells = _cells()
    assert rr.dryrun_table(cells) == rr_j.dryrun_table(cells)
    assert rr.roofline_table(cells) == rr_j.roofline_table(cells)
    for x in (None, 0.0, 3e-7, 2.5e-4, 1e-3, 0.0999, 0.1, 12.345):
        assert rr.fmt_s(x) == rr_j.fmt_s(x)


def test_cli_writes_a_cell_and_the_report_reads_it(tmp_path, capsys):
    dr.main(["--arch", "qwen3-1.7b", "--shape", "decode_32k", "--xcost",
             "--out-dir", str(tmp_path)])
    cell = json.loads((tmp_path / "qwen3-1.7b__decode_32k__1pod.json")
                      .read_text())
    assert cell["method"] == "xcost-depth-extrapolation"
    assert cell["roofline"]["dominant"] in ("compute", "memory")
    capsys.readouterr()
    rr.main(["--dryrun", str(tmp_path), "--roofline", str(tmp_path)])
    text = capsys.readouterr().out
    assert "| qwen3-1.7b | decode_32k | 256 |" in text
    assert "meta devices" in text and "H100" in text


# ------------------------------------------------------------- TDA cells

GRAPHS = 16


def _to_repro(g):
    import jax.numpy as jnp

    adj, mask, f = graph_batch_to_numpy(g)
    return GraphBatchJ(adj=jnp.asarray(adj), mask=jnp.asarray(mask),
                       f=jnp.asarray(f))


def test_tda_reduce_phase_is_repros_on_two_cpu_shards():
    mesh = make_serve_mesh(devices=["cpu"] * 2)
    step, (g,), info = dr.tda_two_phase_specs(mesh, "reduce", graphs=GRAPHS)
    assert info["graphs_in"] == g.batch == GRAPHS
    got = step(g)
    tcfg = tda_config()
    gr = reduce_fixpoint_j(_to_repro(g), ("prunit", "kcore"), tcfg.max_dim,
                           tcfg.sublevel)
    gc, _ = compact_batch_j(gr)
    want = (gc.adj, gc.mask, gc.f, *measure_counts_j(gc))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_tda_persist_phase_is_repros_and_the_repack_plans():
    mesh = make_serve_mesh(devices=["cpu"] * 2)
    step, (gm,), info = dr.tda_two_phase_specs(mesh, "persist",
                                               graphs=GRAPHS)
    mid = dr.middle_rung()
    assert info["rung"] == dataclasses.asdict(mid)
    assert gm.batch == info["fit"] + info["padded"]
    assert gm.batch % mesh.size == 0 and gm.n == mid.n_pad
    d = step(gm)
    tcfg = tda_config()
    want = api_j.topological_signature(
        _to_repro(gm), dim=tcfg.max_dim, method="none",
        sublevel=tcfg.sublevel, edge_cap=mid.edge_cap, tri_cap=mid.tri_cap,
        reducer="jnp")
    assert diagrams_bitwise_equal(d, want)

    # the repack="on" plan over the same ego nets: the graphs it puts in
    # rungs up to the middle one are those that fit it, and with its ladder
    # pinned to that rung their rows are bitwise the persist cell's
    g = dr.tda_graphs(GRAPHS, "cpu")
    kw = dict(dim=tcfg.max_dim, method="both", sublevel=tcfg.sublevel,
              edge_cap=tcfg.edge_cap, tri_cap=tcfg.tri_cap, repack="on")
    _, report = make_topo_plan(**kw).execute_info(g)
    hist = report.rung_histogram()
    assert info["fit"] == sum(v for n, v in hist.items() if n <= mid.n_pad)
    out, report = make_topo_plan(**kw, ladder=(mid,)).execute_info(g)
    idx = np.nonzero(report.class_index == 0)[0]
    assert len(idx) == info["fit"]
    s = d.birth.shape[-1]
    rows = type(out)(*(getattr(out, k)[idx, :s] for k in
                       ("birth", "death", "dim", "valid")))
    fit = type(d)(*(getattr(d, k)[:info["fit"]] for k in
                    ("birth", "death", "dim", "valid")))
    assert diagrams_bitwise_equal(rows, fit)
    assert not out.valid[idx, s:].any()


def test_tda_cells_run_on_the_cpu_only_when_asked():
    out = dr.run_cell("tda_ego", "ego_pd_reduce", False, device="cpu",
                      graphs=8)
    assert out["graphs"] == 8 and out["chips"] == 1
    assert out["launches"] == {}  # the plain versions: no kernel
    assert out["bound_ms"] == out["bound_parts_ms"]["torch_ops"] > 0
    assert out["memory"]["peak_bytes"] is None and out["ms"] > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dr.run_cell("tda_ego", "ego_pd", False)
