"""The port's training half against ``repro``'s: ``lr_schedule``,
``adamw_update``, the clip, ``quantize_int8``/``dequantize_int8`` and
``compressed_psum`` on identical arrays; one ``make_train_step`` per
family against ``repro``'s jitted one; three steps at grad_accum 2; the
cross-pod step on a ("pod",) mesh of 2 CPU devices against ``repro``'s
under ``shard_map``; and the other architectures' train-step smoke.

Tolerances:
* ``lr_schedule``: bitwise ``repro``'s jitted schedule through the
  warm-up, rtol 1e-6 (``IDENTICAL``), atol 1e-6 * base_lr after it and
  against its op-by-op run; ``adamw_update`` (``repro``'s run op by op), the clip and the
  global norm on identical f32 arrays: rtol 1e-6; the step counter
  bitwise;
* ``quantize_int8``, ``dequantize_int8`` and ``compressed_psum``: bitwise;
* a train step from one numpy tree (the two packages' bf16 forwards and
  backwards round differently), ``train.testing.TRAIN_TOLERANCE``: loss
  rtol 1e-4, grad norm rtol 1e-3, the rate bitwise (warm-up steps), every
  gradient leaf within 3e-2 relative Frobenius error (hybrid 0.1), and
  after k <= 3 steps every leaf's update within 0.25 relative Frobenius
  error with at least 98% of its elements moving the same way; after one
  step, where both gradients are known, both over the elements whose
  gradient decides the sign (beyond 3 times the leaf's RMS gradient
  difference, or the two gradients equal), at least 20% of every leaf.
"""
from __future__ import annotations

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import reduced_config as reduced_config_j
from repro.models import transformer as tf_j
from repro.train import optimizer as opt_j
from repro.train.train_step import TrainState as TrainState_j
from repro.train.train_step import make_train_step as make_train_step_j
from repro_torch import convert
from repro_torch.configs.registry import ARCHS, reduced_config
from repro_torch.data.tokens import TokenStream
from repro_torch.models import transformer as tf
from repro_torch.models.testing import random_extras, random_params
from repro_torch.train import optimizer as opt
from repro_torch.train.testing import (
    TRAIN_GNORM_RTOL, TRAIN_LOSS_RTOL, grad_tolerance, rel_frobenius,
    update_agreement, update_ok)
from repro_torch.train.train_step import (
    TrainState, accumulate_grads, clip_by_global_norm, global_norm,
    make_train_step)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
IDENTICAL = 1e-6
LR = 1e-3
# one per family; the hybrid draws from repro's init tree (noised SSM
# constants give NaN gradients in both packages)
FAMILY_ARCHS = ["qwen3-1.7b", "olmoe-1b-7b", "zamba2-7b", "rwkv6-1.6b",
                "whisper-base", "qwen2-vl-2b", "gemma3-27b"]
OTHER_ARCHS = [a for a in ARCHS if a != "tda_ego" and a not in FAMILY_ARCHS]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: these tests run many small torch ops, which
    gain nothing from threads, and parallel test workers would
    oversubscribe the CPUs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree, prefix=()):
    """{path: numpy array} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v, np.float32)
    return out


def assert_updates_close(before, got, want, what, g_got=None, g_want=None):
    """Per leaf: the update got - before against want - before
    (``update_agreement``; with the two gradient trees, where the gradient
    decides the sign)."""
    before, got, want = _flat(before), _flat(got), _flat(want)
    assert got.keys() == want.keys() == before.keys(), what
    grads = (None, None) if g_want is None else (_flat(g_got), _flat(g_want))
    for k in want:
        assert np.isfinite(got[k]).all(), (what, k)
        gg, gw = (None, None) if g_want is None else (grads[0][k],
                                                      grads[1][k])
        agree = update_agreement(before[k], got[k], want[k], gg, gw)
        assert update_ok(agree), (what, "/".join(k), agree)


def assert_grads_close(got: dict, want: dict, cfg, what):
    """Two gradient trees, per leaf within the family's relative Frobenius
    bound."""
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys(), what
    for k in want:
        assert np.isfinite(got[k]).all(), (what, k)
        rel = rel_frobenius(got[k], want[k])
        assert rel <= grad_tolerance(cfg), (what, "/".join(k), rel)


# ------------------------------------------------------------ optimizer ----

@pytest.mark.parametrize("base_lr,warmup,total",
                         [(3e-4, 100, 10_000), (1e-3, 7, 50),
                          (2.5e-4, 13, 1000)])
def test_lr_schedule_matches_repro(base_lr, warmup, total):
    """Every step to past the end: bitwise ``repro``'s jitted schedule (the
    form its train step runs) through the warm-up, within an ulp after it
    (the cosines differ), and within rtol 1e-6 of its op-by-op run; near
    the end, where 1 + cos cancels, within 1e-6 of ``base_lr``."""
    steps = np.arange(0, total + 50, dtype=np.int32)
    jitted = np.asarray(jax.jit(
        lambda s: opt_j.lr_schedule(s, base_lr, warmup, total))(
            jnp.asarray(steps)))
    eager = np.asarray(opt_j.lr_schedule(jnp.asarray(steps), base_lr,
                                         warmup, total))
    got = opt.lr_schedule(torch.from_numpy(steps), base_lr, warmup,
                          total).numpy()
    assert got.dtype == np.float32
    warm = steps < warmup
    np.testing.assert_array_equal(got[warm], jitted[warm])
    for want in (jitted, eager):
        np.testing.assert_allclose(got, want, rtol=IDENTICAL,
                                   atol=IDENTICAL * base_lr)


def _opt_arrays(seed):
    rng = np.random.default_rng(seed)
    shapes = {"a": (8, 16), "b": (16,), "c": (3, 4, 5)}
    params = {k: rng.normal(0, 0.5, s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: (rng.normal(0, 1, s) * 10.0 ** rng.integers(-6, 1))
              .astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    return params, grads


def test_adamw_update_matches_repro():
    """Three updates on identical gradients: parameters, moments, the rate
    and the step against ``repro``'s run op by op."""
    params, grads = _opt_arrays(0)
    pj = {k: jnp.asarray(v) for k, v in params.items()}
    sj = opt_j.adamw_init(pj)
    pt = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    st = opt.adamw_init(pt)
    assert st.step.dtype == torch.int32 and int(st.step) == 0
    for g in grads:
        pj, sj, lrj = opt_j.adamw_update(
            {k: jnp.asarray(v) for k, v in g.items()}, sj, pj, base_lr=LR,
            warmup=2, total=10)
        pt, st, lrt = opt.adamw_update(
            {k: torch.from_numpy(v) for k, v in g.items()}, st, pt,
            base_lr=LR, warmup=2, total=10)
        assert int(st.step) == int(sj.step)
        np.testing.assert_allclose(lrt.item(), float(lrj), rtol=IDENTICAL)
        for k in params:
            for got, want in ((pt[k], pj[k]), (st.m[k], sj.m[k]),
                              (st.v[k], sj.v[k])):
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=IDENTICAL, atol=0)


def test_clip_and_global_norm_match_repro():
    _, grads = _opt_arrays(1)
    g = {k: v * 1e3 for k, v in grads[0].items()}  # a norm above 1
    want_norm = jnp.sqrt(sum(jnp.sum(jnp.square(jnp.asarray(v)))
                             for v in g.values()))
    want_clip = jnp.minimum(1.0, 1.0 / jnp.maximum(want_norm, 1e-6))
    gt = {k: torch.tensor(v) for k, v in g.items()}  # copies: clipped below
    np.testing.assert_allclose(global_norm(gt).item(), float(want_norm),
                               rtol=IDENTICAL)
    norm = clip_by_global_norm(gt)  # in place
    np.testing.assert_allclose(norm.item(), float(want_norm), rtol=IDENTICAL)
    for k, v in g.items():
        np.testing.assert_allclose(gt[k].numpy(),
                                   np.asarray(jnp.asarray(v) * want_clip),
                                   rtol=IDENTICAL, atol=0)
    assert float(want_clip) < 1.0


def test_quantize_int8_bitwise():
    rng = np.random.default_rng(2)
    g = rng.normal(0, 1, (64, 33)).astype(np.float32)
    g[0, :5] = [127.0, -127.0, 0.5, 1.5, -2.5]  # halves round to even
    for x in (g, g * 1e-8, np.zeros((4, 4), np.float32)):
        qj, sj = opt_j.quantize_int8(jnp.asarray(x))
        qt, st = opt.quantize_int8(torch.from_numpy(x))
        assert qt.dtype == torch.int8 and st.dtype == torch.float32
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
        assert st.item() == float(sj)
        np.testing.assert_array_equal(
            opt.dequantize_int8(qt, st).numpy(),
            np.asarray(opt_j.dequantize_int8(qj, sj)))


@pytest.mark.parametrize("n_pods", [2, 3])
def test_compressed_psum_bitwise_under_vmap(n_pods):
    """Against ``repro``'s ``compressed_psum`` vmapped over an axis named
    "pod": the sum and every pod's residual, bitwise."""
    rng = np.random.default_rng(3 + n_pods)
    g = rng.normal(0, 1, (n_pods, 32, 17)).astype(np.float32)
    e = (rng.normal(0, 1, (n_pods, 32, 17)) * 1e-3).astype(np.float32)
    sum_j, err_j = jax.vmap(
        lambda gi, ei: opt_j.compressed_psum(gi, "pod", ei),
        axis_name="pod")(jnp.asarray(g), jnp.asarray(e))
    total, errs = opt.compressed_psum([torch.from_numpy(x) for x in g],
                                      [torch.from_numpy(x) for x in e])
    for p in range(n_pods):
        np.testing.assert_array_equal(total.numpy(), np.asarray(sum_j[p]))
        np.testing.assert_array_equal(errs[p].numpy(), np.asarray(err_j[p]))


# ----------------------------------------------------------- train step ----

class Case:
    """One architecture's parameter tree, batch and extras in both
    packages."""

    def __init__(self, arch, batch=4, seq=32, seed=0):
        self.cfg_j, self.cfg = reduced_config_j(arch), reduced_config(arch)
        if self.cfg.family == "hybrid":
            self.tree = jax.tree.map(np.asarray, tf_j.init_params(
                self.cfg_j, jax.random.PRNGKey(seed)))
        else:
            self.tree = random_params(self.cfg, seed)
        rng = np.random.default_rng(seed + 1)
        tokens = rng.integers(0, self.cfg.vocab_size,
                              (batch, seq)).astype(np.int32)
        ex = random_extras(self.cfg, batch, rng)
        if self.cfg.mrope_sections:
            ex["mrope_positions"] = rng.integers(
                0, 64, (batch, seq, 3)).astype(np.int32)
        self.extra_keys = tuple(ex)
        self.batch_np = {"tokens": tokens, **ex}

    def state_j(self):
        p = jax.tree.map(jnp.asarray, self.tree)
        return TrainState_j(params=p, opt=opt_j.adamw_init(p))

    def state(self):
        model = convert.lm_params_from_numpy(self.tree, self.cfg, device=CPU)
        return TrainState(params=model, opt=opt.adamw_init(model))

    def batch_j(self):
        return {k: jnp.asarray(v) for k, v in self.batch_np.items()}

    def batch(self):
        return {k: torch.from_numpy(v) for k, v in self.batch_np.items()}

    def grads_j(self, grad_accum):
        """``repro``'s accumulated gradients, as its step forms them."""
        ga = grad_accum
        mb = self.batch_np["tokens"].shape[0] // ga

        def loss(p, micro):
            return tf_j.loss_fn(p, self.cfg_j, micro["tokens"],
                                **{k: micro[k] for k in self.extra_keys})

        grad = jax.jit(jax.value_and_grad(loss))
        params = jax.tree.map(jnp.asarray, self.tree)
        acc = None
        for i in range(ga):
            micro = {k: v[i * mb:(i + 1) * mb]
                     for k, v in self.batch_j().items()}
            _, g = grad(params, micro)
            g = jax.tree.map(lambda x: x.astype(jnp.float32) / ga, g)
            acc = g if acc is None else jax.tree.map(jnp.add, acc, g)
        return jax.tree.map(np.asarray, acc)


def _run_steps(case, grad_accum, n_steps):
    """n_steps of both packages' train steps from the same state; returns
    their final parameter trees and each step's metrics."""
    step_j = jax.jit(make_train_step_j(case.cfg_j, grad_accum=grad_accum,
                                       base_lr=LR,
                                       extra_keys=case.extra_keys))
    step = make_train_step(case.cfg, grad_accum=grad_accum, base_lr=LR,
                           extra_keys=case.extra_keys)
    sj, st = case.state_j(), case.state()
    mj, mt = [], []
    for _ in range(n_steps):
        sj, m = step_j(sj, case.batch_j())
        mj.append({k: float(v) for k, v in m.items()})
        st, m = step(st, case.batch())
        mt.append({k: v.item() for k, v in m.items()})
    return (convert.lm_params_to_numpy(st.params),
            jax.tree.map(np.asarray, sj.params), mt, mj, st)


def _assert_metrics(mt, mj, what):
    for i, (a, b) in enumerate(zip(mt, mj)):
        np.testing.assert_allclose(a["loss"], b["loss"],
                                   rtol=TRAIN_LOSS_RTOL,
                                   err_msg=f"{what} step {i} loss")
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"],
                                   rtol=TRAIN_GNORM_RTOL,
                                   err_msg=f"{what} step {i} grad norm")
        assert np.float32(a["lr"]) == np.float32(b["lr"]), (what, i)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_train_step_matches_repro(arch):
    """One step at grad_accum 2 from one numpy tree: loss, grad norm and
    rate, every gradient leaf, and every leaf's update."""
    case = Case(arch)
    grads, loss = accumulate_grads(
        convert.lm_params_from_numpy(case.tree, case.cfg, device=CPU),
        case.cfg, case.batch(), 2, case.extra_keys)
    grads = convert.stack_tree((k, v.numpy()) for k, v in grads.items())
    grads_j = case.grads_j(2)
    assert_grads_close(grads, grads_j, case.cfg, arch)
    got, want, mt, mj, st = _run_steps(case, 2, 1)
    _assert_metrics(mt, mj, arch)
    assert loss.item() == mt[0]["loss"]
    assert int(st.opt.step) == 1
    assert_updates_close(case.tree, got, want, arch, grads, grads_j)


def test_three_steps_grad_accum_2():
    """qwen3 reduced, three consecutive steps at grad_accum 2 (batch 4 x
    32, lr 1e-3): each step's metrics and the parameters after three."""
    case = Case("qwen3-1.7b")
    got, want, mt, mj, _ = _run_steps(case, 2, 3)
    _assert_metrics(mt, mj, "qwen3 x3")
    assert_updates_close(case.tree, got, want, "qwen3 x3")


@pytest.mark.parametrize("arch", OTHER_ARCHS)
def test_train_step_smoke(arch):
    """The port's counterpart of ``test_archs.py::test_train_step_smoke``:
    one step from the port's init on the token stream, a finite positive
    loss, finite parameters that moved."""
    cfg = reduced_config(arch)
    model = tf.init_params(cfg, torch.Generator().manual_seed(0), device=CPU)
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    state = TrainState(params=model, opt=opt.adamw_init(model))
    data = TokenStream(cfg.vocab_size, 2, 32).batch_at(0, device=CPU)
    new, metrics = make_train_step(cfg)(state, data)
    loss = metrics["loss"].item()
    assert np.isfinite(loss) and loss > 0
    after = new.params.state_dict()
    assert all(torch.isfinite(v).all() for v in after.values())
    assert any(not torch.equal(before[k], after[k]) for k in before)


# ------------------------------------------------------------- pod step ----

_REPRO_POD = r"""
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs.registry import reduced_config
from repro.train.optimizer import adamw_init
from repro.train.train_step import TrainState, make_compressed_pod_step

src, dst = sys.argv[1], sys.argv[2]
data = np.load(src)
tree = {}
for key in data.files:
    if key.startswith("p/"):
        node = tree
        parts = key[2:].split("/")
        for k in parts[:-1]:
            node = node.setdefault(k, {})
        node[parts[-1]] = jnp.asarray(data[key])
cfg = reduced_config("qwen3-1.7b")
mesh = Mesh(np.array(jax.devices()[:2]), ("pod",))
step = jax.jit(make_compressed_pod_step(cfg, mesh, base_lr=1e-3))
state = TrainState(params=tree, opt=adamw_init(tree))
error = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), tree)
out = {}
for i in range(2):
    state, error, m = step(state, error, jnp.asarray(data["tokens"]))
    out[f"loss{i}"] = np.asarray(m["loss"])
    out[f"lr{i}"] = np.asarray(m["lr"])
for path, leaf in jax.tree_util.tree_leaves_with_path(state.params):
    out["p/" + "/".join(k.key for k in path)] = np.asarray(leaf)
np.savez(dst, **out)
"""


def test_pod_step_matches_repro_shard_map(tmp_path):
    """Two cross-pod steps on a ("pod",) mesh of 2 CPU devices against
    ``repro``'s under ``shard_map`` on 2 XLA host devices (a fresh
    process: XLA fixes its host device count at first use): the pods'
    mean loss, the rate and every leaf's update after two steps."""
    from repro_torch.launch import make_test_mesh
    from repro_torch.train.train_step import (
        make_compressed_pod_step, zero_errors)

    case = Case("qwen3-1.7b")
    src, dst = tmp_path / "in.npz", tmp_path / "out.npz"
    np.savez(src, tokens=case.batch_np["tokens"],
             **{"p/" + "/".join(k): v for k, v in _flat(case.tree).items()})
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    out = subprocess.run([sys.executable, "-c", _REPRO_POD, str(src),
                          str(dst)], env=env, capture_output=True, text=True,
                         timeout=240)
    assert out.returncode == 0, out.stdout + out.stderr[-4000:]
    want = np.load(dst)

    mesh = make_test_mesh((2,), ("pod",), devices=["cpu"] * 2)
    step = make_compressed_pod_step(case.cfg, mesh, base_lr=LR)
    state = case.state()
    error = zero_errors(state.params, 2)
    tokens = torch.from_numpy(case.batch_np["tokens"])
    for i in range(2):
        state, error, m = step(state, error, tokens)
        assert len(error) == 2
        np.testing.assert_allclose(m["loss"].item(), want[f"loss{i}"],
                                   rtol=TRAIN_LOSS_RTOL)
        assert np.float32(m["lr"].item()) == want[f"lr{i}"]
    # the pods' residuals differ (each pod quantises its own gradient)
    assert any(not torch.equal(error[0][k], error[1][k]) for k in error[0])
    want_tree = convert.stack_tree(
        (k[2:].replace("/", "."), want[k]) for k in want.files
        if k.startswith("p/"))
    assert_updates_close(case.tree, convert.lm_params_to_numpy(state.params),
                         want_tree, "pod step")
