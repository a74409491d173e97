"""The port's training loop and checkpoints on the CPU: the counterparts of
``tests/test_system.py``'s train, restart and checkpoint tests (loss
decreasing over 30 steps, 14 steps equal to 7 + 7 resumed, save and
restore across shard files, pruning and ``.tmp`` directories), the
``train_state_{from,to}_numpy`` round trip, per-block recomputation, the
CLI with ``--device cpu``, the host mesh's shapes, and the device rule.

``repro``'s own loop tests fail on jax 0.9.0 (ROADMAP Queue 3), so these
hold the port's loop to the same properties; the restart check holds it
bitwise, which the CPU gives (every op the step runs is deterministic).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs.registry import reduced_config
from repro_torch.launch import make_host_mesh
from repro_torch.launch import train as train_mod
from repro_torch.models import transformer as tf
from repro_torch.models.testing import random_params
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import adamw_init
from repro_torch.train.train_step import (
    TrainState, accumulate_grads, make_train_step)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: these tests run many small torch ops, which
    gain nothing from threads, and parallel test workers would
    oversubscribe the CPUs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state(arch="qwen3-1.7b", seed=0):
    cfg = reduced_config(arch)
    model = convert.lm_params_from_numpy(random_params(cfg, seed), cfg,
                                         device=CPU)
    return cfg, TrainState(params=model, opt=adamw_init(model))


def _leaves(state):
    return ckpt._flatten(state)


def _assert_states_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert [n for n, _ in la] == [n for n, _ in lb]
    for (name, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and x.device == y.device, name
        assert torch.equal(x, y), name


# ------------------------------------------------------------- the loop ----

def test_train_loss_decreases(tmp_path):
    out = train_mod.train("qwen3-1.7b", steps=30, batch=4, seq=64,
                          ckpt_dir=str(tmp_path), ckpt_every=10, lr=1e-3,
                          device="cpu")
    assert out["steps_run"] == 30 and len(out["step_s"]) == 30
    assert np.isfinite(out["final_loss"])
    assert out["final_loss"] < out["first_loss"]
    assert ckpt.latest_steps(str(tmp_path)) == [10, 20, 30]


def test_checkpoint_restart_bitwise(tmp_path):
    """Interrupted-and-resumed run == uninterrupted run (same stream
    state): every loss after the restart and the final state, bitwise."""
    d1, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    kw = dict(batch=2, seq=32, ckpt_every=7, seed=3, device="cpu")
    full = train_mod.train("qwen3-1.7b", steps=14, ckpt_dir=d1, **kw)
    first = train_mod.train("qwen3-1.7b", steps=7, ckpt_dir=d2, **kw)
    resumed = train_mod.train("qwen3-1.7b", steps=14, ckpt_dir=d2, **kw)
    assert first["losses"] == full["losses"][:7]
    assert resumed["steps_run"] == 7
    assert resumed["losses"] == full["losses"][7:]
    assert resumed["final_loss"] == full["final_loss"]
    _, like = _state()
    a, step_a, ss_a = ckpt.restore(d1, like, device="cpu")
    b, step_b, ss_b = ckpt.restore(d2, like, device="cpu")
    assert step_a == step_b == 14 and ss_a == ss_b == {"seed": 3, "step": 14}
    _assert_states_equal(a, b)


def test_remat_changes_no_bit(monkeypatch):
    """Per-block recomputation (train mode under grad) gives the loss and
    gradients of the forward that keeps its activations, bit for bit; the
    loss equals the no-grad forward's."""
    cfg, state = _state("gemma3-27b")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 32)))
    batch = {"tokens": tokens}
    g_remat, l_remat = accumulate_grads(state.params, cfg, batch)
    calls = []

    def plain(fn, *args, **kw):
        calls.append(1)
        return fn(*args)

    monkeypatch.setattr(tf, "checkpoint", plain)
    g_plain, l_plain = accumulate_grads(state.params, cfg, batch)
    assert len(calls) == sum(n for _, n in tf.segments(cfg))  # the blocks
    assert torch.equal(l_remat, l_plain)
    for k in g_plain:
        assert torch.equal(g_remat[k], g_plain[k]), k
    with torch.no_grad():
        assert torch.equal(tf.loss_fn(state.params, cfg, tokens), l_plain)


def test_grad_accum_microbatches_in_order():
    """grad_accum 2 over a batch of 4: the mean of the two microbatches'
    losses (rows 0-1, then 2-3) and their gradients halved and summed."""
    cfg, state = _state()
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (4, 16)))
    g2, l2 = accumulate_grads(state.params, cfg, {"tokens": tokens}, 2)
    ga, la = accumulate_grads(state.params, cfg, {"tokens": tokens[:2]})
    gb, lb = accumulate_grads(state.params, cfg, {"tokens": tokens[2:]})
    half = torch.tensor(2.0)
    assert torch.equal(l2, la / half + lb / half)
    for k in g2:
        assert torch.equal(g2[k], ga[k] / half + gb[k] / half), k
    with pytest.raises(ValueError, match="grad_accum"):
        accumulate_grads(state.params, cfg, {"tokens": tokens[:3]}, 2)


# ---------------------------------------------------------- checkpoints ----

@pytest.mark.parametrize("shards", [3, 1, 40])
def test_checkpoint_save_restore(tmp_path, shards):
    """A TrainState after one step (nonzero moments, step 1) through
    ``save_shards`` files, restored bitwise into a zeroed state of the
    same structure; more shards than leaves leaves some files empty."""
    cfg, state = _state()
    data = {"tokens": torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 16)))}
    state, _ = make_train_step(cfg, base_lr=1e-3)(state, data)
    path = ckpt.save(str(tmp_path), 5, state, save_shards=shards,
                     stream_state={"seed": 0, "step": 5})
    manifest = json.load(open(os.path.join(path, "manifest.json")))
    assert manifest["codec"] == "raw" and manifest["n_shards"] == shards
    assert manifest["leaf_names"] == [n for n, _ in _leaves(state)]
    assert len(set(manifest["leaf_shard"])) == min(
        shards, len(manifest["leaf_names"]))
    assert manifest["device_count_at_save"] == 1
    assert sorted(os.listdir(path)) == sorted(
        ["manifest.json"] + [f"shard_{s:05d}.bin" for s in range(shards)])
    _, like = _state(seed=1)
    for t in like.opt.m.values():
        t.zero_()
    restored, step, sstate = ckpt.restore(str(tmp_path), like, device="cpu")
    assert step == 5 and sstate == {"seed": 0, "step": 5}
    assert int(restored.opt.step) == 1
    assert restored.params is not like.params
    _assert_states_equal(restored, state)
    assert isinstance(restored.params.embed, torch.nn.Parameter)
    # the restored state trains like the saved one
    nxt = make_train_step(cfg, base_lr=1e-3)
    a, ma = nxt(state, data)
    b, mb = nxt(restored, data)
    assert ma["loss"].item() == mb["loss"].item()
    _assert_states_equal(a, b)


def test_checkpoint_casts_to_like_and_keeps_bf16(tmp_path):
    state = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8),
             "b": torch.linspace(-1, 1, 8).to(torch.bfloat16),
             "step": torch.tensor(7, dtype=torch.int32)}
    ckpt.save(str(tmp_path), 2, state, save_shards=2)
    like = {"w": torch.zeros(8, 8, dtype=torch.bfloat16),
            "b": torch.zeros(8, dtype=torch.bfloat16),
            "step": torch.zeros((), dtype=torch.int32)}
    got, step, sstate = ckpt.restore(str(tmp_path), like, device="cpu")
    assert step == 2 and sstate == {}
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"], state["w"].to(torch.bfloat16))
    assert torch.equal(got["b"].view(torch.int16),
                       state["b"].view(torch.int16))
    assert int(got["step"]) == 7
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(str(tmp_path), {**like, "w": torch.zeros(4)},
                     device="cpu")
    with pytest.raises(KeyError, match="missing"):
        ckpt.restore(str(tmp_path), {**like, "extra": torch.zeros(1)},
                     device="cpu")
    # a manifest naming another codec is refused
    path = os.path.join(str(tmp_path), "step_00000002", "manifest.json")
    manifest = json.load(open(path))
    json.dump({**manifest, "codec": "zlib"}, open(path, "w"))
    with pytest.raises(ValueError, match="codec"):
        ckpt.restore(str(tmp_path), like, device="cpu")


def test_checkpoint_prune_and_atomic(tmp_path):
    state = {"w": torch.zeros(4)}
    for s in (1, 2, 3, 4, 5):
        ckpt.save(str(tmp_path), s, state, keep=2)
    assert ckpt.latest_steps(str(tmp_path)) == [4, 5]
    # a stale .tmp dir, and a step without its manifest, are not committed
    (tmp_path / "step_00000099.tmp").mkdir()
    (tmp_path / "step_00000098").mkdir()
    assert ckpt.latest_steps(str(tmp_path)) == [4, 5]
    _, step, _ = ckpt.restore(str(tmp_path), state, device="cpu")
    assert step == 5
    _, step, _ = ckpt.restore(str(tmp_path), state, step=4, device="cpu")
    assert step == 4
    assert ckpt.latest_steps(str(tmp_path / "none")) == []
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"), state, device="cpu")


# ------------------------------------------------------------ numpy state --

def test_train_state_numpy_round_trip():
    """``train_state_from_numpy`` of repro-shaped trees, back through
    ``train_state_to_numpy``, bitwise; moments keyed as the parameters."""
    cfg = reduced_config("olmoe-1b-7b")
    params, m, v = (random_params(cfg, s) for s in (0, 1, 2))
    state = convert.train_state_from_numpy(params, m, v, 9, cfg, device=CPU)
    assert int(state.opt.step) == 9 and state.opt.step.dtype == torch.int32
    names = [k for k, _ in state.params.named_parameters()]
    assert list(state.opt.m) == list(state.opt.v) == names
    back = convert.train_state_to_numpy(state)
    assert back[3] == 9
    for want, got in zip((params, m, v), back[:3]):
        flat_w, flat_g = dict(convert._leaves(want)), dict(
            convert._leaves(got))
        assert flat_w.keys() == flat_g.keys()
        for k in flat_w:
            np.testing.assert_array_equal(flat_g[k], flat_w[k])


# ------------------------------------------------- entry points, devices ----

def test_cli_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen3-1.7b", "--steps", "4", "--batch", "2", "--seq", "32",
         "--ckpt-dir", str(tmp_path), "--ckpt-every", "2", "--device",
         "cpu"], env=env, capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stdout + out.stderr[-4000:]
    assert "RuntimeWarning" not in out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["steps_run"] == 4 and result["stragglers"] >= 0
    assert np.isfinite(result["final_loss"])
    assert ckpt.latest_steps(str(tmp_path)) == [2, 4]


@pytest.mark.parametrize("n,shape", [(1, (1, 1)), (2, (2, 1)), (4, (2, 2)),
                                     (6, (3, 2)), (8, (2, 4)),
                                     (16, (4, 4))])
def test_make_host_mesh_shapes(n, shape):
    mesh = make_host_mesh(devices=["cpu"] * n)
    assert tuple(mesh.shape.values()) == shape
    assert mesh.axis_names == ("data", "model")


def test_entry_points_need_cuda_unless_asked(monkeypatch, tmp_path):
    """With no device given and no CUDA device, the loop, the host mesh
    and restore raise instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_mod.train("qwen3-1.7b", 1, 2, 16, None)
    with pytest.raises(RuntimeError, match="devices=\\['cpu'"):
        make_host_mesh()
    ckpt.save(str(tmp_path), 1, {"w": torch.zeros(2)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ckpt.restore(str(tmp_path), {"w": torch.zeros(2)})
    out = train_mod.train("qwen3-1.7b", 1, 2, 16, None, device="cpu")
    assert out["steps_run"] == 1


def test_train_refuses_a_mesh_of_several_devices(monkeypatch):
    """Training over several cards is not built: a host mesh of two
    devices raises instead of training on one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(train_mod, "make_host_mesh",
                        lambda devices=None: train_mod._mesh(
                            (2, 1), ("data", "model"), ["cpu"] * 2))
    with pytest.raises(NotImplementedError, match="item 4"):
        train_mod.train("qwen3-1.7b", 1, 2, 16, None)
