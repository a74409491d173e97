"""The port's LM serving path against ``repro``'s: ``generate`` for a
dense, an MoE, a hybrid, an RWKV, an encoder-decoder and a VLM config; the
prefill and decode steps; sampling with a caller's generator; the token
stream's invariants; the configs field for field; and the entry points'
device rule.

Tolerance: greedy tokens are held equal position by position up to the
first position whose argmax is not decided beyond the logits' tolerance
(rtol 2e-2, atol 2e-2 on f32-cast bf16 logits; hybrid atol 3e-2): the top-2
margin of the port's logits there must exceed both logits' bounds, and no
expert choice feeding it may be ambiguous (``ambiguous_routing``).  After
that position the two sequences may part.  The token stream cannot match
``jax.random`` bit for bit, so its invariants are held instead.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as ARCHS_J
from repro.configs.registry import get_config as get_config_j
from repro.configs.registry import reduced_config as reduced_config_j
from repro.models import config as config_j
from repro.serve.serve_step import generate as generate_j
from repro_torch import convert
from repro_torch.configs.registry import ARCHS, get_config, reduced_config
from repro_torch.data.tokens import TokenStream
from repro_torch.models import config as config_t
from repro_torch.models import transformer as tf
from repro_torch.models.testing import (
    compare_generated, generated_held, random_extras, random_params)
from repro_torch.serve.serve_step import (
    generate, make_decode_step, make_prefill_step)

CPU = torch.device("cpu")
LM_ARCHS = [a for a in ARCHS if a != "tda_ego"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: these tests run many small torch ops, which
    gain nothing from threads, and parallel test workers would
    oversubscribe the CPUs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(arch, seed, batch, s0):
    cfg_j, cfg = reduced_config_j(arch), reduced_config(arch)
    tree = random_params(cfg, seed)
    model = convert.lm_params_from_numpy(tree, cfg, device=CPU)
    rng = np.random.default_rng(seed + 1)
    prompt = rng.integers(0, cfg.vocab_size, (batch, s0)).astype(np.int32)
    extras = random_extras(cfg, batch, rng)
    return cfg_j, cfg, tree, model, prompt, extras


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "olmoe-1b-7b", "zamba2-7b",
                                  "rwkv6-1.6b", "whisper-base",
                                  "qwen2-vl-2b"])
def test_generate_matches_repro(arch):
    # s0 + max_new = 16, a whole RWKV chunk for the teacher-forced pass
    batch, s0, max_new = 4, 8, 8
    cfg_j, cfg, tree, model, prompt, extras = _setup(
        arch, LM_ARCHS.index(arch), batch, s0)
    want = np.array(generate_j(
        jax.tree.map(jnp.asarray, tree), cfg_j, jnp.asarray(prompt),
        max_new, s_kv=24, extras={k: jnp.asarray(v)
                                  for k, v in extras.items()}))
    got = generate(model, cfg, torch.from_numpy(prompt), max_new, s_kv=24,
                   extras={k: torch.from_numpy(v) for k, v in extras.items()},
                   device=CPU)
    assert got.dtype == torch.int64 and got.shape == (batch, s0 + max_new)
    got = got.numpy()
    np.testing.assert_array_equal(got[:, :s0], prompt)

    # where the port's logits over repro's sequence decide each new token
    held = generated_held(model, cfg, torch.from_numpy(want), s0,
                          {k: torch.from_numpy(v) for k, v in extras.items()})
    compared, ok = compare_generated(torch.from_numpy(got),
                                     torch.from_numpy(want), s0, held)
    assert ok, (arch, got, want, held)
    # the dense, RWKV, enc-dec and VLM configs hold all 32 positions; the
    # MoE 5 (ambiguous routing) and the hybrid 7 (its wider bound)
    assert compared >= max_new // 2, (arch, held)


def test_prefill_and_decode_steps():
    """The steps are ``forward`` under inference mode: the prefill's last
    logits and the decode step's argmax, caches written in place."""
    cfg = reduced_config("qwen3-1.7b")
    model = convert.lm_params_from_numpy(random_params(cfg, 3), cfg, CPU)
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 8)))
    caches = tf.init_caches(cfg, 2, 12, device=CPU)
    last, out = make_prefill_step(cfg)(model, tokens, caches, {})
    with torch.inference_mode():
        full, _ = tf.forward(model, cfg, tokens)
    assert torch.equal(last, full[:, -1])
    assert out["seg0_attn_block"]["k"] is caches["seg0_attn_block"]["k"]
    assert caches["seg0_attn_block"]["k"][:, :, :8].abs().sum() > 0
    nxt, _ = make_decode_step(cfg)(model, last.argmax(-1)[:, None], caches,
                                   8, {})
    assert nxt.shape == (2,) and nxt.dtype == torch.int64
    assert caches["seg0_attn_block"]["k"][:, :, 8].abs().sum() > 0
    assert caches["seg0_attn_block"]["k"][:, :, 9:].abs().sum() == 0


def test_sampling_is_seeded():
    """Sampling at temperature 0.8 draws from the caller's generator: the
    same seed gives the same tokens, and a sampler without a generator
    raises."""
    cfg = reduced_config("qwen3-1.7b")
    model = convert.lm_params_from_numpy(random_params(cfg, 5), cfg, CPU)
    prompt = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 8)))
    runs = [generate(model, cfg, prompt, 12, temperature=0.8,
                     generator=torch.Generator().manual_seed(s), device=CPU)
            for s in (7, 7, 8)]
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])
    assert torch.equal(runs[0][:, :9], runs[2][:, :9])  # first is greedy
    with pytest.raises(ValueError, match="Generator"):
        generate(model, cfg, prompt, 4, temperature=0.8, device=CPU)


def test_entry_points_need_cuda_unless_asked(monkeypatch):
    """With no device given and no CUDA device, every entry point that
    creates tensors raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced_config("qwen3-1.7b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tf.init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tf.init_caches(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TokenStream(cfg.vocab_size, 1, 8).batch_at(0)
    model = tf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        generate(model, cfg, torch.zeros((1, 4), dtype=torch.long), 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.lm_params_from_numpy(random_params(cfg, 0), cfg)
    out = generate(model, cfg, torch.zeros((1, 4), dtype=torch.long), 2,
                   device="cpu")
    assert out.shape == (1, 6)


def test_init_params_draws_from_the_generator():
    """Weights come from the generator (same seed, same weights); the
    reference's constant initialisations are kept."""
    cfg = reduced_config("zamba2-7b")
    a, b, c = (tf.init_params(cfg, torch.Generator().manual_seed(s), "cpu")
               for s in (1, 1, 2))
    sa, sb, sc = (m.state_dict() for m in (a, b, c))
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["embed"], sc["embed"])
    mamba = a.segments["seg0_zamba_period"][0].mambas[0].mamba
    assert torch.equal(mamba.D_skip, torch.ones_like(mamba.D_skip))
    assert torch.equal(mamba.A_log, torch.zeros_like(mamba.A_log))
    assert abs(float(a.embed.detach().std()) - 0.02) < 1e-3


# ------------------------------------------------------------ token stream

def test_token_stream_invariants():
    s = TokenStream(vocab_size=512, batch=8, seq_len=256, seed=7)
    b1 = s.batch_at(11, device=CPU)["tokens"]
    assert b1.shape == (8, 256) and b1.dtype == torch.int64
    assert torch.equal(b1, s.batch_at(11, device="cpu")["tokens"])
    assert not torch.equal(b1, s.batch_at(12, device=CPU)["tokens"])
    other = dataclasses.replace(s, seed=8)
    assert not torch.equal(b1, other.batch_at(11, device=CPU)["tokens"])
    assert int(b1.min()) >= 0 and int(b1.max()) < 512
    # Zipf: token 0 is the most frequent
    counts = torch.bincount(b1.flatten(), minlength=512)
    assert int(counts.argmax()) == 0
    uni, rep, pick = s._draw(11)
    assert torch.equal(b1, torch.where(pick, rep, uni))
    assert abs(float(pick.float().mean()) - s.p_motif) < 0.02
    # each sequence's motif repeats with the motif's period
    assert torch.equal(rep[:, s.motif_len:], rep[:, :-s.motif_len])
    state = s.state(11)
    assert state == {"seed": 7, "step": 11}
    cfg, step = TokenStream.resume(s, state)
    assert torch.equal(cfg.batch_at(step, device=CPU)["tokens"], b1)
    with pytest.raises(ValueError, match="seed"):
        TokenStream.resume(other, state)


def test_token_stream_feeds_the_model():
    cfg = reduced_config("rwkv6-1.6b")
    model = tf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = TokenStream(cfg.vocab_size, 2, 32, seed=1).batch_at(0, "cpu")
    with torch.inference_mode():
        loss = tf.loss_fn(model, cfg, batch["tokens"])
    assert np.isfinite(float(loss)) and float(loss) > 0


# ----------------------------------------------------------------- configs

@pytest.mark.parametrize("arch", list(ARCHS_J))
def test_configs_match_repro(arch):
    assert list(ARCHS) == list(ARCHS_J)
    for get_t, get_j in ((get_config, get_config_j),
                         (reduced_config, reduced_config_j)):
        got, want = get_t(arch), get_j(arch)
        assert type(got).__name__ == type(want).__name__
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if arch != "tda_ego":
        cfg = get_config(arch)
        assert cfg.param_count() == get_config_j(arch).param_count()
        assert (cfg.active_param_count()
                == get_config_j(arch).active_param_count())


def test_shapes_match_repro():
    assert {k: dataclasses.asdict(v) for k, v in config_t.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in config_j.SHAPES.items()}
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt-5")
