"""The port's LM layers (``models/layers.py``, ``ssm.py``, ``rwkv.py``)
against ``repro``'s, function by function, on the same numpy inputs.

Parameters are drawn from seeded numpy at ``repro``'s shapes (the constant
initialisations too: ``models.testing.draw_leaf``); inputs are seeded
normals, rounded to bf16 where the model feeds bf16.

Tolerance: rtol 2e-2, atol 2e-2 on f32-cast bf16 outputs, the reference's
own bound for bf16 attention (``tests/test_archs.py``); the f32 RoPE tables
within 1e-5; MoE expert choices and keep masks equal, on an input built to
hold exact router ties.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs.registry import reduced_config as reduced_config_j
from repro.models import layers as L_j
from repro.models import rwkv as rw_j
from repro.models import ssm as ssm_j
from repro_torch.configs.registry import reduced_config
from repro_torch.models import layers as L
from repro_torch.models import rwkv as rw
from repro_torch.models import ssm
from repro_torch.models.testing import LM_ATOL, LM_RTOL, draw_leaf

META = torch.device("meta")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: these tests run many small torch ops, which
    gain nothing from threads, and parallel test workers would
    oversubscribe the CPUs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, rtol=LM_RTOL, atol=LM_ATOL):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


def pair(init_j, module_cls, cfg_j, cfg, seed):
    """``repro``'s parameter dict and the port's module holding the same
    drawn values."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: init_j(jax.random.PRNGKey(0), cfg_j))
    tree = {k: draw_leaf(k, s.shape, rng) for k, s in shapes.items()}
    mod = module_cls(cfg, None, META)
    mod.load_state_dict({k: torch.from_numpy(v) for k, v in tree.items()},
                        assign=True)
    mod.requires_grad_(False)
    return {k: jnp.asarray(v) for k, v in tree.items()}, mod


def inputs(shape, seed, scale=1.0):
    """The same bf16 input for both packages."""
    x = (scale * np.random.default_rng(seed).normal(0, 1, shape)).astype(
        np.float32)
    return (jnp.asarray(x).astype(jnp.bfloat16),
            torch.from_numpy(x).bfloat16())


def configs(arch, **updates):
    return (dataclasses.replace(reduced_config_j(arch), **updates),
            dataclasses.replace(reduced_config(arch), **updates))


# ------------------------------------------------------ norms, dense, rope

def test_rmsnorm_and_dense():
    rng = np.random.default_rng(0)
    scale = rng.normal(0, 0.1, 128).astype(np.float32)
    w = rng.normal(0, 0.02, (128, 96)).astype(np.float32)
    b = rng.normal(0, 0.02, 96).astype(np.float32)
    xj, xt = inputs((2, 8, 128), 1)
    close(L.rmsnorm(xt, torch.from_numpy(scale), 1e-6),
          L_j.rmsnorm(xj, jnp.asarray(scale), 1e-6))
    assert L.rmsnorm(xt, torch.from_numpy(scale)).dtype == torch.bfloat16
    close(L.dense(xt, torch.from_numpy(w), torch.from_numpy(b)),
          L_j.dense(xj, jnp.asarray(w), jnp.asarray(b)))


def test_rope_and_mrope_tables():
    pos = np.arange(0, 300, 7)
    for got, want in zip(L.rope_tables(torch.from_numpy(pos), 64, 1e6),
                         L_j.rope_tables(jnp.asarray(pos), 64, 1e6)):
        close(got, want, rtol=1e-5, atol=1e-5)
    mpos = np.random.default_rng(2).integers(0, 200, (2, 9, 3))
    for got, want in zip(
            L.mrope_tables(torch.from_numpy(mpos), 32, 1e6, (4, 6, 6)),
            L_j.mrope_tables(jnp.asarray(mpos), 32, 1e6, (4, 6, 6))):
        close(got, want, rtol=1e-5, atol=1e-5)
    xj, xt = inputs((2, 9, 4, 32), 3)
    cos, sin = L_j.mrope_tables(jnp.asarray(mpos), 32, 1e6, (4, 6, 6))
    ct, st = L.mrope_tables(torch.from_numpy(mpos), 32, 1e6, (4, 6, 6))
    close(L.apply_rope(xt, ct, st), L_j.apply_rope(xj, cos, sin))


# ------------------------------------------------------------- attention

@pytest.mark.parametrize("arch", ["qwen3-1.7b", "qwen1.5-4b", "qwen2-vl-2b"])
def test_qkv_and_sdpa(arch):
    """GQA projections (qk norm, qkv bias), RoPE, and the attention core
    under a causal mask."""
    cfg_j, cfg = configs(arch)
    pj, pt = pair(L_j.attn_init, L.Attention, cfg_j, cfg, seed=4)
    xj, xt = inputs((2, 16, cfg.d_model), 5)
    cos_j, sin_j = L_j.rope_tables(jnp.arange(16), cfg.head_dim, 1e6)
    cos_t, sin_t = L.rope_tables(torch.arange(16), cfg.head_dim, 1e6)
    qkv_j = L_j._qkv(pj, xj, cfg_j, cos_j, sin_j)
    qkv_t = L._qkv(pt, xt, cfg, cos_t, sin_t)
    for got, want in zip(qkv_t, qkv_j):
        close(got, want)
    mask = np.tril(np.ones((16, 16), bool))[None]
    close(L._sdpa(*qkv_t, torch.from_numpy(mask), cfg.head_dim),
          L_j._sdpa(*qkv_j, jnp.asarray(mask), cfg.head_dim))


ATTN_CASES = {
    # (seq, attn_chunk, window, causal): which attn_train branch runs
    "full": (48, 64, 0, True),
    "full_window": (48, 64, 8, True),
    "banded": (256, 64, 64, True),
    "chunked": (256, 64, 0, True),
    "chunked_window": (256, 32, 64, True),
    "chunked_bidirectional": (256, 64, 0, False),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attn_train_branches(case):
    s, chunk, window, causal = ATTN_CASES[case]
    cfg_j, cfg = configs("gemma3-27b", attn_chunk=chunk)
    pj, pt = pair(L_j.attn_init, L.Attention, cfg_j, cfg, seed=6)
    xj, xt = inputs((2, s, cfg.d_model), 7)
    cos_j, sin_j = L_j.rope_tables(jnp.arange(s), cfg.head_dim,
                                   cfg.rope_theta)
    cos_t, sin_t = L.rope_tables(torch.arange(s), cfg.head_dim,
                                 cfg.rope_theta)
    close(L.attn_train(pt, xt, cfg, cos_t, sin_t, window, causal),
          L_j.attn_train(pj, xj, cfg_j, cos_j, sin_j, window, causal))


def test_banded_matches_full_mask():
    """The banded sliding-window branch against the query-chunked one with
    the full window mask (as ``tests/test_archs.py`` holds ``repro``)."""
    _, cfg = configs("gemma3-27b", attn_chunk=64, sliding_window=64)
    _, pt = pair(L_j.attn_init, L.Attention, *configs("gemma3-27b"), seed=8)
    _, xt = inputs((2, 256, cfg.d_model), 9)
    cos, sin = L.rope_tables(torch.arange(256), cfg.head_dim, cfg.rope_theta)
    band = L.attn_train(pt, xt, cfg, cos, sin, window=64)
    full = L.attn_train(pt, xt, dataclasses.replace(cfg, attn_chunk=128),
                        cos, sin, window=64)
    close(band, full.float().numpy())


@pytest.mark.parametrize("window", [0, 6])
def test_attn_decode(window):
    """One decode step at pos 11 of a 16-slot cache that holds noise at
    every slot: the write lands at pos, the mask keeps idx <= pos (and
    > pos - window)."""
    cfg_j, cfg = configs("qwen3-1.7b")
    pj, pt = pair(L_j.attn_init, L.Attention, cfg_j, cfg, seed=10)
    xj, xt = inputs((2, 1, cfg.d_model), 11)
    kj, kt = inputs((2, 16, cfg.kv_heads, cfg.head_dim), 12)
    vj, vt = inputs((2, 16, cfg.kv_heads, cfg.head_dim), 13)
    pos = 11
    cos_j, sin_j = L_j.rope_tables(jnp.asarray(pos)[None], cfg.head_dim, 1e6)
    cos_t, sin_t = L.rope_tables(torch.tensor([pos]), cfg.head_dim, 1e6)
    yj, cj = L_j.attn_decode(pj, xj, {"k": kj, "v": vj}, jnp.int32(pos),
                             cfg_j, cos_j, sin_j, window)
    cache = {"k": kt.clone(), "v": vt.clone()}
    yt, ct = L.attn_decode(pt, xt, cache, pos, cfg, cos_t, sin_t, window)
    assert ct is cache
    close(yt, yj)
    for name in ("k", "v"):
        close(ct[name], cj[name])
        assert torch.equal(ct[name][:, :pos], (kt, vt)[name == "v"][:, :pos])


def test_cache_inits_match():
    for arch, fn_j, fn_t in (
            ("qwen3-1.7b",
             lambda c: L_j.attn_cache_init(c, 3, 24),
             lambda c: L.attn_cache_init(c, 3, 24, META)),
            ("zamba2-7b",
             lambda c: ssm_j.mamba_cache_init(c, 3),
             lambda c: ssm.mamba_cache_init(c, 3, META)),
            ("rwkv6-1.6b",
             lambda c: rw_j.rwkv_cache_init(c, 3),
             lambda c: rw.rwkv_cache_init(c, 3, META))):
        want = fn_j(reduced_config_j(arch))
        got = fn_t(reduced_config(arch))
        assert list(got) == list(want)
        for name, t in got.items():
            assert tuple(t.shape) == want[name].shape, (arch, name)
            assert str(t.dtype).split(".")[1] == str(want[name].dtype), name


# ------------------------------------------------------------------ MLP

@pytest.mark.parametrize("arch", ["qwen3-1.7b", "whisper-base"])
def test_mlp(arch):
    """The gated SiLU MLP and whisper's plain GELU MLP."""
    cfg_j, cfg = configs(arch)
    pj, pt = pair(L_j.mlp_init, L.MLP, cfg_j, cfg, seed=14)
    assert hasattr(pt, "w_gate") == cfg.gated_mlp
    xj, xt = inputs((2, 16, cfg.d_model), 15)
    close(L.mlp_apply(pt, xt, cfg), L_j.mlp_apply(pj, xj, cfg_j))
    close(pt(xt), L_j.mlp_apply(pj, xj, cfg_j))


def test_gelu_is_the_tanh_approximation():
    """``jax.nn.gelu``'s default is the tanh form; torch's default (erf)
    differs from it by up to ~5e-4 near |x| = 2."""
    x = np.linspace(-6, 6, 2001).astype(np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    tanh = F.gelu(torch.from_numpy(x), approximate="tanh").numpy()
    erf = F.gelu(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(tanh, want, rtol=1e-6, atol=1e-6)
    assert np.abs(erf - want).max() > 1e-4


# ------------------------------------------------------------------ MoE

def _route_j(pj, xj, cfg_j):
    """``repro``'s routing (``layers.py`` moe_apply's first lines) for
    inputs xj (G, TB, D): experts and keep mask."""
    tb = xj.shape[1]
    e, k = cfg_j.n_experts, cfg_j.moe_top_k
    cap = max(1, int(cfg_j.capacity_factor * tb * k / e))
    probs = jax.nn.softmax(L_j.dense(xj, pj["moe_gate"]).astype(jnp.float32),
                           axis=-1)
    _, top_e = jax.lax.top_k(probs, k)
    onehot = jax.nn.one_hot(top_e, e, dtype=jnp.float32)
    flat = onehot.reshape(xj.shape[0], tb * k, e)
    pos = (jnp.cumsum(flat, axis=1) - flat).reshape(onehot.shape)
    pos = jnp.sum(pos * onehot, axis=-1)
    return np.asarray(top_e), np.asarray(pos < cap)


def _tied_moe(arch, seed, **updates):
    """Parameters whose router has exact ties: experts 1 and 5 share their
    router column, and experts 2, 3 and 6 share another."""
    cfg_j, cfg = configs(arch, **updates)
    pj, pt = pair(L_j.moe_init, L.MoE, cfg_j, cfg, seed=seed)
    gate = np.asarray(pj["moe_gate"]).copy()
    gate[:, 5] = gate[:, 1]
    gate[:, 3] = gate[:, 6] = gate[:, 2]
    pj["moe_gate"] = jnp.asarray(gate)
    pt.moe_gate = torch.nn.Parameter(torch.from_numpy(gate),
                                     requires_grad=False)
    return cfg_j, cfg, pj, pt


@pytest.mark.parametrize("arch,group,tokens", [
    ("olmoe-1b-7b", 4096, (2, 32)),   # one group: the group does not divide
    ("olmoe-1b-7b", 16, (2, 32)),     # four groups of 16
    ("phi3.5-moe-42b-a6.6b", 0, (4, 16)),  # moe_group=0: one global group
])
def test_moe_routing_and_output(arch, group, tokens):
    """Expert choices and keep masks equal (ties go to the lower expert as
    ``lax.top_k`` breaks them; the capacity drops entries here), outputs
    within the tolerance."""
    cfg_j, cfg, pj, pt = _tied_moe(arch, 16, moe_group=group)
    b, s = tokens
    xj, xt = inputs((b, s, cfg.d_model), 17)
    g, tb, cap = L.moe_groups(cfg, b * s)
    assert (g, tb) == ((b * s) // group, group) if group and (
        b * s) % group == 0 else (g, tb) == (1, b * s)
    want_e, want_keep = _route_j(pj, xj.reshape(g, tb, -1), cfg_j)
    _, top_e, _, _, keep = L.moe_route(pt, xt.reshape(g, tb, -1), cfg, cap)
    np.testing.assert_array_equal(top_e.numpy(), want_e)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    assert not want_keep.all()
    ties = np.isin(want_e, [1, 5]).sum(-1) == 2
    assert ties.any() or np.isin(want_e, [2, 3, 6]).sum(-1).max() == 2
    close(L.moe_apply(pt, xt, cfg), L_j.moe_apply(pj, xj, cfg_j))
    close(pt(xt), L_j.moe_apply(pj, xj, cfg_j))


# -------------------------------------------------------------- Mamba2

def _mamba():
    cfg_j, cfg = configs("zamba2-7b")
    pj, pt = pair(ssm_j.mamba_init, ssm.Mamba, cfg_j, cfg, seed=18)
    return cfg_j, cfg, pj, pt


@pytest.mark.parametrize("seq", [32, 64])
def test_mamba_train(seq):
    """Chunked SSD over one and two chunks of 32.  The gated RMSNorm after
    the SSD amplifies a one-ulp bf16 rounding of its small output (see
    ``models.testing.HYBRID_ATOL``)."""
    cfg_j, cfg, pj, pt = _mamba()
    xj, xt = inputs((2, seq, cfg.d_model), 19)
    close(ssm.mamba_train(pt, xt, cfg), ssm_j.mamba_train(pj, xj, cfg_j),
          atol=3e-2)


def test_mamba_decode():
    """Three O(1) steps from a nonzero conv window and SSM state."""
    cfg_j, cfg, pj, pt = _mamba()
    rng = np.random.default_rng(20)
    want = {k: rng.normal(0, 0.5, v.shape).astype(np.float32)
            for k, v in ssm_j.mamba_cache_init(cfg_j, 2).items()}
    cache = {k: torch.from_numpy(v.copy()) for k, v in want.items()}
    want = {k: jnp.asarray(v) for k, v in want.items()}
    for step in range(3):
        xj, xt = inputs((2, 1, cfg.d_model), 21 + step)
        yj, want = ssm_j.mamba_decode(pj, xj, want, cfg_j)
        yt, got = ssm.mamba_decode(pt, xt, cache, cfg)
        assert got is cache
        close(yt, yj, atol=3e-2)
        for k in want:
            close(got[k], want[k])


# ---------------------------------------------------------------- RWKV6

def _rwkv():
    cfg_j, cfg = configs("rwkv6-1.6b")
    pj, pt = pair(rw_j.rwkv_init, rw.RWKVMix, cfg_j, cfg, seed=24)
    return cfg_j, cfg, pj, pt


def test_rwkv_time_and_channel_mix():
    """Time-mix in chunked form over three chunks of 16 (token shift, the
    data-dependent decay, the bonus), and channel-mix."""
    cfg_j, cfg, pj, pt = _rwkv()
    xj, xt = inputs((2, 48, cfg.d_model), 25)
    close(rw.time_mix_train(pt, xt, cfg), rw_j.time_mix_train(pj, xj, cfg_j))
    close(rw.channel_mix(pt, xt, cfg), rw_j.channel_mix(pj, xj, cfg_j))


def test_rwkv_decode_matches_chunked():
    """Recurrent steps from a nonzero state against ``repro``'s, and (in
    the port alone) 16 steps from zeros against the chunked form."""
    cfg_j, cfg, pj, pt = _rwkv()
    rng = np.random.default_rng(26)
    ln1, ln2 = (rng.normal(0, 0.1, cfg.d_model).astype(np.float32)
                for _ in range(2))
    want = {k: rng.normal(0, 0.5, v.shape).astype(np.float32)
            for k, v in rw_j.rwkv_cache_init(cfg_j, 2).items()}
    cache = {k: torch.from_numpy(v.copy()) for k, v in want.items()}
    want = {k: jnp.asarray(v) for k, v in want.items()}
    for step in range(3):
        xj, xt = inputs((2, 1, cfg.d_model), 27 + step)
        yj, want = rw_j.rwkv_block_decode(pj, xj, want, cfg_j,
                                          jnp.asarray(ln1), jnp.asarray(ln2))
        yt, got = rw.rwkv_block_decode(pt, xt, cache, cfg,
                                       torch.from_numpy(ln1),
                                       torch.from_numpy(ln2))
        assert got is cache
        close(yt, yj)
        for k in want:
            close(got[k], want[k])

    _, xt = inputs((1, 16, cfg.d_model), 30, scale=0.5)
    chunked = rw.time_mix_train(pt, xt, cfg)
    state = rw.rwkv_cache_init(cfg, 1, torch.device("cpu"))
    for i in range(16):
        yi, new_tm = rw.time_mix_decode(pt, xt[:, i:i + 1], state, cfg)
        state["tm_state"] = new_tm
        state["tm_xprev"] = xt[:, i].float()
        close(yi[:, 0], chunked[:, i].float().numpy())
