"""Model zoo orchestrator (counterpart of ``repro.models.transformer``):
segments of blocks covering all six families (dense GQA, MoE,
Mamba2-hybrid, RWKV6, enc-dec, VLM).

A model is a list of *segments*; each segment is a homogeneous stack of
blocks, an ``nn.ModuleList`` run in order where the reference scans over
parameters stacked on a leading axis.  Heterogeneous repeat patterns
(gemma3's 5-local:1-global, zamba2's shared attention every N mamba layers)
are composite "period" kinds whose body runs the pattern once.  Module and
parameter names are the reference's keys (``segments.seg0_attn_block.3.
attn.w_q`` is layer 3 of ``params["segments"]["seg0_attn_block"]["attn"]
["w_q"]``), so ``repro_torch.convert`` maps one tree onto the other.

Caches keep the reference's layout: nested dicts of tensors with the
segment's layer count as the leading axis.  ``forward`` updates them in
place and returns them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch._device import resolve_device
from repro_torch.models import rwkv as rw
from repro_torch.models import ssm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    COMPUTE_DTYPE,
    MLP,
    Attention,
    MoE,
    _const,
    _init,
    _qkv,
    _sdpa,
    attn_cache_init,
    attn_decode,
    attn_train,
    dense,
    mrope_tables,
    rmsnorm,
    rope_tables,
)


@dataclasses.dataclass(frozen=True)
class Ctx:
    cfg: ModelConfig
    mode: str  # "train" | "prefill" | "decode"
    cos: Any
    sin: Any
    pos: Any = None  # decode: the current position
    enc_out: Any = None  # encdec: (B, S_enc, D)
    shared: Any = None  # zamba: the shared attention block

    @property
    def decoding(self) -> bool:
        return self.mode == "decode"


# ------------------------------------------------------------- segments ----
def segments(cfg: ModelConfig) -> list[tuple[str, int]]:
    """[(block_kind, count)] executed in order (decoder side for encdec)."""
    if cfg.family == "moe":
        return [("moe_block", cfg.n_layers)]
    if cfg.family == "ssm" and cfg.rwkv:
        return [("rwkv_block", cfg.n_layers)]
    if cfg.family == "hybrid":
        period = cfg.attn_period
        n_per = cfg.n_layers // period
        tail = cfg.n_layers % period
        segs = [("zamba_period", n_per)]
        if tail:
            segs.append(("mamba_block", tail))
        return segs
    if cfg.local_global_pattern != (0, 0):
        nl, ng = cfg.local_global_pattern
        per = nl + ng
        n_per = cfg.n_layers // per
        tail = cfg.n_layers % per
        segs = [("lg_period", n_per)]
        if tail:
            segs.append(("local_block", tail))
        return segs
    if cfg.family == "encdec":
        return [("dec_block", cfg.n_layers)]
    return [("attn_block", cfg.n_layers)]


# --------------------------------------------------------------- blocks ----
class AttnBlock(nn.Module):
    """attn_block / local_block / enc_block, and moe_block with an MoE."""

    def __init__(self, cfg, generator, device, use_moe=False):
        super().__init__()
        d = cfg.d_model
        self.ln1 = _const((d,), 0.0, device)
        self.attn = Attention(cfg, generator, device)
        self.ln2 = _const((d,), 0.0, device)
        self.mlp = (MoE if use_moe else MLP)(cfg, generator, device)


class MambaBlock(nn.Module):
    def __init__(self, cfg, generator, device):
        super().__init__()
        self.ln = _const((cfg.d_model,), 0.0, device)
        self.mamba = ssm.Mamba(cfg, generator, device)


class RWKVBlock(nn.Module):
    def __init__(self, cfg, generator, device):
        super().__init__()
        self.ln1 = _const((cfg.d_model,), 0.0, device)
        self.ln2 = _const((cfg.d_model,), 0.0, device)
        self.mix = rw.RWKVMix(cfg, generator, device)


class DecBlock(nn.Module):
    def __init__(self, cfg, generator, device):
        super().__init__()
        d = cfg.d_model
        self.ln1 = _const((d,), 0.0, device)
        self.self_attn = Attention(cfg, generator, device)
        self.ln2 = _const((d,), 0.0, device)
        self.cross_attn = Attention(cfg, generator, device)
        self.ln3 = _const((d,), 0.0, device)
        self.mlp = MLP(cfg, generator, device)


class ZambaPeriod(nn.Module):
    """``attn_period`` mamba blocks, then the model's shared attention."""

    def __init__(self, cfg, generator, device):
        super().__init__()
        self.mambas = nn.ModuleList(
            MambaBlock(cfg, generator, device)
            for _ in range(cfg.attn_period))


class LGPeriod(nn.Module):
    """n_local sliding-window blocks (``locals``), then one ``global``."""

    def __init__(self, cfg, generator, device):
        super().__init__()
        nl, _ = cfg.local_global_pattern
        self.locals = nn.ModuleList(AttnBlock(cfg, generator, device)
                                    for _ in range(nl))
        # the reference's key; ``global`` is a keyword, so no attribute
        self.add_module("global", AttnBlock(cfg, generator, device))


def block_init(kind: str, generator, cfg, device) -> nn.Module:
    if kind in ("attn_block", "local_block", "enc_block"):
        return AttnBlock(cfg, generator, device)
    if kind == "moe_block":
        return AttnBlock(cfg, generator, device, use_moe=True)
    if kind == "mamba_block":
        return MambaBlock(cfg, generator, device)
    if kind == "rwkv_block":
        return RWKVBlock(cfg, generator, device)
    if kind == "dec_block":
        return DecBlock(cfg, generator, device)
    if kind == "zamba_period":
        return ZambaPeriod(cfg, generator, device)
    if kind == "lg_period":
        return LGPeriod(cfg, generator, device)
    raise ValueError(kind)


# ---------------------------------------------------------- block cache ----
def _stacked(tree, n: int):
    """``tree`` with a leading axis of ``n`` zero copies on every leaf."""
    if isinstance(tree, dict):
        return {k: _stacked(v, n) for k, v in tree.items()}
    return tree.new_zeros((n,) + tuple(tree.shape))


def _layer(tree, i: int):
    """Layer ``i`` of a stacked cache tree: views, so writes reach it."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def block_cache_init(kind: str, cfg, batch: int, s_kv: int, device):
    if kind in ("attn_block", "moe_block", "local_block"):
        return attn_cache_init(cfg, batch, s_kv, device)
    if kind == "mamba_block":
        return ssm.mamba_cache_init(cfg, batch, device)
    if kind == "rwkv_block":
        return rw.rwkv_cache_init(cfg, batch, device)
    if kind == "dec_block":
        return {"self": attn_cache_init(cfg, batch, s_kv, device)}
    if kind == "zamba_period":
        m = _stacked(ssm.mamba_cache_init(cfg, batch, device),
                     cfg.attn_period)
        return {"mambas": m, "attn": attn_cache_init(cfg, batch, s_kv, device)}
    if kind == "lg_period":
        # the local layers' caches hold every position, as the
        # reference's do (its window-sized capacity is computed, not used)
        nl, _ = cfg.local_global_pattern
        loc = _stacked(attn_cache_init(cfg, batch, s_kv, device), nl)
        return {"locals": loc,
                "global": attn_cache_init(cfg, batch, s_kv, device)}
    raise ValueError(kind)


# ---------------------------------------------------------- block apply ----
def _apply_attn_mlp(p, x, ctx, cache, window=0, causal=True):
    cfg = ctx.cfg
    xn = rmsnorm(x, p.ln1, cfg.rms_eps)
    if ctx.decoding:
        att, new_cache = attn_decode(p.attn, xn, cache, ctx.pos, cfg,
                                     ctx.cos, ctx.sin, window=window)
    else:
        att = attn_train(p.attn, xn, cfg, ctx.cos, ctx.sin, window=window,
                         causal=causal)
        new_cache = None
        if ctx.mode == "prefill" and cache is not None:
            new_cache = _prefill_kv(p.attn, xn, cfg, ctx, cache)
    x = x + att
    xn2 = rmsnorm(x, p.ln2, cfg.rms_eps)
    x = x + p.mlp(xn2)  # mlp_apply or moe_apply
    return x, new_cache


def _prefill_kv(ap, xn, cfg, ctx, cache):
    """Write the full-sequence K/V into the cache prefix (recomputed, as in
    the reference)."""
    _, k, v = _qkv(ap, xn, cfg, ctx.cos, ctx.sin)
    s = k.shape[1]
    cache["k"][:, :s] = k.to(cache["k"].dtype)
    cache["v"][:, :s] = v.to(cache["v"].dtype)
    return cache


def _apply_mamba(p, x, ctx, cache):
    cfg = ctx.cfg
    xn = rmsnorm(x, p.ln, cfg.rms_eps)
    if ctx.decoding:
        y, new_cache = ssm.mamba_decode(p.mamba, xn, cache, cfg)
    else:
        y = ssm.mamba_train(p.mamba, xn, cfg)
        new_cache = cache  # prefill leaves the recurrent state as it was
    return x + y, new_cache


def _apply_rwkv(p, x, ctx, cache):
    cfg = ctx.cfg
    if ctx.decoding:
        return rw.rwkv_block_decode(p.mix, x, cache, cfg, p.ln1, p.ln2)
    xn = rmsnorm(x, p.ln1, cfg.rms_eps)
    x = x + rw.time_mix_train(p.mix, xn, cfg)
    xn2 = rmsnorm(x, p.ln2, cfg.rms_eps)
    x = x + rw.channel_mix(p.mix, xn2, cfg)
    return x, cache


def _apply_cross(p_attn, x, ctx):
    """Cross-attention over ctx.enc_out (no rope, no qk norm, not causal)."""
    cfg = ctx.cfg
    b, sq = x.shape[0], x.shape[1]
    dh = cfg.head_dim
    h, kv = cfg.q_heads, cfg.kv_heads
    q = dense(x, p_attn.w_q, getattr(p_attn, "b_q", None)).reshape(
        b, sq, h, dh)
    enc = ctx.enc_out.to(x.dtype)
    sk = enc.shape[1]
    k = dense(enc, p_attn.w_k, getattr(p_attn, "b_k", None)).reshape(
        b, sk, kv, dh)
    v = dense(enc, p_attn.w_v, getattr(p_attn, "b_v", None)).reshape(
        b, sk, kv, dh)
    mask = torch.ones((1, sq, sk), dtype=torch.bool, device=x.device)
    return dense(_sdpa(q, k, v, mask, dh), p_attn.w_o)


def _apply_dec_block(p, x, ctx, cache):
    cfg = ctx.cfg
    xn = rmsnorm(x, p.ln1, cfg.rms_eps)
    if ctx.decoding:
        att, new_self = attn_decode(p.self_attn, xn, cache["self"], ctx.pos,
                                    cfg, ctx.cos, ctx.sin)
        new_cache = {"self": new_self}
    else:
        att = attn_train(p.self_attn, xn, cfg, ctx.cos, ctx.sin)
        new_cache = None
        if ctx.mode == "prefill" and cache is not None:
            new_cache = {"self": _prefill_kv(p.self_attn, xn, cfg, ctx,
                                             cache["self"])}
    x = x + att
    xn2 = rmsnorm(x, p.ln2, cfg.rms_eps)
    x = x + _apply_cross(p.cross_attn, xn2, ctx)
    xn3 = rmsnorm(x, p.ln3, cfg.rms_eps)
    x = x + p.mlp(xn3)
    return x, new_cache


def _run(blocks, x, stacked_cache, fn, remat: bool = False):
    """Run ``fn(block, x, layer_cache)`` over a stack of blocks in order
    (the reference's ``lax.scan``); returns (x, the stacked cache).

    ``remat``: each block's activations are recomputed in the backward
    instead of kept (the reference's ``jax.checkpoint`` of its scan
    body)."""
    for i, blk in enumerate(blocks):
        if remat:
            x, _ = checkpoint(fn, blk, x, _layer(stacked_cache, i),
                              use_reentrant=False)
        else:
            x, _ = fn(blk, x, _layer(stacked_cache, i))
    return x, stacked_cache


def apply_block(kind: str, p, x, ctx: Ctx, cache):
    cfg = ctx.cfg
    if kind == "attn_block" or kind == "moe_block":
        return _apply_attn_mlp(p, x, ctx, cache)
    if kind == "local_block":
        return _apply_attn_mlp(p, x, ctx, cache, window=cfg.sliding_window)
    if kind == "enc_block":
        return _apply_attn_mlp(p, x, ctx, cache, causal=False)
    if kind == "mamba_block":
        return _apply_mamba(p, x, ctx, cache)
    if kind == "rwkv_block":
        return _apply_rwkv(p, x, ctx, cache)
    if kind == "dec_block":
        return _apply_dec_block(p, x, ctx, cache)
    if kind == "zamba_period":
        mcache = cache["mambas"] if cache is not None else None
        x, _ = _run(p.mambas, x, mcache,
                    lambda pp, xc, cc: _apply_mamba(pp, xc, ctx, cc))
        acache = cache["attn"] if cache is not None else None
        x, _ = _apply_attn_mlp(ctx.shared, x, ctx, acache)
        return x, cache
    if kind == "lg_period":
        lcache = cache["locals"] if cache is not None else None
        x, _ = _run(p.locals, x, lcache,
                    lambda pp, xc, cc: _apply_attn_mlp(
                        pp, xc, ctx, cc, window=cfg.sliding_window))
        gcache = cache["global"] if cache is not None else None
        x, _ = _apply_attn_mlp(getattr(p, "global"), x, ctx, gcache)
        return x, cache
    raise ValueError(kind)


# ------------------------------------------------------------- the model ---
class Model(nn.Module):
    """The parameter tree of ``repro``'s ``init_params`` as modules:
    ``embed``, ``final_norm``, ``segments`` (a ModuleList a segment), and
    ``shared_attn`` (hybrid), ``enc_segments`` / ``enc_norm`` (encdec),
    ``unembed`` (untied) where the config has them."""

    def __init__(self, cfg: ModelConfig, generator, device):
        super().__init__()
        d = cfg.d_model
        self.embed = _init(generator, (cfg.vocab_size, d), device)
        self.final_norm = _const((d,), 0.0, device)
        self.segments = nn.ModuleDict({
            f"seg{i}_{kind}": nn.ModuleList(
                block_init(kind, generator, cfg, device)
                for _ in range(count))
            for i, (kind, count) in enumerate(segments(cfg))})
        if cfg.family == "hybrid":
            self.shared_attn = AttnBlock(cfg, generator, device)
        if cfg.family == "encdec":
            self.enc_segments = nn.ModuleList(
                block_init("enc_block", generator, cfg, device)
                for _ in range(cfg.n_enc_layers))
            self.enc_norm = _const((d,), 0.0, device)
        if not cfg.tie_embeddings:
            self.unembed = _init(generator, (d, cfg.vocab_size), device)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> Model:
    """A model with weights drawn from ``generator`` (which must live on
    ``device``; CUDA unless ``device="cpu"``) and the reference's constant
    initialisations."""
    return Model(cfg, generator, resolve_device(device))


def _rope_for(cfg: ModelConfig, positions, mrope_positions=None):
    dh = cfg.head_dim
    if cfg.mrope_sections and mrope_positions is not None:
        return mrope_tables(mrope_positions, dh, cfg.rope_theta,
                            cfg.mrope_sections)
    return rope_tables(positions, dh, cfg.rope_theta)


def _encode(params: Model, frames, cfg) -> torch.Tensor:
    """Whisper-style encoder over stubbed conv-frontend frames (B, T, D)."""
    x = frames.to(COMPUTE_DTYPE)
    pos = torch.arange(x.shape[1], device=x.device)
    cos, sin = rope_tables(pos, cfg.head_dim, cfg.rope_theta)
    ctx = Ctx(cfg=cfg, mode="train", cos=cos, sin=sin)
    for blk in params.enc_segments:
        x, _ = _apply_attn_mlp(blk, x, ctx, None, causal=False)
    return rmsnorm(x, params.enc_norm, cfg.rms_eps)


def _embed_scale(d: int, device) -> torch.Tensor:
    """sqrt(d) in f32, then rounded to the compute dtype."""
    return torch.tensor(math.sqrt(d), dtype=torch.float32,
                        device=device).to(COMPUTE_DTYPE)


def forward(
    params: Model,
    cfg: ModelConfig,
    tokens: torch.Tensor,
    mode: str = "train",
    caches: dict | None = None,
    pos: int | None = None,
    frames: torch.Tensor | None = None,
    vision: torch.Tensor | None = None,
    mrope_positions: torch.Tensor | None = None,
):
    """Returns (logits, new_caches).

    train/prefill: tokens (B, S).  decode: tokens (B, 1) with ``caches`` and
    the position ``pos``.  ``frames``: encdec encoder input (stub frontend).
    ``vision``: (B, n_vis, D) stub patch embeddings overriding the first
    n_vis positions (VLM, not in decode).  ``mrope_positions``: (B, S|1, 3).
    Caches are updated in place.
    """
    b, s = tokens.shape
    dev = tokens.device
    x = params.embed[tokens.long()].to(COMPUTE_DTYPE)
    x = x * _embed_scale(cfg.d_model, dev)
    if vision is not None and cfg.vision_tokens and mode != "decode":
        nv = min(vision.shape[1], s)
        x = torch.cat([vision[:, :nv].to(COMPUTE_DTYPE), x[:, nv:]], dim=1)

    if mode == "decode":
        positions = torch.tensor([pos], device=dev)
    else:
        positions = torch.arange(s, device=dev)
    cos, sin = _rope_for(cfg, positions, mrope_positions)

    enc_out = None
    if cfg.family == "encdec":
        enc_out = _encode(params, frames, cfg)

    ctx = Ctx(cfg=cfg, mode=mode, cos=cos, sin=sin, pos=pos, enc_out=enc_out,
              shared=getattr(params, "shared_attn", None))

    # per-block recomputation under grad, as the reference's train mode
    # remats its segment scans; serving runs without grad and keeps none
    remat = mode == "train" and torch.is_grad_enabled()
    new_caches = {}
    for name, blocks in params.segments.items():
        kind = name.split("_", 1)[1]
        seg_cache = None if caches is None else caches[name]
        x, new_caches[name] = _run(
            blocks, x, seg_cache,
            lambda pp, xc, cc, kind=kind: apply_block(kind, pp, xc, ctx, cc),
            remat=remat)

    x = rmsnorm(x, params.final_norm, cfg.rms_eps)
    if cfg.tie_embeddings:
        logits = torch.einsum("bsd,vd->bsv", x, params.embed.to(x.dtype))
    else:
        logits = dense(x, params.unembed)
    return logits, (new_caches if caches is not None or mode == "prefill"
                    else None)


def init_caches(cfg: ModelConfig, batch: int, s_kv: int,
                device=None) -> dict:
    """Zeroed caches, one stacked tree a segment, on ``device`` (CUDA
    unless ``device="cpu"``)."""
    dev = resolve_device(device)
    return {f"seg{i}_{kind}": _stacked(
                block_cache_init(kind, cfg, batch, s_kv, dev), count)
            for i, (kind, count) in enumerate(segments(cfg))}


def loss_fn(params: Model, cfg: ModelConfig, tokens: torch.Tensor,
            frames=None, vision=None, mrope_positions=None) -> torch.Tensor:
    """Causal LM loss (next-token CE), computed in f32 from the logits."""
    logits, _ = forward(
        params, cfg, tokens, mode="train", frames=frames, vision=vision,
        mrope_positions=mrope_positions,
    )
    lg = logits[:, :-1].float()
    targets = tokens[:, 1:].long()
    mx = lg.amax(-1, keepdim=True)
    lse = torch.log(torch.exp(lg - mx).sum(-1)) + mx[..., 0]
    tgt = lg.gather(-1, targets[..., None])[..., 0]
    return (lse - tgt).mean()
