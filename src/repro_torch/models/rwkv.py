"""RWKV6 ("Finch") block (counterpart of ``repro.models.rwkv``): time-mix
with data-dependent per-channel decay + channel-mix.  Chunked linear-
attention form for training/prefill (short chunks keep the factored decay
exponentials inside f32 range); O(1) state decode.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import _const, _init, dense, rmsnorm

RWKV_CHUNK = 16
LORA_RANK = 64
W_CLIP = (-8.0, 1.0)  # clamp on log-log decay keeps exp(|w|*chunk) finite


def rwkv_heads(cfg) -> int:
    return cfg.d_model // 64


class RWKVMix(nn.Module):
    """``rwkv_init``: the time-mix (token-shift mixes, r/k/v/g/o, the decay
    LoRA, the bonus, its norm) and channel-mix parameters."""

    def __init__(self, cfg, generator, device):
        super().__init__()
        d = cfg.d_model
        h = rwkv_heads(cfg)
        for name in ("mu_r", "mu_k", "mu_v", "mu_g", "mu_w"):
            setattr(self, name, _const((d,), 0.0, device))
        for name in ("w_r", "w_k", "w_v", "w_g", "w_o"):
            setattr(self, name, _init(generator, (d, d), device))
        self.w0 = _const((d,), -1.0, device)
        self.w_lora_a = _init(generator, (d, LORA_RANK), device)
        self.w_lora_b = _init(generator, (LORA_RANK, d), device)
        self.u_bonus = _const((h, d // h), 0.0, device)
        self.tm_norm = _const((d,), 0.0, device)
        self.cmu_r = _const((d,), 0.0, device)
        self.cmu_k = _const((d,), 0.0, device)
        self.cw_k = _init(generator, (d, cfg.d_ff), device)
        self.cw_v = _init(generator, (cfg.d_ff, d), device)
        self.cw_r = _init(generator, (d, d), device)


def _shift(x: torch.Tensor) -> torch.Tensor:
    """The previous token's row (zeros before the first)."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def _mix(x, xprev, mu):
    return x + (xprev - x) * mu.to(x.dtype)


def _decay_log(p: RWKVMix, xw: torch.Tensor) -> torch.Tensor:
    """w_log (B,S,D) in (-exp(1), -exp(-8)): negative per-channel log decay."""
    lora = torch.tanh(dense(xw, p.w_lora_a)) @ p.w_lora_b.to(xw.dtype)
    raw = p.w0.to(xw.dtype) + lora
    return -torch.exp(torch.clamp(raw.float(), *W_CLIP))


def time_mix_train(p: RWKVMix, x: torch.Tensor, cfg) -> torch.Tensor:
    b, s, d = x.shape
    h = rwkv_heads(cfg)
    pdim = d // h
    lc = min(RWKV_CHUNK, s)
    assert s % lc == 0, (s, lc)
    g = s // lc

    xprev = _shift(x)
    r = dense(_mix(x, xprev, p.mu_r), p.w_r).reshape(b, s, h, pdim)
    k = dense(_mix(x, xprev, p.mu_k), p.w_k).reshape(b, s, h, pdim)
    v = dense(_mix(x, xprev, p.mu_v), p.w_v).reshape(b, s, h, pdim)
    gate = F.silu(dense(_mix(x, xprev, p.mu_g), p.w_g))
    wlog = _decay_log(p, _mix(x, xprev, p.mu_w)).reshape(b, s, h, pdim)

    rf = r.reshape(b, g, lc, h, pdim).float()
    kf = k.reshape(b, g, lc, h, pdim).float()
    vf = v.reshape(b, g, lc, h, pdim).float()
    wl = wlog.reshape(b, g, lc, h, pdim)
    cum = torch.cumsum(wl, dim=2)  # inclusive, decreasing

    # factored decays (chunk short enough that exp stays finite)
    r_dec = rf * torch.exp(cum - wl)  # exp(cum_{l-1})
    k_dec = kf * torch.exp(-cum)

    att = torch.einsum("bglhp,bgshp->bghls", r_dec, k_dec)
    tri = torch.tril(torch.ones((lc, lc), dtype=torch.bool, device=x.device),
                     diagonal=-1)  # strictly lower: s < l
    att = torch.where(tri[None, None, None], att, 0.0)
    y = torch.einsum("bghls,bgshp->bglhp", att, vf)
    # current-token bonus
    bonus = torch.einsum("bglhp,bglhp->bglh", rf, p.u_bonus[None, None] * kf)
    y = y + bonus[..., None] * vf

    # inter-chunk: carry the (B,H,P,P) state
    last = cum[:, :, -1:, :, :]
    k_tail = kf * torch.exp(last - cum)  # decay from s to chunk end
    states = torch.einsum("bgshp,bgshq->bghpq", k_tail, vf)
    chunk_decay = torch.exp(last[:, :, 0])  # (B,G,H,P)
    hprev = torch.zeros((b, h, pdim, pdim), dtype=torch.float32,
                        device=x.device)
    h_prevs = []
    for c in range(g):
        h_prevs.append(hprev)
        hprev = chunk_decay[:, c, ..., None] * hprev + states[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)  # (B,G,H,P,P)
    y = y + torch.einsum("bglhp,bghpq->bglhq", r_dec, h_prevs)

    y = y.reshape(b, s, d).to(x.dtype)
    y = rmsnorm(y, p.tm_norm, cfg.rms_eps) * gate
    return dense(y, p.w_o)


def channel_mix(p: RWKVMix, x: torch.Tensor, cfg,
                xprev: torch.Tensor | None = None) -> torch.Tensor:
    if xprev is None:
        xprev = _shift(x)
    kx = _mix(x, xprev, p.cmu_k)
    rx = _mix(x, xprev, p.cmu_r)
    k = torch.square(F.relu(dense(kx, p.cw_k)))
    return torch.sigmoid(dense(rx, p.cw_r)) * dense(k, p.cw_v)


def rwkv_cache_init(cfg, batch: int, device) -> dict:
    d = cfg.d_model
    h = rwkv_heads(cfg)
    pdim = d // h
    f32 = torch.float32
    return {
        "tm_state": torch.zeros((batch, h, pdim, pdim), dtype=f32,
                                device=device),
        "tm_xprev": torch.zeros((batch, d), dtype=f32, device=device),
        "cm_xprev": torch.zeros((batch, d), dtype=f32, device=device),
    }


def time_mix_decode(p: RWKVMix, x: torch.Tensor, cache: dict, cfg):
    """x (B,1,D); O(1) recurrent update.  Returns (out, new tm_state); the
    cache is left as it was."""
    b, _, d = x.shape
    h = rwkv_heads(cfg)
    pdim = d // h
    xprev = cache["tm_xprev"][:, None, :].to(x.dtype)
    r = dense(_mix(x, xprev, p.mu_r), p.w_r).reshape(b, h, pdim)
    k = dense(_mix(x, xprev, p.mu_k), p.w_k).reshape(b, h, pdim)
    v = dense(_mix(x, xprev, p.mu_v), p.w_v).reshape(b, h, pdim)
    gate = F.silu(dense(_mix(x, xprev, p.mu_g), p.w_g))
    wlog = _decay_log(p, _mix(x, xprev, p.mu_w)).reshape(b, h, pdim)

    rf, kf, vf = (t.float() for t in (r, k, v))
    kv = torch.einsum("bhp,bhq->bhpq", kf, vf)
    wkv = cache["tm_state"] + p.u_bonus[None, :, :, None] * kv
    y = torch.einsum("bhp,bhpq->bhq", rf, wkv)
    new_state = torch.exp(wlog)[..., None] * cache["tm_state"] + kv

    y = y.reshape(b, 1, d).to(x.dtype)
    y = rmsnorm(y, p.tm_norm, cfg.rms_eps) * gate
    return dense(y, p.w_o), new_state


def rwkv_block_decode(p: RWKVMix, x: torch.Tensor, cache: dict, cfg,
                      norm1, norm2):
    """Full block (time-mix + channel-mix) decode step; the cache is
    updated in place once both mixes have read it."""
    xn = rmsnorm(x, norm1, cfg.rms_eps)
    att, new_tm = time_mix_decode(p, xn, cache, cfg)
    x = x + att
    xn2 = rmsnorm(x, norm2, cfg.rms_eps)
    cm_prev = cache["cm_xprev"][:, None, :].to(x.dtype)
    x = x + channel_mix(p, xn2, cfg, xprev=cm_prev)
    cache["tm_state"].copy_(new_tm)
    cache["tm_xprev"].copy_(xn[:, 0].float())
    cache["cm_xprev"].copy_(xn2[:, 0].float())
    return x, cache
