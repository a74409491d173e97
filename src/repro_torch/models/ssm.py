"""Mamba2 (SSD) block (counterpart of ``repro.models.ssm``): chunked
matmul-form scan for training/prefill, O(1) recurrent state for decode.
Used by zamba2 (hybrid family).

Within a chunk the state update is expressed as masked matmuls; across
chunks a short loop carries the (H, N, P) state.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import _const, _init, dense, rmsnorm


def d_inner(cfg) -> int:
    return cfg.ssm_expand * cfg.d_model


def n_ssm_heads(cfg) -> int:
    return d_inner(cfg) // cfg.ssm_head_dim


class Mamba(nn.Module):
    """``mamba_init``: in/out projections, the depthwise conv, A_log,
    D_skip, dt_bias and the gated norm."""

    def __init__(self, cfg, generator, device):
        super().__init__()
        d = cfg.d_model
        din = d_inner(cfg)
        n = cfg.ssm_state
        h = n_ssm_heads(cfg)
        self.in_proj = _init(generator, (d, 2 * din + 2 * n + h), device)
        self.conv_w = _init(generator, (cfg.ssm_conv_width, din + 2 * n),
                            device, scale=0.2)
        self.A_log = _const((h,), 0.0, device)  # a = -exp(A_log) = -1
        self.D_skip = _const((h,), 1.0, device)
        self.dt_bias = _const((h,), 0.0, device)
        self.ssm_norm = _const((din,), 0.0, device)
        self.out_proj = _init(generator, (din, d), device)


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, width W.  xbc (B,S,C), w (W,C)."""
    width = w.shape[0]
    pad = F.pad(xbc, (0, 0, width - 1, 0))
    out = torch.zeros_like(xbc)
    for i in range(width):
        out = out + pad[:, i:i + xbc.shape[1], :] * w[i].to(xbc.dtype)
    return out


def _split_proj(cfg, proj):
    din = d_inner(cfg)
    n = cfg.ssm_state
    return torch.split(proj, [din, din, n, n, n_ssm_heads(cfg)], dim=-1)


def mamba_train(p: Mamba, x: torch.Tensor, cfg) -> torch.Tensor:
    b, s, _ = x.shape
    din = d_inner(cfg)
    n = cfg.ssm_state
    h = n_ssm_heads(cfg)
    pdim = cfg.ssm_head_dim
    lc = min(cfg.ssm_chunk, s)
    assert s % lc == 0, (s, lc)
    g = s // lc

    proj = dense(x, p.in_proj)
    z, xs, bm, cm, dt = _split_proj(cfg, proj)
    xbc = _causal_conv(torch.cat([xs, bm, cm], -1), p.conv_w)
    xbc = F.silu(xbc)
    xs, bm, cm = torch.split(xbc, [din, n, n], dim=-1)

    dt = F.softplus(dt.float() + p.dt_bias)  # (B,S,H)
    a = -torch.exp(p.A_log)  # (H,)
    xs = xs.reshape(b, g, lc, h, pdim)
    bm = bm.reshape(b, g, lc, n).float()
    cm = cm.reshape(b, g, lc, n).float()
    dt = dt.reshape(b, g, lc, h)

    da = dt * a  # (B,G,Lc,H) negative
    cum = torch.cumsum(da, dim=2)  # inclusive
    xf = xs.float()

    # ---- intra-chunk ----
    cb = torch.einsum("bgln,bgsn->bgls", cm, bm)
    decay = torch.exp(cum[:, :, :, None, :] - cum[:, :, None, :, :])
    tri = torch.tril(torch.ones((lc, lc), dtype=torch.bool, device=x.device))
    att = torch.where(tri[None, None, :, :, None], decay, 0.0)
    att = att * cb[..., None] * dt[:, :, None, :, :]
    y_intra = torch.einsum("bglsh,bgshp->bglhp", att, xf)

    # ---- chunk states ----
    last = cum[:, :, -1:, :]  # (B,G,1,H)
    sdecay = torch.exp(last - cum) * dt  # (B,G,Lc,H)
    states = torch.einsum("bgsh,bgsn,bgshp->bghnp", sdecay, bm, xf)

    # ---- inter-chunk recurrence: the state before each chunk ----
    chunk_decay = torch.exp(last[:, :, 0, :])  # (B,G,H)
    hprev = torch.zeros((b, h, n, pdim), dtype=torch.float32,
                        device=x.device)
    h_prevs = []
    for c in range(g):
        h_prevs.append(hprev)
        hprev = chunk_decay[:, c, :, None, None] * hprev + states[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)  # (B,G,H,N,P)
    y_inter = torch.einsum("bgln,bghnp,bglh->bglhp", cm, h_prevs,
                           torch.exp(cum))

    y = y_intra + y_inter + xf * p.D_skip[None, None, None, :, None]
    y = y.reshape(b, s, din).to(x.dtype)
    y = rmsnorm(y * F.silu(z), p.ssm_norm, cfg.rms_eps)
    return dense(y, p.out_proj)


def mamba_cache_init(cfg, batch: int, device) -> dict:
    din = d_inner(cfg)
    n = cfg.ssm_state
    h = n_ssm_heads(cfg)
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, din + 2 * n),
                            dtype=torch.float32, device=device),
        "ssm": torch.zeros((batch, h, n, cfg.ssm_head_dim),
                           dtype=torch.float32, device=device),
    }


def mamba_decode(p: Mamba, x: torch.Tensor, cache: dict,
                 cfg) -> tuple[torch.Tensor, dict]:
    """x (B,1,D) -> (y, cache), the cache updated in place; O(1) a token."""
    b = x.shape[0]
    din = d_inner(cfg)
    n = cfg.ssm_state
    h = n_ssm_heads(cfg)
    pdim = cfg.ssm_head_dim

    proj = dense(x, p.in_proj)[:, 0]  # (B, ...)
    z, xs, bm, cm, dt = _split_proj(cfg, proj)
    conv = cache["conv"]
    xbc_new = torch.cat([xs, bm, cm], -1).to(conv.dtype)  # (B, C)
    window = torch.cat([conv, xbc_new[:, None, :]], dim=1)
    # the weight rounds to the compute dtype first, as the reference's does
    w = p.conv_w.to(x.dtype).to(window.dtype)
    xbc = F.silu(torch.einsum("bwc,wc->bc", window, w))
    xs, bm, cm = torch.split(xbc, [din, n, n], dim=-1)

    dt = F.softplus(dt.float() + p.dt_bias)  # (B,H)
    a = -torch.exp(p.A_log)
    decay = torch.exp(dt * a)  # (B,H)
    xh = xs.reshape(b, h, pdim).float()
    ssm = cache["ssm"] * decay[:, :, None, None] + torch.einsum(
        "bh,bn,bhp->bhnp", dt, bm.float(), xh)
    y = torch.einsum("bn,bhnp->bhp", cm.float(), ssm)
    y = y + xh * p.D_skip[None, :, None]
    y = y.reshape(b, 1, din).to(x.dtype)
    y = rmsnorm(y * F.silu(z[:, None, :]), p.ssm_norm, cfg.rms_eps)
    conv.copy_(window[:, 1:])
    cache["ssm"].copy_(ssm)
    return dense(y, p.out_proj), cache
