"""Shared NN layers (counterpart of ``repro.models.layers``): norms,
RoPE/M-RoPE, GQA attention (train + decode), gated MLP, capacity-based MoE.

Conventions:
* parameters are f32 ``nn.Parameter``s of small ``nn.Module``s named after
  the reference's keys, in the reference's layouts (a dense weight is
  (d_in, d_out)); compute is bf16, each weight cast at its use; norms and
  softmax accumulate in f32.
* every function takes such a module as ``p`` and mirrors the reference's
  function of the same name; a decode step writes its cache in place and
  returns it.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

COMPUTE_DTYPE = torch.bfloat16


def _init(generator, shape, device, scale=0.02) -> nn.Parameter:
    """N(0, scale^2) f32 weights drawn from ``generator``."""
    w = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    return nn.Parameter(w * scale)


def _const(shape, value, device) -> nn.Parameter:
    return nn.Parameter(torch.full(shape, value, dtype=torch.float32,
                                   device=device))


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


def dense(x: torch.Tensor, w: torch.Tensor,
          b: torch.Tensor | None = None) -> torch.Tensor:
    y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(x.dtype)
    return y


# ---------------------------------------------------------------- RoPE ----
def _freq(dim: int, theta: float, device) -> torch.Tensor:
    half = dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def rope_tables(positions: torch.Tensor, dim: int,
                theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """positions (...,) int -> cos/sin (..., dim//2) f32."""
    ang = positions.float()[..., None] * _freq(dim, theta, positions.device)
    return torch.cos(ang), torch.sin(ang)


def mrope_tables(positions: torch.Tensor, dim: int, theta: float,
                 sections: tuple[int, ...]) -> tuple[torch.Tensor, torch.Tensor]:
    """M-RoPE (Qwen2-VL): positions (..., 3) [t, h, w]; per-frequency section
    selects which position stream drives the angle."""
    half = dim // 2
    assert sum(sections) == half, (sections, half)
    sec_id = torch.cat([torch.full((s,), i, dtype=torch.long,
                                   device=positions.device)
                        for i, s in enumerate(sections)])
    pos_sel = positions.float().index_select(-1, sec_id)
    ang = pos_sel * _freq(dim, theta, positions.device)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (..., H, dh); cos/sin broadcastable to (..., 1, dh//2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :].to(x.dtype)
    s = sin[..., None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


# ----------------------------------------------------------- attention ----
class Attention(nn.Module):
    """GQA projections (``attn_init``): w_q, w_k, w_v, w_o, the optional
    qkv biases and q/k norms."""

    def __init__(self, cfg, generator, device):
        super().__init__()
        d, dh = cfg.d_model, cfg.head_dim
        h, kv = cfg.q_heads, cfg.kv_heads
        self.w_q = _init(generator, (d, h * dh), device)
        self.w_k = _init(generator, (d, kv * dh), device)
        self.w_v = _init(generator, (d, kv * dh), device)
        self.w_o = _init(generator, (h * dh, d), device)
        if cfg.qkv_bias:
            self.b_q = _const((h * dh,), 0.0, device)
            self.b_k = _const((kv * dh,), 0.0, device)
            self.b_v = _const((kv * dh,), 0.0, device)
        if cfg.qk_norm:
            self.q_norm = _const((dh,), 0.0, device)
            self.k_norm = _const((dh,), 0.0, device)


def _qkv(p: Attention, x: torch.Tensor, cfg, cos, sin):
    b, s = x.shape[0], x.shape[1]
    h, kv, dh = cfg.q_heads, cfg.kv_heads, cfg.head_dim
    q = dense(x, p.w_q, getattr(p, "b_q", None)).reshape(b, s, h, dh)
    k = dense(x, p.w_k, getattr(p, "b_k", None)).reshape(b, s, kv, dh)
    v = dense(x, p.w_v, getattr(p, "b_v", None)).reshape(b, s, kv, dh)
    if cfg.qk_norm:
        q = rmsnorm(q, p.q_norm, cfg.rms_eps)
        k = rmsnorm(k, p.k_norm, cfg.rms_eps)
    if cos is not None:
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q, k, v


def _sdpa(q, k, v, mask, dh):
    """q (B,Sq,H,dh), k/v (B,Sk,KV,dh), mask (B|1, Sq, Sk) bool keep.

    bf16 products, scores rounded to bf16 then softmaxed in f32, the
    probabilities cast back to bf16 for the value product."""
    bq, sq, h, _ = q.shape
    kv = k.shape[2]
    rep = h // kv
    qg = q.reshape(bq, sq, kv, rep, dh)
    scores = torch.einsum("bqkrd,bskd->bkrqs", qg, k).float()
    scores = scores / math.sqrt(dh)
    scores = torch.where(mask[:, None, None, :, :], scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkrqs,bskd->bqkrd", probs, v)
    return out.reshape(bq, sq, h * dh)


def attn_train(p: Attention, x: torch.Tensor, cfg, cos, sin,
               window: int = 0, causal: bool = True) -> torch.Tensor:
    """Full-sequence attention, query-chunked when the sequence is long."""
    b, s, _ = x.shape
    dh = cfg.head_dim
    q, k, v = _qkv(p, x, cfg, cos, sin)
    dev = x.device
    pos = torch.arange(s, device=dev)

    chunk = cfg.attn_chunk
    if s <= 2 * chunk or s % chunk != 0:
        mask = torch.ones((1, s, s), dtype=torch.bool, device=dev)
        if causal:
            mask = mask & (pos[None, :, None] >= pos[None, None, :])
        if window:
            mask = mask & (pos[None, :, None] - pos[None, None, :] < window)
        out = _sdpa(q, k, v, mask, dh)
    elif window and window <= chunk and causal:
        # banded sliding window: a causal query chunk sees only keys in
        # [c*chunk - window + 1, c*chunk + chunk), so each chunk takes a
        # (window + chunk) K/V band; K/V are front-padded so the band never
        # clamps, and padded keys (kpos < 0) are masked out
        band = window + chunk
        kp = F.pad(k, (0, 0, 0, 0, window, 0))
        vp = F.pad(v, (0, 0, 0, 0, window, 0))
        outs = []
        for q0 in range(0, s, chunk):
            qpos = q0 + torch.arange(chunk, device=dev)
            kpos = q0 - window + torch.arange(band, device=dev)
            mask = ((qpos[None, :, None] >= kpos[None, None, :])
                    & (qpos[None, :, None] - kpos[None, None, :] < window)
                    & (kpos[None, None, :] >= 0))
            outs.append(_sdpa(q[:, q0:q0 + chunk], kp[:, q0:q0 + band],
                              vp[:, q0:q0 + band], mask, dh))
        out = torch.cat(outs, dim=1)
    else:
        outs = []
        for q0 in range(0, s, chunk):
            qpos = q0 + torch.arange(chunk, device=dev)
            mask = torch.ones((1, chunk, s), dtype=torch.bool, device=dev)
            if causal:
                mask = mask & (qpos[None, :, None] >= pos[None, None, :])
            if window:
                mask = mask & (qpos[None, :, None] - pos[None, None, :]
                               < window)
            outs.append(_sdpa(q[:, q0:q0 + chunk], k, v, mask, dh))
        out = torch.cat(outs, dim=1)
    return dense(out, p.w_o)


def attn_decode(p: Attention, x: torch.Tensor, cache: dict, pos: int, cfg,
                cos, sin, window: int = 0) -> tuple[torch.Tensor, dict]:
    """One-token decode against a fixed-capacity KV cache.

    x (B,1,D); cache {k,v}: (B,Skv,KV,dh), written at ``pos`` (the current
    index) in place.
    """
    dh = cfg.head_dim
    q, k_new, v_new = _qkv(p, x, cfg, cos, sin)
    ck, cv = cache["k"], cache["v"]
    ck[:, pos] = k_new[:, 0].to(ck.dtype)
    cv[:, pos] = v_new[:, 0].to(cv.dtype)
    idx = torch.arange(ck.shape[1], device=x.device)
    keep = idx <= pos
    if window:
        keep = keep & (idx > pos - window)
    out = _sdpa(q, ck, cv, keep[None, None, :], dh)
    return dense(out, p.w_o), cache


def attn_cache_init(cfg, batch: int, s_kv: int, device) -> dict:
    kv, dh = cfg.kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((batch, s_kv, kv, dh), dtype=COMPUTE_DTYPE,
                         device=device),
        "v": torch.zeros((batch, s_kv, kv, dh), dtype=COMPUTE_DTYPE,
                         device=device),
    }


# ----------------------------------------------------------------- MLP ----
class MLP(nn.Module):
    """``mlp_init``: gated (w_gate, w_up, w_down) or GELU (w_up, w_down)."""

    def __init__(self, cfg, generator, device):
        super().__init__()
        self.cfg = cfg
        d, f = cfg.d_model, cfg.d_ff
        if cfg.gated_mlp:
            self.w_gate = _init(generator, (d, f), device)
        self.w_up = _init(generator, (d, f), device)
        self.w_down = _init(generator, (f, d), device)

    def forward(self, x):
        return mlp_apply(self, x, self.cfg)


def mlp_apply(p: MLP, x: torch.Tensor, cfg) -> torch.Tensor:
    if hasattr(p, "w_gate"):
        h = F.silu(dense(x, p.w_gate)) * dense(x, p.w_up)
    else:
        # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(dense(x, p.w_up), approximate="tanh")
    return dense(h, p.w_down)


# ----------------------------------------------------------------- MoE ----
class MoE(nn.Module):
    """``moe_init``: router moe_gate (D, E) and expert stacks (E, D, F)."""

    def __init__(self, cfg, generator, device):
        super().__init__()
        self.cfg = cfg
        d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
        self.moe_gate = _init(generator, (d, e), device)
        self.moe_wg = _init(generator, (e, d, f), device)
        self.moe_wu = _init(generator, (e, d, f), device)
        self.moe_wd = _init(generator, (e, f, d), device)

    def forward(self, x):
        return moe_apply(self, x, self.cfg)


def moe_groups(cfg, t: int) -> tuple[int, int, int]:
    """(groups, tokens a group, capacity a group and expert) for t tokens:
    ``cfg.moe_group`` tokens a group, one group when it is 0 or does not
    divide t."""
    grp = cfg.moe_group
    tb = grp if grp and t % grp == 0 else t
    cap = max(1, int(cfg.capacity_factor * tb * cfg.moe_top_k
                     / cfg.n_experts))
    return t // tb, tb, cap


def moe_route(p: MoE, xt: torch.Tensor, cfg, cap: int):
    """Top-k routing of grouped tokens xt (G, TB, D): the renormalised
    top-k probabilities, experts (G, TB, K) int64, each (token, rank)'s
    one-hot expert (G, TB, K, E) and slot in its expert's queue, and the
    keep mask (slot < ``cap``).

    Experts come from a stable descending sort, so a tie between router
    probabilities goes to the lower expert index, as ``lax.top_k`` breaks
    it; queue slots count in the flattened (token, rank) order."""
    g, tb, _ = xt.shape
    e, k = cfg.n_experts, cfg.moe_top_k
    logits = dense(xt, p.moe_gate).float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[..., :k], top_e[..., :k]
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    # a comparison with the expert ids, not F.one_hot, whose CPU form
    # checks the ids' range on the host and whose meta form is other ops:
    # every device then dispatches (and the dry run counts) the same ops
    experts = torch.arange(e, device=top_e.device)
    onehot = (top_e[..., None] == experts).float()
    flat = onehot.reshape(g, tb * k, e)
    pos_in_e = (flat.cumsum(1) - flat).reshape(g, tb, k, e)
    pos = (pos_in_e * onehot).sum(-1)
    return top_p, top_e, onehot, pos, pos < cap


def moe_apply(p: MoE, x: torch.Tensor, cfg) -> torch.Tensor:
    """Capacity-based top-k MoE with one-hot dispatch einsums.

    Routing is block-local (``cfg.moe_group`` tokens a group, the
    GSPMD-MoE / Switch "group size"): capacity applies within each group,
    so the dispatch/combine tensors are (G, TB, E, CB) with CB proportional
    to TB; ``moe_group=0``, or a token count it does not divide, gives one
    group.
    """
    b, s, d = x.shape
    g, tb, cap = moe_groups(cfg, b * s)
    xt = x.reshape(g, tb, d)

    top_p, _, onehot, pos, keep = moe_route(p, xt, cfg, cap)
    gate = torch.where(keep, top_p, 0.0)
    # a slot at or past the capacity has an all-zero one-hot row
    cap_oh = (pos.long()[..., None]
              == torch.arange(cap, device=x.device)).float()
    dispatch = torch.einsum("gtke,gtkc->gtec", onehot * keep[..., None],
                            cap_oh)
    combine = torch.einsum("gtke,gtkc,gtk->gtec", onehot, cap_oh, gate)

    xe = torch.einsum("gtec,gtd->gecd", dispatch.to(x.dtype), xt)
    hg = F.silu(torch.einsum("gecd,edf->gecf", xe, p.moe_wg.to(x.dtype)))
    hu = torch.einsum("gecd,edf->gecf", xe, p.moe_wu.to(x.dtype))
    ye = torch.einsum("gecf,efd->gecd", hg * hu, p.moe_wd.to(x.dtype))
    y = torch.einsum("gtec,gecd->gtd", combine.to(x.dtype), ye)
    return y.reshape(b, s, d)
