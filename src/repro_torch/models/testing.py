"""Seeded inputs for holding the LM stack against ``repro`` and the card
against the CPU: parameter trees with every leaf drawn (the constant
initialisations too, so token shift, the RWKV bonus, the SSM decay and the
norms are not identities), the families' extra inputs, and the tolerance.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from repro_torch.convert import stack_tree
import torch.nn.functional as F

from repro_torch.models.layers import MoE, dense, moe_groups, moe_route
from repro_torch.models.transformer import Model, forward

# logits, caches and losses of a bf16 forward, as f32: the reference's own
# bound for bf16 attention
LM_RTOL, LM_ATOL = 2e-2, 2e-2
# the hybrid family's Mamba2 block rounds its f32 SSD output to bf16 and then
# normalises it (the gated RMSNorm) by the RMS of that small output, which
# turns a one-ulp rounding difference into ~1e-2 of the block's output:
# repro's own jitted and eager forms differ by as much
HYBRID_ATOL = 3e-2
LM_TOLERANCE = ("rtol 2e-2, atol 2e-2 on f32-cast bf16 outputs (hybrid: "
                "atol 3e-2)")
# a model at full width (qwen3-1.7b: 28 blocks, d_model 2048): the bf16
# residual stream gathers ~0.1% of rounding a block, 2.3% of the hidden
# state after the last, and the logits of a bf16 forward stray from an f32
# forward's by up to 0.153 (tools/lm_precision.py on an H100).  Two bf16
# paths through the same weights (decode steps and one train-mode forward,
# or the card and the CPU) are held within twice that.
FULL_WIDTH_TOL = (2e-2, 0.3)
FULL_WIDTH_TOLERANCE = "rtol 2e-2, atol 0.3 on f32-cast bf16 logits"
# a router-logit gap at the top-k boundary below which the bf16 rounding
# noise of the hidden state can flip an expert choice
ROUTING_GAP = 4e-3

_NORMS = ("ln", "ln1", "ln2", "ln3", "final_norm", "enc_norm", "q_norm",
          "k_norm", "ssm_norm", "tm_norm")


def draw_leaf(name: str, shape, rng: np.random.Generator) -> np.ndarray:
    """One parameter leaf, by the reference's key: weights N(0, 0.02), the
    conv N(0, 0.2), norm scales N(0, 0.1), token-shift mixes U(0, 1), the
    SSM's A_log and dt_bias N(0, 0.5) and D_skip 1 + N(0, 0.1), RWKV's w0
    -1 + N(0, 0.5) and bonus N(0, 0.5)."""
    if name == "conv_w":
        a = rng.normal(0.0, 0.2, shape)
    elif name in _NORMS:
        a = rng.normal(0.0, 0.1, shape)
    elif name.startswith(("mu_", "cmu_")):
        a = rng.uniform(0.0, 1.0, shape)
    elif name in ("A_log", "dt_bias", "u_bonus"):
        a = rng.normal(0.0, 0.5, shape)
    elif name == "D_skip":
        a = 1.0 + rng.normal(0.0, 0.1, shape)
    elif name == "w0":
        a = -1.0 + rng.normal(0.0, 0.5, shape)
    else:
        a = rng.normal(0.0, 0.02, shape)
    return a.astype(np.float32)


def random_params(cfg, seed: int) -> dict:
    """``repro``'s parameter tree for ``cfg`` (nested dicts of f32 numpy
    arrays, stacked layers), every leaf drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    meta = Model(cfg, None, torch.device("meta"))
    return stack_tree(
        (key, draw_leaf(key.rsplit(".", 1)[-1], tuple(t.shape), rng))
        for key, t in meta.state_dict().items())


def random_extras(cfg, batch: int, rng: np.random.Generator) -> dict:
    """The family's extra inputs as f32 numpy: encoder ``frames`` (encdec)
    and ``vision`` patch embeddings (VLM), N(0, 1)."""
    out = {}
    if cfg.family == "encdec":
        out["frames"] = rng.normal(
            0.0, 1.0, (batch, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    if cfg.mrope_sections:
        out["vision"] = rng.normal(
            0.0, 1.0, (batch, cfg.vision_tokens, cfg.d_model)).astype(
                np.float32)
    return out


def tolerance(cfg) -> tuple[float, float]:
    """(rtol, atol) for ``cfg``'s family."""
    return LM_RTOL, (HYBRID_ATOL if cfg.family == "hybrid" else LM_ATOL)


def held_positions(logits: torch.Tensor, cfg, tol=None) -> torch.Tensor:
    """Where an argmax is decided beyond the tolerance (``tol`` = (rtol,
    atol), by default the family's): the top-2 margin exceeds the two
    logits' bounds together, so two outputs within the tolerance of each
    other agree on the argmax."""
    rtol, atol = tol or tolerance(cfg)
    top = logits.float().topk(2, dim=-1).values
    bound = atol + rtol * top.abs()
    return top[..., 0] - top[..., 1] > bound.sum(-1)


@contextlib.contextmanager
def ambiguous_routing(model: Model, off: torch.Tensor | None = None):
    """Collect, after each MoE layer call of ``model`` under the context,
    the (B, S) tokens whose output another rounding of the same forward may
    change beyond the tolerance (the last entry covers the whole forward):

    * a token whose k-th and (k+1)-th router logits lie within
      ``ROUTING_GAP``, an
      expert choice that a one-ulp change of the hidden state may flip (an
      order swap inside the top k changes nothing: the combine sums over
      ranks and the token keeps its place in every expert's queue);
    * a token off in an earlier layer (or in ``off``, e.g. an earlier decode
      step), whose hidden state, and so routing, differs;
    * a later token of the same group with an entry within c slots of the
      capacity in an expert whose queue c such earlier tokens may lengthen
      or shorten (the capacity may then drop or keep it the other way).
    """
    found: list[torch.Tensor] = []

    def hook(mod, args, _out):
        x = args[0]
        b, s, d = x.shape
        cfg, k = mod.cfg, mod.cfg.moe_top_k
        g, tb, cap = moe_groups(cfg, b * s)
        xt = x.reshape(g, tb, d)
        _, _, onehot, pos, _ = moe_route(mod, xt, cfg, cap)
        top = dense(xt, mod.moe_gate).float().topk(k + 1, dim=-1)
        amb = top.values[..., k - 1] - top.values[..., k] < ROUTING_GAP
        prior = found[-1] if found else off
        prior = (torch.zeros((g, tb), dtype=torch.bool) if prior is None
                 else prior.reshape(g, tb)).to(x.device)
        e = cfg.n_experts
        pair = (F.one_hot(top.indices[..., k - 1], e)
                + F.one_hot(top.indices[..., k], e))
        moved = (pair * amb[..., None] + prior[..., None]).float()
        shift = moved.cumsum(1) - moved  # earlier tokens only
        c = (onehot * shift[:, :, None, :]).sum(-1)  # per (token, rank)
        near = (c > 0) & (pos >= cap - c) & (pos < cap + c)
        found.append((prior | amb | near.any(-1)).reshape(b, s).cpu())

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, MoE)]
    try:
        yield found
    finally:
        for h in handles:
            h.remove()


def generated_held(model: Model, cfg, tokens: torch.Tensor, s0: int,
                   extras: dict | None = None) -> torch.Tensor:
    """(B, n_new) bool on the CPU: where ``model``'s teacher-forced logits
    over ``tokens`` (B, s0 + n_new) decide each new token beyond the
    tolerance (``held_positions``) with no ambiguous expert choice at that
    position."""
    with torch.inference_mode(), ambiguous_routing(model) as found:
        logits, _ = forward(model, cfg, tokens, mode="train",
                            **(extras or {}))
    held = held_positions(logits[:, s0 - 1:-1], cfg).cpu()
    if found:
        held &= ~found[-1][:, s0 - 1:-1]
    return held


def compare_generated(got: torch.Tensor, want: torch.Tensor, s0: int,
                      held: torch.Tensor) -> tuple[int, bool]:
    """Hold two generations' new tokens equal in each row up to the first
    position not held (after it the sequences may part): (positions
    compared, whether they all agree)."""
    got, want = got.cpu(), want.cpu()
    compared, ok = 0, True
    for row in range(held.shape[0]):
        h = held[row]
        n = int(h.long().argmin()) if not bool(h.all()) else h.numel()
        ok &= torch.equal(got[row, s0:s0 + n], want[row, s0:s0 + n])
        compared += n
    return compared, ok
