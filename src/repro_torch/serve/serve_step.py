"""Serving (counterpart of ``repro.serve.serve_step``): prefill + batched
decode built on the model zoo's cache API, under ``torch.inference_mode``.

Caches are updated in place; each step also returns them.
"""
from __future__ import annotations

import torch

from repro_torch._device import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig


def make_prefill_step(cfg: ModelConfig, extra_keys: tuple[str, ...] = ()):
    """``prefill(params, tokens, caches, extras)`` -> (last logits (B, V),
    caches)."""
    def prefill(params, tokens, caches, extras):
        with torch.inference_mode():
            logits, new_caches = tf.forward(
                params, cfg, tokens, mode="prefill", caches=caches,
                **{k: extras[k] for k in extra_keys},
            )
        return logits[:, -1, :], new_caches

    return prefill


def make_decode_step(cfg: ModelConfig, extra_keys: tuple[str, ...] = (),
                     temperature: float = 0.0):
    """``decode(params, tokens, caches, pos, extras, generator)`` -> (next
    tokens (B,) int64, caches): greedy, or at ``temperature > 0`` sampled
    from softmax(logits / temperature) with the caller's generator."""
    def decode(params, tokens, caches, pos, extras, generator=None):
        with torch.inference_mode():
            logits, new_caches = tf.forward(
                params, cfg, tokens, mode="decode", caches=caches, pos=pos,
                **{k: extras[k] for k in extra_keys},
            )
            lg = logits[:, -1, :].float()
            if temperature > 0:
                if generator is None:
                    raise ValueError("sampling needs a torch.Generator")
                probs = torch.softmax(lg / temperature, dim=-1)
                nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
            else:
                nxt = lg.argmax(dim=-1)
        return nxt, new_caches

    return decode


def generate(params, cfg: ModelConfig, prompt: torch.Tensor, max_new: int,
             s_kv: int | None = None, extras: dict | None = None,
             temperature: float = 0.0, generator: torch.Generator | None = None,
             device=None) -> torch.Tensor:
    """Greedy/sampled generation loop (prefill + one decode step a token)
    on ``device`` (CUDA unless ``device="cpu"``), where ``params`` must be.

    prompt (B, S0) integer; returns (B, S0 + max_new) int64.  The first new
    token is the prefill's argmax (for the ssm and hybrid families, the last
    replayed decode step's pick); sampling at ``temperature > 0`` draws from
    ``generator``, which must live on ``device``.
    """
    dev = resolve_device(device)
    held = next(params.parameters()).device
    if held.type != dev.type:
        raise ValueError(f"params are on {held}, generate runs on {dev}")
    if max_new < 1:
        raise ValueError("max_new must be at least 1")
    prompt = prompt.to(dev).long()
    b, s0 = prompt.shape
    s_kv = s_kv or (s0 + max_new)
    extras = {k: v.to(dev) for k, v in (extras or {}).items()}
    extra_keys = tuple(extras)

    prefill = make_prefill_step(cfg, extra_keys)
    decode = make_decode_step(cfg, extra_keys, temperature)
    with torch.inference_mode():
        caches = tf.init_caches(cfg, b, s_kv, device=dev)
        last_logits, caches = prefill(params, prompt, caches, extras)
        # SSM families keep their recurrent state out of the attention KV
        # cache; replaying the prompt through decode keeps every family exact
        if cfg.family in ("ssm", "hybrid"):
            for i in range(s0):
                nxt, caches = decode(params, prompt[:, i:i + 1], caches, i,
                                     extras, generator)
            first = nxt
        else:
            first = last_logits.float().argmax(dim=-1)

        out = torch.cat([prompt, prompt.new_zeros((b, max_new))], dim=1)
        out[:, s0] = first
        tok = first[:, None]
        for t in range(1, max_new):
            tok_next, caches = decode(params, tok, caches, s0 + t - 1,
                                      extras, generator)
            out[:, s0 + t] = tok_next
            tok = tok_next[:, None]
    return out
