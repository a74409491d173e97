"""AdamW with f32 state, and int8 gradient compression with error feedback
(counterpart of ``repro.train.optimizer``).

The state is keyed by parameter name (``Model.named_parameters()``, whose
names are ``repro``'s tree paths with the stacked layer indices), where
``repro`` keeps pytrees shaped like the parameters.  The update is
``repro``'s formula in ``repro``'s order, ``m̂ / (sqrt(v̂) + eps) + wd·p``
with ``v̂ = v / bc2``; ``torch.optim.AdamW`` places eps and the bias
correction elsewhere and decays the weights first, so it is another
function.  Divisions by a value ``repro`` holds in f32 divide by an f32
tensor on the parameters' device: a CUDA division by a Python scalar
multiplies by its reciprocal, which rounds differently.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn


@dataclasses.dataclass
class AdamWState:
    """``step``: int32 scalar tensor; ``m``, ``v``: f32 tensors by
    parameter name."""

    step: torch.Tensor
    m: dict[str, torch.Tensor]
    v: dict[str, torch.Tensor]


def named_params(params) -> dict[str, torch.Tensor]:
    """``params`` (an ``nn.Module`` or a dict of tensors) by name."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def adamw_init(params) -> AdamWState:
    """Zero f32 moments beside every parameter, step 0."""
    named = named_params(params)
    dev = next(iter(named.values())).device
    m = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in named.items()}
    v = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in named.items()}
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=m, v=v)


def _f32(x: float, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def lr_schedule(step: torch.Tensor, base_lr=3e-4, warmup=100,
                total=10_000) -> torch.Tensor:
    """Linear warm-up to ``base_lr`` over ``warmup`` steps, then a cosine
    to 0 at ``total``; ``step`` an int32 tensor, the rate an f32 one.

    In the form XLA compiles ``repro``'s schedule to, which its jitted
    train step runs: the constant quotients folded in f32
    (``base_lr / warmup``, ``1 / (total - warmup)``) and multiplied in, so
    the warm-up rate equals that step's bit for bit; past the warm-up the
    two packages' cosines may differ in the last bit.  ``repro``'s
    schedule run op by op divides instead, and differs from the jitted
    one in the last bit at some steps."""
    dev = step.device
    warm_rate = np.float32(base_lr) / np.float32(warmup)
    inv_span = np.float32(1.0) / np.float32(max(total - warmup, 1))
    warm = (step + 1).float() * _f32(warm_rate, dev)
    prog = torch.clamp((step - warmup).float() * _f32(inv_span, dev),
                       0.0, 1.0)
    cos = (torch.cos(prog * _f32(math.pi, dev)) + 1.0) * _f32(
        base_lr * 0.5, dev)
    return torch.where(step < warmup, warm, cos).float()


@torch.no_grad()
def adamw_update(grads: dict[str, torch.Tensor], state: AdamWState, params,
                 base_lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
                 warmup=100, total=10_000):
    """One AdamW step: returns (params, the new state, the learning rate).

    The parameters and the moments are updated in place (``repro``'s jitted
    step donates its state); the new state shares the moment tensors and
    holds ``step + 1``."""
    named = named_params(params)
    step = state.step + 1
    dev = step.device
    lr = lr_schedule(step, base_lr, warmup, total)
    sf = step.float()
    bc1 = 1.0 - torch.pow(_f32(b1, dev), sf)
    bc2 = 1.0 - torch.pow(_f32(b2, dev), sf)
    for k, g in grads.items():
        p, m, v = named[k], state.m[k], state.v[k]
        g = g.float()
        m.mul_(b1).add_(g * (1 - b1))
        v.mul_(b2).add_(g * (1 - b2) * g)
        upd = (m / bc1) / (torch.sqrt(v / bc2) + eps) + weight_decay * p
        p.sub_(lr * upd)
    return params, AdamWState(step=step, m=state.m, v=state.v), lr


# ------------------------------------------------ gradient compression ----
def quantize_int8(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization: (q, f32 scale)."""
    amax = torch.clamp_min(g.abs().max(), 1e-12)
    scale = (amax / _f32(127.0, g.device)).float()
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_psum(grads_per_pod: list[torch.Tensor],
                    errors: list[torch.Tensor]):
    """int8 exchange with error feedback across pods, in pod order.

    Pod i sends ``deq_i``, the int8 fidelity of its gradient plus its
    residual ``errors[i]``; returns (the sum of the ``deq_i`` in pod
    order, each pod's new residual).  ``repro``'s ``psum`` of the
    dequantised values over the pod axis is the same sum; on real links
    the payload is the int8 tensor and one f32 scale."""
    total, new_errors = None, []
    for g, err in zip(grads_per_pod, errors, strict=True):
        g_fb = g.float() + err
        deq = dequantize_int8(*quantize_int8(g_fb))
        new_errors.append(g_fb - deq)
        total = deq if total is None else total + deq.to(total.device)
    return total, new_errors
