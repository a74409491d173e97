"""The training step (counterpart of ``repro.train.train_step``): gradient
accumulation over microbatches, the global-norm clip, the AdamW update, and
the cross-pod step with int8 gradient exchange.

``repro`` scans the microbatches inside one jitted function whose
parallelism comes from the launch layer's shardings; here the microbatches
run one after another on the state's device, each backward through the
model's per-block recomputation (``transformer.forward`` in train mode
under grad).
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch._device import device_context, same_device
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig
from repro_torch.train.optimizer import (
    AdamWState, adamw_update, compressed_psum, named_params)


@dataclasses.dataclass
class TrainState:
    params: nn.Module
    opt: AdamWState


def _microbatch(batch: dict, i: int, mb: int) -> dict:
    """Rows [i·mb, (i+1)·mb) of every entry, as ``repro``'s reshape to
    (grad_accum, mb, ...) cuts them."""
    return {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}


def accumulate_grads(params: nn.Module, cfg: ModelConfig, batch: dict,
                     grad_accum: int = 1, extra_keys: tuple[str, ...] = ()):
    """(f32 gradients by parameter name, the mean loss): each
    microbatch's gradient, in f32, is divided by ``grad_accum`` and added
    to a zeroed accumulator, in microbatch order (backpropagating
    ``loss / grad_accum`` would round differently)."""
    named = named_params(params)
    gb = batch["tokens"].shape[0]
    if gb % grad_accum:
        raise ValueError(f"batch {gb} is not a multiple of grad_accum "
                         f"{grad_accum}")
    mb = gb // grad_accum
    dev = batch["tokens"].device
    ga = torch.tensor(float(grad_accum), dtype=torch.float32, device=dev)
    acc = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for k, p in named.items()}
    loss_acc = torch.zeros((), dtype=torch.float32, device=dev)
    for i in range(grad_accum):
        micro = _microbatch(batch, i, mb)
        with torch.enable_grad():
            loss = tf.loss_fn(params, cfg, micro["tokens"],
                              **{k: micro[k] for k in extra_keys})
            grads = torch.autograd.grad(loss, list(named.values()))
        for a, g in zip(acc.values(), grads):
            a.add_(g.float() / ga)
        del grads
        loss_acc = loss_acc + loss.detach() / ga
    return acc, loss_acc


def global_norm(grads: dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum, leaf by leaf in order, of each leaf's f32 sum of
    squares."""
    total = None
    for g in grads.values():
        s = torch.sum(torch.square(g))
        total = s if total is None else total + s
    return torch.sqrt(total)


def clip_by_global_norm(grads: dict[str, torch.Tensor]) -> torch.Tensor:
    """Scale ``grads`` in place to a global norm of at most 1 (``repro``'s
    ``min(1, 1 / max(norm, 1e-6))``); returns the norm before the clip."""
    gnorm = global_norm(grads)
    clip = torch.clamp_max(1.0 / torch.clamp_min(gnorm, 1e-6), 1.0)
    for g in grads.values():
        g.mul_(clip)
    return gnorm


def make_train_step(cfg: ModelConfig, grad_accum: int = 1,
                    base_lr: float = 3e-4, extra_keys: tuple[str, ...] = ()):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    batch: {"tokens": (GB, S)} (+ "frames"/"vision"/"mrope_positions"
    named in ``extra_keys``), GB a multiple of ``grad_accum``.  The state
    is updated in place and returned; metrics are 0-d f32 tensors
    ``loss``, ``grad_norm`` and ``lr`` on the state's device."""

    def train_step(state: TrainState, batch: dict):
        grads, loss = accumulate_grads(state.params, cfg, batch, grad_accum,
                                       extra_keys)
        gnorm = clip_by_global_norm(grads)
        params, opt, lr = adamw_update(grads, state.opt, state.params,
                                       base_lr=base_lr)
        return TrainState(params=params, opt=opt), {
            "loss": loss, "grad_norm": gnorm, "lr": lr}

    return train_step


def _pod_devices(mesh) -> list[torch.device]:
    """The device each pod's shard runs on: the first of its sub-mesh."""
    if "pod" not in mesh.axis_names:
        raise ValueError(f"the mesh has no 'pod' axis: {mesh.axis_names}")
    if mesh.axis_names[0] != "pod":
        raise ValueError("the 'pod' axis must lead the mesh")
    out = []
    for sub in mesh.devices:
        while isinstance(sub, tuple):
            sub = sub[0]
        out.append(sub)
    return out


def _params_on(params: nn.Module, cfg: ModelConfig, dev) -> nn.Module:
    """``params`` itself on its own device, else a copy on ``dev``."""
    if same_device(next(params.parameters()).device, torch.device(dev)):
        return params
    copy = tf.Model(cfg, None, torch.device("meta"))
    copy.load_state_dict({k: v.detach().to(dev) for k, v in
                          params.state_dict().items()}, assign=True)
    return copy


def make_compressed_pod_step(cfg: ModelConfig, mesh, base_lr: float = 3e-4):
    """Cross-pod data parallelism with an int8 + error-feedback gradient
    exchange over the mesh's leading ``"pod"`` axis.

    Returns ``step(state, error, tokens) -> (state, errors, metrics)``.
    The tokens' rows split into one contiguous shard a pod (``repro``'s
    ``P("pod")``); the pods run one after another, each on the first
    device of its sub-mesh, as the sharded plan runs its shards.
    ``error`` is a list of one residual tree (by parameter name) a pod,
    zeros at first (``zero_errors``), and ``errors`` the pods' new ones
    (``repro`` returns pod 0's as its replicated output, and each device
    keeps its own).  A pod on another device than the parameters runs on
    a copy of them there.  The gradients are the exchanged sum over the
    pod count; the loss is the pods' mean.  No clip, as in ``repro``."""
    devices = _pod_devices(mesh)
    n_pods = len(devices)

    def step(state: TrainState, error, tokens: torch.Tensor):
        if tokens.shape[0] % n_pods:
            raise ValueError(f"batch {tokens.shape[0]} does not split over "
                             f"{n_pods} pods")
        if len(error) != n_pods:
            raise ValueError(f"{len(error)} residual trees for {n_pods} pods")
        named = named_params(state.params)
        home = next(iter(named.values())).device
        shard = tokens.shape[0] // n_pods
        per_pod, losses = [], []
        for p, dev in enumerate(devices):
            params = _params_on(state.params, cfg, dev)
            toks = tokens[p * shard:(p + 1) * shard].to(dev)
            with device_context(dev), torch.enable_grad():
                loss = tf.loss_fn(params, cfg, toks)
                g = torch.autograd.grad(loss, list(params.parameters()))
            per_pod.append({k: gi.to(home) for k, gi in zip(named, g)})
            losses.append(loss.detach().to(home))
        n = torch.tensor(float(n_pods), dtype=torch.float32, device=home)
        grads, new_errs = {}, [{} for _ in range(n_pods)]
        for k in named:
            total, res = compressed_psum([g[k] for g in per_pod],
                                         [e[k].to(home) for e in error])
            grads[k] = total / n
            for p in range(n_pods):
                new_errs[p][k] = res[p]
        loss = losses[0]
        for extra in losses[1:]:
            loss = loss + extra
        params, opt, lr = adamw_update(grads, state.opt, state.params,
                                       base_lr=base_lr)
        return (TrainState(params=params, opt=opt), new_errs,
                {"loss": loss / n, "lr": lr})

    return step


def zero_errors(params, n_pods: int) -> list[dict[str, torch.Tensor]]:
    """Zero f32 residuals beside every parameter, one tree a pod (the pod
    step's first ``error``)."""
    return [{k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for k, p in named_params(params).items()}
            for _ in range(n_pods)]
