"""Holding a train step on two executions (the two packages, or the card
and the CPU port): the tolerances, the per-leaf measures, and one
``make_train_step`` from a numpy tree on two devices.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import convert
from repro_torch.models.transformer import Model
from repro_torch.train.optimizer import adamw_init
from repro_torch.train.train_step import (
    TrainState, accumulate_grads, make_train_step)

# a train step from one parameter tree through two bf16 executions: the
# loss and the global gradient norm, and each gradient leaf by its relative
# Frobenius error.  The hybrid family's SSM constants (dt_bias, A_log,
# D_skip) take their gradients through the gated RMSNorm's amplified
# rounding (``models.testing.HYBRID_ATOL``): up to 6.3% there on the CPU
# against repro, 1.9% elsewhere.
TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL = 1e-4, 1e-3
GRAD_REL, HYBRID_GRAD_REL = 3e-2, 0.1
# an update after k <= 3 AdamW steps, leaf by leaf: within UPDATE_REL
# relative Frobenius error, and at least SAME_SIGN of the elements moving
# the same way.  AdamW's first steps are close to lr * sign(g), so an
# element whose gradient lies within the rounding noise moves by the full
# rate either way: where both executions' gradients are known, the update
# is held only where the gradient decides its sign (beyond DECIDED_SIGMAS
# times the leaf's RMS gradient difference, or where both gradients are
# equal), and that must be at least MIN_DECIDED of the leaf's elements.
# The error over all of a leaf's elements is reported beside it: after one
# step it reads up to 0.73 on the CPU against repro (qwen2-vl's b_k, whose
# gradient lies within the noise in 55% of its elements).
UPDATE_REL, SAME_SIGN, DECIDED_SIGMAS, MIN_DECIDED = 0.25, 0.98, 3.0, 0.2
TRAIN_TOLERANCE = (
    "loss rtol 1e-4, grad norm rtol 1e-3, each gradient leaf's relative "
    "Frobenius error <= 3e-2 (hybrid 0.1); each leaf's update <= 0.25 "
    "relative Frobenius with >= 98% of its elements the same sign, where "
    "the gradient decides the sign (>= 20% of every leaf; the error over "
    "all elements reported)")

# one gradient of a model at full width (qwen3-1.7b), card against the CPU
# port, per leaf (relative Frobenius): the bf16 rounding the residual stream
# gathers over 28 blocks (``models.testing.FULL_WIDTH_TOL``) reaches every
# gradient leaf; a 16-token sequence on an H100 read 6.48% at most (the
# last block's k_norm), 3.89% at the median
FULL_WIDTH_GRAD_REL = 0.1


def grad_tolerance(cfg) -> float:
    """The relative Frobenius bound on a gradient leaf for ``cfg``'s
    family."""
    return HYBRID_GRAD_REL if cfg.family == "hybrid" else GRAD_REL


def rel_frobenius(got: np.ndarray, want: np.ndarray) -> float:
    """||got - want|| / ||want|| (the plain norm of got where want is 0)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    den = np.linalg.norm(want)
    num = np.linalg.norm(got - want)
    return float(num / den) if den > 0 else float(num)


def update_agreement(before, got, want, g_got=None,
                     g_want=None) -> dict[str, float]:
    """One leaf's update ``got - before`` against ``want - before``:
    ``rel`` (relative Frobenius error) and ``same`` (share of the moved
    elements moving the same way) over the elements held, ``held`` (their
    share of the leaf) and ``rel_all`` (the error over every element).
    With both executions' gradients ``g_got``, ``g_want``, an element is
    held where its gradient decides the sign: |g_want| beyond
    DECIDED_SIGMAS times the RMS of ``g_got - g_want``, or the two
    gradients equal (an embedding row no token reached); else every
    element is."""
    before = np.asarray(before, np.float32)
    dg = np.asarray(got, np.float32) - before
    dw = np.asarray(want, np.float32) - before
    rel_all = rel_frobenius(dg, dw)
    if g_want is not None:
        g_got = np.asarray(g_got, np.float32)
        g_want = np.asarray(g_want, np.float32)
        noise = np.sqrt(np.mean(np.square(
            g_got.astype(np.float64) - g_want)))
        keep = (np.abs(g_want) > DECIDED_SIGMAS * noise) | (g_got == g_want)
        dg, dw = dg[keep], dw[keep]
    moved = (dg != 0) | (dw != 0)
    same = (float(np.mean(np.sign(dg[moved]) == np.sign(dw[moved])))
            if moved.any() else 1.0)
    return {"rel": rel_frobenius(dg, dw), "same": same,
            "held": dg.size / max(before.size, 1), "rel_all": rel_all}


def update_ok(agree: dict[str, float]) -> bool:
    """One leaf's ``update_agreement`` within ``TRAIN_TOLERANCE``."""
    return (agree["rel"] <= UPDATE_REL and agree["same"] >= SAME_SIGN
            and agree["held"] >= MIN_DECIDED)


def train_step_agreement(cfg, tree: dict, batch: dict, devices,
                         grad_accum: int = 2, base_lr: float = 1e-3,
                         extra_keys: tuple[str, ...] = ()) -> dict:
    """One ``make_train_step`` from the numpy tree ``tree`` on each of
    ``devices`` = (got, want), e.g. (the card, the CPU), on the numpy
    ``batch``; held to ``TRAIN_TOLERANCE``.  Returns the losses, grad
    norms, the worst gradient leaf's relative error, the worst of each
    leaf's ``update_agreement`` (with both gradients), and ``ok``."""
    out = []
    for dev in devices:
        b = {k: torch.from_numpy(np.asarray(v)).to(dev)
             for k, v in batch.items()}
        model = convert.lm_params_from_numpy(tree, cfg, device=dev)
        grads, _ = accumulate_grads(model, cfg, b, grad_accum, extra_keys)
        grads = {k: v.cpu().numpy() for k, v in grads.items()}
        state = TrainState(params=model, opt=adamw_init(model))
        state, metrics = make_train_step(cfg, grad_accum, base_lr,
                                         extra_keys)(state, b)
        params = {k: v.detach().cpu().numpy()
                  for k, v in state.params.state_dict().items()}
        out.append((grads, params, {k: v.item() for k, v in
                                    metrics.items()}))
    (g_got, p_got, m_got), (g_want, p_want, m_want) = out
    before = _named_leaves(tree, cfg)
    grad_rel = max(rel_frobenius(g_got[k], g_want[k]) for k in g_want)
    upd = [update_agreement(before[k], p_got[k], p_want[k], g_got[k],
                            g_want[k]) for k in p_want]
    finite = all(np.isfinite(v).all() for v in list(g_got.values())
                 + list(p_got.values()))
    ok = (finite
          and np.isclose(m_got["loss"], m_want["loss"], rtol=TRAIN_LOSS_RTOL,
                         atol=0)
          and np.isclose(m_got["grad_norm"], m_want["grad_norm"],
                         rtol=TRAIN_GNORM_RTOL, atol=0)
          and grad_rel <= grad_tolerance(cfg)
          and all(update_ok(u) for u in upd))
    return {"loss": [m_got["loss"], m_want["loss"]],
            "grad_norm": [m_got["grad_norm"], m_want["grad_norm"]],
            "lr": [m_got["lr"], m_want["lr"]],
            "grad_rel": grad_rel,
            "update_rel": max(u["rel"] for u in upd),
            "same_sign": min(u["same"] for u in upd),
            "held": min(u["held"] for u in upd),
            "update_rel_all": max(u["rel_all"] for u in upd),
            "ok": bool(ok)}


def _named_leaves(tree: dict, cfg) -> dict:
    """{state-dict key: f32 numpy array} of ``repro``'s tree (one layer of
    a stack a key)."""
    meta = Model(cfg, None, torch.device("meta"))
    flat = dict(convert._leaves(tree))
    out = {}
    for key in meta.state_dict():
        path, idx = convert._tree_path(key)
        out[key] = np.asarray(flat[path], np.float32)[idx]
    return out
