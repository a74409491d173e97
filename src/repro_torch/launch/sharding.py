"""Partitioning rules: params (FSDP+TP), optimizer state, inputs, KV caches
(counterpart of ``repro.launch.sharding``).

Axis meaning, as in ``repro``:
  "pod"   — pure DP across pods (slow links: gradient all-reduce only)
  "data"  — DP for activations, FSDP shard axis for params/optimizer
  "model" — TP: heads / d_ff / experts / vocab; SP fallback for KV seq

The port has no ``PartitionSpec``: a spec is a plain tuple with one entry a
dimension, each ``None`` (replicated), an axis name, or a tuple of two or
more axis names (the dimension split over their product); as in a
``PartitionSpec``, one axis is written as its name and none as ``None``.
A spec shorter than its
tensor leaves the trailing dimensions replicated, as a ``PartitionSpec``
does.  The port runs no partitioned program; the specs size what each
device of a mesh would hold (:func:`shard_shape`, :func:`shard_bytes`).

The port's parameters are per layer (``Model.named_parameters()``, layer
indices in the name) where ``repro`` stacks a segment's layers on leading
axes, so a parameter's spec is ``repro``'s with the stack dimensions
dropped.  The caches keep ``repro``'s stacked layout, and their specs are
``repro``'s.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from repro_torch.launch.mesh import DeviceMesh
from repro_torch.train.optimizer import AdamWState

# trailing-dims spec per leaf name; extra leading dims get None.
_RULES: dict[str, tuple] = {
    # embeddings
    "embed": ("model", "data"),
    "unembed": ("data", "model"),
    # attention
    "w_q": ("data", "model"),
    "w_k": ("data", "model"),
    "w_v": ("data", "model"),
    "w_o": ("model", "data"),
    "b_q": ("model",),
    "b_k": ("model",),
    "b_v": ("model",),
    # dense mlp
    "w_gate": ("data", "model"),
    "w_up": ("data", "model"),
    "w_down": ("model", "data"),
    # moe (experts over "model" = EP)
    "moe_gate": ("data", None),
    "moe_wg": ("model", "data", None),
    "moe_wu": ("model", "data", None),
    "moe_wd": ("model", None, "data"),
    # mamba2
    "in_proj": ("data", "model"),
    "conv_w": (None, "model"),
    "A_log": ("model",),
    "D_skip": ("model",),
    "dt_bias": ("model",),
    "ssm_norm": ("model",),
    "out_proj": ("model", "data"),
    # rwkv6
    "w_r": ("data", "model"),
    "w_g": ("data", "model"),
    "w_lora_a": ("data", None),
    "w_lora_b": (None, "data"),
    "u_bonus": ("model", None),
    "cw_k": ("data", "model"),
    "cw_v": ("model", "data"),
    "cw_r": ("data", "model"),
}
# name fragments of the leaves that stay replicated (``repro`` keeps the
# list beside its rules; a leaf without a rule is replicated either way)
_REPLICATED_HINTS = (
    "ln", "norm", "scale", "mu_", "cmu_", "w0", "final", "b_", "q_norm",
    "k_norm", "step",
)


def _padded(ndim: int, trailing: tuple) -> tuple:
    """``trailing`` behind enough ``None``s to fill ``ndim`` entries."""
    return (None,) * (ndim - len(trailing)) + tuple(trailing)


def spec_for_leaf(name: str, shape) -> tuple:
    """The spec of the parameter ``name`` (a dotted parameter name; its
    last component is the leaf name) of ``shape``: the rule's trailing
    axes, replicated where the leaf has no rule or fewer dimensions than
    its rule."""
    ndim = len(shape)
    rule = _RULES.get(name.rsplit(".", 1)[-1])
    if rule is None or ndim < len(rule):
        return (None,) * ndim
    return _padded(ndim, rule)


def param_specs(model) -> dict[str, tuple]:
    """{parameter name: spec} of a ``Model`` (or a dict of tensors by
    name)."""
    named = (model.named_parameters() if isinstance(model, nn.Module)
             else model.items())
    return {k: spec_for_leaf(k, p.shape) for k, p in named}


def opt_specs(pspecs: dict[str, tuple]) -> AdamWState:
    """AdamW m/v mirror the param sharding; step is replicated."""
    return AdamWState(step=(), m=dict(pspecs), v=dict(pspecs))


def _dp_axes(mesh: DeviceMesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _entry(axes) -> str | tuple | None:
    """A spec entry for ``axes``: ``None``, the one name, or the tuple."""
    axes = tuple(axes)
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else axes


def batch_spec(global_batch: int, mesh: DeviceMesh) -> tuple:
    """Shard the batch over ("pod","data") when divisible, else best effort."""
    size = 1
    use = []
    for a in _dp_axes(mesh):
        if global_batch % (size * mesh.shape[a]) == 0:
            use.append(a)
            size *= mesh.shape[a]
    return (_entry(use),)


def cache_specs(caches, cfg, mesh: DeviceMesh, batch: int):
    """KV/state cache sharding with head-vs-sequence fallback, over the
    tree of ``transformer.init_caches`` (the same tree of specs).

    * batch axis over ("pod","data") when divisible; otherwise the sequence
      axis takes "data" (long-context, batch=1).
    * kv-head axis over "model" when divisible; otherwise the sequence axis
      takes "model" (sequence-parallel attention).
    """
    tp = mesh.shape["model"]
    dp_axes = _dp_axes(mesh)
    dp = math.prod(mesh.shape[a] for a in dp_axes)
    batch_ok = batch % dp == 0 and batch >= dp
    b_ax = _entry(dp_axes) if batch_ok else None

    def leaf_spec(name, leaf):
        nd = leaf.dim()
        if name in ("k", "v"):  # (B, S, KV, dh)
            if leaf.shape[-2] % tp == 0:
                seq_ax = None if batch_ok else "data"
                return _padded(nd, (b_ax, seq_ax, "model", None))
            seq_ax = "model" if batch_ok else ("data", "model")
            return _padded(nd, (b_ax, seq_ax, None, None))
        if name == "conv":  # (B, W-1, C)
            return _padded(nd, (b_ax, None, "model"))
        if name in ("ssm", "tm_state"):  # (B, H, N, P) / (B, H, P, P)
            return _padded(nd, (b_ax, "model", None, None))
        if name in ("tm_xprev", "cm_xprev"):  # (B, D)
            return _padded(nd, (b_ax, "model"))
        return (None,) * nd

    def walk(tree, name=""):
        if tree is None:
            return None
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        return leaf_spec(name, tree)

    return walk(caches)


def index_row_spec() -> tuple:
    """Row-partition spec for ShardedIndex stores (codes / clouds / ids).

    One contiguous block of corpus rows per device of the flattened
    ("row", "col") index mesh — shard ``p`` owns rows
    ``[p·per, (p+1)·per)``, which is also the owner rule the serve-level
    re-rank uses to scatter cloud gathers back to shards.
    """
    return (("row", "col"), None)


def index_gram_specs() -> tuple[tuple, tuple, tuple]:
    """(corpus, queries, out) specs of the SUMMA distributed Gram.

    Corpus rows shard over "row" and the embedding width over "col";
    query blocks start "row"-sharded and step around the ring; the (Q, N)
    output is row-group sharded over "row" and replicated over "col"
    (each column already holds the full-width sum).
    """
    return ("row", "col"), ("row", "col"), (None, "row")


def shard_shape(shape, spec: tuple, mesh: DeviceMesh) -> tuple[int, ...]:
    """The local shape one device of ``mesh`` holds of a ``shape`` array
    laid out by ``spec``, as ``NamedSharding.shard_shape`` computes it; a
    dimension its axes do not divide raises ``ValueError``."""
    shape = tuple(int(s) for s in shape)
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than shape {shape}")
    out = []
    for i, size in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        parts = math.prod(mesh.shape[a] for a in axes)
        if size % parts:
            raise ValueError(
                f"spec {spec} splits axis {i} of {shape} {parts} ways, "
                f"which does not divide {size}")
        out.append(size // parts)
    return tuple(out)


def _leaf_pairs(tree, specs):
    """(tensor, spec) for every tensor of ``tree`` (a tensor, a tuple or
    list, a dict, a dataclass, a ``Module`` by parameter name; ``None`` and
    Python scalars hold none), ``specs`` shaped as the tree with a spec
    tuple at each tensor."""
    if tree is None or isinstance(tree, (bool, int, float)):
        return
    if isinstance(tree, torch.Tensor):
        yield tree, specs
    elif isinstance(tree, (tuple, list)):
        for t, s in zip(tree, specs, strict=True):
            yield from _leaf_pairs(t, s)
    elif isinstance(tree, nn.Module):
        for k, p in tree.named_parameters():
            yield p, specs[k]
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaf_pairs(v, specs[k])
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _leaf_pairs(getattr(tree, f.name),
                                   getattr(specs, f.name))
    else:
        raise TypeError(f"no tensors in a {type(tree).__name__}")


def shard_bytes(tree, specs, mesh: DeviceMesh) -> int:
    """The bytes one device of ``mesh`` holds of ``tree`` laid out by
    ``specs`` (see :func:`_leaf_pairs` for the tree forms)."""
    return sum(math.prod(shard_shape(t.shape, s, mesh)) * t.element_size()
               for t, s in _leaf_pairs(tree, specs))
