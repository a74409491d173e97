"""Carry state between ``repro`` and this package through numpy.

The TDA path has no weights; its state is the ``GraphBatch`` going in, the
``DeltaBatch`` updates of a stream and the ``Diagrams`` coming out.  The LM
stack's state is a model's parameter tree, its decode caches and, in
training, AdamW's moments.  Both packages take and give numpy arrays here,
so neither imports the other.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.delta import DeltaBatch
from repro_torch.core.graph import GraphBatch
from repro_torch.core.persistence import Diagrams, diagrams_to_numpy  # noqa: F401
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Model
from repro_torch.train.optimizer import AdamWState
from repro_torch.train.train_step import TrainState


def graph_batch_from_numpy(adj, mask, f, device=None) -> GraphBatch:
    """A GraphBatch from (B,N,N) bool, (B,N) bool and (B,N) float32 arrays
    (e.g. ``np.asarray`` of a ``repro`` GraphBatch's fields)."""
    dev = resolve_device(device)
    return GraphBatch(
        adj=torch.from_numpy(np.array(adj, dtype=bool)).to(dev),
        mask=torch.from_numpy(np.array(mask, dtype=bool)).to(dev),
        f=torch.from_numpy(np.array(f, dtype=np.float32)).to(dev))


def graph_batch_to_numpy(g: GraphBatch) -> tuple[np.ndarray, ...]:
    """(adj, mask, f) as numpy arrays."""
    return tuple(t.detach().cpu().numpy() for t in (g.adj, g.mask, g.f))


def diagrams_from_numpy(birth, death, dim, valid, device=None) -> Diagrams:
    """Diagrams from (..., S) float32, float32, int32 and bool arrays
    (e.g. ``np.asarray`` of a ``repro`` Diagrams' fields)."""
    dev = resolve_device(device)
    return Diagrams(
        birth=torch.from_numpy(np.array(birth, dtype=np.float32)).to(dev),
        death=torch.from_numpy(np.array(death, dtype=np.float32)).to(dev),
        dim=torch.from_numpy(np.array(dim, dtype=np.int32)).to(dev),
        valid=torch.from_numpy(np.array(valid, dtype=bool)).to(dev))


def diagrams_arrays(d: Diagrams) -> dict[str, np.ndarray]:
    """{birth, death, dim, valid} as numpy arrays."""
    return {k: getattr(d, k).detach().cpu().numpy()
            for k in ("birth", "death", "dim", "valid")}


def delta_batch_from_numpy(edge_u, edge_v, edge_op, f_vertex, f_value,
                           drop_vertex, device=None) -> DeltaBatch:
    """A DeltaBatch from int32 endpoint, op, f-vertex and drop arrays and a
    float32 f-value array, one step (B, slots) or a stream (T, B, slots)
    (e.g. ``np.asarray`` of a ``repro`` DeltaBatch's fields)."""
    dev = resolve_device(device)
    ints = (np.array(x, dtype=np.int32)
            for x in (edge_u, edge_v, edge_op, f_vertex))
    eu, ev, eo, fv = (torch.from_numpy(x).to(dev) for x in ints)
    return DeltaBatch(
        edge_u=eu, edge_v=ev, edge_op=eo, f_vertex=fv,
        f_value=torch.from_numpy(np.array(f_value, dtype=np.float32)).to(dev),
        drop_vertex=torch.from_numpy(
            np.array(drop_vertex, dtype=np.int32)).to(dev))


def delta_batch_to_numpy(d: DeltaBatch) -> tuple[np.ndarray, ...]:
    """(edge_u, edge_v, edge_op, f_vertex, f_value, drop_vertex) as numpy
    arrays."""
    return tuple(getattr(d, k).detach().cpu().numpy()
                 for k in ("edge_u", "edge_v", "edge_op", "f_vertex",
                           "f_value", "drop_vertex"))


# ------------------------------------------------------------ LM stack ----

def _tensor(a) -> torch.Tensor:
    """A numpy array as a tensor; a bfloat16 array (``np.asarray`` of a bf16
    jax array) keeps its bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy; bfloat16 widens to float32 (exactly)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _tree_path(key: str) -> tuple[tuple[str, ...], tuple[int, ...]]:
    """A state-dict key as (the reference tree's path, the layer indices):
    ``segments.seg0_lg_period.2.locals.0.attn.w_q`` is
    ``segments/seg0_lg_period/locals/attn/w_q`` at [2, 0]."""
    parts = key.split(".")
    return (tuple(p for p in parts if not p.isdigit()),
            tuple(int(p) for p in parts if p.isdigit()))


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _state_from_tree(tree: dict, cfg: ModelConfig, dev) -> dict:
    """{state-dict key: f32 tensor on ``dev``} from ``repro``'s tree, with
    every key of the model filled and every leaf of the tree used."""
    flat = dict(_leaves(tree))
    model = Model(cfg, None, torch.device("meta"))
    state, used = {}, set()
    for key, like in model.state_dict().items():
        path, idx = _tree_path(key)
        if path not in flat:
            raise KeyError(f"{key}: no {'/'.join(path)} in the tree")
        t = _tensor(np.asarray(flat[path])[idx]).to(dev)
        if t.shape != like.shape:
            raise ValueError(f"{key}: shape {tuple(t.shape)}, the model "
                             f"wants {tuple(like.shape)}")
        state[key] = t.float()
        used.add(path)
    if used != set(flat):
        raise KeyError(f"leaves the model does not hold: "
                       f"{sorted('/'.join(p) for p in set(flat) - used)}")
    return state


def lm_params_from_numpy(tree: dict, cfg: ModelConfig, device=None) -> Model:
    """A ``Model`` holding ``repro``'s LM parameter tree: nested dicts of
    numpy arrays with a stack's layers on the leading axes
    (``jax.tree.map(np.asarray, params)``).  Weights keep their (d_in,
    d_out) layout; every leaf of the tree must be used."""
    model = Model(cfg, None, torch.device("meta"))
    model.load_state_dict(_state_from_tree(tree, cfg, resolve_device(device)),
                          assign=True)
    return model


def lm_params_to_numpy(model: Model) -> dict:
    """The model's parameters as ``repro``'s tree (stacked layers)."""
    return stack_tree((k, _numpy(t)) for k, t in model.state_dict().items())


def stack_tree(items) -> dict:
    """``repro``'s nested tree from (state-dict key, array) pairs: the
    layers of a stack go onto the leading axes of one array."""
    stacks: dict = {}
    for key, a in items:
        path, idx = _tree_path(key)
        stacks.setdefault(path, {})[idx] = a
    tree: dict = {}
    for path, parts in stacks.items():
        if () in parts:
            arr = parts[()]
        else:
            first = next(iter(parts.values()))
            lead = tuple(max(i[a] for i in parts) + 1
                         for a in range(len(next(iter(parts)))))
            arr = np.empty(lead + first.shape, first.dtype)
            for i, a in parts.items():
                arr[i] = a
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = arr
    return tree


def lm_caches_from_numpy(tree, device=None):
    """``repro``'s decode caches (nested dicts of numpy arrays, stacked
    layers first; ``None`` where the reference has none) as tensors."""
    dev = resolve_device(device)
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: lm_caches_from_numpy(v, dev) for k, v in tree.items()}
    return _tensor(tree).to(dev)


def lm_caches_to_numpy(caches):
    """The port's caches as numpy arrays in the same tree (bfloat16 as
    float32)."""
    if caches is None:
        return None
    if isinstance(caches, dict):
        return {k: lm_caches_to_numpy(v) for k, v in caches.items()}
    return _numpy(caches)


def train_state_from_numpy(params_tree: dict, m_tree: dict, v_tree: dict,
                           step: int, cfg: ModelConfig,
                           device=None) -> TrainState:
    """A ``TrainState`` from ``repro``'s: the parameter tree and AdamW's
    two moment trees (shaped as the parameters) as numpy, and the step."""
    dev = resolve_device(device)
    return TrainState(
        params=lm_params_from_numpy(params_tree, cfg, dev),
        opt=AdamWState(
            step=torch.tensor(int(step), dtype=torch.int32, device=dev),
            m=_state_from_tree(m_tree, cfg, dev),
            v=_state_from_tree(v_tree, cfg, dev)))


def train_state_to_numpy(state: TrainState) -> tuple[dict, dict, dict, int]:
    """(params, m, v, step): the trees as ``repro`` holds them (stacked
    layers), f32 numpy, and the step as an int."""
    return (lm_params_to_numpy(state.params),
            stack_tree((k, _numpy(t)) for k, t in state.opt.m.items()),
            stack_tree((k, _numpy(t)) for k, t in state.opt.v.items()),
            int(state.opt.step))
