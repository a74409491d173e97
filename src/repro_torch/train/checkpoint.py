"""Fault-tolerant checkpoints of a training state (counterpart of
``repro.train.checkpoint``).

Layout (one directory per step):

  ckpt_dir/
    step_00000123/          # committed atomically by directory rename
      manifest.json         # step, codec, leaf names and shards, stream state
      shard_00000.bin ...   # the leaves, spread over ``save_shards`` files

Kept from ``repro``: the atomic commit (write into ``step_XXXXXXXX.tmp``,
fsync, rename; a crashed save never leaves a readable half, and restore
takes the newest committed step), the newest ``keep`` steps kept, leaves
stored whole and spread over the shard files by running byte count (so a
restore may go to another device count), the data stream's state in the
manifest, and a restore cast to the dtype of the structure it fills.

The shard encoding is this package's own, from the stdlib and numpy: each
leaf is an 8-byte little-endian header length, a JSON header (name,
dtype, shape, stored bytes) and the leaf's raw bytes (the manifest names
the codec, ``"raw"``).  ``repro`` packs msgpack with zstd; neither package
reads the other's files.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import os
import shutil
import struct
from concurrent.futures import ThreadPoolExecutor
from typing import Any

import numpy as np
import torch
from torch import nn

from repro_torch._device import resolve_device

FORMAT = "repro_torch.shards/1"
CODEC = "raw"


# ------------------------------------------------------- state <-> leaves --
def _flatten(state: Any, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """(name, tensor) leaves of a state: dataclasses by field, modules by
    state-dict key, dicts by key, in order."""
    if isinstance(state, torch.Tensor):
        return [(prefix, state)]
    if isinstance(state, nn.Module):
        items = state.state_dict().items()
    elif dataclasses.is_dataclass(state):
        items = ((f.name, getattr(state, f.name))
                 for f in dataclasses.fields(state))
    elif isinstance(state, dict):
        items = state.items()
    else:
        raise TypeError(f"{prefix or 'state'}: cannot checkpoint a "
                        f"{type(state).__name__}")
    out = []
    for k, v in items:
        out += _flatten(v, f"{prefix}.{k}" if prefix else str(k))
    return out


def _rebuild(like: Any, leaf, prefix: str = "") -> Any:
    """A state shaped as ``like`` whose tensors are ``leaf(name, ref)``.
    A module is copied around its tensors (no data is copied) and given
    the new ones."""
    if isinstance(like, torch.Tensor):
        return leaf(prefix, like)
    name = (lambda k: f"{prefix}.{k}" if prefix else str(k))
    if isinstance(like, nn.Module):
        memo = {id(t): torch.empty_like(t, device="meta")
                for t in list(like.parameters()) + list(like.buffers())}
        for t in like.parameters():
            memo[id(t)] = nn.Parameter(memo[id(t)],
                                       requires_grad=t.requires_grad)
        out = copy.deepcopy(like, memo)
        out.load_state_dict({k: leaf(name(k), v) for k, v in
                             like.state_dict().items()}, assign=True)
        return out
    if dataclasses.is_dataclass(like):
        return dataclasses.replace(like, **{
            f.name: _rebuild(getattr(like, f.name), leaf, name(f.name))
            for f in dataclasses.fields(like)})
    if isinstance(like, dict):
        return {k: _rebuild(v, leaf, name(k)) for k, v in like.items()}
    raise TypeError(f"{prefix or 'like'}: cannot restore a "
                    f"{type(like).__name__}")


def _to_numpy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """A tensor's host bytes as numpy, and its dtype's name (bfloat16
    travels as its int16 bits)."""
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), "bfloat16"
    return t.numpy(), str(t.numpy().dtype)


def _from_bytes(buf, dtype: str, shape) -> torch.Tensor:
    """A host tensor over ``buf`` (no copy)."""
    if dtype == "bfloat16":
        a = np.frombuffer(buf, dtype=np.int16).reshape(shape)
        return torch.from_numpy(a).view(torch.bfloat16)
    return torch.from_numpy(
        np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape))


# --------------------------------------------------------------- save ----
def _write_leaf(f, name: str, arr: np.ndarray, dtype: str) -> None:
    data = memoryview(np.ascontiguousarray(arr)).cast("B")
    head = json.dumps({"name": name, "dtype": dtype,
                       "shape": list(arr.shape),
                       "nbytes": len(data)}).encode()
    f.write(struct.pack("<Q", len(head)))
    f.write(head)
    f.write(data)


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def save(ckpt_dir: str, step: int, state: Any, *,
         stream_state: dict | None = None, save_shards: int = 4,
         keep: int = 3) -> str:
    """Write one committed checkpoint of ``state`` (a ``TrainState``, a
    module, a dict of tensors or any nesting of them); prune to the newest
    ``keep``.  Returns the step's directory."""
    leaves = _flatten(state)
    names = [n for n, _ in leaves]
    nbytes = [t.numel() * t.element_size() for _, t in leaves]
    shard_of, sizes = [], [0] * save_shards
    for b in nbytes:  # the least-filled shard takes the next leaf
        tgt = int(np.argmin(sizes))
        shard_of.append(tgt)
        sizes[tgt] += b

    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)

    def write_shard(s: int) -> None:
        with open(os.path.join(tmp, f"shard_{s:05d}.bin"), "wb") as f:
            for i, (name, t) in enumerate(leaves):
                if shard_of[i] == s:
                    arr, dtype = _to_numpy(t)
                    _write_leaf(f, name, arr, dtype)
            f.flush()
            os.fsync(f.fileno())

    # one thread a shard file: device copies, writes and fsyncs release
    # the GIL, so the shards' copies and I/O overlap
    with ThreadPoolExecutor(save_shards) as pool:
        list(pool.map(write_shard, range(save_shards)))
    manifest = {
        "format": FORMAT,
        "step": int(step),
        "codec": CODEC,
        "n_shards": save_shards,
        "leaf_names": names,
        "leaf_shard": shard_of,
        "stream_state": stream_state or {},
        "device_count_at_save": len({str(t.device) for _, t in leaves}),
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    _fsync_dir(tmp)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic commit
    _fsync_dir(ckpt_dir)
    _prune(ckpt_dir, keep)
    return final


def _prune(ckpt_dir: str, keep: int) -> None:
    steps = latest_steps(ckpt_dir)
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


def latest_steps(ckpt_dir: str) -> list[int]:
    """The committed steps under ``ckpt_dir``, ascending (``.tmp``
    directories and steps without a manifest are not committed)."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
                out.append(int(name[len("step_"):]))
    return sorted(out)


# ------------------------------------------------------------ restore ----
def _read_shard(path: str, dev) -> dict[str, torch.Tensor]:
    """A shard's leaves, each moved to ``dev`` as it is read (a shard's
    reader holds one leaf at a time on the host)."""
    out = {}
    with open(path, "rb") as f:
        while True:
            raw = f.read(8)
            if not raw:
                break
            (n,) = struct.unpack("<Q", raw)
            head = json.loads(f.read(n))
            buf = np.empty(head["nbytes"], np.uint8)  # not zero-filled
            if f.readinto(memoryview(buf)) != head["nbytes"]:
                raise ValueError(f"{path}: {head['name']} is truncated")
            out[head["name"]] = _from_bytes(buf, head["dtype"],
                                            head["shape"]).to(dev)
    return out


def restore(ckpt_dir: str, like: Any, step: int | None = None,
            device=None) -> tuple[Any, int, dict]:
    """Load the newest (or the given) committed step into the structure of
    ``like``, each leaf cast to ``like``'s dtype, on ``device`` (CUDA
    unless ``device="cpu"``).  Returns (state, step, stream_state)."""
    dev = resolve_device(device)
    steps = latest_steps(ckpt_dir)
    if not steps:
        raise FileNotFoundError(f"no committed checkpoints under {ckpt_dir}")
    step = steps[-1] if step is None else int(step)
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    if manifest.get("format") != FORMAT:
        raise ValueError(f"{d}: not a {FORMAT} checkpoint")
    if manifest.get("codec") != CODEC:
        raise ValueError(f"{d}: codec {manifest.get('codec')!r}, only "
                         f"{CODEC!r} is read")
    by_name: dict[str, torch.Tensor] = {}
    n = manifest["n_shards"]
    with ThreadPoolExecutor(n) as pool:  # one thread a shard file
        for part in pool.map(lambda s: _read_shard(
                os.path.join(d, f"shard_{s:05d}.bin"), dev), range(n)):
            by_name.update(part)

    def leaf(name, ref):
        if name not in by_name:
            raise KeyError(f"checkpoint missing leaf {name}")
        t = by_name.pop(name)
        if tuple(t.shape) != tuple(ref.shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)} in the "
                             f"checkpoint, {tuple(ref.shape)} wanted")
        return t.to(dtype=ref.dtype)

    state = _rebuild(like, leaf)
    return state, step, manifest.get("stream_state", {})
