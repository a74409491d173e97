"""Device meshes (counterpart of ``repro.launch.mesh``).

A mesh here is a plain n-d grid of ``torch.device``s with named axes: the
port runs one process and places each shard's tensors on its device.  A
device may appear more than once, so P shards can share one card (or the
CPU), as ``repro``'s tests lay four XLA host devices over one CPU.

Every constructor takes ``devices=`` (repeats allowed); without it the mesh
covers every CUDA device the process sees, and with none it raises, as
:func:`repro_torch._device.resolve_device` does.  The card's peak rates
live in :mod:`repro_torch.launch.roofline`, not here.
"""
from __future__ import annotations

import dataclasses
import math

import torch

AXIS_NAMES = ("row", "col")


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """An n-d grid of devices: ``devices`` nests one tuple level per axis
    of ``axis_names``.  Frozen and made of tuples, so it is hashable (a
    plan-cache key may hold it)."""

    devices: tuple
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        out, level = {}, self.devices
        for name in self.axis_names:
            out[name] = len(level)
            level = level[0]
        return out

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def flat(self) -> list[torch.device]:
        """The devices in row-major order: shard p's device is ``flat[p]``."""
        out = list(self.devices)
        for _ in self.axis_names[1:]:
            out = [d for level in out for d in level]
        return out


@dataclasses.dataclass(frozen=True)
class IndexMesh(DeviceMesh):
    """An (R, C) grid of devices over the ``("row", "col")`` axes."""

    axis_names: tuple[str, ...] = AXIS_NAMES


def _devices(devices) -> list[torch.device]:
    """``devices`` as ``torch.device``s; by default every CUDA device, and
    with none this raises (there is no silent CPU mesh)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass devices=['cpu', ...] to "
                "lay the mesh over the CPU")
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(d) for d in devices]


def _grid(flat: list, shape: tuple[int, ...]) -> tuple:
    """The first prod(shape) of ``flat`` nested row-major into ``shape``."""
    if len(shape) == 1:
        return tuple(flat[:shape[0]])
    step = math.prod(shape[1:])
    return tuple(_grid(flat[i * step:(i + 1) * step], shape[1:])
                 for i in range(shape[0]))


def _mesh(shape, axis_names, devices=None) -> DeviceMesh:
    """A ``shape`` mesh over ``axis_names`` from the first prod(shape)
    ``devices`` (default: every CUDA device); raises when fewer exist."""
    shape = tuple(int(s) for s in shape)
    axis_names = tuple(axis_names)
    if len(shape) != len(axis_names) or min(shape, default=0) < 1:
        raise ValueError(f"mesh shape {shape} does not fit axes {axis_names}")
    devs = _devices(devices)
    need = math.prod(shape)
    if need > len(devs):
        raise ValueError(f"a {shape} mesh needs {need} devices, "
                         f"{len(devs)} given")
    return DeviceMesh(_grid(devs, shape), axis_names)


def make_production_mesh(*, multi_pod: bool = False,
                         devices=None) -> DeviceMesh:
    """(16, 16) over ``("data", "model")``, or (2, 16, 16) over
    ``("pod", "data", "model")`` when ``multi_pod``; raises when fewer
    devices exist than the shape needs."""
    if multi_pod:
        return _mesh((2, 16, 16), ("pod", "data", "model"), devices)
    return _mesh((16, 16), ("data", "model"), devices)


def make_serve_mesh(n_devices: int | None = None, *, multi_pod: bool = False,
                    devices=None) -> DeviceMesh:
    """Data-only mesh for sharded plan execution and TopoServe.

    The TDA path is embarrassingly parallel over graphs, so it shards over
    ``("data",)``, or ``("pod", "data")`` with shape (2, n / 2) when
    ``multi_pod`` (an even count then); no ``"model"`` axis.  ``n_devices``
    keeps the first n of ``devices`` (default: every CUDA device).
    """
    devs = _devices(devices)
    n = len(devs) if n_devices is None else int(n_devices)
    if multi_pod:
        if n % 2:
            raise ValueError(
                f"multi_pod serve mesh needs an even device count, got {n}")
        return _mesh((2, n // 2), ("pod", "data"), devs)
    return _mesh((n,), ("data",), devs)


def make_test_mesh(shape=(1, 1), axes=("data", "model"),
                   devices=None) -> DeviceMesh:
    """A small mesh over the devices given (tests); refuses a shape larger
    than they are."""
    return _mesh(shape, axes, devices)


def make_index_mesh(n_devices: int | None = None, rows: int | None = None,
                    devices=None) -> IndexMesh:
    """2-D ``("row", "col")`` mesh for ShardedIndex retrieval.

    Corpus rows shard over the flattened mesh for the coarse Hamming scan;
    the SUMMA Gram splits rows over ``"row"`` and the embedding width over
    ``"col"``.  ``rows`` defaults to the largest divisor of the device count
    that is <= sqrt(n), so 4 devices give (2, 2) and one device (1, 1).
    ``n_devices`` keeps the first n of ``devices``.
    """
    devs = _devices(devices)
    n = len(devs) if n_devices is None else int(n_devices)
    if n < 1 or n > len(devs):
        raise ValueError(f"want 1..{len(devs)} devices, got {n}")
    if rows is None:
        rows = 1
        r = int(n ** 0.5)
        while r > 1:
            if n % r == 0:
                rows = r
                break
            r -= 1
    if rows < 1 or n % rows:
        raise ValueError(f"rows={rows} does not divide device count {n}")
    return IndexMesh(_grid(devs, (rows, n // rows)))
