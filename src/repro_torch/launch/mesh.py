"""The index mesh (counterpart of ``repro.launch.mesh.make_index_mesh``).

A mesh here is a plain grid of ``torch.device``s with the axis names
``("row", "col")``: ShardedIndex runs in one process and places each shard's
blocks on its device.  A device may appear more than once, so P shards can
share one card (or the CPU), as ``repro``'s tests lay four XLA host devices
over one CPU.
"""
from __future__ import annotations

import dataclasses

import torch

AXIS_NAMES = ("row", "col")


@dataclasses.dataclass(frozen=True)
class IndexMesh:
    """An (R, C) grid of devices over the ``("row", "col")`` axes."""

    devices: tuple[tuple[torch.device, ...], ...]

    @property
    def axis_names(self) -> tuple[str, str]:
        return AXIS_NAMES

    @property
    def shape(self) -> dict[str, int]:
        return {"row": len(self.devices), "col": len(self.devices[0])}

    @property
    def size(self) -> int:
        return len(self.devices) * len(self.devices[0])

    @property
    def flat(self) -> list[torch.device]:
        """The devices in row-major order: shard p's device is ``flat[p]``."""
        return [d for row in self.devices for d in row]


def make_index_mesh(n_devices: int | None = None, rows: int | None = None,
                    devices=None) -> IndexMesh:
    """2-D ``("row", "col")`` mesh for ShardedIndex retrieval.

    Corpus rows shard over the flattened mesh for the coarse Hamming scan;
    the SUMMA Gram splits rows over ``"row"`` and the embedding width over
    ``"col"``.  ``rows`` defaults to the largest divisor of the device count
    that is <= sqrt(n), so 4 devices give (2, 2) and one device (1, 1).

    ``devices`` lists the devices (repeats allowed); by default every CUDA
    device the process sees, and with none this raises, as
    :func:`repro_torch._device.resolve_device` does.  ``n_devices`` keeps
    the first n of them.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass devices=['cpu', ...] to "
                "lay the mesh over the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    else:
        devices = [torch.device(d) for d in devices]
    n = len(devices) if n_devices is None else int(n_devices)
    if n < 1 or n > len(devices):
        raise ValueError(f"want 1..{len(devices)} devices, got {n}")
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
    cols = n // rows
    return IndexMesh(tuple(tuple(devices[r * cols:(r + 1) * cols])
                           for r in range(rows)))
