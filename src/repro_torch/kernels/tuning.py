"""Launch parameters of the CUDA kernels, keyed by device.

Keyed like ``repro.kernels.tuning``: a device string
``"cuda:<device name>"`` (e.g. ``cuda:NVIDIA H100 80GB HBM3``) selects
pinned values from this package's own file, ``tuned_tiles.json`` beside
this module (or ``$REPRO_TORCH_TUNED_TILES``); defaults apply where the file
is absent or was written for another device.  No pinned file exists yet.
"""
from __future__ import annotations

import json
import os
from pathlib import Path

import torch

TILES_ENV = "REPRO_TORCH_TUNED_TILES"
TILES_SCHEMA = 1

DEFAULT_TILES: dict[str, dict] = {
    # threads per CTA cap; a CTA is one graph and uses 32 per mask word
    "kcore_peel": {"max_threads": 1024},
}


def device_string(device) -> str:
    """``"cuda:<device name>"`` for a CUDA device, else ``"<type>:<type>"``."""
    device = torch.device(device)
    if device.type == "cuda":
        return f"cuda:{torch.cuda.get_device_name(device)}"
    return f"{device.type}:{device.type}"


def tiles_path() -> Path:
    env = os.environ.get(TILES_ENV)
    return Path(env) if env else Path(__file__).with_name("tuned_tiles.json")


def tuned_tiles(kernel: str, device) -> dict:
    """Pinned values for ``kernel`` on ``device``, or ``{}``."""
    try:
        payload = json.loads(tiles_path().read_text())
    except (OSError, ValueError):
        return {}
    if (not isinstance(payload, dict) or payload.get("version") != TILES_SCHEMA
            or payload.get("device") != device_string(device)):
        return {}
    entry = payload.get("kernels", {}).get(kernel, {})
    known = DEFAULT_TILES.get(kernel, {})
    return {k: v for k, v in entry.get("tiles", {}).items() if k in known}


def resolve_tiles(kernel: str, device) -> dict:
    """The defaults, overridden by values pinned for ``device``."""
    return {**DEFAULT_TILES.get(kernel, {}), **tuned_tiles(kernel, device)}
