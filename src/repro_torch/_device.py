"""Device resolution for entry points that create tensors."""
from __future__ import annotations

import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means CUDA.

    CUDA is never replaced by the CPU behind the caller's back: with no
    device given and no CUDA device present this raises, and a caller that
    wants the plain PyTorch path asks for it with ``device="cpu"``.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path")
    return torch.device("cuda")


def device_context(device: torch.device):
    """``torch.cuda.device(device)`` on CUDA, a no-op context elsewhere: a
    serving thread enters it so its launches go to its server's card."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()
