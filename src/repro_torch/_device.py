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


def same_device(a: torch.device, b: torch.device) -> bool:
    """Whether two devices name the same one (an index-less CUDA device
    is the current card)."""
    if a.type != b.type:
        return False
    if a.type != "cuda" or a.index == b.index:
        return True
    cur = torch.cuda.current_device()
    return (cur if a.index is None else a.index) == (
        cur if b.index is None else b.index)


def device_context(device: torch.device):
    """``torch.cuda.device(device)`` on CUDA, a no-op context elsewhere: a
    serving thread enters it so its launches go to its server's card."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()
