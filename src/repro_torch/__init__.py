"""TopoPipe on PyTorch and CUDA: CoralTDA + PrunIT exact persistence.

The counterpart of the JAX package ``repro``, held bit-exact against it.
It imports neither JAX nor ``repro``.  Functions that build tensors run on
CUDA unless given ``device="cpu"``; functions that take tensors follow their
device, launching the hand-written kernels of ``csrc/`` on CUDA and their
plain PyTorch versions on the CPU.
"""
from repro_torch.core import (  # noqa: F401
    Diagrams,
    GraphBatch,
    make_topo_plan,
    reduction_stats,
    topological_signature,
)

__version__ = "0.1.0"
