"""Plain integer counters: kernel launches, host-driven loop rounds and
MetricEngine calls.

``KERNEL_LAUNCHES[name]`` grows by one each time a wrapper in
:mod:`repro_torch.kernels.ops` launches its CUDA kernel, and never on the
plain (CPU) path, so a run can show that it went through the kernels.
``LOOP_ROUNDS`` counts the rounds of the two loops that sync with the host
once per round: PrunIT's prune rounds and the reduction fixpoint's sweeps.
``METRIC_CALLS[(backend, entry)]`` counts the calls of the MetricEngine's
entry points (``entry`` is ``"compare"``, ``"compare_info"`` or
``"pairwise"``; a ``pairwise`` call also counts the ``compare`` calls it
makes).
"""
from __future__ import annotations

from collections import Counter

KERNEL_LAUNCHES: dict[str, int] = {"kcore_peel": 0, "domination": 0,
                                   "gf2_reduce": 0, "common_neighbors": 0,
                                   "pairwise_l1": 0, "sinkhorn_lse": 0,
                                   "sinkhorn_pair_sum": 0}
LOOP_ROUNDS: dict[str, int] = {"prune_rounds": 0, "fixpoint_sweeps": 0}
METRIC_CALLS: Counter[tuple[str, str]] = Counter()


def reset() -> None:
    """Set every counter to 0."""
    for d in (KERNEL_LAUNCHES, LOOP_ROUNDS):
        for k in d:
            d[k] = 0
    METRIC_CALLS.clear()


def snapshot() -> dict[str, int]:
    """A copy of every counter, launches and rounds in one dict."""
    return {**KERNEL_LAUNCHES, **LOOP_ROUNDS}
