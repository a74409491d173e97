"""Plain integer counters: kernel launches, host-driven loop rounds,
MetricEngine calls, price-cache warm starts and ShardedIndex scans.

``KERNEL_LAUNCHES[name]`` grows by one each time a wrapper in
:mod:`repro_torch.kernels.ops` launches its CUDA kernel, and never on the
plain (CPU) path, so a run can show that it went through the kernels.
``LOOP_ROUNDS`` counts the rounds of the two loops that sync with the host
once per round: PrunIT's prune rounds and the reduction fixpoint's sweeps.
``AUCTION[(name, instance)]`` counts the price-cache lookups that found a
warm-start vector (``"warm_start_hits"``) or fell back to a cold start
(``"warm_start_misses"``), per cache ``instance`` label.
``METRIC_CALLS[(backend, entry)]`` counts the calls of the MetricEngine's
entry points (``entry`` is ``"compare"``, ``"compare_info"`` or
``"pairwise"``; a ``pairwise`` call also counts the ``compare`` calls it
makes).
``INDEX[(name, kind)]`` counts ShardedIndex's device-side work by ``kind``
(``"hamming"`` for a coarse scan, ``"summa"`` for a SUMMA Gram):
``"sharded_scans"`` the calls, ``"sharded_rows"`` the (query, corpus row)
pairs they covered (``repro``'s ``index.sharded_scans`` and
``index.sharded_rows``).
"""
from __future__ import annotations

from collections import Counter

KERNEL_LAUNCHES: dict[str, int] = {"kcore_peel": 0, "domination": 0,
                                   "gf2_reduce": 0, "common_neighbors": 0,
                                   "pairwise_l1": 0, "sinkhorn_lse": 0,
                                   "sinkhorn_pair_sum": 0, "auction_lap": 0,
                                   "auction_lap_collapsed": 0,
                                   "hamming_scan": 0}
LOOP_ROUNDS: dict[str, int] = {"prune_rounds": 0, "fixpoint_sweeps": 0}
METRIC_CALLS: Counter[tuple[str, str]] = Counter()
AUCTION: Counter[tuple[str, str]] = Counter()
INDEX: Counter[tuple[str, str]] = Counter()


def reset() -> None:
    """Set every counter to 0."""
    for d in (KERNEL_LAUNCHES, LOOP_ROUNDS):
        for k in d:
            d[k] = 0
    METRIC_CALLS.clear()
    AUCTION.clear()
    INDEX.clear()


def snapshot() -> dict[str, int]:
    """A copy of every counter, launches and rounds in one dict."""
    return {**KERNEL_LAUNCHES, **LOOP_ROUNDS}
