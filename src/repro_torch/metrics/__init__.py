"""MetricEngine: batched persistence-diagram distances behind one backend
registry (the port of ``repro.metrics``).  ``distances`` holds the batched
functions on the ``Diagrams`` layout, ``exact`` the auction-based exact
Wasserstein and bottleneck distances, ``engine`` the registry and the
``compare``/``compare_info``/``pairwise`` entry points, ``price_cache`` the
warm-start LRU, ``reference`` the host oracles, ``testing`` the seeded
generators."""
from repro_torch.metrics.distances import (
    compact_top_k,
    direction_grid,
    masked_points,
    sinkhorn_w2,
    sliced_wasserstein,
    sw_embedding,
)
from repro_torch.metrics.engine import (
    METRIC_REGISTRY,
    MetricBackend,
    compare,
    compare_info,
    get_metric,
    metric_params,
    pairwise,
    register_metric,
)
from repro_torch.metrics.exact import (
    bottleneck_approx,
    exact_w,
    exact_w_full,
    exact_w_info,
)

__all__ = [
    "METRIC_REGISTRY",
    "MetricBackend",
    "bottleneck_approx",
    "compact_top_k",
    "compare",
    "compare_info",
    "direction_grid",
    "exact_w",
    "exact_w_full",
    "exact_w_info",
    "get_metric",
    "masked_points",
    "metric_params",
    "pairwise",
    "register_metric",
    "sinkhorn_w2",
    "sliced_wasserstein",
    "sw_embedding",
]
