"""MetricEngine: batched persistence-diagram distances behind one backend
registry (the port of ``repro.metrics``, without its auction backends yet).
``distances`` holds the batched functions on the ``Diagrams`` layout,
``engine`` the registry and the ``compare``/``pairwise`` entry points,
``reference`` the host oracles, ``testing`` the seeded generators."""
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

__all__ = [
    "METRIC_REGISTRY",
    "MetricBackend",
    "compact_top_k",
    "compare",
    "compare_info",
    "direction_grid",
    "get_metric",
    "masked_points",
    "metric_params",
    "pairwise",
    "register_metric",
    "sinkhorn_w2",
    "sliced_wasserstein",
    "sw_embedding",
]
