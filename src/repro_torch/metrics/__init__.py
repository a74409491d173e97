"""Persistence-diagram distances on the Diagrams layout: the
sliced-Wasserstein distance and embedding (the metric engine comes in a
later slice of the port)."""
from repro_torch.metrics.distances import (
    compact_top_k,
    direction_grid,
    masked_points,
    sliced_wasserstein,
    sw_embedding,
)

__all__ = ["compact_top_k", "direction_grid", "masked_points",
           "sliced_wasserstein", "sw_embedding"]
