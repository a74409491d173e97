"""Topological feature extraction (Betti curves, statistics, persistence
images and landscapes)."""
from repro_torch.topo.features import (
    betti_curve,
    feature_vector,
    persistence_image,
    persistence_landscape,
    persistence_stats,
    signature_features,
)

__all__ = [
    "betti_curve", "feature_vector", "persistence_image",
    "persistence_landscape", "persistence_stats", "signature_features",
]
