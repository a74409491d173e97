"""Serving substrate (counterpart of ``repro.serve``): LM prefill/decode
steps and ``generate`` (serve_step, imported from its module), the
TopoServe batched persistence-diagram scheduler (topo_serve), the
StreamServe stateful dynamic-graph session layer (stream_serve), and the
SimilarityServe graph-similarity query path (similarity)."""
from repro_torch.serve.futures import FutureCancelled, ServeFuture
from repro_torch.serve.similarity import (
    SimilarityFuture,
    SimilarityResult,
    SimilarityServe,
)
from repro_torch.serve.stream_serve import StreamFuture, StreamServe
from repro_torch.serve.topo_serve import (
    DEFAULT_BUCKETS,
    Bucket,
    TopoFuture,
    TopoRequest,
    TopoServe,
    TopoServeConfig,
    pack_requests,
)

__all__ = [
    "Bucket",
    "DEFAULT_BUCKETS",
    "FutureCancelled",
    "ServeFuture",
    "SimilarityFuture",
    "SimilarityResult",
    "SimilarityServe",
    "StreamFuture",
    "StreamServe",
    "TopoFuture",
    "TopoRequest",
    "TopoServe",
    "TopoServeConfig",
    "pack_requests",
]
