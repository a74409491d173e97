"""TopoStream: incremental persistence diagrams over dynamic-graph streams
with reduction-aware invalidation (the port of ``repro.stream``)."""
from repro_torch.stream.topo_stream import (
    StreamVerdict,
    TopoStream,
    TopoStreamConfig,
    dim_pairs,
    eligibility_matrix,
    invalidation_verdict,
)

__all__ = [
    "StreamVerdict",
    "TopoStream",
    "TopoStreamConfig",
    "dim_pairs",
    "eligibility_matrix",
    "invalidation_verdict",
]
