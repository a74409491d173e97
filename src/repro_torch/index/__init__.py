"""TopoIndex: a retrieve -> re-rank persistence-diagram similarity index
over sliced-Wasserstein / feature embeddings, single host
(:class:`TopoIndex`) or with its row stores and coarse scan sharded over an
index mesh in one process (:class:`ShardedIndex`)."""
from repro_torch.index.sharded_index import ShardedIndex
from repro_torch.index.topo_index import (
    QueryResult,
    TopoIndex,
    TopoIndexConfig,
    clouds_to_diagrams,
)

__all__ = ["QueryResult", "ShardedIndex", "TopoIndex", "TopoIndexConfig",
           "clouds_to_diagrams"]
