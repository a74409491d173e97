"""TopoIndex: a retrieve -> re-rank persistence-diagram similarity index
over sliced-Wasserstein / feature embeddings (single host; the mesh-sharded
flavour comes in a later slice of the port)."""
from repro_torch.index.topo_index import (
    QueryResult,
    TopoIndex,
    TopoIndexConfig,
    clouds_to_diagrams,
)

__all__ = ["QueryResult", "TopoIndex", "TopoIndexConfig",
           "clouds_to_diagrams"]
