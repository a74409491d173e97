"""Device meshes for the port (counterpart of ``repro.launch``): so far the
index mesh that ShardedIndex lays its row blocks over."""
from repro_torch.launch.mesh import IndexMesh, make_index_mesh

__all__ = ["IndexMesh", "make_index_mesh"]
