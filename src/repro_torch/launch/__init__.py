"""Device meshes for the port (counterpart of ``repro.launch``): the
general n-d :class:`DeviceMesh` with the serve, test and production
constructors, and the index mesh that ShardedIndex lays its row blocks
over; the card's peak rates are in :mod:`repro_torch.launch.roofline`."""
from repro_torch.launch.mesh import (
    DeviceMesh,
    IndexMesh,
    make_index_mesh,
    make_production_mesh,
    make_serve_mesh,
    make_test_mesh,
)

__all__ = ["DeviceMesh", "IndexMesh", "make_index_mesh",
           "make_production_mesh", "make_serve_mesh", "make_test_mesh"]
