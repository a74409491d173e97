"""Device meshes for the port (counterpart of ``repro.launch``): the
general n-d :class:`DeviceMesh` with the serve, test and production
constructors, and the index mesh that ShardedIndex lays its row blocks
over; the card's peak rates are in :mod:`repro_torch.launch.roofline`.
The training loop is the submodule :mod:`repro_torch.launch.train`
(``train.train``); its ``make_host_mesh`` is exported here, loaded on
first use so that ``python -m repro_torch.launch.train`` runs the
submodule as ``__main__`` alone."""
from repro_torch.launch.mesh import (
    DeviceMesh,
    IndexMesh,
    make_index_mesh,
    make_production_mesh,
    make_serve_mesh,
    make_test_mesh,
)

__all__ = ["DeviceMesh", "IndexMesh", "make_host_mesh", "make_index_mesh",
           "make_production_mesh", "make_serve_mesh", "make_test_mesh"]


def __getattr__(name):
    if name == "make_host_mesh":
        from repro_torch.launch.train import make_host_mesh

        return make_host_mesh
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
