"""The launch layer of the port (counterpart of ``repro.launch``).

Device meshes: the general n-d :class:`DeviceMesh` with the serve, test
and production constructors, and the index mesh that ShardedIndex lays its
row blocks over.  The partitioning rules are :mod:`repro_torch.launch.
sharding` (``param_specs``, ``cache_specs``, ``shard_bytes``, ...); the
card's peak rates and both roofline forms (a kernel's bound, a counted
step's terms) are :mod:`repro_torch.launch.roofline`.  The submodules
with a command line are the training loop :mod:`repro_torch.launch.train`
(``train.train``), the dry run :mod:`repro_torch.launch.dryrun` and its
tables :mod:`repro_torch.launch.roofline_report`; ``make_host_mesh`` is
exported here, loaded on first use so that ``python -m
repro_torch.launch.train`` runs the submodule as ``__main__`` alone."""
from repro_torch.launch.mesh import (
    DeviceMesh,
    IndexMesh,
    make_index_mesh,
    make_production_mesh,
    make_serve_mesh,
    make_test_mesh,
)
from repro_torch.launch.sharding import (
    batch_spec,
    cache_specs,
    opt_specs,
    param_specs,
    shard_bytes,
    shard_shape,
)

__all__ = ["DeviceMesh", "IndexMesh", "batch_spec", "cache_specs",
           "make_host_mesh", "make_index_mesh", "make_production_mesh",
           "make_serve_mesh", "make_test_mesh", "opt_specs", "param_specs",
           "shard_bytes", "shard_shape"]


def __getattr__(name):
    if name == "make_host_mesh":
        from repro_torch.launch.train import make_host_mesh

        return make_host_mesh
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
