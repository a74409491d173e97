"""The main path: CoralTDA + PrunIT reductions and exact persistence."""
from repro_torch.core.api import (
    ReductionStats,
    TopoPlan,
    TopoPlanKey,
    clear_plan_cache,
    make_topo_plan,
    plan_cache_info,
    reduce_graphs,
    reduction_stats,
    topological_signature,
)
from repro_torch.core.graph import (
    GraphBatch,
    canonicalize,
    degree_filtration,
    from_edge_lists,
    from_networkx,
)
from repro_torch.core.kcore import (
    coral_reduce,
    coreness,
    degeneracy,
    kcore,
    kcore_mask,
)
from repro_torch.core.persistence import (
    Diagrams,
    diagrams_bitwise_equal,
    diagrams_to_numpy,
    persistence_diagrams_batched,
)
from repro_torch.core.prunit import (
    domination_matrix,
    eligibility_matrix,
    prunit,
    prunit_mask,
    prunit_then_coral,
)
from repro_torch.core.reduction import (
    METHOD_PASSES,
    PASS_REGISTRY,
    ReductionEngine,
    ReductionPass,
    apply_passes,
    engine_exact_from_dim,
    passes_for_method,
    reduce_fixpoint,
    register_pass,
    run_reduction,
)
from repro_torch.core.repack import (
    RepackReport,
    ShapeClass,
    compact_batch,
    default_ladder,
    diagram_size,
    measure_counts,
    select_classes,
)

__all__ = [
    "Diagrams", "GraphBatch", "METHOD_PASSES", "PASS_REGISTRY",
    "ReductionEngine", "ReductionPass", "ReductionStats", "RepackReport",
    "ShapeClass", "TopoPlan", "TopoPlanKey", "apply_passes", "canonicalize",
    "clear_plan_cache", "compact_batch", "coral_reduce", "coreness",
    "default_ladder", "degeneracy", "degree_filtration", "diagram_size",
    "diagrams_bitwise_equal", "diagrams_to_numpy", "domination_matrix",
    "eligibility_matrix", "engine_exact_from_dim", "from_edge_lists",
    "from_networkx", "kcore", "kcore_mask", "make_topo_plan",
    "measure_counts", "passes_for_method", "persistence_diagrams_batched",
    "plan_cache_info", "prunit", "prunit_mask", "prunit_then_coral",
    "reduce_fixpoint", "reduce_graphs", "reduction_stats", "register_pass",
    "run_reduction", "select_classes", "topological_signature",
]
