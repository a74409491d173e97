"""MetricEngine: the one registry of diagram-distance backends (the port of
``repro.metrics.engine``).

Every backend is a masked batched function over the fixed-size
:class:`~repro_torch.core.persistence.Diagrams` layout with the common
signature ``fn(d1, d2, *, k, cap, **params) -> (...,) distances`` (pairs
aligned row-wise over any leading batch axes), plus a contract record: is
it exact, what error bound it guarantees, what its cost class is.  Serving
code picks backends by contract, through this registry.

Registered here:

========================  ======  =========================================
name                      exact   notes
========================  ======  =========================================
``sw``                    no      Carrière sliced-Wasserstein on the fixed
                                  ``n_dirs`` half-circle grid
``sinkhorn``              no      debiased entropic W2 (≤ ~5% of exact W2;
                                  ``impl="blocked"`` rebuilds the cost in
                                  the ``sinkhorn_lse`` CUDA kernel)
========================  ======  =========================================

``repro``'s ``exact_w`` and ``bottleneck_approx`` backends come with the
port of its auction kernels; until then they are unknown names here.

Entry points: ``compare`` (row-aligned pairs) and ``pairwise`` (the Q×N
cross product).  Each call adds one to
``repro_torch.counters.METRIC_CALLS[(backend, entry)]``.
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Callable, Mapping

import torch

from repro_torch import counters
from repro_torch.core.persistence import Diagrams
from repro_torch.metrics.distances import sinkhorn_w2, sliced_wasserstein

_FIELDS = ("birth", "death", "dim", "valid")


@dataclasses.dataclass(frozen=True)
class MetricBackend:
    """One registered diagram-distance backend.

    ``fn(d1, d2, *, k, cap, **params)`` takes row-aligned Diagrams with any
    leading batch axes and returns ``(...,)`` distances; padding rows never
    contribute.  The contract record is what serving layers select on:
    ``exact`` (the true metric up to documented truncation),
    ``error_bound`` (the guarantee of an approximate backend) and
    ``cost_class`` (cost per pair in terms of the working width).
    ``info_fn`` (optional) returns ``(distances, converged, rounds,
    prices)`` for :func:`compare_info`.
    """

    name: str
    fn: Callable[..., torch.Tensor]
    exact: bool
    error_bound: str
    cost_class: str
    description: str = ""
    defaults: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    params: tuple[str, ...] = ()
    info_fn: Callable[..., tuple] | None = None
    info_params: tuple[str, ...] = ()


METRIC_REGISTRY: dict[str, MetricBackend] = {}


def _fn_params(fn: Callable) -> tuple[str, ...]:
    """Tunable keyword parameters of a backend fn (beyond d1/d2/k/cap)."""
    sig = inspect.signature(fn)
    return tuple(p for p in sig.parameters
                 if p not in ("d1", "d2", "k", "cap"))


def register_metric(backend: MetricBackend,
                    overwrite: bool = False) -> MetricBackend:
    """Register a distance backend under ``backend.name``.

    Fills ``params`` from the fn signature when not given, so ``compare``
    and ``pairwise`` reject unknown parameters before any work.
    """
    if not overwrite and backend.name in METRIC_REGISTRY:
        raise ValueError(f"metric backend {backend.name!r} already registered")
    if not backend.params:
        backend = dataclasses.replace(backend, params=_fn_params(backend.fn))
    if backend.info_fn is not None and not backend.info_params:
        backend = dataclasses.replace(
            backend, info_params=_fn_params(backend.info_fn))
    bad = set(backend.defaults) - set(backend.params)
    if bad:
        raise ValueError(
            f"defaults {sorted(bad)} not accepted by backend "
            f"{backend.name!r} (params: {backend.params})")
    METRIC_REGISTRY[backend.name] = backend
    return backend


def get_metric(name: str) -> MetricBackend:
    try:
        return METRIC_REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown metric backend {name!r}; registered: "
            f"{sorted(METRIC_REGISTRY)}") from None


def metric_params(name: str) -> tuple[str, ...]:
    """The tunable parameter names a backend accepts (config validation)."""
    return get_metric(name).params


def compare(d1: Diagrams, d2: Diagrams, metric: str = "sw", k: int = 1,
            cap: float = 64.0, **params) -> torch.Tensor:
    """Row-aligned batched distances between two Diagrams under ``metric``.

    ``params`` override the backend defaults and are checked against the
    backend's parameter set.
    """
    be = get_metric(metric)
    bad = set(params) - set(be.params)
    if bad:
        raise ValueError(
            f"metric {metric!r} does not accept {sorted(bad)}; "
            f"accepted: {sorted(be.params)}")
    kwargs = dict(be.defaults)
    kwargs.update(params)
    counters.METRIC_CALLS[(metric, "compare")] += 1
    return be.fn(d1, d2, k=k, cap=cap, **kwargs)


def compare_info(d1: Diagrams, d2: Diagrams, metric: str = "exact_w",
                 k: int = 1, cap: float = 64.0, **params) -> tuple:
    """``compare`` with solver diagnostics, ``(w, converged, rounds,
    prices)``, through the backend's ``info_fn``; raises for a backend that
    has none (``sw`` and ``sinkhorn`` have none)."""
    be = get_metric(metric)
    if be.info_fn is None:
        raise ValueError(
            f"metric {metric!r} has no diagnostics entry point (info_fn); "
            "use compare()")
    bad = set(params) - set(be.info_params)
    if bad:
        raise ValueError(
            f"metric {metric!r} info_fn does not accept {sorted(bad)}; "
            f"accepted: {sorted(be.info_params)}")
    kwargs = {p: v for p, v in be.defaults.items() if p in be.info_params}
    kwargs.update(params)
    counters.METRIC_CALLS[(metric, "compare_info")] += 1
    return be.info_fn(d1, d2, k=k, cap=cap, **kwargs)


def _map(fn, d: Diagrams) -> Diagrams:
    return Diagrams(*(fn(getattr(d, f)) for f in _FIELDS))


def pairwise(d1: Diagrams, d2: Diagrams | None = None, metric: str = "sw",
             k: int = 1, cap: float = 64.0, block_rows: int | None = None,
             **params) -> torch.Tensor:
    """(Q, N) cross-product distance matrix under ``metric``.

    ``d1`` carries Q leading rows, ``d2`` N rows (``None``: ``d1`` against
    itself).  Rows are broadcast pairwise (``expand``, no copy) and go
    through the same backend fn as ``compare``; ``block_rows`` chunks the
    query axis to bound the Q·N working set.
    """
    if d2 is None:
        d2 = d1
    n = d2.birth.shape[0]
    counters.METRIC_CALLS[(metric, "pairwise")] += 1

    def tile_pair(da: Diagrams) -> torch.Tensor:
        q = da.birth.shape[0]
        left = _map(lambda x: x[:, None].expand((q, n) + x.shape[1:]), da)
        right = _map(lambda x: x[None, :].expand((q, n) + x.shape[1:]), d2)
        return compare(left, right, metric=metric, k=k, cap=cap, **params)

    if block_rows is None:
        return tile_pair(d1)
    q_total = d1.birth.shape[0]
    return torch.cat([tile_pair(_map(lambda x: x[s:s + block_rows], d1))
                      for s in range(0, q_total, block_rows)], dim=0)


# ---------------------------------------------------------------------------
# built-in backends
# ---------------------------------------------------------------------------

register_metric(MetricBackend(
    name="sw",
    fn=sliced_wasserstein,
    exact=False,
    error_bound="exact on the n_dirs half-circle quadrature "
                "(rtol 1e-5 vs the dense host reference)",
    cost_class="O(n_dirs · S log S) per pair",
    description="Carrière sliced-Wasserstein, pair-dependent diagonal "
                "augmentation",
))
register_metric(MetricBackend(
    name="sinkhorn",
    fn=sinkhorn_w2,
    exact=False,
    error_bound="debiased entropic W2, ≤ ~5% of exact W2 at the default "
                "ε ladder (self-distance exactly 0)",
    cost_class="O(P² · iters) dense, O(tile² · iters) blocked "
               "(P = n_points or full 2S)",
    description="log-domain ε-scaled Sinkhorn divergence; impl='blocked' "
                "rebuilds the cost on the fly in the sinkhorn_lse CUDA "
                "kernel (one thread per row, 128-column tiles in shared "
                "memory)",
))
