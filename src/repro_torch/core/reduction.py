r"""Reduction passes iterated to a fixpoint (counterpart of
``repro.core.reduction``).

Each pass is a mask-monotone closure operator on the vertex mask with a
declared exactness range ``exact_from_dim(target_dim)``:

* ``prunit``          -> 0   (Theorem 7: every ``PD_k`` preserved)
* ``strong_collapse`` -> 0   (equal-``f`` domination, both orientations)
* ``kcore``           -> target_dim   (Theorem 2)

A pipeline's contract is the maximum over its passes.  ``reduce_fixpoint``
iterates the pass list until the mask stops changing; in PyTorch each sweep
ends in one host sync (``changed``), counted in
``counters.LOOP_ROUNDS["fixpoint_sweeps"]``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch import counters
from repro_torch.core.graph import INF, GraphBatch
from repro_torch.core.kcore import kcore_mask
from repro_torch.core.prunit import prunit_mask


@dataclasses.dataclass(frozen=True)
class ReductionPass:
    """One composable reduction pass.

    apply_mask(adj, mask, f, dim, sublevel) -> new mask, with ``adj``/``f``
    already restricted to ``mask``; the pass must only remove vertices.
    exact_from_dim(target_dim) -> lowest homology dimension it preserves.
    """

    name: str
    apply_mask: Callable[..., torch.Tensor]
    exact_from_dim: Callable[[int], int]
    description: str = ""


def _kcore_apply(adj, mask, f, dim, sublevel):
    # the 1-core would drop isolated vertices, which carry PD_0 classes
    if dim < 1:
        return mask
    return kcore_mask(adj, mask, dim + 1)


def _prunit_apply(adj, mask, f, dim, sublevel):
    return prunit_mask(adj, mask, f, sublevel)


def _strong_collapse_apply(adj, mask, f, dim, sublevel):
    return prunit_mask(adj, mask, f, sublevel, equal_only=True)


PASS_REGISTRY: dict[str, ReductionPass] = {}


def register_pass(p: ReductionPass, overwrite: bool = False) -> ReductionPass:
    """Register a reduction pass under ``p.name`` (extension point)."""
    if not overwrite and p.name in PASS_REGISTRY:
        raise ValueError(f"reduction pass {p.name!r} already registered")
    PASS_REGISTRY[p.name] = p
    return p


def get_pass(name: str) -> ReductionPass:
    try:
        return PASS_REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown reduction pass {name!r}; registered: "
            f"{sorted(PASS_REGISTRY)}") from None


register_pass(ReductionPass(
    name="kcore",
    apply_mask=_kcore_apply,
    exact_from_dim=lambda d: d if d >= 1 else 0,
    description="CoralTDA (dim+1)-core (Thm 2; exact for PD_j, j >= dim)",
))
register_pass(ReductionPass(
    name="prunit",
    apply_mask=_prunit_apply,
    exact_from_dim=lambda d: 0,
    description="PrunIT dominated-vertex pruning (Thm 7; exact for all PD_k)",
))
register_pass(ReductionPass(
    name="strong_collapse",
    apply_mask=_strong_collapse_apply,
    exact_from_dim=lambda d: 0,
    description="equal-f domination collapse (orientation-free Thm 7 case)",
))

METHOD_PASSES: dict[str, tuple[str, ...]] = {
    "none": (),
    "coral": ("kcore",),
    "prunit": ("prunit",),
    "both": ("prunit", "kcore"),
}


def passes_for_method(method: str) -> tuple[str, ...]:
    """Map a reduction method name to its pass tuple."""
    try:
        return METHOD_PASSES[method]
    except KeyError:
        raise ValueError(
            f"unknown reduction {method!r}; want one of "
            f"{tuple(METHOD_PASSES)}") from None


def method_for_passes(passes: tuple[str, ...]) -> str:
    """Inverse of ``passes_for_method`` where one exists, else '+'.join."""
    for m, p in METHOD_PASSES.items():
        if p == tuple(passes):
            return m
    return "+".join(passes)


def validate_passes(passes) -> tuple[str, ...]:
    passes = tuple(passes)
    for name in passes:
        get_pass(name)
    return passes


def engine_exact_from_dim(passes: tuple[str, ...], dim: int) -> int:
    """Lowest homology dimension the whole pass pipeline preserves."""
    return max((get_pass(p).exact_from_dim(dim) for p in passes), default=0)


def _sweep_mask(adj, mask, f, passes, dim, sublevel):
    """One in-order application of every pass, re-masking between passes."""
    for name in passes:
        adj_m = adj & mask[..., None, :] & mask[..., :, None]
        f_m = torch.where(mask, f, INF)
        mask = get_pass(name).apply_mask(adj_m, mask, f_m, dim, sublevel) & mask
    return mask


def apply_passes(g: GraphBatch, passes, dim: int,
                 sublevel: bool = True) -> GraphBatch:
    """One sweep through ``passes`` (the single-phase reduction)."""
    passes = validate_passes(passes)
    if not passes:
        return g
    return g.with_mask(_sweep_mask(g.adj, g.mask, g.f, passes, dim, sublevel))


def reduce_fixpoint(g: GraphBatch, passes, dim: int, sublevel: bool = True,
                    max_sweeps: int | None = None) -> GraphBatch:
    """Iterate the pass list to its joint fixpoint (mask unchanged).

    Every pass is mask-monotone, so this ends after at most N changing
    sweeps, and each sweep composes exact reductions.
    """
    passes = validate_passes(passes)
    if not passes:
        return g
    m = g.mask
    sweeps = 0
    while max_sweeps is None or sweeps < max_sweeps:
        new = _sweep_mask(g.adj, m, g.f, passes, dim, sublevel)
        sweeps += 1
        counters.LOOP_ROUNDS["fixpoint_sweeps"] += 1
        changed = bool((new != m).any())
        m = new
        if not changed:
            break
    return g.with_mask(m)


def run_reduction(g: GraphBatch, passes, dim: int, sublevel: bool,
                  fixpoint: bool, max_sweeps: int | None = None) -> GraphBatch:
    """The sweep-vs-fixpoint dispatch every execution path shares."""
    if fixpoint:
        return reduce_fixpoint(g, passes, dim, sublevel, max_sweeps)
    return apply_passes(g, passes, dim, sublevel)


class ReductionEngine:
    """A configured pass pipeline as a callable.

    >>> engine = ReductionEngine(("prunit", "kcore"), dim=1)
    >>> g_red = engine(g)                 # fixpoint-reduced batch
    >>> engine.exact_from_dim()           # 1: PD_j exact for j >= 1
    """

    def __init__(self, passes=("prunit", "kcore"), dim: int = 1,
                 sublevel: bool = True, fixpoint: bool = True,
                 max_sweeps: int | None = None):
        self.passes = validate_passes(passes)
        self.dim = int(dim)
        self.sublevel = bool(sublevel)
        self.fixpoint = bool(fixpoint)
        self.max_sweeps = max_sweeps

    def __call__(self, g: GraphBatch) -> GraphBatch:
        return run_reduction(g, self.passes, self.dim, self.sublevel,
                             self.fixpoint, self.max_sweeps)

    def exact_from_dim(self) -> int:
        return engine_exact_from_dim(self.passes, self.dim)

    def __repr__(self) -> str:
        mode = "fixpoint" if self.fixpoint else "sweep"
        return (f"ReductionEngine({'|'.join(self.passes) or 'identity'}, "
                f"dim={self.dim}, {mode})")
