r"""TopoStream: exact incremental persistence for dynamic graphs
(counterpart of ``repro.stream.topo_stream``).

The paper's two reduction theorems are *locality* statements:

* **Theorem 2 (CoralTDA)** — ``PD_k(G, f) = PD_k(G^{k+1}, f)`` for k >= 1:
  the k-th diagram only sees the (k+1)-core.
* **Theorem 7 (PrunIT)** — deleting a dominated vertex (``N[u] ⊆ N[v]`` with
  ``f(u) >= f(v)``, sublevel) preserves *every* ``PD_k``.

So most updates to a large network provably cannot change its diagram, and
a stream of updates needs only a graph-level check, not a fresh
boundary-matrix reduction, to know that.  ``TopoStream`` is a stateful
session over a :class:`GraphBatch`: it holds the current graphs, their
(dim+1)-core masks, their eligibility matrices and the last diagrams.
``apply(delta)`` runs the **invalidation verdict** (on CUDA a
``kcore_peel`` launch and a ``domination`` launch) and re-executes the
session's persistence plan only for the graphs whose diagram could have
moved, gathered into a power-of-two sub-batch so the recompute cost scales
with the misses, not with the batch.

Invalidation predicates (both exact, proofs in ``invalidation_verdict``):

* **coral hit** — the induced (dim+1)-core subgraph (vertex set, edges and f
  on it) is unchanged ⟹ ``PD_j`` unchanged for all ``j >= dim``.  Guards the
  *target* dimension only, so it is enabled for ``exact_dims="target"`` and
  ``dim >= 1``.
* **prunit hit** — every touched vertex is dominated, before *and* after the
  update, by an untouched witness satisfying the f condition ⟹ ``PD_k``
  unchanged for *all* k.  Always enabled.

``exact_dims="target"`` (default) serves ``PD_dim`` exactly; lower dims may
be stale after coral hits (``all_dims_exact`` tracks this per graph).
``exact_dims="all"`` keeps only the prunit predicate (and reductions exact
in every dimension) so the full diagram tensor stays exact.

A step reads its verdict to the host once: the five (B,) vectors (touched,
coral, prunit, recompute, caps_ok) stacked into one device-to-host copy.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import obs
from repro_torch._device import resolve_device
from repro_torch.core.api import REDUCTIONS, TopoPlan, make_topo_plan
from repro_torch.core.delta import DeltaBatch, apply_delta
from repro_torch.core.filtration import complex_caps_ok
from repro_torch.core.graph import GraphBatch
from repro_torch.core.kcore import coreness, kcore_mask
from repro_torch.core.persistence import REDUCERS, Diagrams, diagrams_to_numpy
from repro_torch.core.prunit import eligibility_matrix as _prunit_eligibility
from repro_torch.stream.calibration import (
    DriftCalibrator,
    parse_drift_threshold,
)

# reductions exact in every homology dimension (no coral core restriction)
_ALL_DIM_METHODS = ("prunit", "none")

# process-wide TopoScope instruments (the per-session breakdown stays in the
# session's own ``stats`` dict; these aggregate across every session)
_OBS_VERDICTS = obs.counter(
    "stream.verdicts", help="invalidation verdicts per (graph, step) touch")
_OBS_DRIFT = obs.histogram(
    "stream.drift_score", help="drift distances of recomputed graphs",
    buckets=(0.01, 0.03, 0.1, 0.3, 1.0, 3.0, 10.0, 30.0, 100.0))

_FIELDS = ("birth", "death", "dim", "valid")
_FLAGS = ("touched", "coral_hit", "prunit_hit", "recompute", "caps_ok")


@dataclasses.dataclass(frozen=True)
class TopoStreamConfig:
    """Pipeline parameters + invalidation policy for one stream session.

    ``reducer`` names one of the port's reducers (``"blocks"``, the plan's
    default, or ``"flat"``); ``repro``'s ``"jnp"`` and ``"pallas"`` have no
    counterpart here and are refused.

    Drift scoring (``drift_metric="sw"`` or any registered MetricEngine
    backend, e.g. ``"sinkhorn"``/``"exact_w"``): each step also reports,
    per graph, the backend's distance between the previous and the new
    ``PD_drift_dim``; cache hits are distance 0 by the theorems, so only
    recomputed graphs are scored.  ``last_drift`` / ``last_anomaly`` expose
    the scores; a score above ``drift_threshold`` flags an anomaly.
    ``drift_threshold`` is a constant or ``"auto:q0.99"``-style: an online
    P² quantile estimator over each graph's own drift history
    (``stream/calibration.py``), with no flags during the first
    ``drift_warmup`` observed recomputes of a graph.

    ``repack="on"`` makes the session's plan two-phase (reduce → repack →
    persist); the session keeps the last reduce-phase report in
    ``last_repack``.
    """

    dim: int = 1
    method: str = "both"
    sublevel: bool = True
    edge_cap: int = 256
    tri_cap: int = 512
    quad_cap: int = 0
    reducer: str = "blocks"
    exact_dims: str = "target"   # "target" (coral+prunit) | "all" (prunit)
    recompute_pad: str = "pow2"  # "pow2" | "full" sub-batch padding policy
    check_caps: bool = True      # verify simplex caps still hold after updates
    repack: str = "off"          # "off" | "on": two-phase persist
    drift_metric: str | None = None  # None (off) | any MetricEngine backend
    drift_dim: int | None = None     # diagram dimension scored (default: dim)
    drift_threshold: float | str = 1.0  # constant, or "auto:qX" (P² quantile)
    drift_n_dirs: int = 16           # SW direction-grid resolution
    drift_cap: float = 64.0          # essential-class death cap
    drift_warmup: int = 10           # auto mode: min observations before flags

    def __post_init__(self):
        if self.method not in REDUCTIONS:
            raise ValueError(f"unknown reduction {self.method!r}")
        if self.reducer not in REDUCERS:
            raise ValueError(
                f"reducer {self.reducer!r} is not one of the port's "
                f"reducers {REDUCERS} (repro's 'jnp' and 'pallas' paths have "
                f"no counterpart here)")
        if self.exact_dims not in ("target", "all"):
            raise ValueError(f"exact_dims must be 'target' or 'all', "
                             f"got {self.exact_dims!r}")
        if self.exact_dims == "all" and self.method not in _ALL_DIM_METHODS:
            raise ValueError(
                f"exact_dims='all' requires a reduction exact in every "
                f"dimension ({_ALL_DIM_METHODS}); {self.method!r} restricts "
                f"to the (dim+1)-core and breaks PD_0..PD_dim-1")
        if self.recompute_pad not in ("pow2", "full"):
            raise ValueError(f"recompute_pad must be 'pow2' or 'full', "
                             f"got {self.recompute_pad!r}")
        if self.repack not in ("off", "on"):
            raise ValueError(f"repack must be 'off' or 'on', "
                             f"got {self.repack!r}")
        parse_drift_threshold(self.drift_threshold)  # raises on bad spec
        if self.drift_warmup < 5:
            raise ValueError(f"drift_warmup must be >= 5 (P² needs 5 "
                             f"observations), got {self.drift_warmup}")
        if self.drift_metric is not None:
            from repro_torch.metrics.engine import get_metric
            try:
                get_metric(self.drift_metric)
            except ValueError as e:
                raise ValueError(f"drift_metric: {e}") from None
        if self.drift_dim is not None and not (0 <= self.drift_dim <= self.dim):
            raise ValueError(
                f"drift_dim {self.drift_dim} outside computed dims 0..{self.dim}")
        if (self.drift_metric is not None and self.drift_dim is not None
                and self.drift_dim < self.dim and self.exact_dims != "all"):
            # coral hits leave dims < dim stale, so a later recompute would
            # misattribute the accumulated sub-target movement to one step
            raise ValueError(
                f"drift_dim {self.drift_dim} < dim {self.dim} requires "
                f"exact_dims='all' (with exact_dims='target' the scored "
                f"dimension can go stale on coral hits)")


@dataclasses.dataclass(frozen=True)
class StreamVerdict:
    """Per-graph invalidation outcome of one ``apply`` step.

    touched:    any effective change (adjacency, mask, or f) this step.
    coral_hit:  induced (dim+1)-core unchanged (PD_{>=dim} preserved).
    prunit_hit: all touched vertices dominated before+after by untouched
                witnesses (every PD_k preserved).
    recompute:  touched & not hit — the graphs the plan re-executes on.
    core_mask:  fresh (dim+1)-core mask of the updated graphs.
    elig:       fresh eligibility (domination & f-condition) matrix.
    caps_ok:    simplex caps still hold for the updated graph.
    """

    touched: torch.Tensor
    coral_hit: torch.Tensor
    prunit_hit: torch.Tensor
    recompute: torch.Tensor
    core_mask: torch.Tensor
    elig: torch.Tensor
    caps_ok: torch.Tensor


def eligibility_matrix(g: GraphBatch, sublevel: bool = True) -> torch.Tensor:
    """(B, N, N) bool E with E[u, v] = "PrunIT may remove u with witness v":
    the GraphBatch view of ``core.prunit.eligibility_matrix`` (on CUDA one
    ``domination`` launch)."""
    return _prunit_eligibility(g.adj, g.mask, g.f, sublevel)


def _prunit_safe(touched_v: torch.Tensor, mask: torch.Tensor,
                 elig: torch.Tensor) -> torch.Tensor:
    r"""(B,) bool: every touched live vertex has an untouched witness.

    Soundness (Theorem 7, iterated): let U be the touched set.  Each u in U
    with a witness v ∉ U stays dominated while *other* members of U are
    removed (deleting z ∉ {u, v} preserves ``N[u] ⊆ N[v]``, and f never
    changes under vertex deletion), so removing U∩live one by one is a valid
    PrunIT sequence: ``PD_k(G) = PD_k(G \ U)`` for all k.
    """
    witness_ok = (elig & ~touched_v[..., None, :]).any(-1)
    need = touched_v & mask
    return (~need | witness_ok).all(-1)


def invalidation_verdict(
    g_old: GraphBatch,
    g_new: GraphBatch,
    core_old: torch.Tensor,
    elig_old: torch.Tensor,
    dim: int,
    sublevel: bool,
    use_coral: bool,
    check_caps: bool = False,
    edge_cap: int = 0,
    tri_cap: int = 0,
    quad_cap: int = 0,
) -> StreamVerdict:
    """The reduction-aware invalidation check (tensors on the batch's device,
    no host sync).

    The touched set is the exact state diff, so ineffective ops (inserting
    an existing edge, rewriting f with the same value) never invalidate.

    Coral predicate: ``PD_dim(G) = PD_dim(core_{dim+1}(G))`` (Thm 2), so if
    the (dim+1)-core *as an f-labelled induced subgraph* is identical in G
    and G', then ``PD_dim(G) = PD_dim(G')``.  The core of G' is taken from
    scratch (one ``kcore_peel`` launch on CUDA), which makes edge insertions
    safe too: an inserted edge between outside-core vertices can create new
    core, which mask equality detects.

    PrunIT predicate: see ``_prunit_safe``; applying it to both G and G'
    gives ``PD_k(G) = PD_k(G \\ U) = PD_k(G' \\ U) = PD_k(G')`` for all k,
    because every changed edge/f/mask entry is incident to the touched set U,
    hence ``G \\ U = G' \\ U``.

    The caps check is the batched ``filtration.complex_caps_ok``.
    """
    adj_diff = g_old.adj ^ g_new.adj
    f_diff = g_old.f != g_new.f
    mask_diff = g_old.mask ^ g_new.mask
    # U only needs to COVER the diff: vertices whose own state changed, plus
    # both endpoints of any changed edge not already covered (dropping u
    # flips its neighbours' rows, but {u} alone covers those edges)
    u0 = f_diff | mask_diff                                      # (B, N)
    covered = u0[..., None, :] | u0[..., :, None]
    touched_v = u0 | (adj_diff & ~covered).any(-1)               # (B, N)
    touched = touched_v.any(-1) | adj_diff.any(-1).any(-1)

    core_new = kcore_mask(g_new.adj, g_new.mask, dim + 1)
    elig_new = eligibility_matrix(g_new, sublevel)

    if use_coral:
        core_same = (core_new == core_old).all(-1)
        edge_in_core = (adj_diff & core_new[..., None, :]
                        & core_new[..., :, None]).any(-1).any(-1)
        f_in_core = (f_diff & core_new).any(-1)
        coral_hit = core_same & ~edge_in_core & ~f_in_core
    else:
        coral_hit = torch.zeros_like(touched)

    prunit_hit = (_prunit_safe(touched_v, g_old.mask, elig_old)
                  & _prunit_safe(touched_v, g_new.mask, elig_new))

    hit = coral_hit | prunit_hit
    if check_caps:
        caps_ok = complex_caps_ok(g_new.adj, g_new.mask, edge_cap, tri_cap,
                                  quad_cap, max_dim=dim)
    else:
        caps_ok = torch.ones_like(touched)
    return StreamVerdict(
        touched=touched,
        coral_hit=coral_hit & touched,
        prunit_hit=prunit_hit & touched,
        recompute=touched & ~hit,
        core_mask=core_new,
        elig=elig_new,
        caps_ok=caps_ok,
    )


def _rows(d: Diagrams, idx: torch.Tensor) -> Diagrams:
    return Diagrams(*(getattr(d, k)[idx] for k in _FIELDS))


def _scatter_rows(cur: Diagrams, idx: torch.Tensor, new: Diagrams) -> Diagrams:
    """``cur`` with rows ``idx`` replaced by the rows of ``new``, in order."""
    out = []
    for k in _FIELDS:
        x = getattr(cur, k).clone()
        x[idx] = getattr(new, k)
        out.append(x)
    return Diagrams(*out)


class TopoStream:
    """Stateful incremental-persistence session over a GraphBatch.

    >>> stream = TopoStream(g0, TopoStreamConfig(dim=1, method="both"))
    >>> d = stream.apply(delta)        # fresh-or-cached Diagrams, exact PD_1
    >>> stream.stats["hits"], stream.stats["recomputes"]

    The session runs on ``device`` (CUDA unless ``device="cpu"``; without a
    card ``None`` raises), moving ``g`` and every delta there.  Recomputes
    gather only the invalidated graphs into a power-of-two sub-batch, so the
    plan (and its ``kcore_peel``, ``domination`` and ``gf2_reduce``
    launches) sees batches of 1, 2, 4, … B.
    """

    def __init__(self, g: GraphBatch, config: TopoStreamConfig | None = None,
                 device=None):
        self.config = config or TopoStreamConfig()
        c = self.config
        self.device = resolve_device(device)
        g = g.to(self.device)
        self._use_coral = c.exact_dims == "target" and c.dim >= 1
        self._plan: TopoPlan = make_topo_plan(
            dim=c.dim, method=c.method, sublevel=c.sublevel,
            edge_cap=c.edge_cap, tri_cap=c.tri_cap, quad_cap=c.quad_cap,
            reducer=c.reducer, repack=c.repack)
        self._g = g
        self._diagrams, self.last_repack = self._plan.execute_info(g)
        self._core = kcore_mask(g.adj, g.mask, c.dim + 1)
        self._elig = eligibility_matrix(g, c.sublevel)
        self._all_dims_exact = np.full(
            (g.batch,), c.method in _ALL_DIM_METHODS, bool)
        self.last_drift = np.zeros((g.batch,), np.float32)
        self.last_anomaly = np.zeros((g.batch,), bool)
        mode, val = parse_drift_threshold(c.drift_threshold)
        self._drift_calibrator = (
            DriftCalibrator(g.batch, q=val, warmup=c.drift_warmup)
            if mode == "auto" else None)
        self._drift_const = val if mode == "const" else None
        self.stats = {
            "applied": 0,            # apply() calls
            "graph_updates": 0,      # (graph, step) pairs with a real change
            "hits": 0,               # ... answered from cache
            "coral_hits": 0,
            "prunit_hits": 0,        # prunit-only hits (coral takes priority)
            "recomputes": 0,         # ... that re-executed the plan
            "recompute_batches": 0,  # plan executions
            "recomputed_rows": 0,    # padded rows executed (cost proxy)
            "anomalies": 0,          # drift scores above drift_threshold
        }
        # diagnostics: the sizes of the recompute sub-batches, in order (one
        # per plan execution), and the last step's host copy of the verdict
        self.recompute_sizes: list[int] = []
        self.last_flags: dict[str, np.ndarray] = {}

    # ------------------------------------------------------------ accessors

    @property
    def graph(self) -> GraphBatch:
        """The current (post-update) GraphBatch."""
        return self._g

    @property
    def diagrams(self) -> Diagrams:
        """The maintained diagrams; ``PD_dim`` rows are always exact."""
        return self._diagrams

    @property
    def plan(self) -> TopoPlan:
        return self._plan

    @property
    def all_dims_exact(self) -> np.ndarray:
        """(B,) bool — graphs whose dims < dim rows are also exact."""
        return self._all_dims_exact.copy()

    def coreness(self) -> torch.Tensor:
        """Full per-vertex core numbers of the current graphs (diagnostic)."""
        return coreness(self._g.adj, self._g.mask)

    def skip_rate(self) -> float:
        """Fraction of graph updates answered from cache so far."""
        return self.stats["hits"] / max(self.stats["graph_updates"], 1)

    def drift_thresholds(self) -> np.ndarray:
        """(B,) per-graph anomaly threshold currently in force (``+inf``
        for a graph still in its warmup in auto mode)."""
        if self._drift_calibrator is not None:
            return self._drift_calibrator.thresholds()
        return np.full((self._g.batch,), self._drift_const, np.float32)

    # ---------------------------------------------------------------- apply

    def apply(self, delta: DeltaBatch) -> Diagrams:
        """Apply one update step; returns the (fresh-or-cached) diagrams.

        Raises ValueError if an update pushes a graph past the session's
        simplex caps (``check_caps=False`` disables the guard).
        """
        c = self.config
        with obs.span("stream.verdict", graphs=self._g.batch):
            g_new = apply_delta(self._g, delta.to(self.device))
            verdict = invalidation_verdict(
                self._g, g_new, self._core, self._elig,
                dim=c.dim, sublevel=c.sublevel, use_coral=self._use_coral,
                check_caps=c.check_caps, edge_cap=c.edge_cap,
                tri_cap=c.tri_cap, quad_cap=c.quad_cap)
            # one device-to-host copy for the five (B,) vectors
            flags = torch.stack([verdict.touched, verdict.coral_hit,
                                 verdict.prunit_hit, verdict.recompute,
                                 verdict.caps_ok]).cpu().numpy()
        touched, coral, prunit, needs, caps_ok = flags
        self.last_flags = dict(zip(_FLAGS, flags))
        if c.check_caps and not caps_ok.all():
            bad = np.nonzero(~caps_ok)[0].tolist()
            raise ValueError(
                f"update overflows simplex caps (edge_cap={c.edge_cap}, "
                f"tri_cap={c.tri_cap}) for graphs {bad}; diagrams would be "
                f"truncated — resize the session caps")

        drift = np.zeros((g_new.batch,), np.float32)
        if needs.any():
            idx = np.nonzero(needs)[0]
            old = self._diagrams
            with obs.span("stream.recompute", misses=len(idx)):
                self._diagrams = self._recompute(g_new, idx)
            self.stats["recomputes"] += int(needs.sum())
            self._all_dims_exact[idx] = c.method in _ALL_DIM_METHODS
            if c.drift_metric is not None:
                with obs.span("stream.drift", backend=c.drift_metric):
                    drift[idx] = self._drift_scores(old, self._diagrams, idx)
                for s in drift[idx]:
                    _OBS_DRIFT.observe(float(s), backend=c.drift_metric)

        if c.drift_metric is not None:
            self.last_drift = drift
            self.last_anomaly = drift > self.drift_thresholds()
            self.stats["anomalies"] += int(self.last_anomaly.sum())
            if self._drift_calibrator is not None and needs.any():
                # absorb AFTER flagging: a burst is judged against the
                # pre-burst history, then becomes part of it
                idx = np.nonzero(needs)[0]
                self._drift_calibrator.observe(idx, drift[idx])

        # coral-only hits leave dims < dim stale for that graph
        self._all_dims_exact[coral & ~prunit] = False

        self.stats["applied"] += 1
        self.stats["graph_updates"] += int(touched.sum())
        self.stats["hits"] += int((touched & ~needs).sum())
        self.stats["coral_hits"] += int(coral.sum())
        self.stats["prunit_hits"] += int((prunit & ~coral).sum())
        for verdict_name, n in (("coral_hit", int(coral.sum())),
                                ("prunit_hit", int((prunit & ~coral).sum())),
                                ("recompute", int(needs.sum()))):
            if n:
                _OBS_VERDICTS.inc(n, verdict=verdict_name)

        self._g = g_new
        self._core = verdict.core_mask
        self._elig = verdict.elig
        return self._diagrams

    def _pow2_rows(self, idx: np.ndarray, b: int) -> torch.Tensor:
        """``idx`` padded to the next power of two (at most ``b``) by
        repeating its first entry, as an index tensor on the device."""
        k = len(idx)
        r = min(b, 1 << (k - 1).bit_length())
        idx_p = np.concatenate([idx, np.full(r - k, idx[0], idx.dtype)])
        return torch.from_numpy(idx_p).to(self.device)

    def _drift_scores(self, old: Diagrams, new: Diagrams,
                      idx: np.ndarray) -> np.ndarray:
        """Drift distances between previous and fresh diagrams of ``idx``,
        through the MetricEngine registry (``compare``); the gather is
        padded to the next power of two like the recompute."""
        from repro_torch.metrics.engine import compare, metric_params

        c = self.config
        rows = self._pow2_rows(idx, old.birth.shape[0])
        params = {}
        if "n_dirs" in metric_params(c.drift_metric):
            params["n_dirs"] = c.drift_n_dirs
        scores = compare(
            _rows(old, rows), _rows(new, rows), metric=c.drift_metric,
            k=c.drift_dim if c.drift_dim is not None else c.dim,
            cap=c.drift_cap, **params)
        return scores.cpu().numpy().astype(np.float32)[:len(idx)]

    def _recompute(self, g_new: GraphBatch, idx: np.ndarray) -> Diagrams:
        """Re-execute the plan on the invalidated graphs only.

        The miss set is gathered into a sub-batch padded to the next power
        of two (``recompute_pad="pow2"``); padding rows repeat the first
        miss and are dropped at scatter time.
        """
        b = g_new.batch
        k = len(idx)
        jidx = torch.from_numpy(idx).to(self.device)
        if self.config.recompute_pad == "full" or k >= b:
            d, rep = self._plan.execute_info(g_new)
            if rep is not None:
                self.last_repack = rep
            self.stats["recompute_batches"] += 1
            self.stats["recomputed_rows"] += b
            self.recompute_sizes.append(b)
            if k >= b:
                return d
            return _scatter_rows(self._diagrams, jidx, _rows(d, jidx))
        rows = self._pow2_rows(idx, b)
        d, rep = self._plan.execute_info(g_new.index(rows))
        if rep is not None:
            self.last_repack = rep  # rung assignment of the gathered misses
        self.stats["recompute_batches"] += 1
        self.stats["recomputed_rows"] += len(rows)
        self.recompute_sizes.append(len(rows))
        return _scatter_rows(self._diagrams, jidx,
                             Diagrams(*(getattr(d, f)[:k] for f in _FIELDS)))


def dim_pairs(d: Diagrams, graph_index: int, k: int) -> list[tuple]:
    """Sorted ``(birth, death)`` pairs of ``PD_k`` for one graph: the
    streamed-vs-scratch parity artifact (cached and recomputed diagram
    tensors may order rows differently; the pairs of every guaranteed
    dimension must match bit for bit)."""
    return diagrams_to_numpy(d, graph_index, max_dim=k)[k]
