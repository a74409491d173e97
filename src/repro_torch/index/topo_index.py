"""TopoIndex: a similarity index over persistence-diagram embeddings
(counterpart of ``repro.index.topo_index``, single host).

Diagrams become fixed-size vectors whose pairwise L1 distance is a diagram
metric (:func:`repro_torch.metrics.sw_embedding`, optionally concatenated
with the :mod:`repro_torch.topo.features` signature vector).  A query is a
retrieve -> re-rank pipeline:

* **coarse stage** (``coarse="lsh"``): packed hyperplane codes over the
  embeddings, Hamming-ranked on the host with byte popcounts, streamed in
  chunks with a running top-m merge;
* **Gram stage**: the pairwise-L1 kernel
  (:func:`repro_torch.kernels.ops.pairwise_l1`) over the surviving
  candidates, or over the whole index when ``coarse="none"``.

The index keeps its embeddings twice: on the host as numpy (saves and LSH
codes) and on its device (the Gram stage), CUDA unless it is created with
``device="cpu"``.  ``save``/``load`` write and read the same ``.npz`` layout
as ``repro``'s TopoIndex, so an index saved by either package loads in the
other.  Ranking ties break toward the lower row, as ``lax.top_k`` does.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.persistence import Diagrams
from repro_torch.kernels import ops
from repro_torch.metrics.distances import compact_top_k, sw_embedding
from repro_torch.topo.features import feature_vector

EMBEDDINGS = ("sw", "features", "both")
COARSE = ("none", "lsh")

# byte -> set-bit count: packed-code Hamming distances on the host
_POPCOUNT = np.array([bin(i).count("1") for i in range(256)], np.uint8)


def clouds_to_diagrams(cl: np.ndarray, k: int, device=None) -> Diagrams:
    """Diagrams rebuilt from stored compacted clouds ``(..., 3, n_points)``
    (birth, death, keep), on ``device`` (CUDA unless ``device="cpu"``)."""
    dev = resolve_device(device)
    cl = torch.from_numpy(np.asarray(cl, np.float32)).to(dev)
    keep = cl[..., 2, :] > 0
    return Diagrams(birth=cl[..., 0, :], death=cl[..., 1, :],
                    dim=torch.where(keep, k, -1).to(torch.int32), valid=keep)


@dataclasses.dataclass(frozen=True)
class TopoIndexConfig:
    """Embedding + query policy (fully determines the embedding space).

    The same fields as ``repro``'s config, so saved configs load in either
    package.
    """

    embedding: str = "sw"      # "sw" | "features" | "both"
    k: int = 1                 # homology dimension of the sw embedding
    n_points: int = 16         # top-persistence points kept per diagram
    n_dirs: int = 16           # SW direction-grid resolution
    cap: float = 64.0          # essential-class death cap
    res: int = 8               # persistence-image resolution (features)
    max_dim: int = 1           # feature dims 0..max_dim (features)
    feature_weight: float = 1.0  # scale of the features block ("both")
    coarse: str = "none"       # "none" | "lsh": Hamming prefilter stage
    lsh_bits: int = 128        # hyperplane code width (multiple of 8)
    lsh_seed: int = 7          # projection seed (defines the code space)
    lsh_overfetch: int = 8     # coarse candidates per query = k * overfetch
    probes: int = 1            # multi-probe LSH budget (1 = single probe)

    def __post_init__(self):
        if self.embedding not in EMBEDDINGS:
            raise ValueError(
                f"unknown embedding {self.embedding!r}; want one of "
                f"{EMBEDDINGS}")
        if self.coarse not in COARSE:
            raise ValueError(
                f"unknown coarse stage {self.coarse!r}; want one of {COARSE}")
        if self.lsh_bits % 8 or self.lsh_bits <= 0:
            raise ValueError(
                f"lsh_bits must be a positive multiple of 8, "
                f"got {self.lsh_bits}")
        if self.probes < 1:
            raise ValueError(f"probes must be >= 1, got {self.probes}")
        if self.flip_bits >= self.lsh_bits:
            raise ValueError(
                f"probes={self.probes} would mask {self.flip_bits} of "
                f"{self.lsh_bits} code bits")

    @property
    def flip_bits(self) -> int:
        """Low-margin query bits masked per query: the smallest t with
        2^t >= probes (one masked scan = the min over 2^t flip probes)."""
        return (self.probes - 1).bit_length()

    @property
    def width(self) -> int:
        """Embedding width: fixed by the config, independent of S."""
        w = 0
        if self.embedding in ("sw", "both"):
            w += self.n_dirs * 2 * self.n_points
        if self.embedding in ("features", "both"):
            w += (6 + self.res * self.res) * (self.max_dim + 1)
        return w


class QueryResult:
    """One batched kNN answer with per-distance backend provenance.

    ``ids``: (B, k') nested id lists, nearest first; ``distances``:
    (B, k') float32 numpy; ``backends``: (B, k') nested lists naming the
    backend of each distance (``"gram"`` = embedding L1); ``rows``: (B, k')
    int index rows of the returned entries; ``stats``: per-stage query
    statistics.  Unpacks like the 2-tuple ``(ids, distances)``.
    """

    __slots__ = ("ids", "distances", "backends", "rows", "stats")

    def __init__(self, ids, distances, backends, rows, stats):
        self.ids = ids
        self.distances = distances
        self.backends = backends
        self.rows = rows
        self.stats = stats

    def __iter__(self):
        return iter((self.ids, self.distances))

    def __getitem__(self, i):
        return (self.ids, self.distances)[i]

    def __len__(self):
        return 2

    def __repr__(self):
        b = len(self.ids)
        k = len(self.ids[0]) if self.ids else 0
        return (f"QueryResult(B={b}, k={k}, stage={self.stats.get('stage')!r}"
                f", coarse_candidates={self.stats.get('coarse_candidates')})")


class TopoIndex:
    """Retrieve -> re-rank kNN index over diagram embeddings.

    >>> index = TopoIndex(device="cpu")
    >>> index.add(diagrams, ids=["a", "b", "c"])
    >>> ids, dists = index.query(query_diagrams, k=2)
    """

    def __init__(self, config: TopoIndexConfig | None = None, device=None):
        self.config = config or TopoIndexConfig()
        self.device = resolve_device(device)
        c = self.config
        self._emb = np.zeros((0, c.width), np.float32)
        self._ids: list[str] = []
        # compacted top-persistence clouds (N, 3, n_points): birth, death,
        # keep; what an exact re-rank stage matches against
        self._clouds = np.zeros((0, 3, c.n_points), np.float32)
        self._has_clouds = True  # False only for loads of pre-clouds saves
        # packed LSH codes (N, lsh_bits/8) u8, kept when coarse="lsh"
        self._codes = np.zeros((0, c.lsh_bits // 8), np.uint8)
        self._proj: Optional[np.ndarray] = None
        # the embeddings on self.device: appended by add, set by load
        self._emb_device = torch.zeros((0, c.width), device=self.device)

    def __len__(self) -> int:
        return len(self._ids)

    @property
    def ids(self) -> tuple[str, ...]:
        return tuple(self._ids)

    # ---------------------------------------------------------- embedding

    def embed(self, d: Diagrams) -> torch.Tensor:
        """(B, width) float32 embedding of a Diagrams batch, on the index's
        device (the diagrams are moved there first)."""
        c = self.config
        d = d.to(self.device)
        parts = []
        if c.embedding in ("sw", "both"):
            parts.append(sw_embedding(d, k=c.k, n_points=c.n_points,
                                      n_dirs=c.n_dirs, cap=c.cap))
        if c.embedding in ("features", "both"):
            fv = feature_vector(d, max_dim=c.max_dim, res=c.res, cap=c.cap)
            parts.append(c.feature_weight * fv)
        emb = torch.cat(parts, dim=-1)
        if emb.dim() == 1:
            emb = emb[None]
        return emb.to(torch.float32).contiguous()

    def _projection(self) -> np.ndarray:
        """(width, lsh_bits) hyperplane normals: pure in (width, bits, seed)."""
        if self._proj is None:
            rng = np.random.default_rng(self.config.lsh_seed)
            self._proj = rng.standard_normal(
                (self.config.width, self.config.lsh_bits)).astype(np.float32)
        return self._proj

    def _lsh_margins(self, emb: np.ndarray) -> np.ndarray:
        """(B, lsh_bits) signed margins of row-centered (B, width) host
        embeddings: ``margin > 0`` is the code bit, ``|margin|`` its
        confidence."""
        centered = emb - emb.mean(axis=-1, keepdims=True)
        return centered @ self._projection()

    def _lsh_codes(self, emb: np.ndarray) -> np.ndarray:
        """(B, lsh_bits/8) packed hyperplane codes."""
        return np.packbits(self._lsh_margins(emb) > 0, axis=-1)

    def _query_bit_masks(self, margins: np.ndarray,
                         probes: int | None = None) -> Optional[np.ndarray]:
        """(B, lsh_bits/8) packed query masks clearing the ``flip_bits``
        lowest-``|margin|`` bits, or ``None`` for a budget of 1 probe."""
        p = self.config.probes if probes is None else int(probes)
        if p < 1:
            raise ValueError(f"probes must be >= 1, got {p}")
        t = (p - 1).bit_length()
        if t == 0:
            return None
        if t >= self.config.lsh_bits:
            raise ValueError(
                f"probes={p} would mask {t} of {self.config.lsh_bits} bits")
        keep = np.ones(margins.shape, bool)
        flip = np.argpartition(np.abs(margins), t - 1, axis=-1)[:, :t]
        np.put_along_axis(keep, flip, False, axis=-1)
        return np.packbits(keep, axis=-1)

    def query_codes(self, d: Diagrams) -> np.ndarray:
        """(B, lsh_bits/8) packed LSH codes of a query batch, whatever the
        ``coarse`` setting."""
        return self._lsh_codes(self.embed(d).cpu().numpy())

    # -------------------------------------------------------- add / query

    def add(self, d: Diagrams, ids: Optional[Sequence[str]] = None
            ) -> list[str]:
        """Embed and append a batch; returns the assigned ids."""
        d = d.to(self.device)
        emb_dev = self.embed(d)
        emb = emb_dev.cpu().numpy()
        if ids is None:
            ids = [f"g{len(self._ids) + i}" for i in range(emb.shape[0])]
        ids = [str(i) for i in ids]
        if len(ids) != emb.shape[0]:
            raise ValueError(f"{len(ids)} ids for {emb.shape[0]} diagrams")
        dup = set(ids) & set(self._ids)
        if dup:
            raise ValueError(f"duplicate ids: {sorted(dup)}")
        c = self.config
        b, e, keep = compact_top_k(d, c.k, c.n_points, c.cap)
        clouds = torch.stack([b, e, keep.to(torch.float32)], dim=-2)
        clouds = clouds.reshape(-1, 3, c.n_points).cpu().numpy()
        self._emb = np.concatenate([self._emb, emb], axis=0)
        self._clouds = np.concatenate([self._clouds, clouds], axis=0)
        if c.coarse == "lsh":
            self._codes = np.concatenate(
                [self._codes, self._lsh_codes(emb)], axis=0)
        self._ids.extend(ids)
        self._emb_device = torch.cat([self._emb_device, emb_dev], dim=0)
        return ids

    def clouds(self, rows: np.ndarray) -> Diagrams:
        """Diagrams rebuilt from the stored compacted clouds of ``rows``,
        shaped ``rows.shape + (n_points,)``, on the index's device."""
        if not self._has_clouds:
            raise ValueError(
                "index was loaded from a save without stored clouds; "
                "re-add the diagrams to enable the exact re-rank stage")
        return clouds_to_diagrams(self._clouds[rows], self.config.k,
                                  self.device)

    def _coarse_candidates(self, emb_q: np.ndarray, m: int,
                           probes: int | None = None,
                           chunk: int = 1 << 16) -> np.ndarray:
        """(Q, m) Hamming-nearest row indices (the coarse LSH stage).

        XOR + popcount over the packed bytes, streamed in ``chunk``-row
        blocks with a running per-query top-``m`` merge on the key
        ``dist * N + row``, so ties go to the lower row whatever the
        chunking.  With ``probes`` > 1 the ``flip_bits`` lowest-margin query
        bits are masked out of the distance.
        """
        margins = self._lsh_margins(emb_q)
        codes_q = np.packbits(margins > 0, axis=-1)
        mask_q = self._query_bit_masks(margins, probes)
        n = self._codes.shape[0]
        best = np.zeros((codes_q.shape[0], 0), np.int64)
        for s in range(0, n, chunk):
            x = codes_q[:, None, :] ^ self._codes[None, s:s + chunk, :]
            if mask_q is not None:
                x &= mask_q[:, None, :]
            dist = _POPCOUNT[x].sum(axis=-1, dtype=np.int64)
            key = dist * n + np.arange(s, s + dist.shape[1], dtype=np.int64)
            cat = np.concatenate([best, key], axis=1)
            if cat.shape[1] > m:
                cat = np.take_along_axis(
                    cat, np.argpartition(cat, m - 1, axis=-1)[:, :m], -1)
            best = cat
        best.sort(axis=-1)
        return best % n

    def _rank_candidates(self, emb_q: torch.Tensor, cand: np.ndarray,
                         kk: int) -> tuple[np.ndarray, np.ndarray]:
        """Gram-rank (Q, m) candidate rows -> top-``kk`` (dists, rows), one
        pairwise-L1 call over the candidate union."""
        union, inv = np.unique(cand, return_inverse=True)
        inv = inv.reshape(cand.shape)
        rows = torch.from_numpy(union).to(self.device)
        gram_u = ops.pairwise_l1(emb_q, self._emb_device[rows].contiguous())
        cand_d = gram_u.cpu().numpy()[np.arange(cand.shape[0])[:, None], inv]
        order = np.argsort(cand_d, axis=-1, kind="stable")[:, :kk]
        return (np.take_along_axis(cand_d, order, axis=-1),
                np.take_along_axis(cand, order, axis=-1))

    def query(self, d: Diagrams, k: int = 5,
              probes: int | None = None) -> QueryResult:
        """Batched kNN, nearest first; every distance is the embedding L1
        (backend ``"gram"``).

        ``coarse="none"`` (or a coarse budget that covers the index): one
        (Q, N) Gram call.  ``coarse="lsh"``: Hamming top
        ``k * lsh_overfetch * probes`` per query, then the Gram kernel over
        the candidate union.  ``probes`` overrides the config's multi-probe
        budget for this batch.
        """
        if not self._ids:
            raise ValueError("query on an empty TopoIndex")
        emb_q = self.embed(d)
        c = self.config
        kk = min(int(k), len(self._ids))
        p = max(int(c.probes if probes is None else probes), 1)
        n_coarse = min(max(kk, 1) * c.lsh_overfetch * p, len(self._ids))
        if c.coarse == "lsh" and n_coarse < len(self._ids):
            cand = self._coarse_candidates(emb_q.cpu().numpy(), n_coarse,
                                           probes=probes)
            dists, idx = self._rank_candidates(emb_q, cand, kk)
            stats = {"stage": "lsh+gram", "coarse_candidates": int(n_coarse),
                     "probes": int(c.probes if probes is None else probes)}
        else:
            gram = ops.pairwise_l1(emb_q, self._emb_device)
            # stable: ties go to the lower row, as lax.top_k(-gram) does
            dists, idx = (t[:, :kk].cpu().numpy() for t in
                          torch.sort(gram, dim=-1, stable=True))
            stats = {"stage": "gram", "coarse_candidates": len(self._ids)}
        ids = [[self._ids[j] for j in row] for row in idx]
        backends = [["gram"] * len(row) for row in idx]
        return QueryResult(ids, np.asarray(dists, np.float32), backends,
                           idx, stats)

    def gram(self) -> torch.Tensor:
        """(N, N) float32 self-distance matrix of the whole index, on the
        index's device (the clustering input)."""
        e = self._emb_device
        return ops.pairwise_l1(e, e)

    # -------------------------------------------------------- persistence

    def save(self, path: str) -> None:
        """Write embeddings + clouds + ids + config as one ``.npz`` at
        ``path`` verbatim (the layout ``repro``'s TopoIndex reads).

        LSH codes are stored when the coarse stage is on; an index loaded
        from a save without clouds re-saves without them.
        """
        payload = dict(
            emb=self._emb,
            ids=np.asarray(self._ids, dtype=np.str_),
            config=np.str_(json.dumps(dataclasses.asdict(self.config))),
        )
        if self._has_clouds:
            payload["clouds"] = self._clouds
        if self.config.coarse == "lsh":
            payload["codes"] = self._codes
        with open(path, "wb") as fh:
            np.savez(fh, **payload)

    @classmethod
    def load(cls, path: str, device=None) -> "TopoIndex":
        """An index from a ``.npz`` written by ``save`` (this package's or
        ``repro``'s), with its embeddings on ``device``."""
        with np.load(path, allow_pickle=False) as z:
            config = TopoIndexConfig(**json.loads(str(z["config"])))
            index = cls(config, device=device)
            emb = np.asarray(z["emb"], np.float32)
            if emb.shape[1] != config.width:
                raise ValueError(
                    f"embedding width {emb.shape[1]} does not match config "
                    f"width {config.width}")
            index._emb = emb
            index._emb_device = torch.from_numpy(emb).to(index.device)
            index._ids = [str(i) for i in z["ids"]]
            if "clouds" in z.files:
                index._clouds = np.asarray(z["clouds"], np.float32)
            else:  # a save without clouds: queryable, no exact re-rank
                index._clouds = np.zeros(
                    (len(index._ids), 3, config.n_points), np.float32)
                index._has_clouds = False
            if config.coarse == "lsh":
                codes = (np.asarray(z["codes"], np.uint8)
                         if "codes" in z.files else None)
                if codes is not None and codes.shape == (
                        emb.shape[0], config.lsh_bits // 8):
                    index._codes = codes
                else:  # a save without codes: rebuild them from emb
                    index._codes = index._lsh_codes(emb)
        return index
