"""ShardedIndex: TopoIndex partitioned row-wise over an index mesh
(counterpart of ``repro.index.sharded_index``, in one process).

This class keeps the :class:`repro_torch.index.topo_index.TopoIndex` query
surface and lays the retrieve path over the devices of a
:func:`repro_torch.launch.make_index_mesh` grid, one row block per shard:

* **row stores**: packed LSH codes (int32 words) and compacted clouds are
  cut in contiguous row blocks over the *flattened* mesh, shard ``p`` of
  ``P`` owning rows ``[p*per, (p+1)*per)``
  (:func:`repro_torch.launch.sharding.index_row_spec`), each block on its
  shard's device;
* **coarse stage on the device**: :func:`repro_torch.index.topo_index.
  device_scan`, the single-host index's own device scan, over the shards'
  blocks: per shard the Hamming kernel and a local top-``m`` on the int64
  key ``dist * N + row``, merged on the base index's device on the same
  key.  The global top-``m`` is a subset of the union of the shards'
  top-``m``, so the candidates equal the single-host scan's, ties
  included; at P = 1 the two indexes run the same code;
* **SUMMA Gram**: for ``coarse="none"`` and :meth:`gram`, corpus rows split
  over ``"row"`` and the embedding width over ``"col"``
  (:func:`repro_torch.launch.sharding.index_gram_specs`).  Query blocks step around the
  ``"row"`` ring: at step ``s`` mesh row ``r`` holds query block
  ``(r - s) mod R``, computes the pairwise-L1 partial of each column's
  width slice, and sums the ``C`` partials in column order;
* **shard-owner gather**: :meth:`clouds` groups the requested rows by
  owning shard, gathers each group from its shard's block, and scatters
  the results back into request order.

``add`` appends through the base index and marks the device state dirty;
the next query re-shards.  ``save``/``load`` use the TopoIndex ``.npz``, so
sharded and single-host indexes (of either package) share their files.
The base index stays the store of record and holds the query embeddings
and the results, on its device.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import counters
from repro_torch.core.persistence import Diagrams
from repro_torch.index.topo_index import (
    QueryResult,
    TopoIndex,
    TopoIndexConfig,
    clouds_to_diagrams,
    device_scan,
)
from repro_torch.kernels import ops
from repro_torch.kernels.hamming import as_int32_words, pack_codes_u32
from repro_torch.launch.mesh import IndexMesh, make_index_mesh


def _default_mesh(device: torch.device) -> IndexMesh:
    """Every CUDA device for an index on CUDA; else its one device."""
    if device.type == "cuda":
        return make_index_mesh()
    return make_index_mesh(devices=[device])


class ShardedIndex:
    """Mesh-sharded retrieve -> re-rank index with the TopoIndex surface.

    >>> index = ShardedIndex(TopoIndexConfig(coarse="lsh"))
    >>> index.add(diagrams, ids=["a", "b", "c"])
    >>> ids, dists = index.query(query_diagrams, k=2)

    Wrap an existing single-host index with :meth:`from_index`.  ``device``
    places a new base index (CUDA unless ``device="cpu"``); the default
    mesh covers every CUDA device for an index on CUDA, and the base's one
    device otherwise.
    """

    def __init__(self, config: TopoIndexConfig | None = None,
                 mesh: IndexMesh | None = None,
                 base: TopoIndex | None = None, device=None):
        if base is not None and (config is not None or device is not None):
            raise ValueError("pass config and device, or base, not both")
        self.base = base if base is not None else TopoIndex(config, device)
        self.mesh = mesh if mesh is not None else _default_mesh(
            self.base.device)
        self._dirty = True
        self._codes: list[torch.Tensor] | None = None  # (per, W) per shard
        self._clouds: list[torch.Tensor] = []  # (per, 3, n_points) per shard
        self._emb: list[list[torch.Tensor]] = []  # (per_r, dp / C) per (r, c)
        self._per = 0    # rows per shard (flattened partition)
        self._per_r = 0  # rows per mesh-row group (SUMMA)

    # --------------------------------------------------- TopoIndex surface

    @property
    def config(self) -> TopoIndexConfig:
        return self.base.config

    @property
    def device(self) -> torch.device:
        return self.base.device

    @property
    def ids(self) -> tuple[str, ...]:
        return self.base.ids

    def __len__(self) -> int:
        return len(self.base)

    @property
    def n_shards(self) -> int:
        return self.mesh.size

    @classmethod
    def from_index(cls, index: TopoIndex,
                   mesh: IndexMesh | None = None) -> "ShardedIndex":
        return cls(mesh=mesh, base=index)

    def embed(self, d: Diagrams) -> torch.Tensor:
        return self.base.embed(d)

    def query_codes(self, d: Diagrams) -> np.ndarray:
        return self.base.query_codes(d)

    def add(self, d: Diagrams, ids: Optional[Sequence[str]] = None
            ) -> list[str]:
        """Append through the base index; re-sharded at the next query."""
        out = self.base.add(d, ids=ids)
        self._dirty = True
        return out

    def save(self, path: str) -> None:
        self.base.save(path)

    @classmethod
    def load(cls, path: str, mesh: IndexMesh | None = None,
             device=None) -> "ShardedIndex":
        """Load a TopoIndex save (either package's) and shard it over
        ``mesh`` at the first query."""
        return cls.from_index(TopoIndex.load(path, device=device), mesh=mesh)

    def clouds(self, rows: np.ndarray) -> Diagrams:
        """Shard-owner gather of the stored clouds of ``rows``: Diagrams
        shaped ``rows.shape + (n_points,)`` on the index's device, the same
        as ``TopoIndex.clouds``."""
        if not self.base._has_clouds:
            # the base's contract: a save without clouds has no re-rank
            return self.base.clouds(rows)
        self._ensure_device_state()
        rows = np.asarray(rows)
        flat = rows.reshape(-1).astype(np.int64)
        owner = flat // max(self._per, 1)
        local = flat - owner * self._per
        out = np.empty((flat.size, 3, self.config.n_points), np.float32)
        for p in np.unique(owner):
            sel = owner == p
            blk = self._clouds[int(p)]
            idx = torch.from_numpy(local[sel]).to(blk.device)
            out[sel] = blk[idx].cpu().numpy()
        return clouds_to_diagrams(
            out.reshape(rows.shape + (3, self.config.n_points)),
            self.config.k, self.device)

    # ------------------------------------------------------- device state

    def _ensure_device_state(self) -> None:
        """(Re)build the shards' blocks on their devices after adds."""
        if not self._dirty:
            return
        base, mesh = self.base, self.mesh
        n = len(base)
        if n == 0:
            self._dirty = False
            return
        n_shards = mesh.size
        rows_ax, cols_ax = mesh.shape["row"], mesh.shape["col"]
        per = -(-n // n_shards)
        per_r = -(-n // rows_ax)
        d = base._emb.shape[1]
        dp = -(-d // cols_ax) * cols_ax
        wc = dp // cols_ax

        # flattened row partition: shard p owns rows [p*per, (p+1)*per)
        if base.config.coarse == "lsh" and base._codes.size:
            words = pack_codes_u32(base._codes)
            pad = np.zeros((n_shards * per - n, words.shape[1]), np.uint32)
            words = np.concatenate([words, pad], axis=0)
            self._codes = [as_int32_words(words[p * per:(p + 1) * per])
                           .to(dev) for p, dev in enumerate(mesh.flat)]
        else:
            self._codes = None
        self._clouds = [torch.from_numpy(base._clouds[p * per:(p + 1) * per])
                        .to(dev) for p, dev in enumerate(mesh.flat)]

        # SUMMA layout: rows over "row" groups, embedding width over "col",
        # zero-padded to (R * per_r, dp)
        emb = np.zeros((rows_ax * per_r, dp), np.float32)
        emb[:n, :d] = base._emb
        self._emb = [[torch.from_numpy(np.ascontiguousarray(
            emb[r * per_r:(r + 1) * per_r, c * wc:(c + 1) * wc])).to(dev)
            for c, dev in enumerate(row)]
            for r, row in enumerate(mesh.devices)]
        self._per, self._per_r = per, per_r
        self._dirty = False

    # -------------------------------------------------------------- query

    def _coarse_candidates(self, emb_q: np.ndarray, m: int,
                           probes: int | None = None) -> np.ndarray:
        """(Q, m) Hamming-nearest rows via the per-shard device scans, in
        the single-host scan's order: (distance, row) ascending."""
        self._ensure_device_state()
        base = self.base
        codes_q, mask_q = base._query_codes(emb_q, probes)
        n, per = len(base), self._per
        cand = device_scan(codes_q, mask_q,
                           [(p * per, codes)
                            for p, codes in enumerate(self._codes)],
                           n, m, base.device)
        counters.INDEX[("sharded_scans", "hamming")] += 1
        counters.INDEX[("sharded_rows", "hamming")] += n * codes_q.shape[0]
        return cand

    def query(self, d: Diagrams, k: int = 5,
              probes: int | None = None) -> QueryResult:
        """Batched kNN over the sharded corpus (TopoIndex semantics).

        ``coarse="lsh"``: the shards' Hamming scans, the host merge, then
        one Gram call over the candidate union
        (``TopoIndex._rank_candidates``, so the distances are the
        single-host index's, bit for bit).  ``coarse="none"`` (or a coarse
        budget that covers the index): the SUMMA Gram.
        """
        base = self.base
        if not len(base):
            raise ValueError("query on an empty ShardedIndex")
        self._ensure_device_state()
        emb_q = base.embed(d)
        c = self.config
        n = len(base)
        kk = min(int(k), n)
        p = max(int(c.probes if probes is None else probes), 1)
        n_coarse = min(max(kk, 1) * c.lsh_overfetch * p, n)
        if c.coarse == "lsh" and n_coarse < n:
            cand = self._coarse_candidates(emb_q.cpu().numpy(), n_coarse,
                                           probes=probes)
            dists, idx = base._rank_candidates(emb_q, cand, kk)
            stats = {"stage": "sharded_lsh+gram",
                     "coarse_candidates": int(n_coarse),
                     "probes": int(c.probes if probes is None else probes)}
        else:
            g = self._summa_gram(emb_q)
            # stable: ties go to the lower row, as in TopoIndex.query
            dists, idx = (t[:, :kk].cpu().numpy() for t in
                          torch.sort(g, dim=-1, stable=True))
            stats = {"stage": "sharded_gram", "coarse_candidates": n}
        stats.update(shards=self.n_shards, mesh=dict(self.mesh.shape))
        ids = [[base._ids[j] for j in row] for row in idx]
        backends = [["gram"] * len(row) for row in idx]
        return QueryResult(ids, np.asarray(dists, np.float32), backends,
                           idx, stats)

    def _summa_gram(self, emb_q: torch.Tensor) -> torch.Tensor:
        """(Q, N) f32 L1 distances via the SUMMA Gram, on the index's
        device."""
        self._ensure_device_state()
        grid = self.mesh.devices
        rows_ax, cols_ax = self.mesh.shape["row"], self.mesh.shape["col"]
        n, per_r = len(self.base), self._per_r
        nq, d = emb_q.shape
        wc = self._emb[0][0].shape[1]
        qb = -(-max(nq, 1) // rows_ax)
        q_pad = torch.zeros((qb * rows_ax, wc * cols_ax), dtype=torch.float32,
                            device=self.device)
        q_pad[:nq, :d] = emb_q
        # query blocks start "row"-sharded: mesh (r, c) holds block r's
        # width slice c
        held = [[q_pad[r * qb:(r + 1) * qb, c * wc:(c + 1) * wc]
                 .contiguous().to(dev) for c, dev in enumerate(row)]
                for r, row in enumerate(grid)]
        out = torch.empty((qb * rows_ax, per_r * rows_ax),
                          dtype=torch.float32, device=self.device)
        for s in range(rows_ax):
            for r in range(rows_ax):
                part = None
                for c in range(cols_ax):  # the psum over "col", in order
                    x = ops.pairwise_l1(held[r][c], self._emb[r][c])
                    x = x.to(self.device)
                    part = x if part is None else part + x
                blk = (r - s) % rows_ax
                out[blk * qb:(blk + 1) * qb, r * per_r:(r + 1) * per_r] = part
            # one step around the ring: row r takes row r - 1's block
            held = [[held[(r - 1) % rows_ax][c].to(dev)
                     for c, dev in enumerate(row)]
                    for r, row in enumerate(grid)]
        counters.INDEX[("sharded_scans", "summa")] += 1
        counters.INDEX[("sharded_rows", "summa")] += n * nq
        # only the last row group is padded, so device order is corpus order
        return out[:nq, :n]

    def gram(self) -> torch.Tensor:
        """(N, N) float32 self-distance matrix via the SUMMA Gram, on the
        index's device (as ``TopoIndex.gram``)."""
        self._ensure_device_state()
        return self._summa_gram(self.base._emb_device)
