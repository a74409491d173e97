"""PriceCache: an LRU of converged auction price vectors for warm starts
(the port of ``repro.metrics.price_cache``).

The collapsed forward/reverse auction (``kernels/auction_lap.py``) returns
its final object-price vector in max-normalized units and accepts any
nonnegative price vector as a warm start: the reverse rounds re-ground
stale prices, so a warm start can save rounds but never breaks optimality.

Vectors are keyed by ``(query LSH bucket code, candidate row)``: two
queries in the same hyperplane bucket are near-duplicates in the
embedding metric, so their reduced-cost matrices against one stored
candidate are close and one's converged prices start the other near
equilibrium.  Only converged vectors are stored; a miss returns zeros, the
solver's own cold start.  Hits and misses count in
``repro_torch.counters.AUCTION`` under the cache's ``instance`` label.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np

from repro_torch import counters


class PriceCache:
    """LRU ``(bucket code bytes, candidate row) -> (n_points,) f32 prices``.

    ``capacity`` bounds the number of stored vectors (LRU eviction).  Not
    thread-safe on its own: a server calls it under its drain lock.
    ``instance`` labels the hit and miss counts so several caches in one
    process report separately.
    """

    def __init__(self, capacity: int = 4096, instance: str = ""):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = int(capacity)
        self.instance = instance
        self._store: OrderedDict[tuple[bytes, int], np.ndarray] = OrderedDict()

    def __len__(self) -> int:
        return len(self._store)

    def lookup(self, codes: np.ndarray, rows: np.ndarray,
               n_points: int) -> tuple[np.ndarray, int, int]:
        """Warm-start prices for a (Q, C) batch of query x candidate pairs.

        ``codes``: (Q, code_bytes) u8 packed bucket codes, one per query;
        ``rows``: (Q, C) int candidate rows.  Returns ``(prices (Q, C,
        n_points) f32, hits, misses)``; missed pairs are zero rows.
        """
        codes = np.asarray(codes)
        rows = np.asarray(rows)
        q, c = rows.shape
        out = np.zeros((q, c, n_points), np.float32)
        hits = 0
        for i in range(q):
            key_q = codes[i].tobytes()
            for j in range(c):
                key = (key_q, int(rows[i, j]))
                v = self._store.get(key)
                if v is not None and v.shape[0] == n_points:
                    out[i, j] = v
                    self._store.move_to_end(key)
                    hits += 1
        misses = q * c - hits
        counters.AUCTION[("warm_start_hits", self.instance)] += hits
        counters.AUCTION[("warm_start_misses", self.instance)] += misses
        return out, hits, misses

    def store(self, codes: np.ndarray, rows: np.ndarray,
              prices: np.ndarray, converged: np.ndarray) -> int:
        """Store the converged price vectors of a finished (Q, C) batch.

        ``prices``: (Q, C, n_points) f32 from ``compare_info``;
        ``converged``: (Q, C) bool, unconverged solves are skipped (their
        prices are mid-ladder).  Returns the number of vectors stored.
        """
        codes = np.asarray(codes)
        rows = np.asarray(rows)
        prices = np.asarray(prices, np.float32)
        converged = np.asarray(converged)
        q, c = rows.shape
        stored = 0
        for i in range(q):
            key_q = codes[i].tobytes()
            for j in range(c):
                if not converged[i, j]:
                    continue
                key = (key_q, int(rows[i, j]))
                self._store[key] = prices[i, j].copy()
                self._store.move_to_end(key)
                stored += 1
        while len(self._store) > self.capacity:
            self._store.popitem(last=False)
        return stored

    @property
    def hits(self) -> int:
        return counters.AUCTION[("warm_start_hits", self.instance)]

    @property
    def misses(self) -> int:
        return counters.AUCTION[("warm_start_misses", self.instance)]
