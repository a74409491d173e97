"""Online drift-threshold calibration: P² quantile estimation per graph
(the port's copy of ``repro.stream.calibration``; numpy only).

``TopoStream`` flags an anomaly when a recompute's drift score exceeds a
threshold.  A constant threshold needs workload-specific tuning;
``drift_threshold="auto:q0.99"``
instead maintains, per graph, a Jain–Chlamtac **P² estimator** of the
q-quantile of that graph's own drift history — O(1) memory (5 markers) and
O(1) update per observation, no sample buffer — and flags scores above the
current estimate.

Only *recomputed* graphs feed the estimator: cache hits score exactly 0 by
theorem (the diagram provably did not move), so including them would only
dilute the distribution of genuine diagram movement.  Scores are compared
against the threshold *before* being absorbed, so a burst is judged against
the pre-burst history; until a graph has ``warmup`` observations its
threshold is ``+inf`` (no flags from an uncalibrated estimator).
"""
from __future__ import annotations

import numpy as np


class P2Quantile:
    """Jain & Chlamtac (1985) P² online quantile estimator (one scalar
    stream).  ``value()`` is ``None`` until 5 observations have been seen."""

    def __init__(self, q: float):
        if not 0.0 < q < 1.0:
            raise ValueError(f"quantile must be in (0, 1), got {q}")
        self.q = float(q)
        self._init: list[float] = []   # first 5 observations
        self._h = np.zeros(5)          # marker heights
        self._n = np.zeros(5)          # marker positions (1-based)
        self._np = np.zeros(5)         # desired positions
        self.count = 0

    def update(self, x: float) -> None:
        x = float(x)
        self.count += 1
        if self.count <= 5:
            self._init.append(x)
            if self.count == 5:
                q = self.q
                self._h = np.sort(np.asarray(self._init, float))
                self._n = np.arange(1.0, 6.0)
                self._np = np.array(
                    [1, 1 + 2 * q, 1 + 4 * q, 3 + 2 * q, 5], float)
            return
        h, n = self._h, self._n
        if x < h[0]:
            h[0] = x
            k = 0
        elif x >= h[4]:
            h[4] = x
            k = 3
        else:
            k = int(np.searchsorted(h, x, side="right")) - 1
            k = min(max(k, 0), 3)
        n[k + 1:] += 1
        self._np += np.array([0, self.q / 2, self.q, (1 + self.q) / 2, 1.0])
        for i in (1, 2, 3):
            d = self._np[i] - n[i]
            if (d >= 1 and n[i + 1] - n[i] > 1) or (d <= -1 and n[i - 1] - n[i] < -1):
                s = 1.0 if d >= 1 else -1.0
                # parabolic (P²) marker adjustment, linear fallback
                hp = h[i] + s / (n[i + 1] - n[i - 1]) * (
                    (n[i] - n[i - 1] + s) * (h[i + 1] - h[i]) / (n[i + 1] - n[i])
                    + (n[i + 1] - n[i] - s) * (h[i] - h[i - 1]) / (n[i] - n[i - 1]))
                if not h[i - 1] < hp < h[i + 1]:
                    j = i + int(s)
                    hp = h[i] + s * (h[j] - h[i]) / (n[j] - n[i])
                h[i] = hp
                n[i] += s

    def value(self) -> float | None:
        if self.count < 5:
            return None
        return float(self._h[2])


class DriftCalibrator:
    """One P² estimator per graph of a TopoStream session.

    ``thresholds()`` returns the per-graph flagging threshold — the current
    quantile estimate, or ``+inf`` while a graph is still inside its warmup
    (fewer than ``warmup`` observed recompute scores).
    """

    def __init__(self, batch: int, q: float, warmup: int = 10):
        if warmup < 5:
            raise ValueError(f"warmup must be >= 5 (P² needs 5 obs), got {warmup}")
        self.q = float(q)
        self.warmup = int(warmup)
        self._est = [P2Quantile(q) for _ in range(batch)]

    def thresholds(self) -> np.ndarray:
        out = np.full(len(self._est), np.inf, np.float32)
        for i, e in enumerate(self._est):
            if e.count >= self.warmup:
                out[i] = e.value()
        return out

    def observe(self, idx, scores) -> None:
        """Absorb the drift scores of the recomputed graphs ``idx``."""
        for i, x in zip(np.asarray(idx).tolist(), np.asarray(scores).tolist()):
            self._est[i].update(x)

    def counts(self) -> np.ndarray:
        return np.asarray([e.count for e in self._est], np.int64)


def parse_drift_threshold(spec) -> tuple[str, float]:
    """Parse ``drift_threshold``: a float (constant mode) or ``"auto:qX"``.

    Returns ``("const", value)`` or ``("auto", quantile)``.
    """
    if isinstance(spec, str):
        if not spec.startswith("auto:q"):
            raise ValueError(
                f"drift_threshold string must look like 'auto:q0.99', "
                f"got {spec!r}")
        q = float(spec[len("auto:q"):])
        if not 0.0 < q < 1.0:
            raise ValueError(f"drift quantile must be in (0, 1), got {q}")
        return "auto", q
    return "const", float(spec)
