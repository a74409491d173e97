"""TopoScope metrics registry: process-wide counters, gauges, histograms
(the port's copy of ``repro.obs.metrics``).

The registry is the *always-on* half of TopoScope (tracing, the opt-in
half, lives in :mod:`repro_torch.obs.trace`): instruments are plain Python
numbers behind per-instrument locks, so recording costs ~a dict lookup
plus a lock — cheap enough that stats surfaces (``TopoStream``'s
instruments today) can be views over this registry rather than ad-hoc
dicts.

Label sets (``{"frontend": "topo", "bucket": "n32"}``) key independent
series inside one instrument; values are coerced to ``str``.  There is no
network server anywhere — export is pull-style via
:meth:`MetricsRegistry.snapshot`.

Concurrency model: one lock per instrument guards its series dict; the
registry lock only guards instrument creation.  No lock is ever held
while another is taken, so instrument methods cannot deadlock against
registry methods.
"""
from __future__ import annotations

import bisect
import itertools
import threading
from typing import Iterable, Optional

# default duration buckets (seconds): log-spaced from 10 µs to 30 s, the
# span of one kernel dispatch up to a full cold-compile drain
DEFAULT_TIME_BUCKETS = (
    1e-5, 3e-5, 1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2,
    0.1, 0.3, 1.0, 3.0, 10.0, 30.0,
)
# default buckets for unit-interval ratios (batch occupancy, skip rates)
DEFAULT_RATIO_BUCKETS = (0.1, 0.25, 0.5, 0.75, 0.9, 1.0)

LabelKey = tuple[tuple[str, str], ...]


def _label_key(labels: dict) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Instrument:
    """Shared plumbing: name/help, a lock, and a labelset -> state dict."""

    kind = "?"
    __slots__ = ("name", "help", "_lock", "_series")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._series: dict = {}

    def clear(self) -> None:
        """Drop every series (tests / registry reset); the instrument stays
        registered so held references keep working."""
        with self._lock:
            self._series.clear()

    def series(self) -> dict:
        """Copy of {label_key: state} under the instrument lock."""
        with self._lock:
            return dict(self._series)

    def labeled(self, label: str) -> dict[str, float]:
        """{value-of-<label>: scalar} across series (counters/gauges)."""
        out: dict[str, float] = {}
        for key, val in self.series().items():
            d = dict(key)
            if label in d:
                out[d[label]] = out.get(d[label], 0.0) + float(val)
        return out


class Counter(_Instrument):
    """Monotone float counter; one series per label set."""

    kind = "counter"
    __slots__ = ()

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease "
                             f"(inc {amount})")
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._series.get(_label_key(labels), 0.0))

    def total(self, **labels) -> float:
        """Sum over every series whose labels are a superset of ``labels``."""
        want = set(_label_key(labels))
        with self._lock:
            return float(sum(v for k, v in self._series.items()
                             if want <= set(k)))


class Gauge(_Instrument):
    """Last-write-wins scalar; ``inc``/``dec`` for up-down counts."""

    kind = "gauge"
    __slots__ = ()

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._series[_label_key(labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._series.get(_label_key(labels), 0.0))


class _HistState:
    __slots__ = ("counts", "sum", "count")

    def __init__(self, n_buckets: int):
        self.counts = [0] * (n_buckets + 1)  # +1: overflow (+Inf) bucket
        self.sum = 0.0
        self.count = 0


def bucket_quantile(bounds: tuple[float, ...],
                    counts: Iterable[int], q: float) -> float:
    """Quantile estimate from fixed-bucket counts via linear interpolation.

    ``counts`` has one entry per bound plus the trailing ``+Inf`` overflow
    bucket.  Observations are assumed uniformly distributed inside each
    bucket (the Prometheus ``histogram_quantile`` model); the first
    bucket's lower edge is 0 (or ``bounds[0]`` if that is negative), and a
    quantile landing in the overflow bucket is clamped to the largest
    finite bound — the histogram carries no information beyond it.
    Returns NaN when the histogram is empty.
    """
    counts = list(counts)
    if len(counts) != len(bounds) + 1:
        raise ValueError(
            f"need {len(bounds) + 1} counts (incl. overflow), "
            f"got {len(counts)}")
    total = sum(counts)
    if total <= 0:
        return float("nan")
    q = min(max(float(q), 0.0), 1.0)
    rank = q * total
    acc = 0.0
    lo = min(0.0, bounds[0])
    for b, c in zip(bounds, counts):
        if c and acc + c >= rank:
            return lo + (rank - acc) / c * (b - lo)
        acc += c
        lo = b
    return bounds[-1]


def bucket_count_over(bounds: tuple[float, ...],
                      counts: Iterable[int], threshold: float) -> float:
    """Estimated number of observations strictly above ``threshold``.

    Buckets entirely above the threshold count whole; the bucket
    containing it contributes its linearly interpolated fraction.  This
    is the SLO engine's "bad event" estimator for latency ceilings; the
    threshold should lie within the bucket range — overflow observations
    are not attributed to a threshold beyond the largest finite bound.
    """
    counts = list(counts)
    if len(counts) != len(bounds) + 1:
        raise ValueError(
            f"need {len(bounds) + 1} counts (incl. overflow), "
            f"got {len(counts)}")
    i = bisect.bisect_left(bounds, threshold)
    over = float(sum(counts[i + 1:]))
    if i < len(bounds):
        lo = bounds[i - 1] if i > 0 else min(0.0, bounds[0])
        width = bounds[i] - lo
        if width > 0:
            over += counts[i] * max(0.0, (bounds[i] - threshold) / width)
    return over


class Histogram(_Instrument):
    """Fixed-bucket histogram (Prometheus ``le`` semantics: a value lands
    in the first bucket whose upper bound is >= it; larger values land in
    the implicit ``+Inf`` overflow bucket)."""

    kind = "histogram"
    __slots__ = ("buckets",)

    def __init__(self, name: str, help: str = "",
                 buckets: Iterable[float] = DEFAULT_TIME_BUCKETS):
        super().__init__(name, help)
        bs = tuple(float(b) for b in buckets)
        if not bs or list(bs) != sorted(bs) or len(set(bs)) != len(bs):
            raise ValueError(
                f"histogram {name}: buckets must be non-empty strictly "
                f"ascending upper bounds, got {bs}")
        self.buckets = bs

    def observe(self, value: float, **labels) -> None:
        value = float(value)
        key = _label_key(labels)
        idx = bisect.bisect_left(self.buckets, value)
        with self._lock:
            st = self._series.get(key)
            if st is None:
                st = self._series[key] = _HistState(len(self.buckets))
            st.counts[idx] += 1
            st.sum += value
            st.count += 1

    def quantile(self, q: float, **labels) -> float:
        """Interpolated quantile over every series whose labels are a
        superset of ``labels`` (all series when none given) — see
        :func:`bucket_quantile`.  NaN when nothing matched/observed."""
        want = set(_label_key(labels))
        merged = [0] * (len(self.buckets) + 1)
        for key, st in self.series().items():
            if want <= set(key):
                for i, c in enumerate(st.counts):
                    merged[i] += c
        return bucket_quantile(self.buckets, merged, q)

    def count_over(self, threshold: float, **labels) -> float:
        """Estimated observations above ``threshold`` across matching
        series — see :func:`bucket_count_over`."""
        want = set(_label_key(labels))
        merged = [0] * (len(self.buckets) + 1)
        for key, st in self.series().items():
            if want <= set(key):
                for i, c in enumerate(st.counts):
                    merged[i] += c
        return bucket_count_over(self.buckets, merged, threshold)

    def merged_counts(self, **labels) -> tuple[list[int], float]:
        """(per-bucket counts incl. overflow, total sum) aggregated over
        series whose labels are a superset of ``labels`` — the raw state
        the SLO engine snapshots for windowed quantiles."""
        want = set(_label_key(labels))
        merged = [0] * (len(self.buckets) + 1)
        total_sum = 0.0
        for key, st in self.series().items():
            if want <= set(key):
                for i, c in enumerate(st.counts):
                    merged[i] += c
                total_sum += st.sum
        return merged, total_sum

    def snapshot_series(self) -> dict[LabelKey, dict]:
        """{label_key: {"count", "sum", "buckets": [(le, cumulative), ...]}}
        with cumulative counts (exposition-format semantics) and a final
        ``("+Inf", count)`` entry."""
        out = {}
        for key, st in self.series().items():
            cum, acc = [], 0
            for le, c in zip(self.buckets, st.counts):
                acc += c
                cum.append((le, acc))
            cum.append(("+Inf", st.count))
            out[key] = {"count": st.count, "sum": st.sum, "buckets": cum}
        return out


class MetricsRegistry:
    """Thread-safe name -> instrument map with get-or-create accessors."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: dict[str, _Instrument] = {}

    def _get(self, cls, name: str, help: str, **kwargs):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = cls(name, help, **kwargs)
                self._instruments[name] = inst
            elif type(inst) is not cls:
                raise TypeError(
                    f"instrument {name!r} already registered as "
                    f"{inst.kind}, not {cls.kind}")
            return inst

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Iterable[float] = DEFAULT_TIME_BUCKETS
                  ) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def get(self, name: str) -> Optional[_Instrument]:
        with self._lock:
            return self._instruments.get(name)

    def items(self) -> list[tuple[str, _Instrument]]:
        with self._lock:
            return sorted(self._instruments.items())

    def snapshot(self) -> dict:
        """JSON-ready {name: {"type", "help", "series": [...]}} snapshot.

        Counter/gauge series: ``{"labels": {...}, "value": v}``; histogram
        series additionally carry cumulative ``buckets``/``sum``/``count``.
        """
        out: dict = {}
        for name, inst in self.items():
            if isinstance(inst, Histogram):
                series = [{"labels": dict(k), **st}
                          for k, st in inst.snapshot_series().items()]
            else:
                series = [{"labels": dict(k), "value": v}
                          for k, v in inst.series().items()]
            out[name] = {"type": inst.kind, "help": inst.help,
                         "series": series}
        return out

    def reset(self) -> None:
        """Zero every instrument's series (instruments stay registered, so
        references held by the serving layers keep recording)."""
        for _, inst in self.items():
            inst.clear()


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    return _DEFAULT


_INSTANCE_COUNTER = itertools.count()


def next_instance(prefix: str) -> str:
    """Process-unique instance label (``topo-0``, ``stream-1``, ...) so
    multiple frontends share the one registry without mixing series."""
    return f"{prefix}-{next(_INSTANCE_COUNTER)}"
