"""TopoScope exporters: snapshot dict, JSON-lines append, Prometheus text
(the port's copy of ``repro.obs.export``).

No network server — everything is file/pull based.  ``snapshot()`` gives
a JSON-ready dict of every instrument, ``append_jsonl(path)`` appends one
timestamped snapshot line (suitable for a poor-man's time series), and
``export_prometheus(path)`` / ``prometheus_text()`` render the standard
text exposition format (counters as ``<name>_total``, histograms with
cumulative ``le`` buckets plus ``_sum``/``_count``), ready to be scraped
off disk by a node-exporter textfile collector.
"""
from __future__ import annotations

import json
import os
import re
import time
from typing import Optional

from .metrics import Counter, Histogram, MetricsRegistry, default_registry

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
_LABEL_RE = re.compile(r"[^a-zA-Z0-9_]")


def _metric_name(name: str) -> str:
    out = _NAME_RE.sub("_", name)
    if out and out[0].isdigit():
        out = "_" + out
    return out


def _label_name(name: str) -> str:
    out = _LABEL_RE.sub("_", name)
    if out and out[0].isdigit():
        out = "_" + out
    return out


def _escape(value: str) -> str:
    return value.replace("\\", "\\\\").replace("\"", "\\\"") \
        .replace("\n", "\\n")


def _render_labels(labels: dict, extra: Optional[dict] = None) -> str:
    merged = dict(labels)
    if extra:
        merged.update(extra)
    if not merged:
        return ""
    inner = ",".join(f'{_label_name(k)}="{_escape(str(v))}"'
                     for k, v in sorted(merged.items()))
    return "{" + inner + "}"


def _fmt(v: float) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def snapshot(registry: Optional[MetricsRegistry] = None) -> dict:
    """JSON-ready snapshot of every instrument in the registry."""
    reg = registry or default_registry()
    return reg.snapshot()


def append_jsonl(path: str,
                 registry: Optional[MetricsRegistry] = None) -> str:
    """Append one ``{"ts": <unix seconds>, "metrics": snapshot}`` line."""
    line = {"ts": time.time(), "metrics": snapshot(registry)}
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "a") as fh:
        fh.write(json.dumps(line) + "\n")
    return path


def prometheus_text(registry: Optional[MetricsRegistry] = None) -> str:
    """Render the registry in Prometheus text exposition format v0.0.4."""
    reg = registry or default_registry()
    lines: list[str] = []
    for name, inst in reg.items():
        base = _metric_name(name)
        if isinstance(inst, Counter):
            base += "_total"
        if inst.help:
            lines.append(f"# HELP {base} {_escape(inst.help)}")
        lines.append(f"# TYPE {base} {inst.kind}")
        if isinstance(inst, Histogram):
            for key, st in sorted(inst.snapshot_series().items()):
                labels = dict(key)
                for le, cum in st["buckets"]:
                    le_s = "+Inf" if le == "+Inf" else _fmt(le)
                    lines.append(
                        f"{base}_bucket"
                        f"{_render_labels(labels, {'le': le_s})} {cum}")
                lines.append(
                    f"{base}_sum{_render_labels(labels)} {repr(st['sum'])}")
                lines.append(
                    f"{base}_count{_render_labels(labels)} {st['count']}")
        else:
            for key, val in sorted(inst.series().items()):
                lines.append(
                    f"{base}{_render_labels(dict(key))} {_fmt(val)}")
    return "\n".join(lines) + "\n"


def export_prometheus(path: str,
                      registry: Optional[MetricsRegistry] = None) -> str:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as fh:
        fh.write(prometheus_text(registry))
    return path
