"""TopoWatch flight recorder: always-on bounded ring of recent events (the
port's copy of ``repro.obs.flight``).

Tracing (:mod:`repro_torch.obs.trace`) is opt-in and unbounded-ish; the flight
recorder is the opposite — **always on**, bounded, and cheap enough to
feed from the serving hot path: each thread appends to its own
``collections.deque(maxlen=...)``, so recording is one lock-free append
(~100 ns) and memory is hard-capped at ``capacity × threads`` events no
matter how long the process runs.

``record(kind, name, **attrs)`` is called from completed spans when
tracing happens to be on, from the serving layers' drain loops, and from
the SLO engine's verdict transitions, so when something goes wrong the
last ~512 events per thread are already in memory.  ``dump(reason)``
writes them (plus a full metrics snapshot and the SLO verdict block) to
``results/obs/FLIGHT_<rev>.json``; ``auto_dump`` is the rate-limited
variant for automatic triggers.
"""
from __future__ import annotations

import json
import os
import subprocess
import threading
import time
from collections import deque
from typing import Optional


class _Config:
    __slots__ = ("capacity", "dump_dir", "min_dump_interval_s")

    def __init__(self):
        self.capacity = 512          # events kept per thread
        self.dump_dir = "results/obs"
        self.min_dump_interval_s = 30.0


_CONFIG = _Config()
_LOCK = threading.Lock()
# (thread name, ring) per thread that ever recorded; rings of finished
# threads linger but are bounded, so a thread-churny process stays capped
_RINGS: list[tuple[int, str, deque]] = []
_TLS = threading.local()

_SEQ_LOCK = threading.Lock()
_SEQ = 0          # global sequence for a total event order across threads
_LAST_DUMP = 0.0  # monotonic instant of the last auto_dump
_LAST_DUMP_PATH: Optional[str] = None


def configure(capacity: Optional[int] = None,
              dump_dir: Optional[str] = None,
              min_dump_interval_s: Optional[float] = None) -> None:
    """Tune the ring size / dump location.  ``capacity`` applies to rings
    created after the call (existing per-thread rings keep their bound)."""
    if capacity is not None:
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        _CONFIG.capacity = int(capacity)
    if dump_dir is not None:
        _CONFIG.dump_dir = dump_dir
    if min_dump_interval_s is not None:
        _CONFIG.min_dump_interval_s = float(min_dump_interval_s)


def _ring() -> deque:
    r = getattr(_TLS, "ring", None)
    if r is None:
        r = _TLS.ring = deque(maxlen=_CONFIG.capacity)
        t = threading.current_thread()
        with _LOCK:
            _RINGS.append((t.ident or 0, t.name, r))
    return r


def record(kind: str, name: str, **attrs) -> None:
    """Append one event to this thread's ring (never blocks on other
    threads; the only lock is first-touch ring registration)."""
    global _SEQ
    with _SEQ_LOCK:
        _SEQ += 1
        seq = _SEQ
    _ring().append({
        "seq": seq,
        "ts": time.time(),
        "kind": kind,
        "name": name,
        "attrs": {k: (v if isinstance(v, (int, float, bool, str)) else str(v))
                  for k, v in attrs.items()},
    })


def events(limit: Optional[int] = None) -> list[dict]:
    """All buffered events merged across threads in recording order
    (most recent last); ``limit`` keeps only the newest N."""
    with _LOCK:
        rings = [(tid, nm, list(r)) for (tid, nm, r) in _RINGS]
    out = []
    for tid, name, evs in rings:
        for e in evs:
            e = dict(e)
            e["thread"] = name
            e["tid"] = tid & 0x7FFFFFFF
            out.append(e)
    out.sort(key=lambda e: e["seq"])
    if limit is not None and limit >= 0:
        out = out[-limit:]
    return out


def clear() -> None:
    """Drop every buffered event (tests); rings stay registered."""
    global _LAST_DUMP, _LAST_DUMP_PATH
    with _LOCK:
        for (_, _, r) in _RINGS:
            r.clear()
    _LAST_DUMP = 0.0
    _LAST_DUMP_PATH = None


_GIT_REV: Optional[str] = None


def _git_rev() -> str:
    """Short revision for the dump filename (cached; "norev" outside a
    checkout).  Deliberately independent of benchmarks/common.py — the
    recorder must work in a bare deployment without the bench package."""
    global _GIT_REV
    if _GIT_REV is None:
        try:
            rev = subprocess.run(
                ["git", "rev-parse", "--short", "HEAD"],
                cwd=os.path.dirname(os.path.abspath(__file__)),
                capture_output=True, text=True, timeout=5,
            ).stdout.strip()
            _GIT_REV = rev or "norev"
        except Exception:
            _GIT_REV = "norev"
    return _GIT_REV


def dump(reason: str, path: Optional[str] = None,
         extra: Optional[dict] = None) -> str:
    """Write the flight buffer + metrics snapshot + SLO verdicts to disk.

    Default path is ``<dump_dir>/FLIGHT_<rev>.json`` — one post-mortem
    per revision, overwritten by later incidents (the newest state is the
    one a responder wants; CI uploads it as an artifact per run).
    """
    global _LAST_DUMP_PATH
    from .export import snapshot  # lazy: flight must import before export

    try:  # lazy + guarded: slo imports flight for its breach callback
        from . import slo as _slo
        slo_block = _slo.verdict_block()
    except Exception:
        slo_block = None
    doc = {
        "schema": 1,
        "reason": reason,
        "ts": time.time(),
        "git_rev": _git_rev(),
        "events": events(),
        "metrics": snapshot(),
        "slo": slo_block,
    }
    if extra:
        doc["extra"] = extra
    if path is None:
        path = os.path.join(_CONFIG.dump_dir, f"FLIGHT_{_git_rev()}.json")
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as fh:
        json.dump(doc, fh, indent=1)
    _LAST_DUMP_PATH = path
    return path


def auto_dump(reason: str, extra: Optional[dict] = None) -> Optional[str]:
    """Rate-limited :func:`dump` for automatic triggers (SLO breach,
    deadline expiry storm, drain exception).  Returns the path, or None
    when a dump landed less than ``min_dump_interval_s`` ago — an
    incident produces one post-mortem, not one per failing request."""
    global _LAST_DUMP
    now = time.monotonic()
    with _SEQ_LOCK:
        if _LAST_DUMP and now - _LAST_DUMP < _CONFIG.min_dump_interval_s:
            return None
        _LAST_DUMP = now
    record("flight", "auto_dump", reason=reason)
    return dump(reason, extra=extra)


def last_dump_path() -> Optional[str]:
    return _LAST_DUMP_PATH
