"""What a traced window saw: the profiler's device timeline, the host ops
around its idle gaps, the program's kernel spans and its counters.

The profiler's Chrome trace is written to a file under ``TMPDIR``, read
back and deleted.  Device events are kernels, copies and sets.  The window
is the harness's ``tdabench.call`` annotations, each one plan call on the
same clock: the harness's own work between calls (reordering the next
batch) is neither busy nor idle time of the program.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
CALL = "tdabench.call"


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def read_profile(prof) -> dict:
    """Summary of a finished ``torch.profiler.profile``: ``window_s`` (the
    calls' seconds), ``busy_s`` (the union of device events inside them),
    ``device_s`` by event name, ``device_n`` (launches by name), and
    ``idle_by_host`` (idle device seconds by the innermost host op running
    at each gap's middle)."""
    fd, path = tempfile.mkstemp(suffix=".json", prefix="tdabench-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh).get("traceEvents", [])
    finally:
        os.unlink(path)
    # the host's annotation of each call (the profiler also draws a copy of
    # it on the device's timeline, as "gpu_user_annotation")
    calls = sorted((e["ts"], e["ts"] + e["dur"], e.get("tid"))
                   for e in events
                   if e.get("name") == CALL and e.get("ph") == "X"
                   and e.get("cat") == "user_annotation")
    if not calls:
        return {"window_s": 0.0, "busy_s": 0.0, "device_s": {},
                "device_n": {}, "idle_by_host": {}}
    starts = [c[0] for c in calls]
    tid = calls[0][2]
    dev, device_s, device_n = [], defaultdict(float), defaultdict(int)
    host = []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        s, t = e["ts"], e["ts"] + e["dur"]
        if cat in DEVICE_CATS:
            k = bisect.bisect_right(starts, t) - 1
            if k < 0 or s >= calls[k][1]:
                continue  # outside every call
            dev.append((max(s, calls[k][0]), min(t, calls[k][1])))
            device_s[e["name"]] += e["dur"] * 1e-6
            device_n[e["name"]] += 1
        elif (cat in ("cpu_op", "user_annotation", "cuda_runtime")
              and e.get("tid") == tid):
            host.append((s, -e["dur"], t, e["name"]))
    busy = _union(dev)
    busy_s = sum(e - s for s, e in busy) * 1e-6
    gaps, k = [], 0
    for c0, c1, _ in calls:
        prev = c0
        while k < len(busy) and busy[k][0] < c1:
            if busy[k][0] > prev:
                gaps.append((prev, busy[k][0]))
            prev = max(prev, busy[k][1])
            k += 1
        if c1 > prev:
            gaps.append((prev, c1))
    # the host thread's events nest: a stack of the open ones gives the
    # innermost op around each gap's middle
    host.sort()
    idle_by_host = defaultdict(float)
    stack, i = [], 0
    for g0, g1 in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = 0.5 * (g0 + g1)
        while i < len(host) and host[i][0] <= mid:
            s, _, t, name = host[i]
            while stack and stack[-1][0] < s:
                stack.pop()
            stack.append((t, name))
            i += 1
        while stack and stack[-1][0] < mid:
            stack.pop()
        label = stack[-1][1] if stack else CALL
        if label == CALL:
            label = "host outside any op"
        idle_by_host[label] += (g1 - g0) * 1e-6
    return {"window_s": sum(c1 - c0 for c0, c1, _ in calls) * 1e-6,
            "busy_s": busy_s,
            "device_s": dict(device_s), "device_n": dict(device_n),
            "idle_by_host": dict(idle_by_host)}


def kernel_spans(events: list[dict]) -> dict[str, list[dict]]:
    """The program's ``kernels.<name>`` spans by kernel name, each its
    shape tokens (``B64_N64`` -> ``{"B": 64, "N": 64}``)."""
    out = defaultdict(list)
    for e in events:
        name = e.get("name", "")
        if not name.startswith("kernels."):
            continue
        shape = str(e.get("args", {}).get("shape", ""))
        tokens = {}
        for tok in shape.split("_"):
            if len(tok) > 1 and tok[0].isalpha() and tok[1:].isdigit():
                tokens[tok[0]] = int(tok[1:])
        out[name.split(".", 1)[1]].append(tokens)
    return dict(out)


def top(d: dict, k: int = 10) -> list:
    return [[name, v] for name, v in sorted(d.items(), key=lambda x: -x[1])
            [:k]]
