"""One run of one cell: set-up, warm-up, the measured window, the check
against the plain reference, and the metrics by name.

Everything a cell is made of is found by name, so a later change adds a
configuration, a traffic mix or a metric as files and ``BENCHMARK.json``
entries without editing this one:

* ``BENCHMARK.json``'s ``workloads`` entry names the configuration and the
  traffic mix; its ``configs`` entry names the configuration's ``file``.
* The configuration (JSON) names its generator, ``gen/<generator>.py``
  (``generate(params, seed, device) -> {"adj", "mask", "f"}``), the plan's
  arguments, the dimensions the plan guarantees and its reference,
  ``reference/<reference>.py`` (``diagrams(adj, mask, f, sublevel)``).
  A configuration with a ``data_seed`` is one fixed dataset, the same in
  every run: the run's seed then draws only the row orders and what is
  checked, so every seed does the same work; without one the run's seed
  draws the graphs too.
* The traffic mix is ``traffic/<traffic>.json``: how the window calls the
  plan and how much of it is checked.  Every call gets the whole batch in
  a row order of its own, so a run's time is no one order's.
* Every metric is read by ``metrics/<name>.py`` (``read(ctx)``, the value
  or None when the run has nothing to read it from).

The system under test is ``repro_torch``'s topological plan,
``make_topo_plan(**plan).execute_info``.
"""
from __future__ import annotations

import importlib.util
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

FOREIGN = ("jax", "jaxlib", "flax", "repro")
KERNELS = ("kcore_peel", "domination", "gf2_reduce")


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_module(path: Path):
    rel = str(path.relative_to(path.parents[1]))
    name = "tdabench_" + "".join(c if c.isalnum() else "_" for c in rel)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_spec(root: Path, workload: str) -> tuple[dict, dict, dict, dict]:
    """(benchmark, cell, configuration, traffic) of ``workload``."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; the benchmark has "
                         f"{sorted(cells)}")
    cell = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = load_json(root / cfg_entry["file"])
    traffic = load_json(root / "tdabench" / "traffic"
                        / f"{cell['traffic']}.json")
    return bench, cell, cfg, traffic


def metric_names(bench: dict, cell: dict, trace: bool) -> list[str]:
    """The metrics this cell reports: untraced, its end-to-end ones (every
    cell's, unless the entry lists ``workloads``); traced, the per-layer
    ones whose ``workloads`` list it."""
    if trace:
        return [m["name"] for m in bench["per_layer"]
                if cell["name"] in m["workloads"]]
    return [m["name"] for m in bench["end_to_end"]
            if cell["name"] in m.get("workloads", [cell["name"]])]


def foreign_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FOREIGN})


def _sync_count(fn) -> int:
    """Synchronising calls ``fn()`` makes (CUDA's sync debug mode)."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message).lower() for w in caught)


def run(root: Path, workload: str, seed: int, seconds: float, trace: bool,
        device: str, t0: float, overrides: dict | None = None,
        control: bool = False) -> dict:
    """One run; returns the result line's object (``checks`` last).

    ``overrides`` replaces entries of the configuration's ``data`` and
    ``plan`` and of the traffic mix (the CPU tests' small sizes);
    ``control`` puts the reference's control in the program's place: the
    kept calls' rows are the control's diagrams of the same graphs, judged
    by the same comparison, so a sound check reads ``correct`` false.
    """
    import torch

    from repro_torch import counters, obs
    from repro_torch.core.api import make_topo_plan
    from repro_torch.core.graph import GraphBatch

    from tdabench import check
    from tdabench import trace as tr
    from tdabench.gen.common import host_rng

    bench, cell, cfg, traffic = cell_spec(root, workload)
    params, plan_kw = dict(cfg["data"]), dict(cfg["plan"])
    for key, val in (overrides or {}).items():
        for d in (params, plan_kw, traffic):
            if key in d:
                d[key] = val
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    dims = tuple(cfg["checked_dims"])
    here = root / "tdabench"

    # --- set-up: data, the checked sample, kernels, plan, warm-up ---
    gen = load_module(here / "gen" / f"{cfg['generator']}.py")
    data = gen.generate(params, cfg.get("data_seed", seed), dev)
    b = data["adj"].shape[0]
    rng = host_rng(seed, "tdabench.run")
    n_check = traffic["check_rows"]
    if n_check == "all" or n_check >= b:
        check_ids = np.arange(b)
    else:
        a = data["adj"].to(torch.float32)
        tri = (torch.bmm(a, a) * a).sum((-1, -2)).cpu().numpy()
        del a
        heavy = np.argsort(-tri, kind="stable")[:traffic["check_heaviest"]]
        rest = np.setdiff1d(np.arange(b), heavy)
        check_ids = np.sort(np.concatenate([
            heavy, rng.choice(rest, n_check - heavy.size, replace=False)]))
    host = {k: data[k][torch.from_numpy(check_ids).to(dev)].cpu().numpy()
            for k in ("adj", "mask", "f")}
    graphs = GraphBatch(**data)
    del data

    def submit(order: np.ndarray) -> GraphBatch:
        """The batch in ``order``, on the device before the call's clock
        starts."""
        pt = torch.from_numpy(order).to(dev)
        g = GraphBatch(adj=graphs.adj[pt], mask=graphs.mask[pt],
                       f=graphs.f[pt])
        if on_card:
            torch.cuda.synchronize()
        return g

    def keep(order: np.ndarray, out) -> tuple:
        """The checked rows of a call, and the graph each one holds."""
        if check_ids.size == b:
            return order, check.keep_rows(out, None, dims, plan_kw["dim"])
        inv = np.empty(b, np.int64)
        inv[order] = np.arange(b)
        pos = torch.from_numpy(inv[check_ids]).to(dev)
        return check_ids, check.keep_rows(out, pos, dims, plan_kw["dim"])

    if on_card:
        from repro_torch.kernels import _build
        _build.build(KERNELS)
    plan = make_topo_plan(**plan_kw)
    for _ in range(traffic["warmup_calls"]):
        plan.execute_info(submit(rng.permutation(b)))
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    # --- the window: one caller, calls back to back, each on the whole
    # batch in a row order of its own ---
    keep_rng = host_rng(seed, "tdabench.keep")
    kept, lat, reports, failures = [], [], [], []
    slots = traffic["check_calls"]
    calls = traffic["traced_calls"] if trace else None
    prof = None
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if on_card else [])
        obs.configure(enabled=True)
        obs.clear_trace()
        before = counters.snapshot()
        prof = profile(activities=acts)
        prof.__enter__()
    w0 = time.perf_counter()
    i, seen, last = 0, 0, None
    while True:
        order = rng.permutation(b)
        g = submit(order)
        ts = time.perf_counter()
        try:
            if trace:
                with torch.profiler.record_function(tr.CALL):
                    out, rep = plan.execute_info(g)
                    if on_card:
                        torch.cuda.synchronize()
            else:
                out, rep = plan.execute_info(g)
                if on_card:
                    torch.cuda.synchronize()
        except Exception as exc:  # a call that fails counts; the run goes on
            failures.append(f"call {i}: {type(exc).__name__}: {exc}")
            out = rep = None
        te = time.perf_counter()
        lat.append(te - ts)
        del g
        if trace and rep is not None:
            reports.append(float(np.mean([rep.ladder[c].n_pad
                                          for c in rep.class_index])))
        if out is not None:
            # a reservoir of calls whose rows are checked, and the last
            seen += 1
            j = seen - 1 if seen <= slots else int(keep_rng.integers(0, seen))
            if j < slots:
                if j < len(kept):
                    kept[j] = keep(order, out)
                else:
                    kept.append(keep(order, out))
                last = None
            else:
                last = (order, out)
        i += 1
        if (calls is not None and i >= calls) or (
                calls is None and te - w0 >= seconds):
            break
    window_s = time.perf_counter() - w0
    if last is not None:
        kept.append(keep(*last))
    del out, last
    peak = torch.cuda.max_memory_allocated() if on_card else 0

    prof_summary, spans, deltas, syncs = None, {}, {}, None
    if trace:
        prof.__exit__(None, None, None)
        after = counters.snapshot()
        deltas = {k: after[k] - before[k] for k in after}
        spans = tr.kernel_spans(obs.trace_events())
        obs.configure(enabled=False)
        obs.clear_trace()
        prof_summary = tr.read_profile(prof)
        del prof
        if on_card:
            syncs = [_sync_count(lambda: plan.execute_info(
                submit(rng.permutation(b)))) for _ in range(
                    traffic["sync_calls"])]
    del graphs
    if on_card:
        torch.cuda.empty_cache()

    # --- the check: the reference, once the program's state is freed ---
    ref_mod = load_module(here / "reference" / f"{cfg['reference']}.py")
    sub = plan_kw["sublevel"]
    reference = {}
    for k, gid in enumerate(check_ids.tolist()):
        reference[gid] = ref_mod.diagrams(host["adj"][k], host["mask"][k],
                                          host["f"][k], sub)
    if control:
        ctl = {gid: ref_mod.diagrams(
            host["adj"][k],
            ref_mod.dominated_pruned(host["adj"][k], host["mask"][k]),
            host["f"][k], sub) for k, gid in enumerate(check_ids.tolist())}
        kept = [(gids, check.as_kept(ctl, gids, dims)) for gids, _ in kept]
    wrong_by_call = [check.rows_wrong(kd, gids, reference, dims)
                     for gids, kd in kept]
    wrong = sum(wrong_by_call)
    checks = {
        "calls_failed": {"value": len(failures), "limit": 0, "rule": "<="},
        "rows_wrong": {"value": wrong, "limit": 0, "rule": "<="},
        "calls_checked": {"value": len(kept), "limit": 1, "rule": ">="},
        "rows_checked": {"value": len(kept) * int(check_ids.size),
                         "limit": int(check_ids.size), "rule": ">="},
    }
    correct = all(
        (c["value"] <= c["limit"]) if c["rule"] == "<=" else
        (c["value"] >= c["limit"]) for c in checks.values())

    # --- metrics, each by its reader ---
    ok_calls = len(lat) - len(failures)
    # what a metric's reader sees
    ctx = SimpleNamespace(
        cell=cell, cfg=cfg, traffic=traffic, graphs=b, setup_s=setup_s,
        window_s=window_s, latencies=lat, ok_calls=ok_calls, peak_bytes=peak,
        reports=reports, counters=deltas, syncs=syncs, profile=prof_summary,
        spans=spans, on_card=on_card, calls=len(lat))
    metrics = {}
    units = {m["name"]: m["unit"]
             for m in bench["end_to_end"] + bench["per_layer"]}
    for name in metric_names(bench, cell, trace):
        value = load_module(here / "metrics" / f"{name}.py").read(ctx)
        if value is not None:
            metrics[name] = {"value": value, "unit": units[name]}
    device_info = {"platform": "gpu" if on_card else dev.type,
                   "kind": (torch.cuda.get_device_name(dev) if on_card
                            else "cpu"),
                   "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": len(lat),
              "failed": len(failures) + sum(w > 0 for w in wrong_by_call),
              "metrics": metrics, "device": device_info}
    if trace and prof_summary is not None:
        device_info["busy_s"] = prof_summary["busy_s"]
        device_info["window_s"] = prof_summary["window_s"]
        result["breakdown"] = {
            "device_ops": tr.top(prof_summary["device_s"]),
            "idle_gaps": tr.top(prof_summary["idle_by_host"])}
    if failures:
        result["errors"] = failures[:3]
    result["checks"] = checks
    return result
