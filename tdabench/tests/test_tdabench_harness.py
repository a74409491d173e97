"""The harness on the CPU: cells, configurations, traffic mixes and
metrics found by name, a run of each cell at a small size traced and
untraced, a cell added as files alone, the refusals of ``run.py``, and the
imports of every module under ``tdabench/``."""
from __future__ import annotations

import ast
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from tdabench import harness
from tdabench.tests.small import SMALL

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_parts_found_by_name(cell):
    bench, w, cfg, traffic = harness.cell_spec(ROOT, cell)
    here = ROOT / "tdabench"
    assert (here / "gen" / f"{cfg['generator']}.py").exists()
    assert (here / "reference" / f"{cfg['reference']}.py").exists()
    assert traffic["loop"] == "closed" and traffic["callers"] == 1
    for trace in (False, True):
        names = harness.metric_names(bench, w, trace)
        assert names
        for name in names:
            assert (here / "metrics" / f"{name}.py").exists(), name
    assert "setup_s" in harness.metric_names(bench, w, False)


def test_benchmark_entries_have_files():
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).exists()
        assert c["file"].startswith("tdabench/")
        assert set(c["reduced"]) <= set(
            json.loads((ROOT / c["file"]).read_text())["reduced"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (ROOT / "tdabench" / "metrics" / f"{m['name']}.py").exists()


def _result_ok(r, trace):
    assert list(r)[-1] == "checks"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in r
    for c in r["checks"].values():
        assert set(c) == {"value", "limit", "rule"}
    assert r["attempted"] >= 1 and r["failed"] == 0 and r["correct"]
    json.dumps(r)
    if trace:
        assert "busy_s" in r["device"] and "window_s" in r["device"]
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
@pytest.mark.parametrize("cell", CELLS)
def test_small_run_on_cpu(cell, trace):
    r = harness.run(ROOT, cell, 2 ** 33 + 7, 0.5, trace, "cpu",
                    time.perf_counter(), overrides=SMALL[cell])
    _result_ok(r, trace)
    names = set(r["metrics"])
    if trace:
        assert "prune_rounds_per_call" in names
    else:
        assert {"graphs_per_s", "call_p95_ms", "setup_s"} <= names
    assert harness.foreign_modules() == []


def test_cell_config_traffic_and_metric_added_as_files(tmp_path):
    """A new cell with its own configuration, traffic mix and per-layer
    metric: new files and new BENCHMARK.json entries, no file edited."""
    shutil.copytree(ROOT / "tdabench", tmp_path / "tdabench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "tdabench/configs/tda_ego.json").read_text())
    cfg.update(name="tda_ego_sublevel",
               plan=dict(cfg["plan"], sublevel=True, method="prunit"),
               checked_dims=[0, 1])
    (tmp_path / "tdabench/configs/tda_ego_sublevel.json").write_text(
        json.dumps(cfg))
    traffic = json.loads(
        (ROOT / "tdabench/traffic/closed_egos.json").read_text())
    traffic.update(check_calls=1, warmup_calls=1)
    (tmp_path / "tdabench/traffic/two_orders.json").write_text(
        json.dumps(traffic))
    (tmp_path / "tdabench/metrics/calls_traced.py").write_text(
        "def read(ctx):\n    return ctx.calls\n")
    bench["configs"].append(dict(
        bench["configs"][0], name="tda_ego_sublevel",
        file="tdabench/configs/tda_ego_sublevel.json"))
    bench["workloads"].append(dict(name="ego_sub", config="tda_ego_sublevel",
                                   traffic="two_orders", chips=1, why="x"))
    bench["per_layer"].append(dict(name="calls_traced", unit="count",
                                   better="higher", source="program_counter",
                                   layer="plan execute (core/api.py)",
                                   moves="graphs_per_s",
                                   workloads=["ego_sub"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    r = harness.run(tmp_path, "ego_sub", 5, 0.5, True, "cpu",
                    time.perf_counter(), overrides=SMALL["ego_16k"])
    _result_ok(r, True)
    assert r["metrics"]["calls_traced"]["value"] == SMALL["ego_16k"][
        "traced_calls"]


def _run_py(cwd, *extra):
    return subprocess.run(
        [sys.executable, "tdabench/run.py", "--workload", "ego_16k",
         "--seed", "3", "--seconds", "1", "--trace", "0", *extra],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_run_py_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    p = _run_py(ROOT)
    assert p.returncode == 2 and p.stdout == ""
    assert "CUDA" in p.stderr


def test_run_py_fails_with_the_benchmark_files_alone(tmp_path):
    shutil.copytree(ROOT / "tdabench", tmp_path / "tdabench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    p = _run_py(tmp_path)
    assert p.returncode != 0 and p.stdout == ""


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted((ROOT / "tdabench").rglob("*.py"))
    assert files
    for f in files:
        assert not _imports(f) & set(harness.FOREIGN), f
        text = f.read_text()
        for word in ("benchmarks/", "results/"):
            assert word not in text or f.name.startswith("test_"), f


def test_reference_imports_nothing_of_the_program():
    for f in (ROOT / "tdabench" / "reference").glob("*.py"):
        assert not _imports(f) & {"repro_torch", *harness.FOREIGN}, f
