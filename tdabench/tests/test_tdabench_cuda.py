"""The harness on the card at small sizes, and the generators' graphs on
the card equal to the CPU's.  Skips without a CUDA device:

    python -m pytest -q -m requires_cuda tdabench/tests
"""
from __future__ import annotations

import time
from pathlib import Path

import pytest
import torch

from tdabench import harness
from tdabench.gen import ego_nets, pa_dataset
from tdabench.tests.small import SMALL

ROOT = Path(__file__).resolve().parents[2]
pytestmark = pytest.mark.requires_cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return "cuda"


@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
@pytest.mark.parametrize("cell", ["ego_16k", "dd_1178"])
def test_small_run_on_the_card(cuda, cell, trace):
    r = harness.run(ROOT, cell, 123, 0.5, trace, cuda, time.perf_counter(),
                    overrides=SMALL[cell])
    assert r["correct"] and r["device"]["platform"] == "gpu"
    if trace:
        assert r["device"]["busy_s"] > 0
        for name in ("kcore_peel", "domination", "gf2_reduce"):
            share = r["metrics"].get(f"{name}_roofline", {}).get("value")
            assert share is None or 0 < share <= 105, (name, share)
    else:
        assert r["metrics"]["peak_mem_gb"]["value"] > 0


@pytest.mark.parametrize("gen, params", [
    (pa_dataset, dict(graphs=6, n_pad=64, nv_max=64, nv_log_mu=3.9,
                      nv_log_sigma=0.35, nv_min=4, m=2, p_triangle=0.2)),
    (ego_nets, dict(host_vertices=300, m=7, p_triad=0.9, n_pad=32)),
])
def test_generators_make_the_same_graphs_on_the_card(cuda, gen, params):
    a = gen.generate(params, 2 ** 35 + 3, "cpu")
    b = gen.generate(params, 2 ** 35 + 3, cuda)
    for k in a:
        assert torch.equal(a[k], b[k].cpu()), k
