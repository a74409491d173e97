"""The plain reference: against the port's own numpy oracle on small
seeded graphs (both orientations, both dimensions), against the port's
Diagrams on graphs of each configuration, and its control, which has to
read as wrong."""
from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import persistence_ref as oracle
from repro_torch.core.api import make_topo_plan
from repro_torch.core.graph import GraphBatch
from repro_torch.core.persistence import diagrams_to_numpy
from tdabench import harness
from tdabench.reference import persistence as ref
from tdabench.tests.small import SMALL

ROOT = Path(__file__).resolve().parents[2]


def _graphs(seed, count, n_max=11):
    rng = np.random.default_rng(seed)
    for _ in range(count):
        n = int(rng.integers(3, n_max + 1))
        a = np.triu(rng.random((n, n)) < rng.uniform(0.2, 0.8), 1)
        a = a | a.T
        mask = rng.random(n) < 0.9
        yield a, mask, rng.integers(0, 5, n).astype(np.float32)


@pytest.mark.parametrize("sublevel", [True, False])
def test_reference_equals_the_ports_oracle(sublevel):
    for a, mask, f in _graphs(11 + sublevel, 60):
        want = oracle.persistence_diagrams(a, f, mask, max_dim=1,
                                           sublevel=sublevel)
        got = ref.diagrams(a, mask, f, sublevel)
        for k in (0, 1):
            assert got[k] == sorted(want.get(k, [])), (k, got, want)


@pytest.mark.parametrize("cell", ["ego_16k", "dd_1178"])
def test_reference_equals_the_ports_diagrams(cell):
    """The port's plan on the CPU and the reference agree on every graph of
    a small batch of the cell's configuration, in its checked dimension."""
    _, _, cfg, _ = harness.cell_spec(ROOT, cell)
    params = dict(cfg["data"])
    plan_kw = dict(cfg["plan"])
    for k, v in SMALL[cell].items():
        for d in (params, plan_kw):
            if k in d:
                d[k] = v
    gen = harness.load_module(ROOT / "tdabench/gen" / f"{cfg['generator']}.py")
    data = gen.generate(params, 17, "cpu")
    out, _ = make_topo_plan(**plan_kw).execute_info(GraphBatch(**data))
    nonempty = 0
    for i in range(data["adj"].shape[0]):
        want = ref.diagrams(data["adj"][i].numpy(), data["mask"][i].numpy(),
                            data["f"][i].numpy(), plan_kw["sublevel"])
        got = diagrams_to_numpy(out, i, 1)
        for k in cfg["checked_dims"]:
            assert sorted(got[k]) == want[k], (i, k)
        nonempty += bool(want[1])
    assert nonempty > 0


def test_dominated_pruned_ignores_the_filtration():
    # a path 0-1-2: 0 and 2 are dominated by 1 whatever f says
    a = np.zeros((3, 3), bool)
    a[0, 1] = a[1, 0] = a[1, 2] = a[2, 1] = True
    m = ref.dominated_pruned(a, np.ones(3, bool))
    assert m.sum() == 1


@pytest.mark.parametrize("cell", ["ego_16k", "dd_1178"])
def test_control_reads_wrong(cell):
    """The control, the reference with PrunIT's filtration condition
    dropped, put in the program's place: the same comparison reads the
    run not correct."""
    torch.set_num_threads(2)
    r = harness.run(ROOT, cell, 9, 0.2, False, "cpu", time.perf_counter(),
                    overrides=SMALL[cell], control=True)
    assert r["correct"] is False
    assert r["checks"]["rows_wrong"]["value"] > 0
    assert r["checks"]["calls_failed"]["value"] == 0
