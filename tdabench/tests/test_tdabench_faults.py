"""Runs with the timed path broken underneath: the harness's look for a
card skipped, a small cell on the CPU, and ``correct`` has to come out
false for each fault a cell can have (one card: no exchange between
chips to leave out)."""
from __future__ import annotations

import time
from pathlib import Path

import pytest
import torch

from repro_torch.core import api, persistence
from tdabench import harness
from tdabench.tests.small import SMALL

ROOT = Path(__file__).resolve().parents[2]
CELLS = ["ego_16k", "dd_1178"]


def _stale(monkeypatch):
    """A call that returns the first call's Diagrams again: state left
    unchanged."""
    real = api.TopoPlan.execute_info
    first = {}

    def execute_info(self, g):
        if "out" not in first:
            first["out"] = real(self, g)
        return first["out"]

    monkeypatch.setattr(api.TopoPlan, "execute_info", execute_info)


def _half(monkeypatch):
    """Only the first half of the batch executed; the rest left invalid."""
    real = api.TopoPlan.execute_info

    def execute_info(self, g):
        out, rep = real(self, g)
        h = g.batch // 2
        out.valid[h:] = False
        return out, rep

    monkeypatch.setattr(api.TopoPlan, "execute_info", execute_info)


def _altered(monkeypatch):
    """Every PD_1 death one later where the diagrams are produced."""
    real = persistence.pairs_to_diagrams

    def pairs_to_diagrams(*args, **kw):
        d = real(*args, **kw)
        return persistence.Diagrams(
            d.birth, torch.where(d.dim == 1, d.death + 1, d.death), d.dim,
            d.valid)

    monkeypatch.setattr(persistence, "pairs_to_diagrams", pairs_to_diagrams)


@pytest.mark.parametrize("fault", [_stale, _half, _altered],
                         ids=["stale", "half_batch", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_reads_not_correct(cell, fault, monkeypatch):
    torch.set_num_threads(2)
    api.clear_plan_cache()
    fault(monkeypatch)
    r = harness.run(ROOT, cell, 21, 0.2, True, "cpu", time.perf_counter(),
                    overrides=SMALL[cell])
    api.clear_plan_cache()
    assert r["correct"] is False
    assert r["checks"]["rows_wrong"]["value"] > 0
