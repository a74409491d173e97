"""The trace reader on a made-up profiler trace, and the frozen cost
arithmetic against the program's own."""
from __future__ import annotations

import json
import types

import pytest

from repro_torch.launch import roofline as program_roofline
from repro_torch.perfgate import cost_cells
from tdabench import trace
from tdabench.cost import roofline


def _prof(events):
    def export_chrome_trace(path):
        with open(path, "w") as fh:
            json.dump({"traceEvents": events}, fh)
    return types.SimpleNamespace(export_chrome_trace=export_chrome_trace)


def X(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid}


def test_read_profile_windows_busy_and_gaps():
    events = [
        X(trace.CALL, "user_annotation", 0, 100),
        X(trace.CALL, "user_annotation", 200, 100),
        X(trace.CALL, "gpu_user_annotation", 0, 300, tid=7),  # not a call
        X("aten::nonzero", "cpu_op", 10, 30),
        X("cudaStreamSynchronize", "cuda_runtime", 15, 5),
        X("k1", "kernel", 0, 10, tid=7),
        X("k2", "kernel", 5, 10, tid=7),     # overlaps k1
        X("k1", "kernel", 50, 50, tid=7),
        X("copy", "gpu_memcpy", 150, 20, tid=7),  # between calls: not counted
        X("k1", "kernel", 210, 90, tid=7),
    ]
    p = trace.read_profile(_prof(events))
    assert p["window_s"] == pytest.approx(200e-6)
    assert p["busy_s"] == pytest.approx((15 + 50 + 90) * 1e-6)
    assert p["device_n"] == {"k1": 3, "k2": 1}
    assert p["device_s"]["k1"] == pytest.approx(150e-6)
    # gaps: 15-50 in the first call (mid 32.5, inside nonzero), 200-210
    assert p["idle_by_host"]["aten::nonzero"] == pytest.approx(35e-6)
    assert p["idle_by_host"]["host outside any op"] == pytest.approx(10e-6)


def test_read_profile_without_calls():
    assert trace.read_profile(_prof([]))["busy_s"] == 0.0


def test_kernel_spans_tokens():
    spans = trace.kernel_spans([
        {"name": "kernels.gf2_reduce_batch",
         "args": {"shape": "B64_S1536_C17408"}},
        {"name": "kernels.kcore_peel", "args": {"shape": "B16384_N64"}},
        {"name": "serve.batch", "args": {}}])
    assert spans == {"gf2_reduce_batch": [{"B": 64, "S": 1536, "C": 17408}],
                     "kcore_peel": [{"B": 16384, "N": 64}]}


@pytest.mark.parametrize("b, n", [(16384, 64), (1178, 512), (3, 37)])
def test_frozen_counts_are_the_programs(b, n):
    assert roofline.kcore_peel(b, n) == cost_cells.kcore_cost(b, n, 1)
    assert roofline.domination(b, n) == cost_cells.domination_cost(b, n)
    # gf2: the program's count with the owner vector's bytes and one step
    # a column; the frozen one leaves the owners out
    blocks = [(b, 512, 2, n, b * 512), (b, 1024, 16, 512, b * 1024)]
    moved, ops = cost_cells.gf2_cost(blocks)
    words = 512 * 2 + 1024 * 16
    mine, mine_ops = roofline.gf2_reduce(b, 512 + 1024, words)
    assert mine == moved - 4 * b * (n + 512)
    assert mine_ops == ops


def test_frozen_peaks_are_the_programs():
    assert roofline.HBM_BYTES_PER_S == program_roofline.HBM_BYTES_PER_S
    for unit, rate in roofline.PEAK_OPS_PER_S.items():
        assert rate == program_roofline.PEAK_OPS_PER_S[unit]
