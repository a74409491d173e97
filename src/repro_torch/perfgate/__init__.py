"""PerfGate on the card: the cost cells (the port's ``repro.perfgate``).

:mod:`repro_torch.perfgate.cost_cells` attributes a benchmark row or a
trace span to a roofline cell on one H100 (:mod:`repro_torch.launch.
roofline`), which the trace report (:mod:`repro_torch.obs.report`) reads.

``repro``'s ``gate`` and ``references`` drive its benchmark runner and
read its committed ``results/BENCH_*.json``, and its ``autotune`` sweeps
Pallas tiles; all three wait for the port's own benchmark (no port kernel
takes a tile parameter, so there is nothing to tune).
"""
from repro_torch.perfgate.cost_cells import attribute, parse_shape

__all__ = ["attribute", "parse_shape"]
