"""Fig 29's WFQ pair that ``chip_smoke.py``'s ``fabric`` phase holds the
card to, recomputed at full size (a read tenant and a write tenant on
interleaved SQs, one unit an SQ, a TX-bound wire under WFQ 2:1, 96
rounds) under the program-order and the ready-time lock, from the
reference and from the port on the CPU, to the last digit and leaf by
leaf: the latency
tenant's p99 falls from 2090.800048828125 to 241.4418182373047 us. The
recorded run is also the one in ``BENCH_lock_order.json``."""
import json
from pathlib import Path

import pytest

from chip_smoke import FABRIC_REFERENCE, fabric_cells
from test_torch_figures_fabric import check_row
from port_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("order", ["program", "ready_time"])
def test_fig29_wfq_row(order):
    check_row(f"fig29_wfq_2_1_{order}", leaves=True)


def test_recorded_fig29_is_bench_lock_order():
    points = json.loads((ROOT / "BENCH_lock_order.json").read_text())
    assert {f"{p['arbiter']}_{p['lock_order']}": {
        k: p[k] for k in ("latency_p99_us", "bulk_p99_us",
                          "latency_slo_attainment", "latency_share")}
        for p in points["fig29"]} == FABRIC_REFERENCE["fig29"]
    assert sorted(n[len("fig29_"):] for n, c in fabric_cells().items()
                  if c["figure"] == "fig29") == sorted(
        FABRIC_REFERENCE["fig29"])
    wfq = FABRIC_REFERENCE["fig29"]
    assert wfq["wfq_2_1_program"]["latency_p99_us"] == 2090.800048828125
    assert wfq["wfq_2_1_ready_time"]["latency_p99_us"] == 241.4418182373047
