"""Fig 23's rows that ``chip_smoke.py``'s ``fabric`` phase holds the card
to (``chip_smoke.FABRIC_REFERENCE``), recomputed here at full size (a
remote 4 x 40M array, depth 1024, 24 rounds) from the reference
(``benchmarks/figures.py::fig23_fabric_roofline``'s settings) and from
the port on the CPU: the 1000 B/us link row and the unconstrained one.
Every number, recorded, reference's and port's, to the last digit, and
the 1000 B/us row's final state leaf by leaf. The
same check of fig 25 is ``tests/test_torch_figures_switch.py``, of figs
26 and 29 ``tests/test_torch_figures_qos.py`` and
``tests/test_torch_figures_lock.py``."""
import numpy as np
import pytest

from benchmarks import common as C
from chip_smoke import (FABRIC_REFERENCE, fabric_cells, fabric_numbers,
                        fabric_violations, port_cell)
from repro import workloads as jw
from repro.core import engine as je
from repro.core import types as jt
from repro_torch import convert
from repro_torch.core import engine as te
from test_torch_fabric import assert_states_agree, jleaves
from port_threads import one_torch_thread  # noqa: F401

ROWS = ("fig23_bw_1000", "fig23_bw_inf")


def reference_config(cell):
    """The reference's (EngineConfig, SSDConfig, workload) of a
    ``chip_smoke.fabric_cells`` entry."""
    cfg = C.swarmio_cfg(fabric=jt.FabricConfig(**cell["fabric"]),
                        **cell["engine"])
    wl = (jw.MultiTenant(**cell["wl"]) if "tenant_read_frac" in cell["wl"]
          else jt.WorkloadConfig(**cell["wl"]))
    return cfg, getattr(C, cell["ssd"]), wl


def reference_numbers(figure, state):
    """The figure's numbers of a reference state, read as
    ``benchmarks/figures.py`` reads them."""
    m = state.metrics
    if figure in ("fig23", "fig25"):
        return {"aggregate_miops": float(je.aggregate_iops(state)) / 1e6,
                "p50_us": float(m.p50_us()), "p99_us": float(m.p99_us())}
    share = m.tenant_share()
    if figure == "fig26":
        lat = m.tenant_avg_e2e_us()
        return {"share0": float(share[0]), "tenant0_e2e_us": float(lat[0]),
                "tenant1_e2e_us": float(lat[1])}
    p99 = m.tenant_p99_us()
    return {"latency_p99_us": float(p99[0]), "bulk_p99_us": float(p99[1]),
            "latency_slo_attainment": float(m.slo_attainment(500.0)[0]),
            "latency_share": float(share[0])}


def reference_row(name):
    """The figure's numbers of a row and its final state's leaves."""
    cell = fabric_cells()[name]
    cfg, ssd, wl = reference_config(cell)
    state = C.run_engine(cfg, ssd, wl, rounds=cell["rounds"],
                         num_devices=cell["devices"])
    return reference_numbers(cell["figure"], state), jleaves(state)


def port_row(name):
    cell = fabric_cells()[name]
    cfg, ssd, wl = port_cell(cell)
    state = te.simulate(cfg, ssd, wl, rounds=cell["rounds"],
                        num_devices=cell["devices"], device="cpu")
    return fabric_numbers(cell["figure"], state), state


def check_row(name, leaves=False):
    """The recorded row is the reference's, to the last digit; the
    port's numbers are too (``chip_smoke.fabric_violations``); with
    ``leaves`` the two final states agree leaf by leaf
    (``test_torch_fabric.assert_states_agree``)."""
    fig = fabric_cells()[name]["figure"]
    want = FABRIC_REFERENCE[fig][name[len(fig) + 1:]]
    ref_nums, ref_leaves = reference_row(name)
    assert ref_nums == want
    got, state = port_row(name)
    assert not fabric_violations(fig, got, want, state), (got, want)
    if leaves:
        assert_states_agree(ref_leaves, convert.engine_state_to_numpy(state))


@pytest.mark.parametrize("name", ROWS)
def test_fig23_row(name):
    """The 1000 B/us row also holds the 4-drive remote array's final
    state leaf by leaf, each drive's link cursors among them."""
    check_row(name, leaves=name == "fig23_bw_1000")


def test_every_fig23_row_is_recorded():
    cells = [n for n, c in fabric_cells().items() if c["figure"] == "fig23"]
    assert sorted(n[len("fig23_"):] for n in cells) == sorted(
        FABRIC_REFERENCE["fig23"])
    assert np.isfinite([v["aggregate_miops"] for v in
                        FABRIC_REFERENCE["fig23"].values()]).all()
