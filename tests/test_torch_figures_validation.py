"""Figs 04 and 10, the paper's validation, as ``chip_smoke.py``'s
``figures`` phase holds the card to them (``chip_smoke.FIGURES_REFERENCE``,
a recorded run of ``benchmarks/figures.py`` at its own settings),
recomputed here from the reference and from the port on the CPU: fig 04's
closed form in full, and fig 10's row at 256 outstanding requests
(SwarmIO on D7_PS1010 at io_depth 8, 48 rounds). Recorded, reference's
and port's numbers agree to the last digit, but the average E2E, which
the reference adds in another order, within ``SUM_ULP``
(``chip_smoke.figure_violations``); the row's final states agree leaf by
leaf (``test_torch_fabric.assert_states_agree``). The helpers here serve
the other figure files: ``test_torch_figures_scalability.py`` (fig 12),
``_ablation.py`` (13, 14), ``_sensitivity.py`` (15) and
``_frontend.py`` (03)."""
from benchmarks import common as C
from benchmarks.figures import fig04_per_request_overhead
from chip_smoke import (FIGURES_REFERENCE, fig04_numbers, figure_cells,
                        figure_config, figure_numbers, figure_violations)
from repro.core import types as jt
from repro_torch import convert
from repro_torch.core import engine as te
from test_torch_fabric import assert_states_agree, jleaves
from port_threads import one_torch_thread  # noqa: F401


def reference_config(cell):
    """The reference's (EngineConfig, SSDConfig, WorkloadConfig,
    PlatformModel) of a ``chip_smoke.figure_cells`` entry, built as
    ``benchmarks/figures.py`` builds it."""
    make = C.swarmio_cfg if cell["engine"] == "swarmio" else C.nvmevirt_cfg
    return (make(**cell["cfg"]),
            getattr(C, cell["ssd"]).replace(**cell["ssd_kw"]),
            jt.WorkloadConfig(io_depth=cell["depth"]),
            jt.PlatformModel(**cell["plat"]))


def check_cells(*names):
    """Each cell's numbers from the reference equal the recorded row's, the
    port's agree with them (``figure_violations``), and the two final
    states agree leaf by leaf."""
    cells = figure_cells()
    for name in names:
        cell = cells[name]
        want = FIGURES_REFERENCE[cell["figure"]][cell["row"]]
        cfg, ssd, wl, plat = reference_config(cell)
        ref = C.run_engine(cfg, ssd, wl, plat, rounds=cell["rounds"])
        ref_nums = figure_numbers(cell, ref.metrics)
        assert ref_nums == {k: want[k] for k in ref_nums}, name
        cfg, ssd, wl, plat = figure_config(cell)
        out = te.simulate(cfg, ssd, wl, plat, rounds=cell["rounds"],
                          device="cpu")
        got = figure_numbers(cell, out.metrics)
        assert not figure_violations(got, {k: want[k] for k in got}), name
        assert_states_agree(jleaves(ref), convert.engine_state_to_numpy(out))


def test_fig04_closed_form():
    """Fig 04 in full: the reference's row, the recorded one and the
    port's ``PlatformModel()`` give the same five numbers."""
    header, rows = fig04_per_request_overhead()
    ref = dict(zip(header, rows[0]))
    assert ref == FIGURES_REFERENCE["fig04"]["closed_form"]
    assert fig04_numbers() == ref


def test_fig10_row_at_256_outstanding():
    check_cells("fig10_256")
