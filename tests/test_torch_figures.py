"""The reference's figs 18-20 numbers that ``chip_smoke.py``'s
``workloads`` phase holds the card to (``chip_smoke.WORKLOAD_REFERENCE``),
recomputed here from the reference itself: ``benchmarks/figures.py``'s
``fig18_workload_sweep``, ``fig19_write_mix`` and ``fig20_steady_state``
at full size (``quick=False``) on the CPU. Every recorded number must be
the figure's, to the last digit (virtual time is deterministic). This
file checks fig 18 (about 35 s), ``test_torch_figures_mixes.py`` figs 19
and 20.
"""
import functools

import pytest

from benchmarks import figures
from chip_smoke import WORKLOAD_REFERENCE
from port_threads import one_torch_thread  # noqa: F401

# (figure function, the row's name column -> cell name, column of each
# number in the figure's rows).
FIGURES = {
    "fig18": (figures.fig18_workload_sweep, lambda r: f"fig18/{r}",
              dict(virtual_miops=1, p50_us=3, p99_us=5)),
    "fig19": (figures.fig19_write_mix, lambda r: f"fig19/read_frac_{r}",
              dict(virtual_miops=1, p50_us=2, p99_us=3, gc_count=4)),
    "fig20": (figures.fig20_steady_state, lambda r: f"fig20/{r}",
              dict(virtual_miops=1, p50_us=2, p99_us=3, gc_count=4)),
}


@functools.lru_cache(maxsize=None)
def reference_cells(fig: str) -> dict:
    """The reference's numbers of one figure by cell name (run once)."""
    fn, cell, cols = FIGURES[fig]
    _, table = fn(quick=False)
    return {cell(r[0]): {k: float(r[c]) for k, c in cols.items()}
            for r in table}


def cells_of(fig: str) -> list:
    return sorted(k for k in WORKLOAD_REFERENCE if k.startswith(fig + "/"))


def check_cell(cell: str) -> None:
    got = reference_cells(cell.split("/")[0])
    assert cell in got, sorted(got)
    assert WORKLOAD_REFERENCE[cell] == got[cell]


def test_every_figure_cell_is_recorded():
    """The recorded cells are exactly the three figures' full-size rows."""
    assert {k.split("/")[0] for k in WORKLOAD_REFERENCE} == set(FIGURES)
    assert [len(cells_of(f)) for f in FIGURES] == [4, 4, 2]


@pytest.mark.parametrize("cell", cells_of("fig18"))
def test_recorded_numbers_are_the_reference_s(cell):
    check_cell(cell)
