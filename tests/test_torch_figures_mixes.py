"""Figs 19 and 20 of ``test_torch_figures.py``'s check: the write-mix and
steady-state numbers of ``chip_smoke.WORKLOAD_REFERENCE`` against
``benchmarks/figures.py`` at full size on the CPU (about 45 s)."""
import pytest

from test_torch_figures import cells_of, check_cell
from port_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("cell", cells_of("fig19") + cells_of("fig20"))
def test_recorded_numbers_are_the_reference_s(cell):
    check_cell(cell)
