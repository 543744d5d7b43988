"""Fig 25's rows that ``chip_smoke.py``'s ``fabric`` phase holds the card
to, recomputed at full size (4 x 40M remote drives behind one switch,
depth 1024, 24 rounds) from the reference and from the port on the CPU:
the 4000 B/us switch row and the unconstrained one, to the last digit
(see ``tests/test_torch_figures_fabric.py``)."""
import pytest

from chip_smoke import FABRIC_REFERENCE, fabric_cells
from test_torch_figures_fabric import check_row
from port_threads import one_torch_thread  # noqa: F401

ROWS = ("fig25_sw_4000", "fig25_sw_inf")


@pytest.mark.parametrize("name", ROWS)
def test_fig25_row(name):
    check_row(name)


def test_every_fig25_row_is_recorded():
    cells = [n for n, c in fabric_cells().items() if c["figure"] == "fig25"]
    assert sorted(n[len("fig25_"):] for n in cells) == sorted(
        FABRIC_REFERENCE["fig25"])
