"""Fig 26's (2,1) share row that ``chip_smoke.py``'s ``fabric`` phase
holds the card to, recomputed at full size (two read tenants on an
RX-bound link under WFQ 2:1, depth 64, 192 rounds) from the reference and
from the port on the CPU: the shares to the last digit, the tenants'
average E2E within the bound of the reference's recursive per-tenant sum
(``chip_smoke.fabric_violations``), and the final state leaf by leaf;
see ``tests/test_torch_figures_fabric.py``."""
from chip_smoke import FABRIC_REFERENCE, fabric_cells
from test_torch_figures_fabric import check_row
from port_threads import one_torch_thread  # noqa: F401


def test_fig26_share_row():
    check_row("fig26_share_2:1", leaves=True)


def test_every_fig26_row_is_recorded():
    cells = [n for n, c in fabric_cells().items() if c["figure"] == "fig26"]
    assert sorted(n[len("fig26_"):] for n in cells) == sorted(
        FABRIC_REFERENCE["fig26"])
