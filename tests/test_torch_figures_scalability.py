"""Fig 12, the paper's scalability figure, as ``chip_smoke.py``'s
``figures`` phase holds the card to it (``FIGURES_REFERENCE``),
recomputed from the reference and from the port on the CPU: panel (a)'s
16-unit SwarmIO run (FUTURE_40M at io_depth 256, 8 rounds: the achieved
IOPS of the paper's 303.9x). Every number to the last digit, and the
final state leaf by leaf (``test_torch_figures_validation.check_cells``).
The ratio's NVMeVirt denominator (``nvmevirt_cfg()`` on the stock
platform at io_depth 256, 8 rounds) is recomputed by no CPU test: only
the card is held to its ``FIGURES_REFERENCE`` row. The panel's wall-clock
half is not recomputed either: it times this host, not the emulated
drive."""
from test_torch_figures_validation import check_cells
from port_threads import one_torch_thread  # noqa: F401


def test_fig12a_swarmio_at_16_units():
    check_cells("fig12_units_16")
