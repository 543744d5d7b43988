"""Fig 15, the paper's sensitivity figure, as ``chip_smoke.py``'s
``figures`` phase holds the card to it (``FIGURES_REFERENCE``),
recomputed from the reference and from the port on the CPU: the 512-byte
row of panel (b) (DSA roof 42 GB/s over 16 engines, io_depth 1024, 24
rounds). Every number to the last digit, and the final state leaf by
leaf (``test_torch_figures_validation.check_cells``)."""
from test_torch_figures_validation import check_cells
from port_threads import one_torch_thread  # noqa: F401


def test_fig15_block_size_512():
    check_cells("fig15_block_512")
