"""Figs 13 and 14, the paper's ablations, as ``chip_smoke.py``'s
``figures`` phase holds the card to them (``FIGURES_REFERENCE``),
recomputed from the reference and from the port on the CPU: fig 13's
D+A+C run (the distributed, DSA-fetched, coalesced frontend with the
CPU-worker datapath on the frontend-only platform, a 100 MIOPS drive of
1024 instances, io_depth 1024, 24 rounds: the numerator of the paper's
537x), and fig 14's per-request run at 2 units (SwarmIO's frontend with
the NVMeVirt timing model at a 5 MIOPS target, io_depth 1024, 32
rounds). Every number to the last digit, and each final state leaf by
leaf (``test_torch_figures_validation.check_cells``)."""
from test_torch_figures_validation import check_cells
from port_threads import one_torch_thread  # noqa: F401


def test_fig13_full_frontend():
    check_cells("fig13_D+A+C")


def test_fig14_per_request_at_2_units():
    check_cells("fig14_per_request_2")
