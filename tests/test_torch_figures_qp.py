"""The reference's fig 21 numbers that ``chip_smoke.py``'s ``qp`` phase
holds the card to (``chip_smoke.QP_REFERENCE``), recomputed here from the
reference itself: ``benchmarks/figures.py::fig21_cq_coalescing`` at full
size (``quick=False``: six coalescing counts and the neutral QP, 32
rounds at depth 1024 on FUTURE_40M) on the CPU, about 40 s. Every
recorded number must be the figure's, to the last digit."""
import functools

import pytest

from benchmarks import figures
from chip_smoke import QP_COALESCE, QP_REFERENCE
from port_threads import one_torch_thread  # noqa: F401


@functools.lru_cache(maxsize=None)
def reference_rows() -> dict:
    _, table = figures.fig21_cq_coalescing(quick=False)
    return {int(r[0]): dict(virtual_miops=float(r[1]), p50_us=float(r[2]),
                            p99_us=float(r[3]))
            for r in table}


def test_every_coalescing_count_is_recorded():
    assert tuple(reference_rows()) == QP_COALESCE == tuple(QP_REFERENCE)


@pytest.mark.parametrize("n_coal", QP_COALESCE)
def test_recorded_qp_numbers_are_the_reference_s(n_coal):
    assert QP_REFERENCE[n_coal] == reference_rows()[n_coal]
