"""The reference's fig 17 numbers that ``chip_smoke.py``'s ``array``
phase holds the card to (``chip_smoke.ARRAY_REFERENCE``), recomputed here
from the reference itself: ``benchmarks/figures.py``'s
``fig17_array_scaling`` at full size (``quick=False``: M = 1, 2, 4 and 8
vmapped 40-MIOPS drives, depth 1024, 24 rounds) on the CPU, about 50 s.
Every recorded number must be the figure's, to the last digit (virtual
time is deterministic).
"""
import functools

import pytest

from benchmarks import figures
from chip_smoke import ARRAY_DEVICES, ARRAY_REFERENCE
from port_threads import one_torch_thread  # noqa: F401

COLUMNS = dict(aggregate_miops=1, fraction_of_target=2, p50_us=3, p99_us=4)


@functools.lru_cache(maxsize=None)
def reference_rows() -> dict:
    _, table = figures.fig17_array_scaling(quick=False)
    return {int(r[0]): {k: float(r[c]) for k, c in COLUMNS.items()}
            for r in table}


def test_every_array_size_is_recorded():
    assert tuple(sorted(ARRAY_REFERENCE)) == ARRAY_DEVICES
    assert tuple(sorted(reference_rows())) == ARRAY_DEVICES


@pytest.mark.parametrize("m", ARRAY_DEVICES)
def test_recorded_array_numbers_are_the_reference_s(m):
    assert ARRAY_REFERENCE[m] == reference_rows()[m]
