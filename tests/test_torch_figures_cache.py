"""The reference's fig 22 numbers that ``chip_smoke.py``'s ``cache`` phase
holds the card to (``chip_smoke.CACHE_REFERENCE``), recomputed here from
the reference itself: ``benchmarks/figures.py::fig22_cache_hit_rate`` at
full size (``quick=False``: six cache sizes, 48 rounds of the Zipf loop
on D7_PS1010) on the CPU, about 35 s. Every recorded number must be the
figure's, to the last digit (virtual time is deterministic)."""
import functools

import pytest

from benchmarks import figures
from chip_smoke import CACHE_REFERENCE, CACHE_SETS
from port_threads import one_torch_thread  # noqa: F401


@functools.lru_cache(maxsize=None)
def reference_rows() -> dict:
    _, table = figures.fig22_cache_hit_rate(quick=False)
    return {int(r[0]): dict(hit_rate=float(r[2]), virtual_miops=float(r[3]),
                            p50_us=float(r[4]), p99_us=float(r[5]))
            for r in table}


def test_every_cache_size_is_recorded():
    assert tuple(reference_rows()) == CACHE_SETS == tuple(CACHE_REFERENCE)


@pytest.mark.parametrize("sets", CACHE_SETS)
def test_recorded_cache_numbers_are_the_reference_s(sets):
    assert CACHE_REFERENCE[sets] == reference_rows()[sets]
