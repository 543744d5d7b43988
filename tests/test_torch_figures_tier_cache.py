"""Fig 28's hot-window x cache points that ``chip_smoke.py``'s
``serve_tier`` phase holds the card to (``chip_smoke.TIER_CACHE_REFERENCE``),
recomputed here from the reference at the sweep's own settings
(``benchmarks/kv_serving.py``'s ``_run``, ``_tier`` and ``_ssd``, not
quick): the three ``hot_window = 32`` points, cache off, small and large
(about 24 s; the card runs all nine). Every recorded number must be the
reference's, to the last digit, and every point's data check 0.0."""
import functools

import pytest

from benchmarks import kv_serving
from chip_smoke import TIER_CACHE_REFERENCE, TIER_CACHES
from repro.core.types import CacheConfig, EngineConfig
from port_threads import one_torch_thread  # noqa: F401

KEYS = ("tokens_per_s", "avg_storage_us", "blocks_per_step")


@functools.lru_cache(maxsize=None)
def reference_point(cache: str) -> dict:
    ecfg = EngineConfig(num_units=8, fetch_width=64,
                        cache=CacheConfig(**TIER_CACHES[cache]))
    return kv_serving._run(kv_serving._tier(hot_window=32),
                           kv_serving._ssd(2.5), ecfg, quick=False)


def test_the_sweep_is_recorded_whole():
    assert sorted(TIER_CACHE_REFERENCE) == sorted(
        f"hw{hw}_cache_{c}" for hw in (32, 64, 128) for c in TIER_CACHES)


@pytest.mark.parametrize("cache", sorted(TIER_CACHES))
def test_recorded_tier_points_are_the_reference_s(cache):
    got = reference_point(cache)
    assert got["data_check_max_abs"] == 0.0
    assert TIER_CACHE_REFERENCE[f"hw32_cache_{cache}"] == {
        k: float(got[k]) for k in KEYS}
