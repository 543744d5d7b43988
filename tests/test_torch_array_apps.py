"""The two applications that stripe over an M-drive array, against the
reference: the vector search over four drives, fed the reference's own
index (n = 1024, batch 64, width 4, at 2.5e6 and 40e6 IOPS, write-back on
and off) and held to the bounds that ``tests/test_torch_vector_search.py``
states for one drive; and the KV tier striped over four 40-MIOPS drives
(fig 27's ``4x40m_striped`` point at ``benchmarks/kv_serving.py``'s
settings), whose tokens/s must be the reference's within ``TIER_REL``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.apps.vector_search as jvs
from benchmarks import kv_serving
from chip_smoke import ARRAY_TIER_REFERENCE
from repro import configs as jconfigs
from repro.core import types as jt
from repro.core.client import StorageClient as JClient
from repro.serving import kv_tier as jtier
from repro_torch import configs, convert
from repro_torch.apps import vector_search as tvs
from repro_torch.convert import ulp_distance
from repro_torch.core import types as tt
from repro_torch.serving import kv_tier
from port_threads import one_torch_thread  # noqa: F401

TIER_REL = 1e-5
# tests/test_torch_vector_search.py's bounds for one drive.
DIST_ULP = 0
TIME_ULP = 0
AVG_ULP = 0


# -- the vector search over four drives -----------------------------------------

N = 1024
VS_DEVICES = 4


@dataclasses.dataclass(frozen=True)
class _CompiledClient(JClient):
    """The reference client with ``submit`` compiled (its eager first call
    costs half a minute)."""

    def submit(self, state, flash, ops, data=None, with_data=False):
        return _jit_submit(self, state, flash, ops, data, with_data)


_jit_submit = jax.jit(
    lambda c, s, f, o, d, w: JClient.submit(c, s, f, o, data=d, with_data=w),
    static_argnums=(0, 5))


@pytest.fixture(scope="module")
def search_ref():
    vecs, graph = jvs._cached_index(N, 128, 16, 0)
    q = jax.random.normal(jax.random.PRNGKey(1), (64, 128))
    q = q / jnp.linalg.norm(q, axis=1, keepdims=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jvs, "StorageClient", _CompiledClient)
        yield dict(vecs=vecs, graph=graph, queries=q, runs={})


def _ref_search(ref, iops):
    if iops not in ref["runs"]:
        ssd = jt.SSDConfig(t_max_iops=iops, l_min_us=50.0,
                           n_instances=max(64, int(iops // 4e4)),
                           num_blocks=N)
        ref["runs"][iops] = jvs.search(
            ref["queries"], ref["vecs"], ref["graph"],
            jvs.SearchConfig(beam_width=4), ssd,
            ecfg=jt.EngineConfig(num_units=8, fetch_width=64),
            num_devices=VS_DEVICES, write_back=True)
    return ref["runs"][iops]


def f32_ulp(a, b):
    return ulp_distance(np.float32(a), np.float32(b))


@pytest.mark.parametrize("write_back", [False, True])
@pytest.mark.parametrize("iops", [2.5e6, 40e6])
def test_striped_vector_search_matches_reference(search_ref, iops,
                                                 write_back):
    want = _ref_search(search_ref, iops)
    vecs, graph, queries = convert.search_inputs_from_numpy(
        np.asarray(search_ref["vecs"]), np.asarray(search_ref["graph"]),
        np.asarray(search_ref["queries"]), "cpu")
    ssd, ecfg = tvs.case_configs(N, iops)
    got = tvs.search(queries, vecs, graph, tvs.SearchConfig(beam_width=4),
                     ssd, ecfg=ecfg, num_devices=VS_DEVICES,
                     write_back=write_back)
    np.testing.assert_array_equal(got["indices"].numpy(),
                                  np.asarray(want["indices"]))
    assert ulp_distance(np.asarray(want["distances"]),
                        got["distances"].numpy()) <= DIST_ULP
    assert f32_ulp(want["avg_iter_us"], got["avg_iter_us"]) <= AVG_ULP
    virtual = want["virtual_us"] - (0.0 if write_back
                                    else want["writeback_us"])
    assert f32_ulp(virtual, got["virtual_us"]) <= TIME_ULP
    assert got["qps"] == pytest.approx(64 / (virtual * 1e-6),
                                       rel=TIME_ULP * 2.0 ** -23)
    if write_back:
        assert want["writeback_us"] > 0
        assert f32_ulp(want["writeback_us"], got["writeback_us"]) <= TIME_ULP


# -- the KV tier striped over four 40-MIOPS drives (fig 27) ----------------------

def test_striped_kv_tier_matches_reference():
    """fig 27's ``4x40m_striped`` point: yi-34b (smoke dims), page 16,
    hot window 64, 100 us of modelled GPU time a token, four drives of
    40 MIOPS, batch 4 after 512 tokens, 16 decode steps."""
    shape = kv_serving._serve_shape(False)
    ref = jtier.decode_tokens_per_s(
        jconfigs.get_config(kv_serving.ARCH, smoke=True),
        kv_serving._tier(num_devices=4), kv_serving._ssd(40.0),
        jt.EngineConfig(num_units=8, fetch_width=64), **shape)
    ssd = kv_serving._ssd(40.0)
    out = kv_tier.decode_tokens_per_s(
        configs.get_config(kv_serving.ARCH, smoke=True),
        kv_tier.KVTierConfig(page_tokens=16, hot_window=64,
                             gpu_step_us=kv_serving.GPU_STEP_US,
                             num_devices=4),
        tt.SSDConfig(t_max_iops=ssd.t_max_iops, l_min_us=ssd.l_min_us,
                     n_instances=ssd.n_instances,
                     num_blocks=ssd.num_blocks),
        tt.EngineConfig(num_units=8, fetch_width=64), device="cpu", **shape)
    assert out["data_check_max_abs"] == 0.0
    assert out["blocks_per_step"] == ref["blocks_per_step"]
    for k in ("tokens_per_s", "avg_step_us", "iops_demand"):
        assert abs(out[k] - ref[k]) <= TIER_REL * abs(ref[k]), k
    # What chip_smoke.py's array phase holds the card to.
    for k, v in ARRAY_TIER_REFERENCE.items():
        assert v == ref[k], k
