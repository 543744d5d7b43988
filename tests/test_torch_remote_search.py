"""``vector_search.case_study(remote=True)`` in the port against the
reference: n = 1024, batch 64, width 4, 40e6 IOPS, every drive behind
``REMOTE_FABRIC`` (10 us RTT, 8000 B/us links each way, MTU batches of
8), on 1 and 4 drives, fed the reference's index and
queries through ``convert.search_inputs_from_numpy``: indices, distances
and every virtual number equal. The reference's client ``submit`` is
compiled, as the engine compiles it."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.apps.vector_search as jvs
from repro.core import types as jt
from repro_torch import convert
from repro_torch.apps import vector_search as tvs
from test_torch_remote_client import M, N, _CompiledClient
from port_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def search_ref():
    vecs, graph = jvs._cached_index(N, 128, 16, 0)
    q = jax.random.normal(jax.random.PRNGKey(1), (64, 128))
    q = q / jnp.linalg.norm(q, axis=1, keepdims=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jvs, "StorageClient", _CompiledClient)
        yield dict(vecs=vecs, graph=graph, queries=q,
                   truth=jvs.ground_truth(vecs, q, 10))


@pytest.mark.parametrize("devices", [1, M])
def test_remote_case_study(search_ref, devices):
    """``case_study(n=1024, batch=64, remote=True)`` at 40e6 IOPS over 1
    and 4 drives behind ``REMOTE_FABRIC``: indices, distances and every
    virtual number equal to the reference's, and slower than the same
    search on local drives."""
    ssd, ecfg = tvs.case_configs(N, 40e6, fabric=tvs.REMOTE_FABRIC)
    jssd = jt.SSDConfig(t_max_iops=40e6, l_min_us=50.0, n_instances=1000,
                        num_blocks=N)
    jecfg = jt.EngineConfig(num_units=8, fetch_width=64,
                            fabric=jvs.REMOTE_FABRIC)
    want = jvs.search(search_ref["queries"], search_ref["vecs"],
                      search_ref["graph"], jvs.SearchConfig(beam_width=4),
                      jssd, ecfg=jecfg, num_devices=devices)
    vecs, graph, queries = convert.search_inputs_from_numpy(
        np.asarray(search_ref["vecs"]), np.asarray(search_ref["graph"]),
        np.asarray(search_ref["queries"]), "cpu")
    got = tvs.search(queries, vecs, graph, tvs.SearchConfig(beam_width=4),
                     ssd, ecfg=ecfg, num_devices=devices)
    np.testing.assert_array_equal(got["indices"].numpy(),
                                  np.asarray(want["indices"]))
    np.testing.assert_array_equal(got["distances"].numpy(),
                                  np.asarray(want["distances"]))
    for k in ("virtual_us", "writeback_us", "qps", "avg_iter_us",
              "reads_per_iter", "gpu_iter_us"):
        assert got[k] == want[k], (k, got[k], want[k])
    lssd, lecfg = tvs.case_configs(N, 40e6)
    local = tvs.search(queries, vecs, graph, tvs.SearchConfig(beam_width=4),
                       lssd, ecfg=lecfg, num_devices=devices)
    assert got["virtual_us"] > local["virtual_us"]
