"""The port's vector-search case study against the reference
(``repro/apps/vector_search.py``) on one drive, fed the reference's own
index: its ``build_index`` vectors and graph and its queries, drawn with
``jax.random`` and handed over through ``convert.search_inputs_from_numpy``.

Contract, at n = 1024, batches 16 and 64, widths 1 and 4, 2.5e6 and 40e6
IOPS, with and without ``write_back``: ``indices`` and ``recall`` equal;
``distances`` bit-exact (``DIST_ULP``: the port sums the 128 lanes in
XLA's CPU order); ``virtual_us``, ``writeback_us`` and ``qps`` within
``TIME_ULP`` float32 units of the reference's and ``avg_iter_us`` within
``AVG_ULP``, both 0: all sixteen cells are bit-exact, since the port's
timing core fuses the multiply-adds that the reference's compiled one
fuses (at batch 16, width 4, 2.5e6 IOPS, where several reads share a
flash instance, it was 1 ULP off before). The reference's client
``submit`` is
compiled, as the engine compiles it (its eager first call costs half a
minute).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.apps.vector_search as jvs
from repro.core import types as jt
from repro.core.client import StorageClient as JClient
from repro_torch import convert
from repro_torch.apps import vector_search as tvs
from repro_torch.convert import ulp_distance
from repro_torch.core import xla_math
from port_threads import one_torch_thread  # noqa: F401

N = 1024
DIST_ULP = 0
TIME_ULP = 0      # virtual_us, writeback_us, qps
AVG_ULP = 0       # avg_iter_us, the mean of 24 such step times
# The reference's own case_study(n=1024, batch=64, width=4) numbers.
REFERENCE_CASE = {
    2.5e6: dict(virtual_us=30096.02734375, qps=2126.526510260192,
                avg_iter_us=1254.001220703125, recall=0.918749988079071),
    40e6: dict(virtual_us=4301.8486328125, qps=14877.324950914772,
               avg_iter_us=179.2436981201172, recall=0.918749988079071),
}


@dataclasses.dataclass(frozen=True)
class _CompiledClient(JClient):
    """The reference client with ``submit`` compiled."""

    def submit(self, state, flash, ops, data=None, with_data=False):
        return _jit_submit(self, state, flash, ops, data, with_data)


_jit_submit = jax.jit(
    lambda c, s, f, o, d, w: JClient.submit(c, s, f, o, data=d, with_data=w),
    static_argnums=(0, 5))


@pytest.fixture(scope="module")
def reference():
    """The reference's index, queries and ground truth at n = 1024, and a
    cache of its search results (write-back on: the search part of such
    a run is the run without it)."""
    vecs, graph = jvs._cached_index(N, 128, 16, 0)
    queries, truth = {}, {}
    for b in (16, 64):
        q = jax.random.normal(jax.random.PRNGKey(1), (b, 128))
        queries[b] = q / jnp.linalg.norm(q, axis=1, keepdims=True)
        truth[b] = jvs.ground_truth(vecs, queries[b], 10)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jvs, "StorageClient", _CompiledClient)
        yield dict(vecs=vecs, graph=graph, queries=queries, truth=truth,
                   runs={})


def reference_run(ref, b, width, iops):
    key = (b, width, iops)
    if key not in ref["runs"]:
        ssd = jt.SSDConfig(t_max_iops=iops, l_min_us=50.0,
                           n_instances=max(64, int(iops // 4e4)),
                           num_blocks=N)
        out = jvs.search(ref["queries"][b], ref["vecs"], ref["graph"],
                         jvs.SearchConfig(beam_width=width), ssd,
                         ecfg=jt.EngineConfig(num_units=8, fetch_width=64),
                         write_back=True)
        out["recall"] = jvs.recall_at_k(out["indices"], ref["truth"][b])
        ref["runs"][key] = out
    return ref["runs"][key]


def port_inputs(ref, b):
    return convert.search_inputs_from_numpy(
        np.asarray(ref["vecs"]), np.asarray(ref["graph"]),
        np.asarray(ref["queries"][b]), "cpu")


def port_run(ref, b, width, iops, write_back):
    vecs, graph, queries = port_inputs(ref, b)
    ssd, ecfg = tvs.case_configs(N, iops)
    out = tvs.search(queries, vecs, graph, tvs.SearchConfig(beam_width=width),
                     ssd, ecfg=ecfg, write_back=write_back)
    truth = torch.from_numpy(np.array(ref["truth"][b]))
    out["recall"] = tvs.recall_at_k(out["indices"], truth)
    return out


def f32_ulp(a: float, b: float) -> int:
    return ulp_distance(np.float32(a), np.float32(b))


@pytest.mark.parametrize("write_back", [False, True])
@pytest.mark.parametrize("iops", [2.5e6, 40e6])
@pytest.mark.parametrize("width", [1, 4])
@pytest.mark.parametrize("batch", [16, 64])
def test_search_matches_reference(reference, batch, width, iops, write_back):
    want = reference_run(reference, batch, width, iops)
    got = port_run(reference, batch, width, iops, write_back)
    np.testing.assert_array_equal(got["indices"].numpy(),
                                  np.asarray(want["indices"]))
    assert got["recall"] == want["recall"]
    assert ulp_distance(np.asarray(want["distances"]),
                        got["distances"].numpy()) <= DIST_ULP
    assert f32_ulp(want["avg_iter_us"], got["avg_iter_us"]) <= AVG_ULP
    assert got["reads_per_iter"] == want["reads_per_iter"]
    assert got["gpu_iter_us"] == want["gpu_iter_us"]
    # The write-back run's search part: total = virtual - writeback, both
    # exact sums of float32 values in double.
    virtual = want["virtual_us"] - (0.0 if write_back
                                    else want["writeback_us"])
    assert f32_ulp(virtual, got["virtual_us"]) <= TIME_ULP
    assert got["qps"] == pytest.approx(batch / (virtual * 1e-6),
                                       rel=TIME_ULP * 2.0 ** -23)
    if write_back:
        assert want["writeback_us"] > 0
        assert f32_ulp(want["writeback_us"], got["writeback_us"]) <= TIME_ULP
    else:
        assert got["writeback_us"] == 0.0


@pytest.mark.parametrize("iops", sorted(REFERENCE_CASE))
def test_case_study_numbers_of_the_reference(reference, iops):
    """The reference's ``case_study(n=1024, batch=64, width=4)``: the port
    fed its index gives its virtual numbers (7.0x QPS from 2.5e6 to 40e6
    IOPS at batch 64)."""
    got = port_run(reference, 64, 4, iops, False)
    for k, v in REFERENCE_CASE[iops].items():
        assert got[k] == v, (k, got[k], v)


def test_knn_graph_and_ground_truth_are_the_reference_s(reference):
    """``knn_graph`` on the reference's vectors is the reference's graph,
    and ``ground_truth`` its truth: distances in XLA's order, ties to the
    lower index."""
    vecs, _, queries = port_inputs(reference, 64)
    np.testing.assert_array_equal(tvs.knn_graph(vecs, 16).numpy(),
                                  np.asarray(reference["graph"]))
    np.testing.assert_array_equal(tvs.ground_truth(vecs, queries, 10).numpy(),
                                  np.asarray(reference["truth"][64]))


@pytest.mark.parametrize("n", [1, 5, 24, 32, 33, 100, 128, 1025])
def test_lane_sum_is_xla_sum(n):
    """``xla_math.lane_sum`` adds in the compiled ``jnp.sum``'s order
    (windows of 32 past 32 elements), bit for bit, and
    ``xla_math.lane_mean`` is the compiled ``jnp.mean``."""
    x = np.random.default_rng(n).random((257, n)).astype(np.float32) * 3
    same = jax.jit(lambda a: jnp.sum(a, axis=-1))(x)
    np.testing.assert_array_equal(
        xla_math.lane_sum(torch.from_numpy(x)).numpy().view(np.int32),
        np.asarray(same).view(np.int32))
    row = x[0] * 1000
    assert float(xla_math.lane_mean(torch.from_numpy(row))) == float(
        jax.jit(jnp.mean)(row))


def test_smallest_keeps_the_lower_index_on_ties():
    """``_smallest`` is ``jax.lax.top_k(-x, k)``'s index rule on rows full
    of ties (many ``BIG``, repeated distances); ``torch.topk`` gives no
    such promise."""
    rng = np.random.default_rng(3)
    x = rng.integers(0, 4, (64, 80)).astype(np.float32)
    x[rng.random(x.shape) < 0.5] = jvs.BIG
    for k in (1, 4, 10):
        _, want = jax.lax.top_k(-jnp.asarray(x), k)
        np.testing.assert_array_equal(
            tvs._smallest(torch.from_numpy(x), k).numpy(), np.asarray(want))


def _tie_case():
    """64 nodes that are 32 vectors twice over, so every candidate has a
    twin at an equal distance, and a beam of 2 from a single start node,
    so the first pick of every query is among 63 ``BIG`` ties."""
    rng = np.random.default_rng(1)
    base = rng.standard_normal((32, 128)).astype(np.float32)
    base /= np.linalg.norm(base, axis=1, keepdims=True)
    vecs = np.concatenate([base, base])
    graph = rng.integers(0, 64, (64, 16)).astype(np.int32)
    queries = (rng.standard_normal((4, 128)) * 0.1
               + vecs[rng.integers(0, 64, 4)]).astype(np.float32)
    return vecs, graph, queries


def test_search_breaks_ties_as_the_reference(monkeypatch):
    """On ``_tie_case`` the port's results are the reference's; picking
    the higher index on ties instead changes them."""
    vecs, graph, queries = _tie_case()
    ssd = dict(t_max_iops=2.5e6, l_min_us=50.0, n_instances=64, num_blocks=64)
    kw = dict(beam_width=2, iterations=6, top_k=12)
    want = jvs.search(jnp.asarray(queries), jnp.asarray(vecs),
                      jnp.asarray(graph), jvs.SearchConfig(**kw),
                      jt.SSDConfig(**ssd),
                      ecfg=jt.EngineConfig(num_units=8, fetch_width=64))
    tv, tg, tq = convert.search_inputs_from_numpy(vecs, graph, queries, "cpu")

    def run():
        return tvs.search(tq, tv, tg, tvs.SearchConfig(**kw),
                          tvs.SSDConfig(**ssd),
                          ecfg=tvs.EngineConfig(num_units=8, fetch_width=64))

    got = run()
    np.testing.assert_array_equal(got["indices"].numpy(),
                                  np.asarray(want["indices"]))
    assert got["virtual_us"] == want["virtual_us"]

    def last_on_ties(x, k):
        order = torch.argsort(torch.flip(x, dims=[1]), dim=1,
                              stable=True)[:, :k]
        return (x.shape[1] - 1 - order).long()

    monkeypatch.setattr(tvs, "_smallest", last_on_ties)
    assert not np.array_equal(run()["indices"].numpy(),
                              np.asarray(want["indices"]))


def test_merge_top_matches_reference():
    """``_merge_top`` with duplicate ids, -1 padding and equal distances."""
    rng = np.random.default_rng(5)
    b, L, m = 8, 16, 24
    dist = np.sort(rng.integers(0, 6, (b, L)).astype(np.float32), axis=1)
    dist[:, 10:] = jvs.BIG
    idx = rng.integers(-1, 20, (b, L)).astype(np.int32)
    exp = rng.random((b, L)) < 0.3
    new_d = rng.integers(0, 6, (b, m)).astype(np.float32)
    new_d[rng.random((b, m)) < 0.3] = jvs.BIG
    new_i = rng.integers(0, 20, (b, m)).astype(np.int32)
    want = jax.jit(lambda *a: jvs._merge_top(*a, L))(
        *(jnp.asarray(x) for x in (dist, idx, exp, new_d, new_i)))
    got = tvs._merge_top(*(torch.from_numpy(x) for x in (dist, idx, exp,
                                                         new_d, new_i)), L)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_unported_options_raise():
    with pytest.raises(ValueError, match="divisible by num_devices=3"):
        tvs.case_study(n=64, batch=4, num_devices=3, device="cpu")
    with pytest.raises(ValueError, match="float32"):
        convert.search_inputs_from_numpy(np.zeros((4, 8)), np.zeros(
            (4, 2), np.int32), np.zeros((1, 8), np.float32), "cpu")


def test_case_study_of_the_port_on_the_cpu():
    """The port's own index (numpy draws) on the CPU: deterministic,
    finite, and a faster drive serves more queries a second."""
    slow = tvs.case_study(n=256, batch=8, iterations=6, t_max_iops=2.5e6,
                          device="cpu")
    fast = tvs.case_study(n=256, batch=8, iterations=6, t_max_iops=40e6,
                          device="cpu")
    again = tvs.case_study(n=256, batch=8, iterations=6, t_max_iops=40e6,
                           device="cpu")
    assert fast["qps"] > slow["qps"] > 0
    assert 0.0 <= fast["recall"] <= 1.0
    assert torch.equal(fast["indices"], again["indices"])
    assert fast["virtual_us"] == again["virtual_us"]
    assert bool(torch.isfinite(fast["distances"]).all())


def test_make_search_binds_the_configs_of_search(reference):
    """A ``make_search`` object called twice, write-back off and on, gives
    ``search``'s results on the reference's index, bit for bit."""
    vecs, graph, queries = port_inputs(reference, 16)
    ssd, ecfg = tvs.case_configs(N, 40e6)
    cfg = tvs.SearchConfig(beam_width=4, iterations=8)
    searcher = tvs.make_search(cfg, ssd, ecfg=ecfg)
    for write_back in (False, True):
        got = searcher(queries, vecs, graph, write_back=write_back)
        want = tvs.search(queries, vecs, graph, cfg, ssd, ecfg=ecfg,
                          write_back=write_back)
        assert set(got) == set(want)
        for k, v in want.items():
            if isinstance(v, torch.Tensor):
                assert torch.equal(got[k], v), k
            else:
                assert got[k] == v, k
    with pytest.raises(ValueError, match="num_devices=0"):
        tvs.make_search(cfg, ssd, ecfg=ecfg, num_devices=0)
