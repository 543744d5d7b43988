"""The port's stage-0 page cache (``repro_torch/core/cache.py``) and its
callers against the reference (``repro/core/cache.py``, the engine's hit
chase, the client's stage 0, the vector search's ``cache_sets``).

Per function, on shared seeded inputs: ``lookup`` (with ``lba = -1``
rows), ``_insert_once`` (more fills to one set than it has ways: two
fills of one call land on one (set, way) and the later row's block must
stay, the reference's CPU scatter rule that an indexed assignment on a
card would not keep), ``insert`` with ``readahead`` 0 and 2, and
``serve``; each for one drive and for a stack of drives against the
reference vmapped. Whole runs at small widths: ``simulate`` with the
cache on (Zipf reads, and a 70/30 mix with readahead) for one drive and
an array of two, every leaf equal but the metric sums (``SUM_ULP``);
chained client ``submit`` calls with read hits and write-allocate, and
``read_striped`` over a stacked cache; ``case_study(cache_sets=8)`` at
n = 64 fed the reference's index. Integer and bool leaves (``cache.tags``
and ``cache.rr`` among them) must be equal and times bit-exact, the
search's virtual times among them.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.apps.vector_search as jvs
from repro import workloads as jw
from repro.core import cache as jc
from repro.core import engine as je
from repro.core import types as jt
from repro.core.client import StorageClient as JClient
from repro_torch import convert
from repro_torch import workloads as tw
from repro_torch.apps import vector_search as tvs
from repro_torch.core import cache as tc
from repro_torch.core import engine as te
from repro_torch.core import types as tt
from repro_torch.core.client import StorageClient as TClient
from port_threads import one_torch_thread  # noqa: F401

SMALL = dict(num_sqs=8, sq_depth=64, fetch_width=16)
SUM_ULP = 16
SUM_BOUNDS = {k: SUM_ULP for k in (
    "metrics.sum_e2e", "metrics.sum_target", "metrics.sum_proc",
    "metrics.tenant_sum_e2e")}
S, W = 8, 4
TIME_ULP = 0      # the search's virtual_us and qps (see the search test)
AVG_ULP = 0       # its avg_iter_us, a mean of 24 step times


def jleaves(state):
    return {jax.tree_util.keystr(p).lstrip("."): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(state)[0]}


def caches(tags, rr):
    return (jc.CacheState(jnp.asarray(tags), jnp.asarray(rr)),
            tc.CacheState(torch.from_numpy(tags), torch.from_numpy(rr)))


def same(want, got):
    want, got = np.asarray(want), got.numpy()
    assert want.dtype == got.dtype and want.shape == got.shape
    np.testing.assert_array_equal(got, want)


def same_cache(want, got):
    same(want.tags, got.tags)
    same(want.rr, got.rr)


def inputs(seed, lead=()):
    """Tags (S, W) with empty ways, cursors, and a batch of 96 rows whose
    LBAs include -1 and crowd set 3 (more fills than ways)."""
    rng = np.random.default_rng(seed)
    tags = rng.integers(0, 48, lead + (S, W)).astype(np.int32)
    tags[rng.random(tags.shape) < 0.3] = -1
    rr = rng.integers(0, W, lead + (S,)).astype(np.int32)
    lba = rng.integers(-1, 48, lead + (96,)).astype(np.int32)
    lba[..., :12] = 3 + S * np.arange(12, dtype=np.int32)   # set 3, twelve
    lba[..., 12:16] = -1
    valid = rng.random(lead + (96,)) < 0.85
    valid[..., :12] = True
    t_sub = (rng.random(lead + (96,)) * 100).astype(np.float32)
    return tags, rr, lba, valid, t_sub


CCFGS = {r: (jt.CacheConfig(enabled=True, num_sets=S, ways=W, readahead=r),
             tt.CacheConfig(enabled=True, num_sets=S, ways=W, readahead=r))
         for r in (0, 2)}


@pytest.mark.parametrize("lead", [(), (3,)], ids=["one", "stack3"])
@pytest.mark.parametrize("readahead", [0, 2])
def test_cache_functions_match_reference(lead, readahead):
    jcfg, tcfg = CCFGS[readahead]
    tags, rr, lba, valid, t_sub = inputs(7 + readahead, lead)
    js, ts = caches(tags, rr)
    a = [jnp.asarray(x) for x in (lba, valid, t_sub)]
    b = [torch.from_numpy(x) for x in (lba, valid, t_sub)]

    def ref(fn):
        f = lambda *args: fn(*args)  # noqa: E731
        for _ in lead:
            f = jax.vmap(f)
        return jax.jit(f)

    same(ref(lambda s, l, v: jc.lookup(s, l, v, jcfg))(js, a[0], a[1]),
         tc.lookup(ts, b[0], b[1], tcfg))
    fill = a[1] & (a[0] >= 0)
    same_cache(ref(lambda s, l, f: jc._insert_once(s, l, f, jcfg))(
        js, a[0], fill), tc._insert_once(ts, b[0], b[1] & (b[0] >= 0), tcfg))
    same_cache(ref(lambda s, l, v: jc.insert(s, l, v, jcfg))(js, a[0], a[1]),
               tc.insert(ts, b[0], b[1], tcfg))
    for want, got in zip(
            ref(lambda s, l, v, t: jc.serve(s, l, v, t, jcfg))(js, *a),
            tc.serve(ts, *b, tcfg)):
        same(want, got)
    assert tc.set_of(torch.tensor([-1], dtype=torch.int32), tcfg).item() \
        == S - 1


def test_more_fills_than_ways_keep_the_last_writer():
    """Six fills to a one-set, four-way cache: ways 0 and 1 are written
    twice, and the later rows (14, 15) stay, as the reference leaves them
    eagerly and compiled."""
    jcfg = jt.CacheConfig(enabled=True, num_sets=1, ways=4)
    tcfg = tt.CacheConfig(enabled=True, num_sets=1, ways=4)
    tags = np.full((1, 4), -1, np.int32)
    rr = np.zeros((1,), np.int32)
    lba = np.arange(10, 16, dtype=np.int32)
    fill = np.ones(6, bool)
    js, ts = caches(tags, rr)
    eager = jc._insert_once(js, jnp.asarray(lba), jnp.asarray(fill), jcfg)
    jitted = jax.jit(lambda s, l, f: jc._insert_once(s, l, f, jcfg))(
        js, jnp.asarray(lba), jnp.asarray(fill))
    got = tc._insert_once(ts, torch.from_numpy(lba), torch.from_numpy(fill),
                          tcfg)
    assert got.tags.tolist() == [[14, 15, 12, 13]] and got.rr.tolist() == [2]
    same_cache(eager, got)
    same_cache(jitted, got)


# -- whole engine runs ---------------------------------------------------------

RUNS = {
    "zipf": (dict(num_sets=16, ways=4), (
        jw.ZipfClosedLoop(io_depth=16, theta=0.9),
        tw.ZipfClosedLoop(io_depth=16, theta=0.9))),
    "mixed_readahead": (dict(num_sets=32, ways=2, readahead=1, chase=3), (
        jw.MixedReadWrite(io_depth=16, read_frac=0.7, theta=0.9),
        tw.MixedReadWrite(io_depth=16, read_frac=0.7, theta=0.9))),
}


@pytest.mark.parametrize("name, m", [("zipf", 1), ("mixed_readahead", 2)])
def test_cached_simulate_matches_reference(name, m):
    """Six rounds with the cache on: Zipf reads on one drive, a 70/30 mix
    with readahead and three chased hits on an array of two. Every leaf
    (the cache's tags and cursors, the hit count, the histograms) equal,
    the metric sums within SUM_ULP."""
    ccfg, (wj, wt) = RUNS[name]
    ssd = dict(num_blocks=1 << 10)
    cj = jt.EngineConfig(**SMALL, cache=jt.CacheConfig(enabled=True, **ccfg))
    ct = tt.EngineConfig(**SMALL, cache=tt.CacheConfig(enabled=True, **ccfg))
    rounds = 6
    if m == 1:
        ref = je.make_runner(cj, jt.SSDConfig(**ssd), wj, jt.PlatformModel(),
                             rounds)(je.init_state(cj, jt.SSDConfig(**ssd),
                                                   wj))
    else:
        ref = je.simulate(cj, jt.SSDConfig(**ssd), wj, rounds=rounds,
                          num_devices=m)
    out = te.simulate(ct, tt.SSDConfig(**ssd), wt, rounds=rounds,
                      num_devices=m, device="cpu")
    want, got = jleaves(ref), convert.engine_state_to_numpy(out)
    assert "cache.tags" in got and float(want["metrics.cache_hits"].min()) > 0
    assert not convert.leaf_differences(want, got, SUM_BOUNDS)
    np.testing.assert_array_equal(np.asarray(ref.metrics.hit_rate()),
                                  out.metrics.hit_rate().numpy())


def test_cached_state_round_trips_through_convert():
    """A cached engine state goes to numpy and back with its cache; a
    state without one comes back without one."""
    ct = tt.EngineConfig(**SMALL, cache=tt.CacheConfig(enabled=True,
                                                       num_sets=16))
    state = te.init_state(ct, tt.SSDConfig(), tt.WorkloadConfig(io_depth=4),
                          device="cpu")
    leaves = convert.engine_state_to_numpy(state)
    assert leaves["cache.tags"].shape == (16, 4)
    back = convert.engine_state_from_numpy(leaves, "cpu")
    assert not convert.leaf_differences(
        leaves, convert.engine_state_to_numpy(back))
    plain = {k: v for k, v in leaves.items() if not k.startswith("cache.")}
    assert convert.engine_state_from_numpy(plain, "cpu").cache is None


# -- the client's stage 0 ------------------------------------------------------

CLIENT_SSD = dict(t_max_iops=2.5e6, l_min_us=50.0, n_instances=64,
                  num_blocks=256)
CLIENT_CFG = dict(num_units=4, fetch_width=32, num_sqs=8, sq_depth=128)
WORDS = 4


def clients(**cache):
    return (JClient(jt.SSDConfig(**CLIENT_SSD), jt.EngineConfig(
                **CLIENT_CFG, cache=jt.CacheConfig(enabled=True, **cache))),
            TClient(tt.SSDConfig(**CLIENT_SSD), tt.EngineConfig(
                **CLIENT_CFG, cache=tt.CacheConfig(enabled=True, **cache))))


def agree(sj, st, bounds=None):
    assert not convert.leaf_differences(
        jleaves(sj), convert.engine_state_to_numpy(st), bounds)


def test_client_submit_hits_and_write_allocate():
    """Three chained mixed submits on one cached client: reads of blocks
    read or written before hit (at t + hit_us, no SQE), writes never hit
    and fill the cache. Completion times, block store, gathered rows and
    every leaf, cache included, equal."""
    cj, ct = clients(num_sets=16, ways=4, readahead=1)
    rng = np.random.default_rng(3)
    flash = rng.standard_normal((256, WORDS)).astype(np.float32)
    sub_j = jax.jit(lambda s, f, o, d: cj.submit(s, f, o, data=d,
                                                 with_data=True))
    sj, st = cj.init_state(), ct.init_state("cpu")
    fj, ft = jnp.asarray(flash), torch.from_numpy(flash)
    hits = 0
    for step in range(3):
        n = 96
        lba = rng.permutation(64)[:n // 2].astype(np.int32)
        lba = np.concatenate([lba, lba[::-1]])[:n]
        op = (rng.random(n) < 0.3).astype(np.int32)
        op[n // 2:] = 0                       # second half re-reads
        t_sub = np.round(rng.uniform(0, 300, n), 1).astype(np.float32) \
            + np.float32(1000 * step)
        valid = rng.random(n) < 0.9
        data = rng.standard_normal((n, WORDS)).astype(np.float32)
        ops_j = jt.StorageOps(jnp.asarray(op), jnp.asarray(lba),
                              jnp.asarray(t_sub), jnp.zeros(n, jnp.int32),
                              jnp.asarray(valid))
        ops_t = tt.StorageOps(*(torch.from_numpy(np.asarray(x)) for x in (
            op, lba, t_sub, np.zeros(n, np.int32), valid)))
        sj, fj, oj, dj = sub_j(sj, fj, ops_j, jnp.asarray(data))
        st, ft, ot, dt = ct.submit(st, ft, ops_t, data=torch.from_numpy(data),
                                   with_data=True)
        same(dj, dt)
        same(fj, ft)
        same(oj, ot)
        hits += int(np.sum(np.asarray(dj) == t_sub + np.float32(0.5)))
        agree(sj, st)
    assert hits > 0


def test_read_striped_over_a_stacked_cache():
    """Two striped reads over three drives, each with its cache: the
    second re-reads the first's blocks. Times and every stacked leaf
    equal."""
    cj, ct = clients(num_sets=8, ways=2)
    m = 3
    rng = np.random.default_rng(4)
    flash = rng.standard_normal((256, WORDS)).astype(np.float32)
    read_j = jax.jit(lambda s, f, l, ts: cj.read_striped(s, f, l, ts))
    sj, st = cj.init_array_state(m), ct.init_array_state(m, "cpu")
    lba = rng.integers(0, 40, 100).astype(np.int32)
    for t0 in (5.0, 900.0):
        sj, dj, donej = read_j(sj, jnp.asarray(flash), jnp.asarray(lba),
                               jnp.float32(t0))
        st, dt, donet = ct.read_striped(st, torch.from_numpy(flash),
                                        torch.from_numpy(lba), t0)
        same(donej, donet)
        same(dj, dt)
        agree(sj, st)
    assert st.cache.tags.shape == (m, 8, 2)
    assert float((donet == 900.5).to(torch.float32).mean()) > 0.5


# -- the vector search's cache_sets --------------------------------------------

@dataclasses.dataclass(frozen=True)
class _CompiledClient(JClient):
    """The reference client with ``submit`` compiled (as its engine is)."""

    def submit(self, state, flash, ops, data=None, with_data=False):
        return _jit_submit(self, state, flash, ops, data, with_data)


_jit_submit = jax.jit(
    lambda c, s, f, o, d, w: JClient.submit(c, s, f, o, data=d, with_data=w),
    static_argnums=(0, 5))


def test_case_study_with_cache_sets_matches_reference(monkeypatch):
    """``case_study(n=64, batch=16, cache_sets=8)``'s search fed the
    reference's index and queries: indices and distances equal, and the
    cache changes the run. The virtual times are held to ``TIME_ULP`` and
    ``AVG_ULP`` as in ``tests/test_torch_vector_search.py``, both 0: the
    port's timing core fuses the multiply-adds the reference's compiled
    one fuses (at width 4 and 2.5e6 IOPS this cell was 1 ULP off before,
    with the cache on and off)."""
    n, b = 64, 16
    vecs, graph = jvs._cached_index(n, 128, 16, 0)
    q = jax.random.normal(jax.random.PRNGKey(1), (b, 128))
    q = q / jnp.linalg.norm(q, axis=1, keepdims=True)
    monkeypatch.setattr(jvs, "StorageClient", _CompiledClient)
    ssd, ecfg = tvs.case_configs(n, 2.5e6, cache_sets=8)
    jssd = jt.SSDConfig(**dataclasses.asdict(ssd))
    jecfg = jt.EngineConfig(num_units=8, fetch_width=64,
                            cache=jt.CacheConfig(enabled=True, num_sets=8))
    want = jvs.search(q, vecs, graph, jvs.SearchConfig(), jssd, ecfg=jecfg)
    tv, tg, tq = convert.search_inputs_from_numpy(
        np.asarray(vecs), np.asarray(graph), np.asarray(q), "cpu")
    got = tvs.search(tq, tv, tg, tvs.SearchConfig(), ssd, ecfg=ecfg)
    same(want["indices"], got["indices"])
    same(want["distances"], got["distances"])
    for k, bound in (("virtual_us", TIME_ULP), ("qps", TIME_ULP),
                     ("avg_iter_us", AVG_ULP)):
        assert convert.ulp_distance(np.float32(want[k]),
                                    np.float32(got[k])) <= bound, k
    _, plain = tvs.case_configs(n, 2.5e6)
    off = tvs.search(tq, tv, tg, tvs.SearchConfig(), ssd, ecfg=plain)
    assert off["virtual_us"] > got["virtual_us"]
    own = tvs.case_study(n=n, batch=4, cache_sets=8, device="cpu")
    assert np.isfinite(own["virtual_us"]) and own["recall"] > 0
