"""The port's engine against the reference: metrics, workloads, the
initial state, whole closed-loop runs, state conversion, and the rules of
the entry points.

Whole runs start both packages from the same configuration and compare
the final ``EngineState`` leaf by leaf, dtype included. Integer and bool
leaves must be equal, and so must every float leaf but four: the
metrics' running sums (``sum_e2e``, ``sum_target``, ``sum_proc``,
``tenant_sum_e2e``) add thousands of fractional latencies per round, and
XLA's reduction order is not PyTorch's, so they are held to
``SUM_ULP``. Everything else is bit-exact — on the integer-timestamp
drive with the kernel flags off and on, and on a stock-shaped drive with
fractional costs.

At the stock width of ``local_1drive`` (``benchmarks/common.py::
swarmio_cfg()`` on ``FUTURE_40M``, closed loop at io_depth 256, 24
rounds) the contract is stated per leaf below: every integer and bool
leaf equal; the time leaves equal to the reference's, whose compiled
``timing._sorted_batch_core`` contracts its three multiply-adds into
fused ones, as the port computes them (pinned per stage call on a shared
state); the three global sums within ``SUM_ULP``; and the per-tenant sum within the
error bound of recursive summation over its own terms, which the
reference's ``segment_sum`` uses, while the port's fixed-order tree sum
stays within a far tighter bound of the exact (float64) sum.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.common import FUTURE_40M, swarmio_cfg
from repro.core import engine as je
from repro.core import frontend as jf
from repro.core import types as jt
from repro.core.device import DevicePipeline as JPipeline
from repro.workloads import MixedReadWrite as JMixed
from repro_torch import convert, cuda_graph
from repro_torch.bench import local_1drive
from repro_torch.core import engine as te
from repro_torch.core import frontend as tf
from repro_torch.core import types as tt
from repro_torch.core.device import DevicePipeline as TPipeline
from repro_torch.workloads import MixedReadWrite as TMixed
from port_threads import one_torch_thread  # noqa: F401

SMALL = dict(num_sqs=8, sq_depth=64, fetch_width=16)
SUM_ULP = 16
SUM_BOUNDS = {k: SUM_ULP for k in (
    "metrics.sum_e2e", "metrics.sum_target", "metrics.sum_proc",
    "metrics.tenant_sum_e2e")}
INT_SSD = dict(l_min_us=50.0, t_max_iops=64e6, n_instances=64)
INT_PLAT = dict(
    cpu_sqe_fetch_us=10.0, cpu_coal_byte_us=0.0, cpu_coal_base_us=1.0,
    dsa_sqe_fetch_us=4.0, dsa_coal_base_us=18.0, dsa_desc_issue_us=1.0,
    dsa_batch_setup_us=1.0, dsa_bytes_per_us=64.0, doorbell_poll_us=1.0,
    host_txn_base_us=1.0, host_bytes_per_us=64.0, txn_base_us=1.0,
    link_bytes_per_us=64.0, per_req_map_us=3.0, lock_per_req_us=1.0,
    lock_per_batch_us=1.0,
)
FLAGS = dict(use_pallas=True, use_pallas_segscan=True, use_pallas_reap=True,
             use_pallas_flash=True)
EPS32 = 2.0 ** -24          # float32 unit roundoff
TIME_ULP = 0                # stock-width time leaves
STOCK_ROUNDS = 24
STOCK_SUMS = ("metrics.sum_e2e", "metrics.sum_target", "metrics.sum_proc")


def jleaves(state):
    return {jax.tree_util.keystr(p).lstrip("."): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(state)[0]}


def both(cfg_kw, ssd_kw, plat_kw):
    return ((jt.EngineConfig(**cfg_kw), jt.SSDConfig(**ssd_kw),
             jt.PlatformModel(**plat_kw)),
            (tt.EngineConfig(**cfg_kw), tt.SSDConfig(**ssd_kw),
             tt.PlatformModel(**plat_kw)))


def run_both(cfg_kw, ssd_kw, plat_kw, wls, rounds):
    (cj, sj, pj), (ct, st, pt) = both(cfg_kw, ssd_kw, plat_kw)
    ref = je.make_runner(cj, sj, wls[0], pj, rounds)(
        je.init_state(cj, sj, wls[0]))
    out = te.simulate(ct, st, wls[1], pt, rounds=rounds, device="cpu")
    return jleaves(ref), convert.engine_state_to_numpy(out)


# -- metrics -------------------------------------------------------------------

def test_latency_bucket_edges_on_a_dense_grid():
    """Every float32 within 300 ULP of each bucket edge, plus a log grid
    over 14 decades: the port's edge table reproduces the reference's
    float32 log10 bucketing exactly."""
    grid = [np.logspace(-8, 7, 20001).astype(np.float32),
            np.array([0.0, 1e-6, 1.0, 99999.0, 1e30], np.float32)]
    for k in range(1, 64):
        mid = np.array(np.float32(10.0 ** (k * 5.0 / 64))).view(np.int32)
        grid.append(np.arange(mid - 300, mid + 300, dtype=np.int32)
                    .view(np.float32))
    x = np.concatenate(grid)
    ref = np.asarray(jax.jit(je.latency_bucket)(jnp.asarray(x)))
    out = te.latency_bucket(torch.from_numpy(x)).numpy()
    assert out.dtype == ref.dtype == np.int32
    np.testing.assert_array_equal(ref, out)


def test_hist_percentile():
    hist = np.random.default_rng(0).integers(0, 50, 64).astype(np.float32)
    for q in (0.5, 0.95, 0.99):
        ref = np.asarray(je.hist_percentile(jnp.asarray(hist), q))
        out = te.hist_percentile(torch.from_numpy(hist), q).numpy()
        assert convert.ulp_distance(ref, out) == 0, q


def test_hist_percentile_of_every_bucket():
    """The value each of the 64 buckets reports is the reference's, eager
    and compiled, bit for bit (the port's table of XLA's float32 powers,
    which ``torch.pow`` on the card does not give for every bucket)."""
    one_hot = np.eye(64, dtype=np.float32)
    jitted = jax.jit(je.hist_percentile, static_argnums=1)
    for i in range(64):
        out = te.hist_percentile(torch.from_numpy(one_hot[i]), 0.5).numpy()
        for ref in (je.hist_percentile(jnp.asarray(one_hot[i]), 0.5),
                    jitted(jnp.asarray(one_hot[i]), 0.5)):
            assert convert.ulp_distance(np.asarray(ref), out) == 0, i


# -- workloads -----------------------------------------------------------------

@pytest.mark.parametrize("theta", [0.0, 0.9])
def test_mixed_workload_stream(theta):
    """Addresses, opcodes and the prefill; ``theta=0.9`` goes through a
    float32 pow, which rounds alike on the CPU for this whole stream."""
    ids = np.arange(0, 20000, 3, dtype=np.int32)
    jw = JMixed(read_frac=0.7, theta=theta, seed=3)
    tw = TMixed(read_frac=0.7, theta=theta, seed=3)
    sj, st = jt.SSDConfig(num_blocks=1 << 14), tt.SSDConfig(num_blocks=1 << 14)
    for salt in (0, 5):
        np.testing.assert_array_equal(
            np.asarray(jw.address(jnp.asarray(ids), sj, salt)),
            tw.address(torch.from_numpy(ids), st, salt).numpy())
        np.testing.assert_array_equal(
            np.asarray(jw.opcode(jnp.asarray(ids), salt)),
            tw.opcode(torch.from_numpy(ids), salt).numpy())
    cj, ct = jt.EngineConfig(**SMALL), tt.EngineConfig(**SMALL)
    jp, tp = jw.prefill(cj, sj, 2), tw.prefill(ct, st, 2, "cpu")
    for a, b in zip(jp, tp):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_init_state_matches():
    (cj, sj, _), (ct, st, _) = both(SMALL, {}, {})
    wl_j, wl_t = jt.WorkloadConfig(io_depth=16), tt.WorkloadConfig(io_depth=16)
    ref = jleaves(je.init_state(cj, sj, wl_j))
    out = convert.engine_state_to_numpy(
        te.init_state(ct, st, wl_t, device="cpu"))
    assert sorted(ref) == sorted(out)
    assert not convert.leaf_differences(ref, out)


# -- whole runs ----------------------------------------------------------------

@pytest.mark.parametrize("flags", [False, True])
def test_integer_timestamp_run_matches(flags):
    """The integer-timestamp drive (every cost a whole microsecond, the
    baseline datapath), a 50/50 read/write loop, kernel flags off and on:
    every leaf but the metric sums bit-exact, and the flags change
    nothing."""
    cfg = dict(SMALL, batched_datapath=False, **(FLAGS if flags else {}))
    wls = (jt.WorkloadConfig(io_depth=16, read_frac=0.5),
           tt.WorkloadConfig(io_depth=16, read_frac=0.5))
    assert jt.integer_timestamps(jt.EngineConfig(**cfg),
                                 jt.SSDConfig(**INT_SSD),
                                 jt.PlatformModel(**INT_PLAT))
    ref, out = run_both(cfg, INT_SSD, INT_PLAT, wls, rounds=5)
    assert not convert.leaf_differences(ref, out, SUM_BOUNDS)
    if flags:
        plain = te.simulate(
            tt.EngineConfig(**SMALL, batched_datapath=False),
            tt.SSDConfig(**INT_SSD), wls[1], tt.PlatformModel(**INT_PLAT),
            rounds=5, device="cpu")
        assert not convert.leaf_differences(
            convert.engine_state_to_numpy(plain), out)


def test_stock_shaped_fractional_run_matches():
    """The stock DSA datapath on the 40-MIOPS drive's shape (fractional
    sched_us = 12.8 us and fractional DSA costs), 70/30 mix with data
    emulation on."""
    ssd = dict(name="future-40m", t_max_iops=40e6, l_min_us=30.0,
               n_instances=512, num_blocks=1 << 14)
    cfg = dict(SMALL, num_units=4, num_bufs=1 << 10)
    wls = (JMixed(io_depth=16, read_frac=0.7),
           TMixed(io_depth=16, read_frac=0.7))
    ref, out = run_both(cfg, ssd, {}, wls, rounds=6)
    assert ref["metrics.completed"] > 0
    assert not convert.leaf_differences(ref, out, SUM_BOUNDS)


def test_convert_round_trip():
    """Reference leaves -> port state -> leaves is the identity (dtypes
    and shapes included), and a converted reference state keeps running
    in the port as it does in the reference."""
    (cj, sj, pj), (ct, st, pt) = both(SMALL, {}, {})
    wl = jt.WorkloadConfig(io_depth=16)
    runner = je.make_runner(cj, sj, wl, pj, 2)
    mid = runner(je.init_state(cj, sj, wl))
    leaves = jleaves(mid)
    state = convert.engine_state_from_numpy(leaves, "cpu")
    back = convert.engine_state_to_numpy(state)
    assert sorted(back) == sorted(leaves)
    for k, v in leaves.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape, k
        np.testing.assert_array_equal(back[k], v)
    ref = jleaves(runner(mid))
    out = convert.engine_state_to_numpy(te.run(
        state, ct, st, tt.WorkloadConfig(io_depth=16), pt, 2))
    assert not convert.leaf_differences(ref, out, SUM_BOUNDS)


# -- entry points ----------------------------------------------------------------

def test_entry_points_need_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, ssd = tt.EngineConfig(**SMALL), tt.SSDConfig()
    wl = tt.WorkloadConfig(io_depth=4)
    for call in (lambda: te.simulate(cfg, ssd, wl, rounds=1),
                 lambda: te.init_state(cfg, ssd, wl),
                 lambda: te.make_runner(cfg, ssd, wl, tt.PlatformModel(), 1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


@pytest.mark.parametrize("kw", [
    dict(timing_scope="local"), dict(sanitize=True),
])
def test_unported_branches_raise_when_built(kw):
    """The two branches the port once refused when a runner was built (the
    local timing scope and the sanitizer) are ported: each builds and runs
    one round on the CPU, and its final state agrees with the reference's
    leaf by leaf (``tests/test_torch_variants.py`` holds them further)."""
    wls = (jt.WorkloadConfig(io_depth=4), tt.WorkloadConfig(io_depth=4))
    ref, out = run_both(dict(SMALL, **kw), {}, {}, wls, 1)
    assert out["metrics.fetched"] > 0
    assert not convert.leaf_differences(ref, out, SUM_BOUNDS)


def test_array_simulation_is_not_ported_yet():
    """The array is ported now (``tests/test_torch_array.py`` holds it
    against the reference): ``simulate(num_devices=2)`` returns a state
    with a leading (2,) axis on every leaf, and an array of no drives
    raises."""
    args = (tt.EngineConfig(**SMALL), tt.SSDConfig(),
            tt.WorkloadConfig(io_depth=4))
    state = te.simulate(*args, rounds=1, num_devices=2, device="cpu")
    assert all(v.shape[0] == 2 for v in
               convert.engine_state_to_numpy(state).values())
    with pytest.raises(ValueError, match="num_devices"):
        te.simulate(*args, rounds=1, num_devices=0, device="cpu")


def test_metrics_of_a_port_run():
    state = te.simulate(tt.EngineConfig(**SMALL), tt.SSDConfig(),
                        tt.WorkloadConfig(io_depth=16), rounds=4,
                        device="cpu")
    m = state.metrics
    assert float(m.completed) > 0
    assert float(m.p50_us()) <= float(m.p95_us()) <= float(m.p99_us())
    assert float(te.aggregate_iops(state)) == float(m.iops()) > 0
    assert dataclasses.is_dataclass(state)


# -- the compiled runner's contract: unalias and donate ----------------------

def _small_state(wl):
    (_, _, _), (ct, st, pt) = both(SMALL, {}, {})
    return (ct, st, pt), te.init_state(ct, st, wl, device="cpu")


def test_unalias_leaves_share_no_storage():
    """Every leaf of ``unalias``'s copy has storage of its own (no two
    leaves, and no leaf and the original, share a data pointer) and the
    original's value, dtype and shape."""
    _, state = _small_state(tt.WorkloadConfig(io_depth=16))
    copy = te.unalias(state)
    old = convert.engine_state_to_numpy(state)
    new = convert.engine_state_to_numpy(copy)
    assert sorted(old) == sorted(new) and not convert.leaf_differences(old,
                                                                       new)
    ptrs = [t.untyped_storage().data_ptr()
            for st in (state, copy) for t in _leaves(st)]
    assert len(set(ptrs)) == len(ptrs)


def _leaves(state):
    out = []
    cuda_graph.map_leaves(out.append, state)
    return out


def test_donated_runner_equals_undonated_and_spares_its_input():
    (ct, st, pt), state = _small_state(MIXED_T)
    before = convert.engine_state_to_numpy(state)
    kept = te.make_runner(ct, st, MIXED_T, pt, 4, device="cpu")(state)
    assert not convert.leaf_differences(
        before, convert.engine_state_to_numpy(state))
    donated = te.make_runner(ct, st, MIXED_T, pt, 4, donate=True,
                             device="cpu")(te.unalias(state))
    assert not convert.leaf_differences(convert.engine_state_to_numpy(kept),
                                        convert.engine_state_to_numpy(donated))


def test_chained_donated_calls_equal_one_run_of_twice_the_rounds():
    (ct, st, pt), state = _small_state(MIXED_T)
    runner = te.make_runner(ct, st, MIXED_T, pt, 3, donate=True,
                            device="cpu")
    chained = runner(runner(te.unalias(state)))
    whole = te.run(state, ct, st, MIXED_T, pt, 6)
    assert not convert.leaf_differences(convert.engine_state_to_numpy(whole),
                                        convert.engine_state_to_numpy(chained))


MIXED_J = JMixed(io_depth=16, read_frac=0.7)
MIXED_T = TMixed(io_depth=16, read_frac=0.7)


def test_donated_runner_matches_reference_donated_runner():
    """The reference's ``make_runner(donate=True)`` fed through its
    ``unalias``, against the port's, two chained calls each."""
    (cj, sj, pj), (ct, st, pt) = both(SMALL, {}, {})
    jr = je.make_runner(cj, sj, MIXED_J, pj, 3, donate=True)
    ref = jr(jr(je.unalias(je.init_state(cj, sj, MIXED_J))))
    tr = te.make_runner(ct, st, MIXED_T, pt, 3, donate=True, device="cpu")
    out = tr(tr(te.unalias(te.init_state(ct, st, MIXED_T, device="cpu"))))
    assert float(out.metrics.completed) > 0
    assert not convert.leaf_differences(
        jleaves(ref), convert.engine_state_to_numpy(out), SUM_BOUNDS)


# -- the first milestone at stock width ---------------------------------------

STOCK_WORKLOADS = {
    "read": (jt.WorkloadConfig(io_depth=256), tt.WorkloadConfig(io_depth=256)),
    "mixed_70_30": (JMixed(read_frac=0.7, io_depth=256),
                    TMixed(read_frac=0.7, io_depth=256)),
}
_STOCK_RUNS: dict = {}


def _stock_run(name):
    """The stock ``local_1drive`` for 24 rounds in both packages (run once
    a workload per test process), with the terms the port's per-tenant
    sum added each round: (reference leaves, port leaves, terms (M,)
    float64, their tenants (M,))."""
    if name not in _STOCK_RUNS:
        wj, wt = STOCK_WORKLOADS[name]
        cj = swarmio_cfg()
        ref = je.make_runner(cj, FUTURE_40M, wj, jt.PlatformModel(),
                             STOCK_ROUNDS)(je.init_state(cj, FUTURE_40M, wj))
        ct, st = local_1drive()
        terms = []
        group_sum = te._group_sum

        def recording(vals, seg, k):
            terms.append((vals.double(), seg))
            return group_sum(vals, seg, k)

        te._group_sum = recording
        try:
            out = te.simulate(ct, st, wt, tt.PlatformModel(),
                              rounds=STOCK_ROUNDS, device="cpu")
        finally:
            te._group_sum = group_sum
        _STOCK_RUNS[name] = (
            jleaves(ref), convert.engine_state_to_numpy(out),
            torch.cat([v for v, _ in terms]).numpy(),
            torch.cat([s for _, s in terms]).numpy())
    return _STOCK_RUNS[name]


@pytest.mark.parametrize("name", sorted(STOCK_WORKLOADS))
def test_stock_local_1drive_matches_reference(name):
    """The first milestone: ``simulate`` on the stock ``local_1drive``
    against the reference's final state, leaf by leaf (see the module
    docstring for the bounds)."""
    ref, out, _, _ = _stock_run(name)
    assert ref["metrics.completed"] > 10000
    floats = [k for k in ref if ref[k].dtype.kind == "f"]
    bounds = {k: TIME_ULP for k in floats}
    bounds.update({k: SUM_ULP for k in STOCK_SUMS})
    bounds.pop("metrics.tenant_sum_e2e")  # test_stock_tenant_sum_e2e_bound
    ref = {k: v for k, v in ref.items() if k != "metrics.tenant_sum_e2e"}
    out = {k: v for k, v in out.items() if k != "metrics.tenant_sum_e2e"}
    assert not convert.leaf_differences(ref, out, bounds)


@pytest.mark.parametrize("name", sorted(STOCK_WORKLOADS))
def test_stock_tenant_sum_e2e_bound(name):
    """``metrics.tenant_sum_e2e`` at stock width. The reference's
    ``segment_sum`` adds a tenant's terms one by one in row order, whose
    error is at most ``(n - 1) * eps * sum|e2e|`` over the n nonzero terms;
    both packages must lie within that of the exact float64 sum. The
    port's fixed-order tree sum (each round a masked row sum, then one
    addition a round) must lie within ``(rounds + ceil(log2 rows)) * eps *
    sum|e2e|``, far tighter, which shows the port to be the accurate
    side."""
    ref, out, terms, tenants = _stock_run(name)
    rows = terms.shape[0] // STOCK_ROUNDS
    for t in range(out["metrics.tenant_sum_e2e"].shape[0]):
        e = terms[tenants == t]
        exact, mag = float(e.sum()), float(np.abs(e).sum())
        n = int(np.count_nonzero(e))
        recursive = (n - 1) * EPS32 * mag
        tree = (STOCK_ROUNDS + math.ceil(math.log2(rows))) * EPS32 * mag
        got_ref = float(ref["metrics.tenant_sum_e2e"][t])
        got_port = float(out["metrics.tenant_sum_e2e"][t])
        assert n == int(out["metrics.tenant_completed"][t]) > 0
        assert abs(got_ref - exact) <= recursive, (got_ref, exact, recursive)
        assert abs(got_port - exact) <= recursive
        assert abs(got_port - exact) <= tree, (got_port, exact, tree)


def _round_one_inputs():
    """The reference's stock ``local_1drive`` state after one compiled
    round, fetched for round two by both packages: the shared state on
    which the eager reference and the compiled one first differ."""
    cj, wj = swarmio_cfg(), jt.WorkloadConfig(io_depth=256)
    pj = jt.PlatformModel()
    s = jax.jit(lambda s: je.engine_round(s, cj, FUTURE_40M, wj, pj))(
        je.init_state(cj, FUTURE_40M, wj))
    ct, st = local_1drive()
    pt = tt.PlatformModel()
    ts = convert.engine_state_from_numpy(jleaves(s), "cpu")
    jfetch = jax.jit(lambda s: jf.fetch(s.rings, s.clock, s.device.disp_time,
                                        cj, pj))(s)
    tfetch = tf.fetch(ts.rings, ts.clock, ts.device.disp_time, ct, pt)
    return (cj, pj, s, jfetch), (ct, st, pt, ts, tfetch)


def test_stock_timing_matches_compiled_contraction():
    """Per stage call on a shared state: the reference's compiled
    pipeline and the port's agree bit for bit on every stage's output,
    the timing model's completions (``target``) and everything downstream
    of them (``done``, ``reaped``) included, and on the new device state
    (the timing model's busy cursors among it). The compiled
    ``timing._sorted_batch_core`` fuses ``s_arr - rank * sched``,
    ``b + rank * sched`` and ``last_b + seg_counts * sched`` into fused
    multiply-adds, and so does the port (rounding each product apart, as
    the reference run eagerly does, was 1 ULP off on this state)."""
    (cj, pj, s, jfetch), (ct, st, pt, ts, tfetch) = _round_one_inputs()
    np.testing.assert_array_equal(np.asarray(jfetch[3]), tfetch[3].numpy())
    jpipe, tpipe = JPipeline(cj, FUTURE_40M, pj), TPipeline(ct, st, pt)
    jdev = dataclasses.replace(s.device, disp_time=jfetch[1])
    tdev = dataclasses.replace(ts.device, disp_time=tfetch[1])
    junit, tunit = jf.fetch_row_units(cj), tf.fetch_row_units(ct, "cpu")
    jstate, _, jres = jax.jit(lambda d, b, f, q: jpipe.process(
        d, b, f, junit, q, ring_layout=True))(jdev, jfetch[2], jfetch[3],
                                              s.cq)
    tstate, _, tres = tpipe.process(tdev, tfetch[2], tfetch[3], tunit, ts.cq,
                                    ring_layout=True)
    for f in ("arrival", "ready", "flash_done", "target", "done", "reaped"):
        np.testing.assert_array_equal(np.asarray(getattr(jres, f)),
                                      getattr(tres, f).numpy(), f)
    assert not convert.leaf_differences(
        jleaves(jstate), convert.engine_state_to_numpy(tstate))
