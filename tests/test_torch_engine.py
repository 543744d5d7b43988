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
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as je
from repro.core import types as jt
from repro.workloads import MixedReadWrite as JMixed
from repro_torch import convert
from repro_torch.core import engine as te
from repro_torch.core import types as tt
from repro_torch.workloads import MixedReadWrite as TMixed

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
        assert convert.ulp_distance(ref, out) <= 2, q  # float32 pow


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
    dict(mode="per_request"), dict(frontend="centralized"),
    dict(timing_scope="local"), dict(lock_order="ready_time"),
    dict(fabric=tt.FabricConfig(remote=True)),
    dict(cache=tt.CacheConfig(enabled=True)),
    dict(qp=tt.QPConfig(cq_coalesce_n=4)), dict(sanitize=True),
])
def test_unported_branches_raise_when_built(kw):
    cfg = tt.EngineConfig(**SMALL).replace(**kw)
    with pytest.raises(NotImplementedError, match="ROADMAP A"):
        te.make_runner(cfg, tt.SSDConfig(), tt.WorkloadConfig(io_depth=4),
                       tt.PlatformModel(), 1, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A"):
        te.init_state(cfg, tt.SSDConfig(), tt.WorkloadConfig(io_depth=4),
                      device="cpu")


def test_array_simulation_is_not_ported_yet():
    with pytest.raises(NotImplementedError, match="ROADMAP A11"):
        te.simulate(tt.EngineConfig(**SMALL), tt.SSDConfig(),
                    tt.WorkloadConfig(io_depth=4), rounds=1, num_devices=2,
                    device="cpu")


def test_metrics_of_a_port_run():
    state = te.simulate(tt.EngineConfig(**SMALL), tt.SSDConfig(),
                        tt.WorkloadConfig(io_depth=16), rounds=4,
                        device="cpu")
    m = state.metrics
    assert float(m.completed) > 0
    assert float(m.p50_us()) <= float(m.p95_us()) <= float(m.p99_us())
    assert float(te.aggregate_iops(state)) == float(m.iops()) > 0
    assert dataclasses.is_dataclass(state)
