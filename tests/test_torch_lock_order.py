"""The ready-time lock (``EngineConfig.lock_order="ready_time"``) and the
per-tenant readouts of ``Metrics``, in the port against the reference.

The ordering helpers (``epoch.unit_ready_order``, ``admission_row_order``
in its ring and direct forms) and ``device.acquire_lock`` are held to
``jax.jit`` of the reference's on epochs made from a seed, one drive and
a stacked array of drives; a ``DevicePipeline.process`` pass and small
closed loops under both lock orders hold every leaf. The lock only moves
whole unit blocks, so everything is bit-exact. The readouts
(``tenant_share``, ``tenant_p50_us``, ``tenant_p99_us``,
``slo_attainment``, ``tenant_avg_e2e_us``) of a two-tenant run are the
reference's, the average within the error bound of the reference's
recursive per-tenant sum.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import workloads as jw
from repro.core import device as jdev
from repro.core import engine as je
from repro.core import epoch as jep
from repro.core import types as jt
from repro_torch import convert, cuda_graph
from repro_torch import workloads as tw
from repro_torch.core import device as tdev
from repro_torch.core import engine as te
from repro_torch.core import epoch as tep
from repro_torch.core import types as tt
from test_torch_fabric import assert_states_agree, jleaves, tconfig
from test_torch_pipeline import agree, batches, device_states, make_batch, pair
from port_threads import one_torch_thread  # noqa: F401

PLAT = dict(lock_per_req_us=1.0, lock_per_batch_us=3.0)


def cfgs(order, mode="aggregated", **kw):
    base = dict(num_sqs=8, sq_depth=64, num_units=4, fetch_width=32,
                mode=mode, lock_order=order)
    base.update(kw)
    return jt.EngineConfig(**base), tt.EngineConfig(**base)


def epochs(seed, u, w, layout, lead=(), ties=False):
    """A random epoch of u unit blocks of w rows, fractional ready times
    (or whole ones with ties)."""
    rng = np.random.default_rng(seed)
    shape = tuple(lead) + (u * w,)
    ready = rng.uniform(0, 64, shape)
    ready = np.floor(ready / 8) if ties else ready
    ready = ready.astype(np.float32)
    valid = rng.random(shape) > 0.25
    unit = np.repeat(np.arange(u, dtype=np.int32), w)
    tenant = np.zeros(shape, np.int32)

    def build(mod, mk):
        return mod.Epoch(arrival=mk(ready), ready=mk(ready),
                         tenant=mk(tenant), valid=mk(valid), unit=mk(unit),
                         layout=layout)

    return (build(jep, jnp.asarray),
            build(tep, lambda a: torch.from_numpy(a.copy())))


@pytest.mark.parametrize("ties", [False, True])
def test_unit_ready_order(ties):
    """Stable, so tied units keep their index order; per drive on a
    stacked (M, U) input."""
    je_, te_ = epochs(1, 12, 3, "direct", ties=ties)
    ref = jax.jit(lambda e: jep.unit_ready_order(e.unit_ready(12)))(je_)
    agree(ref, tep.unit_ready_order(te_.unit_ready(12)))
    _, stacked = epochs(1, 12, 3, "direct", lead=(3,), ties=ties)
    out = tep.unit_ready_order(stacked.unit_ready(12))
    for d in range(3):
        one = dataclasses.replace(
            stacked, ready=stacked.ready[d], valid=stacked.valid[d])
        assert torch.equal(out[d], tep.unit_ready_order(one.unit_ready(12)))


@pytest.mark.parametrize("layout", ["ring", "direct"])
@pytest.mark.parametrize("seed", range(4))
def test_admission_row_order(layout, seed):
    """Whole unit blocks in acquisition order, rows in program order
    inside a block: the reference's permutation, ring and direct forms
    alike."""
    u, w = 2 + seed * 2, 1 + seed
    je_, te_ = epochs(seed, u, w, layout, ties=True)

    def jorder(e):
        return jep.admission_row_order(
            jep.unit_ready_order(e.unit_ready(u)), e, u)

    ref = jax.jit(jorder)(je_)
    out = tep.admission_row_order(
        tep.unit_ready_order(te_.unit_ready(u)), te_, u)
    agree(ref, out)
    other = dataclasses.replace(
        te_, layout="direct" if layout == "ring" else "ring")
    assert torch.equal(out, tep.admission_row_order(
        tep.unit_ready_order(other.unit_ready(u)), other, u))


@pytest.mark.parametrize("mode", ["aggregated", "per_request"])
@pytest.mark.parametrize("layout", ["ring", "direct"])
def test_ready_time_lock(mode, layout):
    """``acquire_lock`` under the ready-time order: the lock's end, every
    grant (unsorted back to unit order) and the acquisition order; a
    stacked call of 3 drives equals three calls."""
    cj, ct = cfgs("ready_time", mode)
    pj, pt = jt.PlatformModel(**PLAT), tt.PlatformModel(**PLAT)
    je_, te_ = epochs(5, 8, 4, layout)
    lt = np.float32(9.5)
    ref = jax.jit(lambda t, e: jdev.acquire_lock(t, e, 8, cj, pj))(
        jnp.asarray(lt), je_)
    out = tdev.acquire_lock(torch.tensor(lt), te_, 8, ct, pt)
    agree(ref, out)
    _, stacked = epochs(6, 8, 4, layout, lead=(3,))
    many = tdev.acquire_lock(torch.full((3,), lt), stacked, 8, ct, pt)
    for d in range(3):
        one = dataclasses.replace(stacked, ready=stacked.ready[d],
                                  arrival=stacked.arrival[d],
                                  valid=stacked.valid[d])
        single = tdev.acquire_lock(torch.tensor(lt), one, 8, ct, pt)
        for a, b in zip(many, single):
            assert torch.equal(a[d], b)


@pytest.mark.parametrize("seed", range(3))
def test_monotone_ready_gives_program_order(seed):
    """With unit ready times monotone in index order (every row valid)
    the stable sort is the identity: both orders give the same grants
    bit for bit."""
    _, te_ = epochs(seed, 6, 3, "direct")
    ready_u = torch.sort(te_.unit_ready(6)).values
    r = ready_u[te_.unit.long()]
    te_ = dataclasses.replace(te_, ready=r, arrival=r,
                              valid=torch.ones_like(te_.valid))
    pt = tt.PlatformModel(**PLAT)
    lt = torch.tensor(2.0)
    prog = tdev.acquire_lock(lt, te_, 6, cfgs("program")[1], pt)
    ready = tdev.acquire_lock(lt, te_, 6, cfgs("ready_time")[1], pt)
    assert torch.equal(prog[0], ready[0]) and torch.equal(prog[1], ready[1])
    assert torch.equal(ready[2], torch.arange(6, dtype=torch.int32))


@pytest.mark.parametrize("late_unit", [0, 2])
def test_process_under_the_ready_time_lock(late_unit):
    """One pipeline pass in which one unit's batch lands long after the
    others: the ready-time lock dispatches the timing model in
    acquisition order. Every result and state leaf against the
    reference's, and the first completion well before the late batch."""
    rng = np.random.default_rng(8)
    q, f = 8, 16
    cj, ct = cfgs("ready_time", num_sqs=q, fetch_width=f)
    sj = jt.SSDConfig(t_max_iops=1e6, l_min_us=20.0, n_instances=32,
                      num_blocks=1 << 10)
    st = tt.SSDConfig(**sj.__dict__)
    dj, dt = device_states(rng, cj, sj)
    fields = make_batch(rng, q, f, num_blocks=sj.num_blocks, integer=False)
    jb, tb = batches(fields)
    unit = np.repeat(np.arange(4), q * f // 4).astype(np.int32)
    fetch = np.where(unit == late_unit, 500.0,
                     60.0 + unit + rng.uniform(0, 1, q * f))
    jf_, tf_ = pair(fetch.astype(np.float32))
    ju, tu = pair(unit)
    pj, pt = jt.PlatformModel(**PLAT), tt.PlatformModel(**PLAT)
    ref = jax.jit(lambda d, b, fd, u: jdev.DevicePipeline(cj, sj, pj).process(
        d, b, fd, u, ring_layout=True))(dj, jb, jf_, ju)
    out = tdev.DevicePipeline(ct, st, pt).process(dt, tb, tf_, tu,
                                                  ring_layout=True)
    agree(ref, out)
    v = tb.valid
    assert float(out[2].target[v].min()) < 500.0


# -- closed loops and the tenant readouts -------------------------------------

SMALL = dict(num_sqs=8, sq_depth=64, fetch_width=16, num_units=8)
WIRE = dict(remote=True, tx_bytes_per_us=400.0, rx_bytes_per_us=16000.0)


_RUNS: dict = {}


def tenant_run(order, weights):
    """A misaligned two-tenant loop (a read tenant and a write tenant on
    interleaved SQs, one unit per SQ) behind a TX-bound wire, 24 rounds,
    in both packages (once a test process)."""
    key = (order, weights)
    if key not in _RUNS:
        jcfg = jt.EngineConfig(lock_order=order, fabric=jt.FabricConfig(
            qos_weights=weights, **WIRE), **SMALL)
        ssd = jt.SSDConfig(t_max_iops=2.47e6, l_min_us=50.0, n_instances=64,
                           num_blocks=1 << 14)
        kw = dict(io_depth=16, tenant_read_frac=(1.0, 0.0), interleave=True)
        ref = je.simulate(jcfg, ssd, jw.MultiTenant(**kw), rounds=24)
        out = te.simulate(tconfig(jcfg), tt.SSDConfig(**ssd.__dict__),
                          tw.MultiTenant(**kw), rounds=24, device="cpu")
        _RUNS[key] = ref, out
    return _RUNS[key]


@pytest.mark.parametrize("weights", [(), (2.0, 1.0)])
def test_tenant_loop(weights):
    """Under the ready-time lock, FIFO and WFQ: every leaf but the
    metrics' float sums equal (``SUM_ULP``, and the per-tenant sum within
    its recursion's bound, as in ``tests/test_torch_fabric.py``). The
    program-order lock under this mix at fig 29's full size is
    ``tests/test_torch_figures_lock.py``."""
    ref, out = tenant_run("ready_time", weights)
    assert_states_agree(jleaves(ref), convert.engine_state_to_numpy(out))


def test_tenant_readouts():
    """The readouts of the WFQ ready-time loop: shares, p50 and p99 per
    tenant and SLO attainment at several SLOs equal to the reference's;
    the average E2E within the per-tenant sum's bound."""
    ref, out = tenant_run("ready_time", (2.0, 1.0))
    check_readouts(ref.metrics, out.metrics)


def test_pooled_tenant_readouts():
    """An array's readouts pool its drives: the port's metrics of the two
    ready-time loops (FIFO and WFQ) stacked as two drives, and the
    reference's readouts of the same stacked leaves, agree as above."""
    port = [tenant_run("ready_time", w)[1].metrics for w in ((), (2.0, 1.0))]
    stacked = cuda_graph.map_leaves(lambda *x: torch.stack(x), *port)
    ref = je.Metrics(**{
        f.name: jnp.asarray(getattr(stacked, f.name).numpy())
        for f in dataclasses.fields(je.Metrics)})
    check_readouts(ref, stacked)


def check_readouts(rm, tm):
    for name in ("tenant_share", "tenant_p50_us", "tenant_p99_us"):
        np.testing.assert_array_equal(np.asarray(getattr(rm, name)()),
                                      getattr(tm, name)().numpy(), name)
    for slo in (1.0, 100.0, 500.0, 2090.8, 1e5):
        np.testing.assert_array_equal(np.asarray(rm.slo_attainment(slo)),
                                      tm.slo_attainment(slo).numpy())
    n = tm.tenant_completed.reshape(-1, 2).sum(0).double().numpy()
    want = np.asarray(rm.tenant_avg_e2e_us(), np.float64)
    got = tm.tenant_avg_e2e_us().double().numpy()
    assert (np.abs(got - want) <= (n * 2.0 ** -24 + 2.0 ** -23) * want).all()
    assert float(tm.tenant_share().sum()) == pytest.approx(1.0)
