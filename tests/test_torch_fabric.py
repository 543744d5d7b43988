"""The port's fabric layer (``repro_torch/core/fabric.py``) against the
reference's, one hop call at a time, then inside ``DevicePipeline.process``
and whole closed-loop runs of remote drives.

Each hop call takes the same numpy inputs, made from a seed, and holds
the port's cursors and landing times to ``jax.jit`` of the reference's.
They are bit-exact on one tenant class and on the ``seg_scan`` route,
whose sum adds the costs in ``jnp.cumsum``'s order. With two or more
classes the weighted share ``cost * (act_w / w_k)`` feeds the scan's
adds, and the compiled reference fuses that product into some of them,
as XLA's fusion of the combine tree decides for the shape at hand; the
port rounds the product once. Those calls are held to ``GPS_ULP``. The
closed-loop helpers below (``closed_loop``, ``assert_states_agree``) hold
every leaf of two final states equal but the metrics' float sums, which
XLA adds in another order; ``tests/test_torch_fabric_loops.py`` and the
figure tests run them.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import common as C
from repro import workloads as jw
from repro.core import device as jdev
from repro.core import fabric as jf
from repro.core import qp as jqp
from repro.core import types as jt
from repro_torch import convert
from repro_torch import workloads as tw
from repro_torch.core import device as tdev
from repro_torch.core import engine as te
from repro_torch.core import fabric as tf
from repro_torch.core import qp as tqp
from repro_torch.core import types as tt
from test_torch_pipeline import agree, batches, device_states, make_batch, pair
from port_threads import one_torch_thread  # noqa: F401

GPS_ULP = 2          # the reference's fused cost * share product (module doc)
SUM_ULP = 16
SUM_BOUNDS = {k: SUM_ULP for k in (
    "metrics.sum_e2e", "metrics.sum_target", "metrics.sum_proc")}
WIRE = dict(rtt_us=3.0, wire_txn_us=0.7, mtu_batch=4, mtu_timeout_us=1.3,
            switch_bytes_per_us=150.0, switch_fanin=3)
N = 2048


def fabrics(weights=(), **kw):
    kw = dict(WIRE, **kw)
    return (jt.FabricConfig(remote=True, qos_weights=weights, **kw),
            tt.FabricConfig(remote=True, qos_weights=weights, **kw))


def frames(seed, n=N, t=1, lead=()):
    """Ready times, wire bytes, validity, tenants and cursors."""
    rng = np.random.default_rng(seed)
    shape = tuple(lead) + (n,)
    return dict(
        ready=rng.uniform(0, 50, shape).astype(np.float32),
        nbytes=rng.choice([80.0, 528.0, 4160.0, 16.0], shape).astype(
            np.float32),
        valid=rng.uniform(size=shape) < 0.85,
        tenant=rng.integers(0, t, shape).astype(np.int32),
        busy=rng.uniform(0, 30, tuple(lead) + (t,)).astype(np.float32),
    )


def hop(kind, fr, weights=(), fused=False, pallas=False, **kw):
    """The reference's hop (jitted, its frame layout as two stable sorts or
    one fused sort) and the port's, whose one layout is both, on the same
    frames."""
    jfab, tfab = fabrics(weights, **kw)
    multi = jfab.num_tenants > 1
    args = [fr[k] for k in ("busy", "ready", "nbytes", "valid")]
    if kind == "link":
        def jfn(b, r, nb, v, te_):
            return jf.fabric_hop(b, r, nb, v, jfab, 37.3, te_,
                                 fused_sort=fused, use_pallas=pallas)

        def tfn(*a):
            return tf.fabric_hop(*a[:4], tfab, 37.3, a[4], use_pallas=pallas)
    else:
        def jfn(b, r, nb, v, te_):
            return jf.switch_hop(b, r, nb, v, jfab, te_, fused_sort=fused,
                                 use_pallas=pallas)

        def tfn(*a):
            return tf.switch_hop(*a[:4], tfab, a[4], use_pallas=pallas)
    ten = fr["tenant"]
    ref = jax.jit(jfn)(*args, ten if multi else None)
    out = tfn(*[torch.from_numpy(a.copy()) for a in args],
              torch.from_numpy(ten.copy()) if multi else None)
    return ref, out


@pytest.mark.parametrize("pallas", [False, True])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("kind", ["link", "switch"])
def test_one_tenant_hop_is_exact(kind, fused, pallas):
    """One class: both routes, both frame layouts, bit for bit."""
    ref, out = hop(kind, frames(1), fused=fused, pallas=pallas)
    agree(ref, out)


@pytest.mark.parametrize("weights", [(2.0, 1.0), (3.0, 1.0), (7.0, 1.0)])
@pytest.mark.parametrize("kind", ["link", "switch"])
def test_weighted_tenants(kind, weights):
    """Two classes at weights (2,1), (3,1) and (7,1): exact on the
    seg_scan route (against the reference's fused frame layout), within
    ``GPS_ULP`` on the combine tree (against its two-sort layout), and
    the per-class cursors only ever advance."""
    fr = frames(2, n=1024, t=2)
    ref, out = hop(kind, fr, weights, fused=True, pallas=True)
    agree(ref, out)
    ref, out = hop(kind, fr, weights)
    agree(ref, out, **{"0": GPS_ULP, "1": GPS_ULP})
    assert bool((out[0] >= torch.from_numpy(fr["busy"])).all())


def test_mtu_stragglers_pay_a_wire_transaction():
    """Frames that become ready after their MTU batch's flush timer
    (``mtu_timeout_us`` far below the frames' spread) ship on their own
    and pay ``wire_txn_us`` again: exact, and later than on a wire that
    waits for the batch to fill."""
    fr = frames(3)
    fr["ready"] = np.sort(fr["ready"]) * 40.0
    ref, out = hop("link", fr, mtu_timeout_us=0.5, mtu_batch=8)
    agree(ref, out)
    _, tfab = fabrics(mtu_timeout_us=1e6, mtu_batch=8)
    patient = tf.fabric_hop(*[torch.from_numpy(fr[k].copy()) for k in (
        "busy", "ready", "nbytes", "valid")], tfab, 37.3)
    v = torch.from_numpy(fr["valid"])
    assert not torch.equal(out[1][v], patient[1][v])


@pytest.mark.parametrize("kind", ["link", "switch"])
def test_infinite_wire_is_an_exact_no_op(kind):
    """An ``inf`` wire with no RTT, transaction cost or switch, from idle
    cursors: every frame lands when it was ready and no cursor moves, in
    both packages."""
    fr = frames(4, t=2)
    fr["busy"] = np.zeros_like(fr["busy"])
    free = dict(rtt_us=0.0, wire_txn_us=0.0, mtu_timeout_us=0.0,
                switch_bytes_per_us=float("inf"))
    jfab, tfab = fabrics((2.0, 1.0), **free)
    t = torch.from_numpy
    if kind == "link":
        out = tf.fabric_hop(t(fr["busy"]), t(fr["ready"]), t(fr["nbytes"]),
                            t(fr["valid"]), tfab, float("inf"),
                            t(fr["tenant"]))
        ref = jax.jit(lambda *a: jf.fabric_hop(*a[:4], jfab, float("inf"),
                                               a[4]))(
            fr["busy"], fr["ready"], fr["nbytes"], fr["valid"], fr["tenant"])
    else:
        out = tf.switch_hop(t(fr["busy"]), t(fr["ready"]), t(fr["nbytes"]),
                            t(fr["valid"]), tfab, t(fr["tenant"]))
        ref = jax.jit(lambda *a: jf.switch_hop(*a[:4], jfab, a[4]))(
            fr["busy"], fr["ready"], fr["nbytes"], fr["valid"], fr["tenant"])
    agree(ref, out)
    np.testing.assert_array_equal(out[0].numpy(), fr["busy"])
    np.testing.assert_array_equal(out[1].numpy(), fr["ready"])


@pytest.mark.parametrize("weights", [(), (3.0, 1.0)])
def test_stacked_drives_equal_single_calls(weights):
    """A stacked (M, ...) call prices each drive as a call on its own
    rows does."""
    m, t = 3, max(len(weights), 1)
    fr = frames(5, n=512, t=t, lead=(m,))
    _, tfab = fabrics(weights)
    ten = torch.from_numpy(fr["tenant"]) if t > 1 else None
    for kind in ("link", "switch"):
        def call(sl):
            a = [torch.from_numpy(np.ascontiguousarray(fr[k][sl])) for k in
                 ("busy", "ready", "nbytes", "valid")]
            tn = None if ten is None else ten[sl]
            if kind == "link":
                return tf.fabric_hop(*a, tfab, 37.3, tn)
            return tf.switch_hop(*a, tfab, tn)

        whole = call(slice(None))
        for d in range(m):
            one = call(d)
            assert torch.equal(whole[0][d], one[0])
            assert torch.equal(whole[1][d], one[1])


def test_wire_bytes():
    rng = np.random.default_rng(6)
    fields = make_batch(rng, 4, 16)
    fields["nblocks"] = rng.integers(1, 5, 64).astype(np.int32)
    jb, tb = batches(fields)
    jfab, tfab = fabrics()
    ssd = dict(num_blocks=1 << 14)
    jssd, tssd = jt.SSDConfig(**ssd), tt.SSDConfig(**ssd)
    agree(jax.jit(lambda b: (jf.tx_wire_bytes(b, 64, jssd),
                             jf.rx_wire_bytes(b, jfab, jssd)))(jb),
          (tf.tx_wire_bytes(tb, 64, tssd), tf.rx_wire_bytes(tb, tfab, tssd)))


@pytest.mark.parametrize("weights", [(), (2.0, 1.0)])
def test_process_on_a_remote_switched_drive(weights):
    """One ``DevicePipeline.process`` pass of a remote drive behind a
    finite switch, TX and RX hops on: every result and state leaf, the
    four fabric cursors among them, against the reference's (two tenant
    classes on the seg_scan route, where the hops are exact)."""
    rng = np.random.default_rng(7)
    q, f = 8, 16
    jfab, tfab = fabrics(weights, tx_bytes_per_us=900.0,
                         rx_bytes_per_us=700.0, switch_bytes_per_us=2400.0)
    cfg_kw = dict(num_sqs=q, sq_depth=64, fetch_width=f, num_units=4,
                  use_pallas_segscan=True)
    cj = jt.EngineConfig(fabric=jfab, **cfg_kw)
    ct = tt.EngineConfig(fabric=tfab, **cfg_kw)
    sj, st = C.FUTURE_40M, tt.SSDConfig(**C.FUTURE_40M.__dict__)
    dj, dt = device_states(rng, cj, sj)
    t = cj.fabric.num_tenants
    if t > 1:
        z = np.zeros(t, np.float32)
        dj = dataclasses.replace(dj, fabric=jf.FabricState(
            *(jnp.asarray(z + k) for k in range(4))))
        dt = dataclasses.replace(dt, fabric=tf.FabricState(
            *(torch.from_numpy(z + k) for k in range(4))))
    fields = make_batch(rng, q, f, integer=False)
    fields["tenant"] = rng.integers(0, t, q * f).astype(np.int32)
    jb, tb = batches(fields)
    jfd, tfd = pair(rng.uniform(60, 120, q * f).astype(np.float32))
    ju, tu = pair(np.repeat(np.arange(4), q * f // 4).astype(np.int32))
    pj, pt = jt.PlatformModel(), tt.PlatformModel()
    ref = jax.jit(lambda d, b, fd, u, c: jdev.DevicePipeline(
        cj, sj, pj).process(d, b, fd, u, c, ring_layout=True))(
        dj, jb, jfd, ju, jqp.CQRings.empty(q, 64))
    out = tdev.DevicePipeline(ct, st, pt).process(
        dt, tb, tfd, tu, tqp.CQRings.empty(q, 64, "cpu"), ring_layout=True)
    agree(ref, out)
    assert float(out[0].fabric.rx_busy.max()) > 3.0


# -- closed loops ------------------------------------------------------------

def jleaves(state):
    return {jax.tree_util.keystr(p).lstrip("."): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(state)[0]}


def tconfig(jcfg):
    """The port's EngineConfig of a reference one (same fields)."""
    kw = {f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__}
    kw["fabric"] = tt.FabricConfig(**jcfg.fabric.__dict__)
    kw["qp"] = tt.QPConfig(**jcfg.qp.__dict__)
    kw["cache"] = tt.CacheConfig(**jcfg.cache.__dict__)
    return tt.EngineConfig(**kw)


def assert_states_agree(ref, got):
    """Reference and port leaves: every leaf equal but the global sums
    (``SUM_ULP``) and the per-tenant E2E sum, which the reference adds
    one term after another (``segment_sum``): the port's, near-exact,
    must lie within that recursion's error bound, ``(n - 1) * 2^-24``
    of the sum for n nonnegative terms (Higham's gamma)."""
    key = "metrics.tenant_sum_e2e"
    assert not convert.leaf_differences(
        {k: v for k, v in ref.items() if k != key},
        {k: v for k, v in got.items() if k != key}, SUM_BOUNDS)
    n = got["metrics.tenant_completed"].astype(np.float64)
    want = ref[key].astype(np.float64)
    assert (np.abs(got[key] - want) <= np.maximum(n - 1, 0) * 2.0 ** -24
            * want).all()


def closed_loop(jcfg, jssd, jwl, twl, rounds, m=1):
    """Both packages' final states, held by ``assert_states_agree``."""
    ref = jleaves(C.run_engine(jcfg, jssd, jwl, rounds=rounds,
                               num_devices=m))
    out = te.simulate(tconfig(jcfg), tt.SSDConfig(**jssd.__dict__), twl,
                      rounds=rounds, num_devices=m, device="cpu")
    got = convert.engine_state_to_numpy(out)
    assert_states_agree(ref, got)
    return got


REMOTE_SWITCHED = dict(remote=True, rtt_us=10.0, tx_bytes_per_us=8000.0,
                       rx_bytes_per_us=4000.0, wire_txn_us=0.2,
                       mtu_batch=16, mtu_timeout_us=20.0,
                       switch_bytes_per_us=60000.0, switch_fanin=4)


def test_convert_carries_fabric_and_tenant_leaves():
    """``convert`` moves a two-tenant remote state both ways leaf by leaf:
    the four (T,) fabric cursors and the per-tenant metrics among them."""
    cfg = tt.EngineConfig(num_sqs=8, sq_depth=64, fetch_width=16,
                          fabric=tt.FabricConfig(**dict(
                              REMOTE_SWITCHED, qos_weights=(2.0, 1.0))))
    state = te.simulate(cfg, tt.SSDConfig(), tw.MultiTenant(io_depth=8),
                        rounds=3, device="cpu")
    leaves = convert.engine_state_to_numpy(state)
    for k in ("device.fabric.tx_busy", "device.fabric.switch_rx",
              "metrics.tenant_completed", "metrics.tenant_lat_hist"):
        assert leaves[k].shape[0] == 2, k
    assert leaves["device.fabric.rx_busy"].max() > 0
    back = convert.engine_state_to_numpy(
        convert.engine_state_from_numpy(leaves, "cpu"))
    assert not convert.leaf_differences(leaves, back)
