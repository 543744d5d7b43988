"""``StorageClient.read`` and ``StorageClient.write`` of the port against
the reference's (``repro/core/client.py``), compiled as an application
step compiles them.

Both are thin wrappers over ``submit``: the tests chain calls on one
client state with mixed valid masks, scalar and per-request submission
clocks and tenants, and compare the completion times, the gathered
blocks, the block store and every leaf of the device state. Integer and
bool leaves and every block must be equal; virtual times are held to
``TIME_ULP``, 0: the port's timing core fuses the multiply-adds the
reference's compiled one fuses. No batch writes one LBA twice (the reference
leaves that case unspecified).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import types as jt
from repro.core.client import StorageClient as JClient
from repro_torch.convert import ulp_distance
from repro_torch.core import types as tt
from repro_torch.core.client import StorageClient as TClient
from port_threads import one_torch_thread  # noqa: F401

TIME_ULP = 0
CONFIGS = {
    # the vector-search client on fig 16's two drives, n = 1024
    "search_2.5M": (dict(t_max_iops=2.5e6, l_min_us=50.0, n_instances=64,
                         num_blocks=1024),
                    dict(num_units=8, fetch_width=64)),
    "search_40M": (dict(t_max_iops=40e6, l_min_us=50.0, n_instances=1000,
                        num_blocks=1024),
                   dict(num_units=8, fetch_width=64)),
    # a small drive with a few service units and two tenants
    "small": (dict(t_max_iops=1e6, l_min_us=20.0, n_instances=32,
                   num_blocks=1024),
              dict(num_units=4, fetch_width=64, num_sqs=8, sq_depth=512)),
}
WORDS = 8


def t(x):
    return torch.from_numpy(np.array(x))


def leaves(obj, prefix=""):
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if v is None:
            continue
        if dataclasses.is_dataclass(v):
            out.update(leaves(v, prefix + f.name + "."))
        else:
            out[prefix + f.name] = np.asarray(v)
    return out


def agree_states(sj, st):
    want, got = leaves(sj.dev), leaves(st.dev)
    assert want.keys() == got.keys()
    for k in want:
        assert want[k].dtype == got[k].dtype, k
        if want[k].dtype.kind == "f":
            assert ulp_distance(want[k], got[k]) <= TIME_ULP, k
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def same(want, got):
    want, got = np.asarray(want), got.numpy()
    assert want.dtype == got.dtype and want.shape == got.shape
    np.testing.assert_array_equal(got, want)


def clients(name):
    ssd, ecfg = CONFIGS[name]
    return (JClient(jt.SSDConfig(**ssd), jt.EngineConfig(**ecfg)),
            TClient(tt.SSDConfig(**ssd), tt.EngineConfig(**ecfg)))


def batch(rng, n, blocks, per_request):
    lba = rng.permutation(blocks)[:n].astype(np.int32)
    valid = rng.random(n) < 0.8
    if per_request:
        t_sub = np.round(rng.uniform(0, 300, n), 1).astype(np.float32)
        tenant = rng.integers(0, 2, n).astype(np.int32)
    else:
        t_sub, tenant = np.float32(rng.uniform(0, 300)), 1
    return lba, t_sub, valid, tenant


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("per_request", [False, True])
def test_read_matches_reference(name, per_request):
    """Two chained reads (the second from the first's state, 900 slots,
    several fetch passes): data, completion times and the state."""
    cj, ct = clients(name)
    rng = np.random.default_rng(len(name) + per_request)
    blocks = CONFIGS[name][0]["num_blocks"]
    flash = rng.standard_normal((blocks, WORDS)).astype(np.float32)
    read_j = jax.jit(lambda s, f, l, ts, v, te: cj.read(
        s, f, l, ts, v, with_data=True, tenant=te))
    sj, st = cj.init_state(), ct.init_state("cpu")
    for n in (300, 900):
        lba, t_sub, valid, tenant = batch(rng, n, blocks, per_request)
        sj, dj, donej = read_j(sj, jnp.asarray(flash), jnp.asarray(lba),
                               jnp.asarray(t_sub), jnp.asarray(valid),
                               jnp.asarray(tenant))
        st, dt, donet = ct.read(st, t(flash), t(lba), t(t_sub)
                                if per_request else float(t_sub),
                                t(valid), tenant=t(tenant)
                                if per_request else tenant)
        same(dj, dt)
        assert ulp_distance(np.asarray(donej), donet.numpy()) <= TIME_ULP
        agree_states(sj, st)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_write_matches_reference(name):
    """A write with a mixed valid mask, then a read of the same blocks:
    the block store holds exactly the valid writes, the read returns them,
    and times and state agree with the reference."""
    cj, ct = clients(name)
    rng = np.random.default_rng(len(name))
    blocks = CONFIGS[name][0]["num_blocks"]
    flash = rng.standard_normal((blocks, WORDS)).astype(np.float32)
    lba, t_sub, valid, tenant = batch(rng, 500, blocks, True)
    data = rng.standard_normal((500, WORDS)).astype(np.float32)
    write_j = jax.jit(lambda s, f, d, l, ts, v, te: cj.write(
        s, f, d, l, ts, v, tenant=te))
    sj, fj, donej = write_j(cj.init_state(), jnp.asarray(flash),
                            jnp.asarray(data), jnp.asarray(lba),
                            jnp.asarray(t_sub), jnp.asarray(valid),
                            jnp.asarray(tenant))
    st, ft, donet = ct.write(ct.init_state("cpu"), t(flash), t(data), t(lba),
                             t(t_sub), t(valid), tenant=t(tenant))
    same(fj, ft)
    want = flash.copy()
    want[lba[valid]] = data[valid]
    np.testing.assert_array_equal(ft.numpy(), want)
    assert ulp_distance(np.asarray(donej), donet.numpy()) <= TIME_ULP
    agree_states(sj, st)
    st, back, _ = ct.read(st, ft, t(lba), 1000.0)
    np.testing.assert_array_equal(back.numpy()[valid], data[valid])


def test_read_without_data_and_write_defaults():
    """``with_data=False`` returns no data and the same times; scalar
    defaults (t_submit 0, every slot valid, tenant 0) fan out."""
    _, ct = clients("small")
    flash = torch.arange(1024 * WORDS, dtype=torch.float32).reshape(1024,
                                                                    WORDS)
    lba = torch.arange(0, 1000, 7, dtype=torch.int32)
    s0 = ct.init_state("cpu")
    _, data, done = ct.read(s0, flash, lba)
    _, none, done2 = ct.read(s0, flash, lba, with_data=False)
    assert none is None and torch.equal(done, done2)
    torch.testing.assert_close(data, flash[lba.long()], rtol=0, atol=0)
    _, f2, wdone = ct.write(s0, flash, torch.zeros(len(lba), WORDS), lba)
    assert torch.all(f2[lba.long()] == 0) and bool(torch.all(wdone > 0))
    assert torch.equal(flash[1], f2[1])
