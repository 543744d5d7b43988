"""The port's array client (``StorageClient.submit_array``,
``submit_striped`` and their wrappers ``read_array``, ``write_array``,
``read_striped``, ``read_replicated`` and ``write_replicated``) and the two
applications that stripe over an array, against the reference.

The client's entry points run on local drives from one seeded batch in
both packages: the final stacked ``ClientState``, the completion times,
the gathered blocks and the shared block store must be equal, every
leaf bit for bit. The reference's entry points are compiled (run
eagerly, its vmapped ring path costs most of a minute a call). The
applications over an array are in ``tests/test_torch_array_apps.py``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import types as jt
from repro.core.client import StorageClient as JClient
from repro_torch import convert
from repro_torch.core import types as tt
from repro_torch.core.client import StorageClient as TClient
from port_threads import one_torch_thread  # noqa: F401

M = 3
NB = 1 << 12
W = 4
SSD = dict(t_max_iops=40e6, l_min_us=30.0, n_instances=128, num_blocks=NB)
ECFG = dict(num_units=4, fetch_width=16, num_sqs=8, sq_depth=64)


_COMPILED: dict = {}


class _Compiled:
    """The reference client's entry points, each compiled (once a test
    process) with its non-array arguments static."""

    def __init__(self, client):
        self.client = client

    def __getattr__(self, name):
        if name == "init_array_state":
            return self.client.init_array_state

        def call(*args, **static):
            key = (name, tuple(sorted(static.items())))
            if key not in _COMPILED:
                _COMPILED[key] = jax.jit(functools.partial(
                    getattr(JClient, name), self.client, **static))
            return _COMPILED[key](*args)

        return call


def clients():
    return (_Compiled(JClient(jt.SSDConfig(**SSD), jt.EngineConfig(**ECFG))),
            TClient(tt.SSDConfig(**SSD), tt.EngineConfig(**ECFG)))


def jleaves(tree):
    return {jax.tree_util.keystr(p).lstrip("."): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def t(x):
    return torch.from_numpy(np.asarray(x))


def assert_same(ref, out):
    """Reference outputs (state, arrays...) against the port's, bit for
    bit."""
    assert not convert.leaf_differences(
        jleaves(ref[0]), convert.engine_state_to_numpy(out[0]))
    for a, b in zip(ref[1:], out[1:]):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    n = 101
    return dict(
        flash=rng.random((NB, W)).astype(np.float32),
        lba=rng.integers(0, NB, (M, n)).astype(np.int32),
        t=(rng.random((M, n)) * 10).astype(np.float32),
        valid=rng.random((M, n)) < 0.8,
        op=(rng.random((M, n)) < 0.3).astype(np.int32),
        data=rng.random((M, n, W)).astype(np.float32),
        flat_lba=rng.integers(0, NB, n).astype(np.int32),
        flat_t=(rng.random(n) * 5).astype(np.float32),
        flat_op=(rng.random(n) < 0.4).astype(np.int32),
        flat_data=rng.random((n, W)).astype(np.float32),
    )


def busy_states(jc, tc, b):
    """Array states after one striped batch, so that drives differ."""
    js, _, _ = jc.read_striped(jc.init_array_state(M), jnp.asarray(
        b["flash"]), jnp.asarray(b["flat_lba"]), jnp.asarray(b["flat_t"]))
    ts, _, _ = tc.read_striped(tc.init_array_state(M, "cpu"), t(b["flash"]),
                               t(b["flat_lba"]), t(b["flat_t"]))
    return js, ts


@pytest.mark.parametrize("with_data", [False, True])
def test_submit_array_matches_reference(batch, with_data):
    jc, tc = clients()
    b = batch
    jops = jt.StorageOps.make(jnp.asarray(b["lba"]), jnp.asarray(b["t"]),
                              opcode=jnp.asarray(b["op"]),
                              valid=jnp.asarray(b["valid"]))
    tops = tt.StorageOps.make(t(b["lba"]), t(b["t"]), opcode=t(b["op"]),
                              valid=t(b["valid"]))
    ref = jc.submit_array(jc.init_array_state(M), jnp.asarray(b["flash"]),
                          jops, jnp.asarray(b["data"]), with_data=with_data)
    out = tc.submit_array(tc.init_array_state(M, "cpu"), t(b["flash"]),
                          tops, data=t(b["data"]), with_data=with_data)
    assert_same(ref, out)
    assert out[3].shape == (M, b["lba"].shape[1])


def test_submit_array_drive_d_is_submit_on_its_row(batch):
    """The port against itself: each drive of ``submit_array`` prices its
    row as ``submit`` on one drive does, bit for bit."""
    _, tc = clients()
    b = batch
    tops = tt.StorageOps.make(t(b["lba"]), t(b["t"]), opcode=t(b["op"]),
                              valid=t(b["valid"]))
    st, _, _, done = tc.submit_array(tc.init_array_state(M, "cpu"),
                                     t(b["flash"]), tops)
    arr = convert.engine_state_to_numpy(st)
    for d in range(M):
        ops_d = tt.StorageOps(**{f.name: getattr(tops, f.name)[d]
                                 for f in dataclasses.fields(tops)})
        one, _, _, done_d = tc.submit(tc.init_state("cpu"), t(b["flash"]),
                                      ops_d)
        assert torch.equal(done[d], done_d)
        assert not convert.leaf_differences(
            convert.engine_state_to_numpy(one),
            {k: v[d] for k, v in arr.items()})


@pytest.mark.parametrize("stripe_width", [None, 1, 2])
def test_submit_striped_matches_reference(batch, stripe_width):
    """A mixed batch of 101 ops (a ragged tail at every width) striped
    over all three drives, over one, and over two of three."""
    jc, tc = clients()
    b = batch
    jops = jt.StorageOps.make(jnp.asarray(b["flat_lba"]),
                              jnp.asarray(b["flat_t"]),
                              opcode=jnp.asarray(b["flat_op"]))
    tops = tt.StorageOps.make(t(b["flat_lba"]), t(b["flat_t"]),
                              opcode=t(b["flat_op"]))
    ref = jc.submit_striped(jc.init_array_state(M), jnp.asarray(b["flash"]),
                            jops, jnp.asarray(b["flat_data"]),
                            stripe_width=stripe_width, with_data=True)
    out = tc.submit_striped(tc.init_array_state(M, "cpu"), t(b["flash"]),
                            tops, data=t(b["flat_data"]),
                            stripe_width=stripe_width, with_data=True)
    assert_same(ref, out)
    busy = convert.engine_state_to_numpy(out[0])["dev.lock_time"]
    assert (busy > 0).sum() == (stripe_width or M)


def test_read_and_write_array_match_reference(batch):
    jc, tc = clients()
    b = batch
    js, ts = busy_states(jc, tc, b)
    t_drive = b["t"][:, 0] + 20.0          # an (M,) clock, one a drive
    ref = jc.write_array(js, jnp.asarray(b["flash"]), jnp.asarray(b["data"]),
                         jnp.asarray(b["lba"]), jnp.asarray(t_drive),
                         jnp.asarray(b["valid"]))
    out = tc.write_array(ts, t(b["flash"]), t(b["data"]), t(b["lba"]),
                         t(t_drive), valid=t(b["valid"]))
    assert_same(ref, out)
    ref = jc.read_array(ref[0], ref[1], jnp.asarray(b["lba"]),
                        jnp.asarray(b["t"] + 40.0))
    out = tc.read_array(out[0], out[1], t(b["lba"]), t(b["t"] + 40.0))
    assert_same(ref, out)


def test_read_striped_matches_reference(batch):
    jc, tc = clients()
    b = batch
    js, ts = busy_states(jc, tc, b)
    ref = jc.read_striped(js, jnp.asarray(b["flash"]),
                          jnp.asarray(b["flat_lba"]),
                          jnp.asarray(b["flat_t"] + 30.0), None, stripe_width=2)
    out = tc.read_striped(ts, t(b["flash"]), t(b["flat_lba"]),
                          t(b["flat_t"] + 30.0), stripe_width=2)
    assert_same(ref, out)


@pytest.mark.parametrize("replicas", [2, 3])
def test_replicated_reads_and_writes_match_reference(batch, replicas):
    """Least-loaded replica reads from drives that the striped batch left
    unevenly loaded, then the replica fan-out of a write batch."""
    jc, tc = clients()
    b = batch
    js, ts = busy_states(jc, tc, b)
    valid = np.arange(b["flat_lba"].shape[0]) % 7 != 3
    ref = jc.read_replicated(
        js, jnp.asarray(b["flash"]), jnp.asarray(b["flat_lba"]),
        jnp.asarray(b["flat_t"] + 20.0), jnp.asarray(valid),
        replicas=replicas)
    out = tc.read_replicated(ts, t(b["flash"]), t(b["flat_lba"]),
                             t(b["flat_t"] + 20.0), t(valid),
                             replicas=replicas)
    assert_same(ref, out)
    ref = jc.write_replicated(
        ref[0], jnp.asarray(b["flash"]), jnp.asarray(b["flat_data"]),
        jnp.asarray(b["flat_lba"]), jnp.asarray(b["flat_t"] + 60.0),
        replicas=replicas)
    out = tc.write_replicated(out[0], t(b["flash"]), t(b["flat_data"]),
                              t(b["flat_lba"]), t(b["flat_t"] + 60.0),
                              replicas=replicas)
    assert_same(ref, out)


def test_array_entry_points_check_their_arguments(batch):
    _, tc = clients()
    b = batch
    one = tc.init_state("cpu")
    with pytest.raises(ValueError, match="leading"):
        tc.read_striped(one, t(b["flash"]), t(b["flat_lba"]))
    arr = tc.init_array_state(M, "cpu")
    with pytest.raises(ValueError, match="stripe_width=4"):
        tc.read_striped(arr, t(b["flash"]), t(b["flat_lba"]), stripe_width=4)
    with pytest.raises(ValueError, match="replicas=4"):
        tc.read_replicated(arr, t(b["flash"]), t(b["flat_lba"]), replicas=4)
    back = convert.client_state_from_numpy(
        convert.engine_state_to_numpy(arr), "cpu")
    assert not convert.leaf_differences(convert.engine_state_to_numpy(arr),
                                        convert.engine_state_to_numpy(back))
