"""The storage client and the vector search on remote drives, in the port
against the reference.

Fig 24's placements (``benchmarks/figures.py::fig24_stripe_replication``)
at n = 1024 on a remote 4-drive client: stripe widths 1-4 over a uniform
batch and 1-4 replicas of a batch homed on drive 0, each read's
completion bit for bit. ``read_replicated`` routes by a load that, on a
remote array, adds each drive's RX link cursor (and its switch cursor
when the switch has a finite roof) and a frame's wire time to the
routed reads' estimate: from a state whose cursors differ per drive the
two packages route and complete alike. The reference's client
``submit`` is compiled, as the engine compiles it. The remote vector
search is ``tests/test_torch_remote_search.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import common as C
from repro.core import types as jt
from repro.core.client import StorageClient as JClient
from repro_torch import convert
from repro_torch.bench import FUTURE_40M
from repro_torch.core import types as tt
from repro_torch.core.client import StorageClient as TClient
from port_threads import one_torch_thread  # noqa: F401

N = 1024
M = 4
FIG24 = dict(remote=True, rtt_us=5.0, tx_bytes_per_us=8000.0,
             rx_bytes_per_us=2000.0, wire_txn_us=0.2, mtu_batch=8,
             mtu_timeout_us=20.0)


@dataclasses.dataclass(frozen=True)
class _CompiledClient(JClient):
    """The reference client with ``submit`` compiled."""

    def submit(self, state, flash, ops, data=None, with_data=False):
        return _jit_submit(self, state, flash, ops, data, with_data)


_jit_submit = jax.jit(
    lambda c, s, f, o, d, w: JClient.submit(c, s, f, o, data=d, with_data=w),
    static_argnums=(0, 5))


def clients(**fab):
    kw = dict(num_units=8, fetch_width=64)
    return (_CompiledClient(C.FUTURE_40M, jt.EngineConfig(
                fabric=jt.FabricConfig(**fab), **kw)),
            TClient(FUTURE_40M, tt.EngineConfig(
                fabric=tt.FabricConfig(**fab), **kw)))


def batches_of(kind):
    lba = (np.arange(N, dtype=np.int32) * 13) % FUTURE_40M.num_blocks
    if kind == "replicas":
        lba = lba // M * M
    return lba


def jleaves(state):
    return {jax.tree_util.keystr(p).lstrip("."): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(state)[0]}


@pytest.mark.parametrize("kind,value", [
    ("stripe", M), *(("replicas", r) for r in range(1, M + 1)),
])
def test_fig24_placement(kind, value):
    """A row of fig 24 at n = 1024 (the widest stripe and every replica
    count): every completion and every leaf of the array's state."""
    jc, tc = clients(**FIG24)
    lba = batches_of(kind)
    jflash = jnp.zeros((FUTURE_40M.num_blocks, 8), jnp.float32)
    tflash = torch.zeros((FUTURE_40M.num_blocks, 8))
    if kind == "stripe":
        jst, _, jdone = jc.read_striped(jc.init_array_state(M), jflash,
                                        jnp.asarray(lba), jnp.float32(0),
                                        stripe_width=value)
        tst, _, tdone = tc.read_striped(tc.init_array_state(M, "cpu"),
                                        tflash, torch.from_numpy(lba), 0.0,
                                        stripe_width=value)
    else:
        jst, _, jdone = jc.read_replicated(jc.init_array_state(M), jflash,
                                           jnp.asarray(lba), jnp.float32(0),
                                           replicas=value)
        tst, _, tdone = tc.read_replicated(tc.init_array_state(M, "cpu"),
                                           tflash, torch.from_numpy(lba),
                                           0.0, replicas=value)
    np.testing.assert_array_equal(np.asarray(jdone), tdone.numpy())
    assert not convert.leaf_differences(jleaves(jst),
                                        convert.engine_state_to_numpy(tst))


def test_replica_routing_reads_the_wire_cursors():
    """From a state whose drives' RX link cursors differ (after a read
    striped over two of the four drives, fig 24's wire), replica reads
    route by the remote load, the link cursor and the frame's wire
    estimate included: the same completions and state as the
    reference's."""
    jc, tc = clients(**FIG24)
    lba = batches_of("replicas")
    jflash = jnp.zeros((FUTURE_40M.num_blocks, 8), jnp.float32)
    tflash = torch.zeros((FUTURE_40M.num_blocks, 8))
    jst, _, _ = jc.read_striped(jc.init_array_state(M), jflash,
                                jnp.asarray(lba), jnp.float32(0),
                                stripe_width=2)
    tst, _, _ = tc.read_striped(tc.init_array_state(M, "cpu"), tflash,
                                torch.from_numpy(lba), 0.0, stripe_width=2)
    rx = tst.dev.fabric.rx_busy
    assert float(rx[0].max()) > float(rx[3].max())
    jst, _, jdone = jc.read_replicated(jst, jflash, jnp.asarray(lba),
                                       jnp.float32(5.0), replicas=3)
    tst, _, tdone = tc.read_replicated(tst, tflash, torch.from_numpy(lba),
                                       5.0, replicas=3)
    np.testing.assert_array_equal(np.asarray(jdone), tdone.numpy())
    assert not convert.leaf_differences(jleaves(jst),
                                        convert.engine_state_to_numpy(tst))


def test_replica_routing_reads_the_switch_cursor():
    """On a switched client the switch port's RX cursor joins the load:
    with every link idle, a busy switch lane on drive 0 steers a block
    homed there to its other replica, and an idle one does not (the first
    candidate wins a tie)."""
    _, tc = clients(**FIG24, switch_bytes_per_us=6000.0, switch_fanin=M)
    tflash = torch.zeros((FUTURE_40M.num_blocks, 8))
    lba = torch.zeros((1,), dtype=torch.int32)

    def drive_of(switch_busy_us):
        st = tc.init_array_state(M, "cpu")
        sw = st.dev.fabric.switch_rx.clone()
        sw[0] = switch_busy_us
        st = dataclasses.replace(st, dev=dataclasses.replace(
            st.dev, fabric=dataclasses.replace(st.dev.fabric,
                                               switch_rx=sw)))
        out = tc.read_replicated(st, tflash, lba, 0.0, replicas=2)[0]
        return int(torch.argmax(out.dev.fabric.rx_busy.amax(dim=-1)))

    assert drive_of(0.0) == 0
    assert drive_of(1e4) == 1
