"""A remote switched drive in a closed loop, in the port against the
reference's ``simulate``: ``remote_qos`` (``benchmarks/emulator_speed.py``:
``local_1drive`` behind 30000 B/us links, a 60000 B/us switch shared by
four links, WFQ 2:1, a read tenant and a write tenant at depth 256) for 8
rounds. Every leaf equal but the metrics' float sums
(``test_torch_fabric.assert_states_agree``); the two tenants' cursors of
both links and both switch directions among them. A 4-drive remote array
is held leaf by leaf in ``tests/test_torch_figures_fabric.py`` (fig 23's
1000 B/us row)."""
from benchmarks import common as C
from repro import workloads as jw
from repro.core import types as jt
from repro_torch import workloads as tw
from test_torch_fabric import closed_loop
from port_threads import one_torch_thread  # noqa: F401

REMOTE_QOS = dict(remote=True, tx_bytes_per_us=30_000.0,
                  rx_bytes_per_us=30_000.0, rtt_us=2.0, wire_txn_us=0.2,
                  mtu_batch=8, mtu_timeout_us=5.0,
                  switch_bytes_per_us=60_000.0, switch_fanin=4,
                  qos_weights=(2.0, 1.0))


def test_remote_qos_loop():
    kw = dict(io_depth=256, tenant_read_frac=(1.0, 0.0))
    got = closed_loop(
        C.swarmio_cfg(fabric=jt.FabricConfig(**REMOTE_QOS)), C.FUTURE_40M,
        jw.MultiTenant(**kw), tw.MultiTenant(**kw), 8)
    assert got["metrics.completed"] > 0
    for k in ("tx_busy", "rx_busy", "switch_tx", "switch_rx"):
        assert (got[f"device.fabric.{k}"] > 0).all(), k
