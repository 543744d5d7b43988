"""Port of ``core/types.py``: config parity with the reference, the device
rule of the entry points, and the import boundary of the port.

The config dataclasses must carry the reference's field names, defaults,
checks and derived properties; ``integer_timestamps`` must agree with the
reference over a grid of configs. The port and ``chip_smoke.py`` may not
import JAX or anything of the reference package.
"""
import ast
import dataclasses
import itertools
from pathlib import Path

import pytest
import torch

from repro.core import types as jt
from repro_torch.core import types as tt
from port_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]

CLASSES = ["SSDConfig", "PlatformModel", "QPConfig", "FabricConfig",
           "CacheConfig", "WorkloadConfig", "EngineConfig"]


@pytest.mark.parametrize("name", CLASSES)
def test_config_fields_and_defaults_match(name):
    ref, port = getattr(jt, name), getattr(tt, name)
    rf = [(f.name, f.default) for f in dataclasses.fields(ref)]
    pf = [(f.name, f.default) for f in dataclasses.fields(port)]
    assert [n for n, _ in rf] == [n for n, _ in pf]
    for (n, a), (_, b) in zip(rf, pf):
        if dataclasses.is_dataclass(a):
            assert dataclasses.asdict(a) == dataclasses.asdict(b), n
        else:
            assert a == b, n


def test_derived_properties_match():
    for kw in [{}, dict(t_max_iops=40e6, n_instances=512, num_blocks=1 << 14),
               dict(num_channels=4, chips_per_channel=2, over_provision=0.2)]:
        r, p = jt.SSDConfig(**kw), tt.SSDConfig(**kw)
        assert (r.sched_us, r.num_chips, r.phys_pages) == (
            p.sched_us, p.num_chips, p.phys_pages)
    fab = dict(remote=True, switch_bytes_per_us=60_000.0, switch_fanin=4,
               qos_weights=(2.0, 1.0))
    r, p = jt.FabricConfig(**fab), tt.FabricConfig(**fab)
    assert (r.num_tenants, r.switched, r.switch_share_bytes_per_us,
            r.neutral) == (p.num_tenants, p.switched,
                           p.switch_share_bytes_per_us, p.neutral)
    assert jt.QPConfig().neutral == tt.QPConfig().neutral
    assert jt.CacheConfig().capacity == tt.CacheConfig().capacity


@pytest.mark.parametrize("name,kw", [
    ("SSDConfig", dict(num_channels=0)),
    ("SSDConfig", dict(mapping_hit_rate=1.5)),
    ("SSDConfig", dict(over_provision=0.0)),
    ("SSDConfig", dict(gc_watermark=0.5)),
    ("QPConfig", dict(cq_coalesce_n=0)),
    ("QPConfig", dict(cq_poll_us=-1.0)),
    ("FabricConfig", dict(mtu_batch=0)),
    ("FabricConfig", dict(qos_weights=(1.0, 0.0))),
    ("CacheConfig", dict(chase=0)),
    ("EngineConfig", dict(fetch_width=2048)),
    ("EngineConfig", dict(num_sqs=30, num_units=16)),
    ("EngineConfig", dict(mode="bogus")),
    ("EngineConfig", dict(lock_order="bogus")),
])
def test_post_init_checks_match(name, kw):
    with pytest.raises(ValueError):
        getattr(jt, name)(**kw)
    with pytest.raises(ValueError):
        getattr(tt, name)(**kw)


INT_PLAT = dict(
    cpu_sqe_fetch_us=10.0, cpu_coal_byte_us=0.0, cpu_coal_base_us=1.0,
    dsa_sqe_fetch_us=4.0, dsa_coal_base_us=18.0, dsa_desc_issue_us=1.0,
    dsa_batch_setup_us=1.0, dsa_bytes_per_us=64.0, doorbell_poll_us=1.0,
    host_txn_base_us=1.0, host_bytes_per_us=64.0, txn_base_us=1.0,
    link_bytes_per_us=64.0, per_req_map_us=3.0, lock_per_req_us=1.0,
    lock_per_batch_us=1.0,
)


def test_integer_timestamps_agrees_over_a_grid():
    """The static bit-exactness proof gives the reference's verdict on
    every combination of datapath, drive, platform and completion knobs."""
    ssds = [dict(), dict(t_max_iops=64e6), dict(t_max_iops=51.2e6,
                                                 n_instances=512)]
    plats = [dict(), INT_PLAT, dict(INT_PLAT, dsa_bytes_per_us=30000.0)]
    engines = [dict(batched_datapath=False), dict(batched_datapath=True),
               dict(batched_datapath=False, poll_quantum_us=2.5),
               dict(batched_datapath=False,
                    qp=dict(cq_coalesce_n=4, cq_doorbell_us=1.0)),
               dict(batched_datapath=False,
                    fabric=dict(remote=True, rtt_us=2.0,
                                tx_bytes_per_us=64.0,
                                rx_bytes_per_us=16.0))]
    seen = set()
    for s, p, e in itertools.product(ssds, plats, engines):
        verdicts = []
        for mod in (jt, tt):
            ekw = dict(e)
            if "qp" in ekw:
                ekw["qp"] = mod.QPConfig(**ekw["qp"])
            if "fabric" in ekw:
                ekw["fabric"] = mod.FabricConfig(**ekw["fabric"])
            cfg = mod.EngineConfig(**ekw)
            ssd, plat = mod.SSDConfig(**s), mod.PlatformModel(**p)
            verdicts.append((mod.integer_timestamps(cfg, ssd, plat),
                             cfg.resolve_pallas_segscan(ssd, plat)))
        assert verdicts[0] == verdicts[1]
        seen.add(verdicts[0][0])
    assert seen == {True, False}


def test_state_types_are_int32_float32():
    b = tt.RequestBatch.empty(5, "cpu")
    assert b.arrival.dtype == torch.float32 and b.lba.dtype == torch.int32
    assert b.valid.dtype == torch.bool and b.capacity == 5
    ts = tt.TimingState.init(7, "cpu")
    assert ts.busy_until.dtype == torch.float32 and ts.busy_until.shape == (7,)
    assert ts.rr.dtype == torch.int32 and ts.rr.shape == ()


def test_resolve_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.resolve_device(None)
    assert tt.resolve_device("cpu") == torch.device("cpu")


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in (ROOT / "src/repro_torch").rglob("*.py")]
    + ["chip_smoke.py"]
))
def test_port_imports_neither_jax_nor_the_reference(path):
    tree = ast.parse((ROOT / path).read_text())
    for mod in _imports(tree):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, mod)


def test_local_1drive_is_the_benchmarks_configuration():
    """The port's copy of ``benchmarks/emulator_speed.py``'s local_1drive
    (``swarmio_cfg()`` on ``FUTURE_40M``) keeps every field."""
    from benchmarks import common
    from repro_torch import bench

    cfg, ssd = bench.local_1drive()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(common.swarmio_cfg())
    assert dataclasses.asdict(ssd) == dataclasses.asdict(common.FUTURE_40M)


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    from repro_torch.kernels import build

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.library("seg_scan")
