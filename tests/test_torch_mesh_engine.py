"""The emulator on several ranks: ``engine.make_sharded_array_runner`` and
``timing.distributed_aggregated_update`` (``timing.update(axis_name=)``)
on a world of 4 gloo CPU ranks (and a 2-rank mesh inside it), held
against the port's one-process ``make_array_runner``/``timing.update`` and
against the reference's ``shard_map`` versions on 4 virtual CPU devices
(``tests/torch_mesh_reference.py``).

Bounds: the sharded runner's drives equal the one-process array's bit
for bit, every leaf (the same per-drive work, gathered); against the
reference the array's contract of ``tests/test_torch_array.py``: every
integer and time leaf equal, the metrics' three float32 sums within
``SUM_ULP`` and the per-tenant sum within the same. The distributed
update: integer leaves exact and times 0 ULP against the reference's
and against ``timing.update`` on the concatenated batch (the aggregated
core is the reference's bit for bit since the timing core's repair).
"""
import numpy as np
import pytest

from repro_torch import convert
from repro_torch.distributed.world import run_world

import mesh_worlds
import torch_mesh_bodies
from port_threads import one_torch_thread  # noqa: F401

SUM_ULP = 16
SUMS = ("metrics.sum_e2e", "metrics.sum_target", "metrics.sum_proc",
        "metrics.tenant_sum_e2e")
SSD = dict(t_max_iops=2.47e6, l_min_us=50.0, n_instances=64,
           num_blocks=1 << 12)
CFG = dict(num_sqs=8, sq_depth=256, fetch_width=32, num_units=4,
           emulate_data=False, num_bufs=512)
TIMING_SSD = dict(t_max_iops=2.47e6, l_min_us=50.0, n_instances=16)
N_UPDATE = 96          # rows of the global batch


def update_inputs(routing, n, seed):
    rng = np.random.default_rng(seed)
    return dict(
        busy=np.sort(rng.uniform(0, 200, 16)).astype(np.float32),
        rr=np.array(rng.integers(0, 16), np.int32),
        arrival=np.sort(rng.uniform(0, 400, N_UPDATE)).astype(np.float32),
        lba=rng.integers(0, 1 << 20, N_UPDATE).astype(np.int32),
        valid=rng.random(N_UPDATE) < 0.8)


UPDATE_CASES = [("round_robin", 2), ("round_robin", 4), ("lba_hash", 4)]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_engine")
    inp = dict(ssd=SSD, cfg=CFG, io_depth=16, rounds=8,
               runner_cases=[(4, 4), (8, 4)],
               port_runner_cases=[(4, 4), (8, 4), (4, 2), (8, 2)],
               update_cases=UPDATE_CASES, timing_ssd=TIMING_SSD,
               update={c: update_inputs(*c, seed=i)
                       for i, c in enumerate(UPDATE_CASES)})
    ref = mesh_worlds.start_reference("engine", inp, tmp)
    port = run_world(torch_mesh_bodies.engine_body, 4, inp,
                     timeout_s=mesh_worlds.WORLD_TIMEOUT_S,
                     store_dir=str(tmp))
    return mesh_worlds.reference_result(ref), port


@pytest.mark.parametrize("m,n", [(4, 4), (8, 4), (4, 2), (8, 2)])
def test_sharded_runner_equals_array_runner(results, m, n):
    _, port = results
    got, want = port[0]["runner"][(m, n)], port[0]["array"][m]
    assert (want["metrics.completed"] > 0).all()
    assert not convert.leaf_differences(want, got)


@pytest.mark.parametrize("m", [4, 8])
def test_sharded_runner_equals_reference(results, m):
    ref, port = results
    want = ref["runner"][(m, 4)]
    bounds = {k: SUM_ULP for k in SUMS}
    for n in (4, 2):
        assert not convert.leaf_differences(want, port[0]["runner"][(m, n)],
                                            bounds), n


def test_indivisible_array_raises(results):
    _, port = results
    assert all("divisible by the mesh size" in r["indivisible"]
               for r in port)


@pytest.mark.parametrize("routing,n", UPDATE_CASES)
def test_distributed_update_equals_reference(results, routing, n):
    ref, port = results
    r = ref["update"][(routing, n)]
    whole = port[0]["update"][(routing, n, "whole")]
    parts = [port[k]["update"][(routing, n, k)] for k in range(n)]
    comp = np.concatenate([p["comp"] for p in parts])
    for p in parts:   # the replicated state evolves identically
        assert np.array_equal(p["busy"].view(np.int32),
                              r["busy"].view(np.int32))
        assert p["rr"] == r["rr"] and p["rr"].dtype == np.int32
    assert np.array_equal(comp.view(np.int32), r["comp"].view(np.int32))
    # ... and it is timing.update on the concatenated batch, in both
    # packages.
    assert np.array_equal(comp.view(np.int32), whole["comp"].view(np.int32))
    assert np.array_equal(whole["busy"].view(np.int32),
                          r["busy_whole"].view(np.int32))
    assert np.array_equal(r["comp"].view(np.int32),
                          r["comp_whole"].view(np.int32))
