"""The port's M-drive array (``engine.init_array_state``,
``make_array_runner``, ``simulate(num_devices=M)``) against the reference's
vmapped array, and against the port's own single drive.

Against the reference: the stacked initial state leaf by leaf (a
``TraceReplay`` array's drives stripe the trace); 14 rounds of a small
stock-shaped array of M = 3 drives, read-only and 70/30, with every
integer and bool leaf equal and every float leaf but the metrics' sums
(``SUM_ULP``) bit-exact; and fig 17 (``benchmarks/figures.py``'s
settings: stock ``swarmio_cfg()`` on ``FUTURE_40M``, depth 1024, 24
rounds) at M = 1 and 4, whose aggregate MIOPS, p50 and p99 must equal the
reference's, recomputed here, and whose per-drive ring LBAs and request
ids must too: every drive of a read array prints the same aggregate, so
only the leaves tell drives apart. The fig 17 contract is the stock one
of ``tests/test_torch_engine.py``: time leaves within ``TIME_ULP``, 0
(the port fuses the multiply-adds the reference's compiled timing core
fuses), its three global
sums within ``SUM_ULP``, the per-tenant sum within the error bound of
recursive summation.

Against itself, bit for bit: drive d of an array equals a single drive of
salt d, for the engine and for every stage on shared inputs, and an
M = 1 array, squeezed, equals ``make_runner``'s result.

The engine kernels take all M drives in one launch (``kernels/ops.py``
lays the drives end to end); on the CPU their plain versions run the
same flattening, so a flattened call over M drives must equal M separate
calls. Two of these tests guard a flattening rule:
``test_flat_block_gather_wraps_and_clamps_per_drive`` (each drive's index
is wrapped and clamped before its offset) and
``test_flat_fused_reap_keeps_rows_in_their_drive`` (a valid row's key is
clipped into its own drive's CQs before its offset; invalid rows carry
``M*Q``).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from benchmarks import common as C
from repro.core import engine as je
from repro.core import types as jt
from repro.workloads import MixedReadWrite as JMixed
from repro.workloads import TraceReplay as JTrace
from repro_torch import convert
from repro_torch.bench import array_4drive, local_1drive, nvmevirt_1drive
from repro_torch.core import datapath, flash, frontend, qp, timing
from repro_torch.core import engine as te
from repro_torch.core import types as tt
from repro_torch.core.device import DevicePipeline
from repro_torch.kernels import ops as kops
from repro_torch.workloads import MixedReadWrite as TMixed
from repro_torch.workloads import PoissonOpenLoop as TPoisson
from repro_torch.workloads import TraceReplay as TTrace
from port_threads import one_torch_thread  # noqa: F401

M = 3
SMALL = dict(num_sqs=8, sq_depth=64, fetch_width=16, num_units=4,
             num_bufs=1 << 10)
STOCK_SSD = dict(name="future-40m", t_max_iops=40e6, l_min_us=30.0,
                 n_instances=512, num_blocks=1 << 14)
SUM_ULP = 16
SUMS = ("metrics.sum_e2e", "metrics.sum_target", "metrics.sum_proc")
TIME_ULP = 0
EPS32 = 2.0 ** -24
FLAGS = dict(use_pallas=True, use_pallas_segscan=True, use_pallas_reap=True,
             use_pallas_flash=True)


def jleaves(state):
    return {jax.tree_util.keystr(p).lstrip("."): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(state)[0]}


def drive(leaves, d):
    return {k: v[d] for k, v in leaves.items()}


def trace(n=40):
    rng = np.random.default_rng(7)
    return (np.sort(rng.random(n) * 20).astype(np.float32),
            rng.integers(0, 1 << 14, n).astype(np.int32),
            (rng.random(n) < 0.3).astype(np.int32))


WORKLOADS = {
    "read": lambda j: (jt if j else tt).WorkloadConfig(io_depth=16),
    "mixed_70_30": lambda j: (JMixed if j else TMixed)(io_depth=16,
                                                      read_frac=0.7),
    "trace": lambda j: (JTrace if j else TTrace).from_trace(
        *trace(), (jt if j else tt).EngineConfig(**SMALL)),
}


def configs(emulate_data=True, **kw):
    cfg = dict(SMALL, emulate_data=emulate_data, **kw)
    return ((jt.EngineConfig(**cfg), jt.SSDConfig(**STOCK_SSD),
             jt.PlatformModel()),
            (tt.EngineConfig(**cfg), tt.SSDConfig(**STOCK_SSD),
             tt.PlatformModel()))


# -- against the reference -----------------------------------------------------

@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_init_array_state_matches_reference(name):
    (cj, sj, _), (ct, st, _) = configs()
    ref = jleaves(je.init_array_state(cj, sj, WORKLOADS[name](True), M))
    out = convert.engine_state_to_numpy(
        te.init_array_state(ct, st, WORKLOADS[name](False), M, device="cpu"))
    assert sorted(ref) == sorted(out)
    assert all(v.shape[0] == M for v in out.values())
    assert not convert.leaf_differences(ref, out)
    if name == "trace":
        # The drives stripe the trace: each holds its own rows, all of
        # them together the whole trace.
        per_drive = out["rings.tail"].sum(axis=1)
        assert per_drive.sum() == len(trace()[0]) and (per_drive > 0).all()


@pytest.mark.parametrize("name", ["read", "mixed_70_30"])
def test_array_runner_matches_reference(name):
    (cj, sj, pj), (ct, st, pt) = configs()
    wj, wt = WORKLOADS[name](True), WORKLOADS[name](False)
    ref = je.make_array_runner(cj, sj, wj, pj, 14)(
        je.init_array_state(cj, sj, wj, M))
    out = te.make_array_runner(ct, st, wt, pt, 14, device="cpu")(
        te.init_array_state(ct, st, wt, M, device="cpu"))
    ref, out = jleaves(ref), convert.engine_state_to_numpy(out)
    assert (ref["metrics.completed"] > 0).all()
    bounds = {k: SUM_ULP for k in SUMS + ("metrics.tenant_sum_e2e",)}
    assert not convert.leaf_differences(ref, out, bounds)


_FIG17: dict = {}


def fig17_run(m):
    """``benchmarks/figures.py::fig17_array_scaling``'s run of M drives in
    both packages (once a test process): (reference state, its numbers,
    port state)."""
    if m not in _FIG17:
        ref = je.simulate(C.swarmio_cfg(), C.FUTURE_40M,
                          jt.WorkloadConfig(io_depth=1024), rounds=24,
                          num_devices=m)
        agg = float(je.aggregate_iops(ref))
        nums = (agg / 1e6, agg / (m * C.FUTURE_40M.t_max_iops),
                float(ref.metrics.p50_us()), float(ref.metrics.p99_us()))
        cfg, ssd = local_1drive()
        out = te.simulate(cfg, ssd, tt.WorkloadConfig(io_depth=1024),
                          rounds=24, num_devices=m, device="cpu")
        _FIG17[m] = (jleaves(ref), nums, out)
    return _FIG17[m]


@pytest.mark.parametrize("m", [1, 4])
def test_fig17_matches_reference(m):
    ref, (miops, frac, p50, p99), out = fig17_run(m)
    agg = float(te.aggregate_iops(out))
    got = (agg / 1e6, agg / (m * 40e6), float(out.metrics.p50_us()),
           float(out.metrics.p99_us()))
    assert got == (miops, frac, p50, p99)
    assert miops > 38 * m  # at least 95% of 40 MIOPS a drive

    leaves = convert.engine_state_to_numpy(out)
    for k in ("rings.lba", "rings.req_id", "cq.req_id"):
        np.testing.assert_array_equal(leaves[k], ref[k], k)
    if m > 1:
        # The salts give every drive its own addresses.
        for d in range(1, m):
            assert not np.array_equal(leaves["rings.lba"][0],
                                      leaves["rings.lba"][d])
    tenant = "metrics.tenant_sum_e2e"
    bounds = {k: TIME_ULP for k in ref if ref[k].dtype.kind == "f"}
    bounds.update({k: SUM_ULP for k in SUMS})
    bounds.pop(tenant)
    assert not convert.leaf_differences(
        {k: v for k, v in ref.items() if k != tenant},
        {k: v for k, v in leaves.items() if k != tenant}, bounds)
    # Each package's per-tenant sum lies within (n - 1) * eps * sum of the
    # exact one (the terms are latencies, not negative), so the two lie
    # within twice that of each other.
    n = leaves["metrics.tenant_completed"]
    diff = np.abs(leaves[tenant].astype(np.float64) - ref[tenant])
    assert (diff <= 2 * (n - 1) * EPS32 * ref[tenant]).all()


# -- against the port's own single drive --------------------------------------

def _single_vs_array(cfg, ssd, wl, rounds):
    plat = tt.PlatformModel()
    arr = convert.engine_state_to_numpy(te.make_array_runner(
        cfg, ssd, wl, plat, rounds, device="cpu")(
        te.init_array_state(cfg, ssd, wl, M, device="cpu")))
    for d in range(M):
        one = te.init_state(cfg, ssd, wl.sharded(M), salt=d, device="cpu")
        one = convert.engine_state_to_numpy(
            te.run(one, cfg, ssd, wl, plat, rounds))
        assert not convert.leaf_differences(one, drive(arr, d)), d
    return arr


SELF_CASES = {
    "mixed_data": (dict(emulate_data=True), lambda: TMixed(
        io_depth=16, read_frac=0.7)),
    "mixed_kernels": (dict(emulate_data=True, **FLAGS), lambda: TMixed(
        io_depth=16, read_frac=0.7, theta=0.9)),
    "poisson": (dict(emulate_data=False), lambda: TPoisson(
        io_depth=16, rate_iops=4e6)),
    "trace": (dict(emulate_data=True), lambda: WORKLOADS["trace"](False)),
}


@pytest.mark.parametrize("name", sorted(SELF_CASES))
def test_drive_d_equals_single_drive_of_salt_d(name):
    kw, wl = SELF_CASES[name]
    (_, _, _), (ct, st, _) = configs(**kw)
    arr = _single_vs_array(ct, st, wl(), 10)
    assert (arr["metrics.completed"] > 0).all()


def test_baseline_array_equals_single_drives():
    """The NVMeVirt baseline's stages (centralized fetch, per-request
    timing and lock, CPU copy workers) over a drive axis, kernels on."""
    cfg, ssd = nvmevirt_1drive(num_sqs=8, sq_depth=64, fetch_width=16,
                               workers_per_unit=4, **FLAGS)
    _single_vs_array(cfg, ssd, TMixed(io_depth=16, read_frac=0.7), 8)


def test_one_drive_array_equals_make_runner():
    (_, _, _), (ct, st, pt) = configs()
    wl = WORKLOADS["mixed_70_30"](False)
    one = te.make_runner(ct, st, wl, pt, 8, device="cpu")(
        te.init_state(ct, st, wl, device="cpu"))
    arr = te.make_array_runner(ct, st, wl, pt, 8, device="cpu")(
        te.init_array_state(ct, st, wl, 1, device="cpu"))
    assert not convert.leaf_differences(
        convert.engine_state_to_numpy(one),
        drive(convert.engine_state_to_numpy(arr), 0))
    sim = te.simulate(ct, st, wl, pt, rounds=8, num_devices=1, device="cpu")
    assert sim.clock.dim() == 0


def test_array_runner_contract():
    """``make_array_runner`` refuses a single drive's state; donating a
    copy gives the undonated result and spares the caller's state."""
    (_, _, _), (ct, st, pt) = configs()
    wl = WORKLOADS["read"](False)
    with pytest.raises(ValueError, match="leading"):
        te.make_array_runner(ct, st, wl, pt, 1, device="cpu")(
            te.init_state(ct, st, wl, device="cpu"))
    state = te.init_array_state(ct, st, wl, 2, device="cpu")
    before = convert.engine_state_to_numpy(state)
    kept = te.make_array_runner(ct, st, wl, pt, 3, device="cpu")(state)
    donated = te.make_array_runner(ct, st, wl, pt, 3, donate=True,
                                   device="cpu")(te.unalias(state))
    assert not convert.leaf_differences(before,
                                        convert.engine_state_to_numpy(state))
    assert not convert.leaf_differences(
        convert.engine_state_to_numpy(kept),
        convert.engine_state_to_numpy(donated))
    assert float(te.aggregate_iops(kept)) == pytest.approx(
        float(kept.metrics.iops().sum()))
    cfg, ssd, m = array_4drive()
    assert (m, cfg.fetch_width, ssd.t_max_iops) == (4, 256, 40e6)


# -- every stage on shared inputs ----------------------------------------------

@pytest.fixture(scope="module")
def mid_array():
    """A kernel-flagged 70/30 array with data emulated after 4 rounds, and
    its next round's fetch: the shared inputs of every stage."""
    (_, _, _), (ct, st, pt) = configs(**FLAGS)
    wl = TMixed(io_depth=16, read_frac=0.7)
    s = te.run(te.init_array_state(ct, st, wl, M, device="cpu"), ct, st, wl,
               pt, 4)
    fetched = frontend.fetch(s.rings, s.clock, s.device.disp_time, ct, pt)
    return ct, st, pt, s, fetched


def _flatten(x):
    """The tensors of a nest of tuples, dataclasses and tensors, in
    order (``None`` left out)."""
    if x is None:
        return []
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _flatten(v)]
    if dataclasses.is_dataclass(x):
        return [t for f in dataclasses.fields(x)
                for t in _flatten(getattr(x, f.name))]
    return []


def _row(x, d):
    """Drive d of a nest of tuples, dataclasses and tensors."""
    if isinstance(x, torch.Tensor):
        return x[d]
    if isinstance(x, tuple):
        return tuple(_row(v, d) for v in x)
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: _row(getattr(x, f.name), d)
            for f in dataclasses.fields(x)})
    return x


def _same(arr_out, one_outs):
    flat = _flatten(arr_out)
    assert flat
    for d, one in enumerate(one_outs):
        ones = _flatten(one)
        assert len(ones) == len(flat)
        for a, b in zip(flat, ones):
            assert a.shape[1:] == b.shape and a.dtype == b.dtype
            np.testing.assert_array_equal(a[d].numpy(), b.numpy())


def _stage(name, ct, st, pt, s, fetched):
    """Stage ``name`` as a function of one drive's (or the array's) state
    and fetch."""
    pipe = DevicePipeline(ct, st, pt)
    unit = frontend.fetch_row_units(ct, "cpu")

    def call(s, f):
        rings, disp, batch, done = f
        dev = dataclasses.replace(s.device, disp_time=disp)
        if name == "fetch":
            return frontend.fetch(s.rings, s.clock, s.device.disp_time, ct,
                                  pt)
        if name == "process":
            return pipe.process(dev, batch, done, unit, s.cq,
                                ring_layout=True)
        if name == "timing":
            return timing.update(s.device.tstate, batch, st, ct.mode,
                                 use_compaction=True)
        if name == "per_request_timing":
            return timing.update(s.device.tstate, batch, st, "per_request")
        if name == "flash_stage":
            return flash.flash_stage(s.device.flash, batch, done, done + 3.0,
                                     st, use_counting_sort=True)
        if name == "flash_stage_kernel":
            return flash.flash_stage(s.device.flash, batch, done, done + 3.0,
                                     st, use_pallas_flash=True)
        if name == "dsa_workers":
            return datapath.dsa_worker_times(s.device.dsa_time, done, batch,
                                             ct, pt, st, unit=unit)
        if name == "baseline_workers":
            w = torch.zeros(s.device.dsa_time.shape + (4,))
            return datapath.baseline_worker_times(
                w, s.device.map_time, done, batch, ct, pt, st, unit=unit,
                use_counting_sort=True)
        if name == "apply_data":
            bufs = datapath.apply_reads(s.flash, s.bufs, batch, True)
            return bufs, datapath.apply_writes(s.flash, bufs, batch)
        if name == "post_and_reap":
            return qp.post_and_reap(s.cq, batch.sq_id, done, batch.req_id,
                                    batch.valid, ct.qp, fused_scatter=True,
                                    use_pallas_reap=True)
        if name == "submit_grouped":
            q = ct.num_sqs
            shape = batch.valid.shape[:-1] + (q, -1)
            return frontend.submit_grouped(
                rings, *(x.reshape(shape) for x in (
                    done, batch.opcode, batch.lba, batch.nblocks,
                    batch.buf_id, batch.req_id, batch.valid)),
                tenant=batch.tenants.reshape(shape), fused=True)
        raise KeyError(name)

    return call(s, fetched), [call(_row(s, d), _row(fetched, d))
                              for d in range(M)]


STAGES = ("fetch", "process", "timing", "per_request_timing", "flash_stage",
          "flash_stage_kernel", "dsa_workers", "baseline_workers",
          "apply_data", "post_and_reap", "submit_grouped")


@pytest.mark.parametrize("name", STAGES)
def test_stage_on_an_array_equals_each_drive_alone(mid_array, name):
    arr, ones = _stage(name, *mid_array)
    _same(arr, ones)


# -- the engine kernels over M drives in one call ------------------------------

def _per_drive_calls(fn, args, m):
    outs = [fn(*(a[d] for a in args)) for d in range(m)]
    return [torch.stack(x) for x in zip(*outs)] if isinstance(
        outs[0], tuple) else torch.stack(outs)


def _equal(got, want):
    for g, w in zip(got if isinstance(got, (list, tuple)) else [got],
                    want if isinstance(want, (list, tuple)) else [want]):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w.numpy())


def test_flat_seg_scan_equals_per_drive_scans():
    rng = np.random.default_rng(1)
    vals = torch.from_numpy(rng.normal(size=(4, 777)).astype(np.float32))
    heads = torch.from_numpy(rng.random((4, 777)) < 0.05)
    heads[2, 0] = False   # a drive whose first row is no head
    _equal(kops.seg_scan(vals, heads),
           _per_drive_calls(kops.seg_scan, (vals, heads), 4))


def test_flat_die_contention_equals_per_drive_folds():
    rng = np.random.default_rng(2)
    m, n, k = 3, 500, 16
    ready = torch.from_numpy(rng.integers(0, 50, (m, n)).astype(np.float32))
    cost = torch.from_numpy(rng.integers(1, 9, (m, n)).astype(np.float32))
    chip = torch.from_numpy(rng.integers(0, k, (m, n)).astype(np.int32))
    event = torch.from_numpy(rng.random((m, n)) < 0.4)
    busy = torch.from_numpy(rng.integers(0, 30, (m, k)).astype(np.float32))
    args = (ready, cost, chip, event, busy)
    _equal(kops.die_contention(*args),
           _per_drive_calls(kops.die_contention, args, m))


def _reap_args(m, q, d, n, seed, tail_lo=0):
    rng = np.random.default_rng(seed)
    rings = [torch.from_numpy(rng.random((m, q, d)).astype(np.float32)),
             torch.from_numpy(rng.random((m, q, d)).astype(np.float32)),
             torch.from_numpy(rng.integers(0, 99, (m, q, d)).astype(
                 np.int32))]
    tail = torch.from_numpy(rng.integers(tail_lo, tail_lo + 50, (m, q))
                            .astype(np.int32))
    valid = torch.from_numpy(rng.random((m, n)) < 0.7)
    key = torch.from_numpy(rng.integers(0, q, (m, n)).astype(np.int32))
    key = torch.where(valid, key, q)
    done = torch.from_numpy(rng.random((m, n)).astype(np.float32))
    rid = torch.from_numpy(rng.integers(0, 1 << 20, (m, n)).astype(np.int32))
    return rings + [tail, key, done, rid, valid]


def test_flat_fused_reap_equals_per_drive_posts():
    """Invalid rows everywhere and drive 1's tails next to the int32 wrap
    (tail + rank passes 2^31 and D = 6 does not divide 2^32)."""
    args = _reap_args(3, 4, 6, 200, 3)
    args[3][1] = 2 ** 31 - 3
    _equal(kops.fused_reap(*args),
           _per_drive_calls(kops.fused_reap, args, 3))


def test_flat_fused_reap_keeps_rows_in_their_drive():
    """Valid rows of drive 1 whose CQ key is out of range (negative, Q and
    beyond): each drive clips its keys into its own Q CQs, as a call of
    its own does, before the offset moves them into the flat rings."""
    args = _reap_args(3, 4, 6, 120, 4)
    key, valid = args[4], args[7]
    key[1, :40] = torch.tensor([-3, 4, 5, 9] * 10, dtype=torch.int32)
    valid[1, :40] = True
    args[3][1] = 2 ** 31 - 2
    _equal(kops.fused_reap(*args),
           _per_drive_calls(kops.fused_reap, args, 3))


def test_flat_block_gather_equals_per_drive_gathers():
    rng = np.random.default_rng(5)
    flash = torch.from_numpy(rng.random((3, 64, 16)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 64, (3, 300)).astype(np.int32))
    _equal(kops.block_gather(flash, idx),
           _per_drive_calls(kops.block_gather, (flash, idx), 3))


def test_flat_block_gather_wraps_and_clamps_per_drive():
    """Negative and out-of-range indices in drives 1 and 2: each wraps
    (a negative counts from its own drive's end) and clamps into its own
    drive's blocks, as a call of its own does."""
    flash = torch.arange(3 * 8 * 4, dtype=torch.float32).reshape(3, 8, 4)
    idx = torch.tensor([[0, 1, 2, 3, 4, 5],
                        [-1, -8, 8, 100, -100, 3],
                        [7, -2, 9, -9, 0, 12]], dtype=torch.int32)
    got = kops.block_gather(flash, idx)
    _equal(got, _per_drive_calls(kops.block_gather, (flash, idx), 3))
    assert torch.equal(got[1, 0], flash[1, 7]) and torch.equal(
        got[1, 3], flash[1, 7])
