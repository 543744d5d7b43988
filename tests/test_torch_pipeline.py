"""The pipeline stages of the port against the reference, one stage call
at a time from a shared state made with numpy from a seed.

Each test builds one input state and batch, hands identical copies to
the reference stage (jit-compiled, as the engine runs it) and to the
port's stage, and compares every output leaf: integer and bool leaves
exactly, float leaves bit-exactly unless the test states a ULP bound.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import datapath as jdp
from repro.core import device as jdev
from repro.core import epoch as jep
from repro.core import flash as jfl
from repro.core import frontend as jfe
from repro.core import qp as jqp
from repro.core import timing as jti
from repro.core import types as jt
from repro_torch.convert import leaf_differences
from repro_torch.core import datapath as tdp
from repro_torch.core import device as tdev
from repro_torch.core import epoch as tep
from repro_torch.core import flash as tfl
from repro_torch.core import frontend as tfe
from repro_torch.core import qp as tqp
from repro_torch.core import timing as tti
from repro_torch.core import types as tt
from port_threads import one_torch_thread  # noqa: F401

FUTURE_40M = dict(name="future-40m", t_max_iops=40e6, l_min_us=30.0,
                  n_instances=512, num_blocks=1 << 14)
INT_SSD = dict(t_max_iops=64e6, l_min_us=50.0, n_instances=64)


def flat(obj, prefix=""):
    """Path -> numpy for a (possibly nested) dataclass, tuple or array,
    from either package."""
    if obj is None:
        return {}
    if dataclasses.is_dataclass(obj):
        out = {}
        for f in dataclasses.fields(obj):
            if isinstance(getattr(obj, f.name), str):
                continue
            out.update(flat(getattr(obj, f.name), f"{prefix}{f.name}."))
        return out
    if isinstance(obj, (tuple, list)):
        out = {}
        for i, v in enumerate(obj):
            out.update(flat(v, f"{prefix}{i}."))
        return out
    if isinstance(obj, torch.Tensor):
        return {prefix.rstrip("."): obj.numpy()}
    return {prefix.rstrip("."): np.asarray(obj)}


def agree(ref, port, **bounds):
    bad = leaf_differences(flat(ref), flat(port), bounds)
    assert not bad, bad


def make_batch(rng, q, f, p_valid=0.8, p_write=0.3, integer=True,
               num_blocks=1 << 14, t0=100.0):
    """A SQ-major fetched batch of q*f rows (identical numpy for both)."""
    n = q * f
    arrival = rng.uniform(t0, t0 + 50, n)
    arrival = np.floor(arrival) if integer else arrival
    fields = dict(
        arrival=arrival.astype(np.float32),
        sq_id=np.repeat(np.arange(q), f).astype(np.int32),
        slot=rng.integers(0, 64, n).astype(np.int32),
        opcode=(rng.random(n) < p_write).astype(np.int32),
        lba=rng.integers(0, num_blocks, n).astype(np.int32),
        nblocks=np.ones(n, np.int32),
        buf_id=rng.integers(0, 32, n).astype(np.int32),
        req_id=rng.integers(0, 1 << 20, n).astype(np.int32),
        valid=rng.random(n) < p_valid,
        tenant=np.zeros(n, np.int32),
    )
    return fields


def batches(fields):
    jb = jt.RequestBatch(**{k: jnp.asarray(v) for k, v in fields.items()})
    tb = tt.RequestBatch(**{k: torch.from_numpy(v.copy())
                            for k, v in fields.items()})
    return jb, tb


def pair(x):
    x = np.asarray(x)
    return jnp.asarray(x), torch.from_numpy(x.copy())


# -- stage 2b: timing ----------------------------------------------------------

@pytest.mark.parametrize("ssd_kw,integer", [
    (INT_SSD, True), (FUTURE_40M, False), ({}, False),
    (dict(routing="lba_hash"), False),
])
@pytest.mark.parametrize("compact", [False, True])
def test_timing_update(ssd_kw, integer, compact):
    """1024 rows, up to 16 per scheduling instance, exact on every drive.
    On the fractional ones (FUTURE_40M's 12.8 us, the stock 25.9 us) the
    compiled reference contracts ``rank*sched`` and ``count*sched`` with
    the add that follows into a fused multiply-add, and so does the
    port."""
    rng = np.random.default_rng(len(ssd_kw) + compact)
    fields = make_batch(rng, 16, 64, integer=integer)
    jb, tb = batches(fields)
    jssd, tssd = jt.SSDConfig(**ssd_kw), tt.SSDConfig(**ssd_kw)
    k = jssd.n_instances
    busy = np.floor(rng.uniform(80, 160, k)).astype(np.float32)
    rr = np.int32(rng.integers(0, k))
    js = jt.TimingState(jnp.asarray(busy), jnp.asarray(rr))
    tsn = tt.TimingState(torch.from_numpy(busy.copy()), torch.tensor(rr))
    ref = jax.jit(lambda s, b: jti.update(s, b, jssd,
                                          use_compaction=compact))(js, jb)
    out = tti.update(tsn, tb, tssd, use_compaction=compact)
    agree(ref, out)


def test_timing_dispatch_order_permutes_rows():
    rng = np.random.default_rng(5)
    fields = make_batch(rng, 4, 8)
    jb, tb = batches(fields)
    ssd_j, ssd_t = jt.SSDConfig(**INT_SSD), tt.SSDConfig(**INT_SSD)
    perm = rng.permutation(32).astype(np.int32)
    js = jt.TimingState.init(64)
    tsn = tt.TimingState.init(64, "cpu")
    ref = jax.jit(lambda s_, b, d: jti.update(s_, b, ssd_j,
                                              dispatch_order=d))(
        js, jb, jnp.asarray(perm))
    out = tti.update(tsn, tb, ssd_t, dispatch_order=torch.from_numpy(perm))
    agree(ref, out)


# -- stage 2a: epoch and lock --------------------------------------------------

@pytest.mark.parametrize("layout", ["ring", "direct"])
def test_epoch_and_program_order_lock(layout):
    rng = np.random.default_rng(11)
    fields = make_batch(rng, 8, 4, integer=False)
    jb, tb = batches(fields)
    unit = np.repeat(np.arange(4), 8).astype(np.int32)
    ju, tu = pair(unit)
    ready = rng.uniform(0, 90, 32).astype(np.float32)
    jr, tr = pair(ready)
    je = jep.Epoch.from_batch(jb, jr, ju, layout)
    te = tep.Epoch.from_batch(tb, tr, tu, layout)
    agree((je.unit_counts(4), je.unit_ready(4)),
          (te.unit_counts(4), te.unit_ready(4)))
    cfg_j, cfg_t = jt.EngineConfig(num_units=4), tt.EngineConfig(num_units=4)
    lt = np.float32(37.5)
    ref = jax.jit(lambda lt_, e: jdev.acquire_lock(
        lt_, e, 4, cfg_j, jt.PlatformModel())[:2])(jnp.asarray(lt), je)
    out = tdev.acquire_lock(torch.tensor(lt), te, 4, cfg_t,
                            tt.PlatformModel())[:2]
    agree(ref, out)
    agree(je.admit(ref[1]).arrival, te.admit(out[1]).arrival)


# -- stage 1: frontend ---------------------------------------------------------

def rings_pair(rng, q, d, fill):
    z = np.zeros((q, d), np.int32)
    tail = rng.integers(0, fill + 1, q).astype(np.int32)
    head = (tail - rng.integers(0, fill + 1, q).clip(0, tail)).astype(np.int32)
    submit = np.sort(np.floor(rng.uniform(0, 40, (q, d))), axis=1)
    fields = dict(
        submit_time=submit.astype(np.float32),
        opcode=(rng.random((q, d)) < 0.3).astype(np.int32),
        lba=rng.integers(0, 1000, (q, d)).astype(np.int32),
        nblocks=np.ones((q, d), np.int32), buf_id=z + 3,
        req_id=rng.integers(0, 9999, (q, d)).astype(np.int32), tenant=z,
        head=head, tail=tail,
    )
    return (jfe.SQRings(**{k: jnp.asarray(v) for k, v in fields.items()}),
            tfe.SQRings(**{k: torch.from_numpy(v.copy())
                           for k, v in fields.items()}))


@pytest.mark.parametrize("fused", [False, True])
def test_submit_grouped(fused):
    rng = np.random.default_rng(2)
    q, f, d = 4, 8, 16
    jr, tr = rings_pair(rng, q, d, 12)
    sub = np.sort(rng.uniform(0, 9, (q, f)).astype(np.float32), axis=1)
    ints = [rng.integers(0, 99, (q, f)).astype(np.int32) for _ in range(5)]
    valid = rng.random((q, f)) < 0.6
    args = [sub, *ints, valid]
    ref = jfe.submit_grouped(jr, *map(jnp.asarray, args), fused=fused)
    out = tfe.submit_grouped(tr, *[torch.from_numpy(a.copy()) for a in args],
                             fused=fused)
    agree(ref, out)


@pytest.mark.parametrize("kw", [
    dict(), dict(dsa_fetch=False), dict(transport="host"),
    dict(coalesced=False), dict(num_units=2),
])
def test_fetch_distributed(kw):
    """Exact, except the CPU coalesced fetch cost
    ``cpu_coal_base_us + bytes * cpu_coal_byte_us``, which the compiled
    reference contracts into an FMA: 1 ULP on the dispatcher cursors and
    fetch times there."""
    rng = np.random.default_rng(3)
    q, d, f = 8, 32, 8
    cfg_kw = dict(num_sqs=q, sq_depth=d, fetch_width=f, **kw)
    cj, ct = jt.EngineConfig(**cfg_kw), tt.EngineConfig(**cfg_kw)
    jr, tr = rings_pair(rng, q, d, 24)
    u = cj.num_units
    disp = rng.uniform(0, 30, u).astype(np.float32)
    clock = np.float32(20.0)
    ref = jax.jit(lambda r, c, dt: jfe.fetch(r, c, dt, cj, jt.PlatformModel()))(
        jr, jnp.asarray(clock), jnp.asarray(disp))
    out = tfe.fetch(tr, torch.tensor(clock), torch.from_numpy(disp), ct,
                    tt.PlatformModel())
    fma = {"1": 1, "3": 1} if kw.get("dsa_fetch") is False else {}
    agree(ref, out, **fma)
    agree(jfe.fetch_row_units(cj), tfe.fetch_row_units(ct, "cpu"))


# -- stage 3: data path --------------------------------------------------------

def test_apply_reads_and_writes_with_duplicate_destinations():
    """Many rows share a buffer row and many writes share an LBA: the last
    valid row for each destination wins, as in the reference's scatter."""
    rng = np.random.default_rng(4)
    n, nb, nbuf, w = 64, 12, 5, 4
    fields = make_batch(rng, 8, 8, p_write=0.5, num_blocks=nb)
    fields["buf_id"] = rng.integers(0, nbuf, n).astype(np.int32)
    jb, tb = batches(fields)
    flash = rng.uniform(0, 9, (nb, w)).astype(np.float32)
    bufs = rng.uniform(0, 9, (nbuf, w)).astype(np.float32)
    jf, tf = pair(flash)
    jbu, tbu = pair(bufs)
    assert len(np.unique(fields["buf_id"])) < n  # duplicates present
    for use_pallas in (False, True):
        rb = jdp.apply_reads(jf, jbu, jb, use_pallas=use_pallas)
        ob = tdp.apply_reads(tf, tbu, tb, use_pallas=use_pallas)
        agree(rb, ob)
    agree(jdp.apply_writes(jf, rb, jb), tdp.apply_writes(tf, ob, tb))


@pytest.mark.parametrize("integer", [True, False])
def test_dsa_worker_times(integer):
    rng = np.random.default_rng(6)
    fields = make_batch(rng, 8, 16, integer=integer)
    jb, tb = batches(fields)
    cfg_kw = dict(num_sqs=8, sq_depth=64, fetch_width=16, num_units=4)
    cj, ct = jt.EngineConfig(**cfg_kw), tt.EngineConfig(**cfg_kw)
    dsa = rng.uniform(90, 140, 4).astype(np.float32)
    unit = np.repeat(np.arange(4), 32).astype(np.int32)
    plat_j, plat_t, ssd_j, ssd_t = (jt.PlatformModel(), tt.PlatformModel(),
                                    jt.SSDConfig(), tt.SSDConfig())
    ref = jax.jit(lambda d, a, b, u: jdp.dsa_worker_times(
        d, a, b, cj, plat_j, ssd_j, unit=u))(
        jnp.asarray(dsa), jb.arrival, jb, jnp.asarray(unit))
    out = tdp.dsa_worker_times(torch.from_numpy(dsa), tb.arrival, tb, ct,
                               plat_t, ssd_t, unit=torch.from_numpy(unit))
    agree(ref, out)


@pytest.mark.parametrize("counting,rank_given,pallas", [
    (False, False, False), (True, True, False), (True, True, True),
])
def test_baseline_worker_times(counting, rank_given, pallas):
    rng = np.random.default_rng(8)
    fields = make_batch(rng, 8, 16)
    jb, tb = batches(fields)
    cfg_kw = dict(num_sqs=8, sq_depth=64, fetch_width=16, num_units=4,
                  workers_per_unit=3, batched_datapath=False,
                  use_pallas_segscan=pallas)
    cj, ct = jt.EngineConfig(**cfg_kw), tt.EngineConfig(**cfg_kw)
    plat = dict(per_req_map_us=3.0, txn_base_us=1.0,
                link_bytes_per_us=512.0)
    work = np.floor(rng.uniform(90, 140, (4, 3))).astype(np.float32)
    unit = np.repeat(np.arange(4), 32).astype(np.int32)
    rank = np.tile(np.arange(32), 4).astype(np.int32) if rank_given else None
    mt = np.float32(120.0)

    def jrun(w, m, a, b):
        return jdp.baseline_worker_times(
            w, m, a, b, cj, jt.PlatformModel(**plat), jt.SSDConfig(),
            unit=jnp.asarray(unit),
            unit_rank=None if rank is None else jnp.asarray(rank),
            use_counting_sort=counting)

    ref = jax.jit(jrun)(jnp.asarray(work), jnp.asarray(mt), jb.arrival, jb)
    out = tdp.baseline_worker_times(
        torch.from_numpy(work), torch.tensor(mt), tb.arrival, tb, ct,
        tt.PlatformModel(**plat), tt.SSDConfig(),
        unit=torch.from_numpy(unit),
        unit_rank=None if rank is None else torch.from_numpy(rank),
        use_counting_sort=counting)
    agree(ref, out)


# -- stage 4: flash ------------------------------------------------------------

def flash_states(rng, ssd_j, ssd_t, preconditioned):
    k = ssd_j.num_chips
    chip = np.floor(rng.uniform(50, 200, k)).astype(np.float32)
    free = np.float32(ssd_j.phys_pages * (0.021 if preconditioned else 0.9))
    valid = np.float32(ssd_j.num_blocks * (0.98 if preconditioned else 0.1))
    vals = dict(chip_busy=chip, free_pages=free, valid_pages=valid,
                io_seq=np.int32(77), prog_seq=np.int32(5),
                gc_count=np.float32(2.0))
    return (jfl.FlashState(**{k_: jnp.asarray(v) for k_, v in vals.items()}),
            tfl.FlashState(**{k_: torch.tensor(v) for k_, v in vals.items()}))


@pytest.mark.parametrize("layout", ["sort", "counting", "kernel"])
@pytest.mark.parametrize("gc", [False, True])
def test_flash_stage(layout, gc):
    """Writes, mapping misses and (with ``gc``) a drive below its GC
    watermark, in each of the three die-contention layouts, on integer
    timestamps; the fractional GC page arithmetic is exact too."""
    rng = np.random.default_rng(12)
    ssd_kw = dict(num_blocks=4096, mapping_hit_rate=0.8,
                  num_channels=4, chips_per_channel=2)
    ssd_j, ssd_t = jt.SSDConfig(**ssd_kw), tt.SSDConfig(**ssd_kw)
    fields = make_batch(rng, 8, 16, p_write=0.4, num_blocks=4096)
    jb, tb = batches(fields)
    fj, ft = flash_states(rng, ssd_j, ssd_t, gc)
    target = (fields["arrival"] + np.floor(rng.uniform(20, 60, 128))).astype(
        np.float32)
    jtg, ttg = pair(target)
    kw = dict(use_pallas=layout != "sort",
              use_counting_sort=layout == "counting",
              use_pallas_flash=layout == "kernel")
    ref = jax.jit(lambda f, b, a, tg: jfl.flash_stage(
        f, b, a, tg, ssd_j, **kw))(fj, jb, jb.arrival, jtg)
    out = tfl.flash_stage(ft, tb, tb.arrival, ttg, ssd_t, **kw)
    if gc:
        assert float(ref[0].gc_count) > 2.0  # the watermark was crossed
    agree(ref, out)


# -- stage 5: completion queues ------------------------------------------------

@pytest.mark.parametrize("variant", ["rank", "plan_fused", "kernel"])
def test_post_and_reap_neutral(variant):
    rng = np.random.default_rng(13)
    q, d, f = 8, 16, 8
    fields = make_batch(rng, q, f)
    valid = fields["valid"]
    done = rng.uniform(0, 1e3, q * f).astype(np.float32)
    vals = dict(
        done_time=rng.uniform(0, 9, (q, d)).astype(np.float32),
        visible_time=rng.uniform(0, 9, (q, d)).astype(np.float32),
        req_id=rng.integers(0, 99, (q, d)).astype(np.int32),
        head=rng.integers(0, 40, q).astype(np.int32),
        tail=rng.integers(0, 40, q).astype(np.int32),
        bell_time=np.zeros(q, np.float32),
    )
    jc = jqp.CQRings(**{k: jnp.asarray(v) for k, v in vals.items()})
    tc = tqp.CQRings(**{k: torch.from_numpy(v.copy()) for k, v in vals.items()})
    kw_j, kw_t = {}, {}
    if variant == "plan_fused":
        from repro.core import segops as js
        from repro_torch.core import segops as tsg

        jv, tv = pair(valid)
        kw_j = dict(posted_rank=js.block_masked_rank(jv, f),
                    posted_counts=js.block_counts(jv, f), fused_scatter=True)
        kw_t = dict(posted_rank=tsg.block_masked_rank(tv, f),
                    posted_counts=tsg.block_counts(tv, f), fused_scatter=True)
    if variant == "kernel":
        kw_j = kw_t = dict(use_pallas_reap=True)
    args = [fields["sq_id"], done, fields["req_id"], valid]
    ref = jqp.post_and_reap(jc, *map(jnp.asarray, args), jt.QPConfig(),
                            **kw_j)
    out = tqp.post_and_reap(tc, *[torch.from_numpy(a.copy()) for a in args],
                            tt.QPConfig(), **kw_t)
    agree(ref, out)


# -- stages 2-5: one DevicePipeline.process call -------------------------------

def device_states(rng, cfg, ssd):
    u, w = cfg.num_units, cfg.workers_per_unit
    k = ssd.n_instances
    vals = {
        "tstate.busy_until": np.floor(rng.uniform(50, 150, k)),
        "tstate.rr": np.int32(rng.integers(0, k)),
        "disp_time": np.floor(rng.uniform(40, 90, u)),
        "work_time": np.floor(rng.uniform(40, 90, (u, w))),
        "dsa_time": np.floor(rng.uniform(40, 90, u)),
        "lock_time": np.float32(61.0), "map_time": np.float32(70.0),
        "flash.chip_busy": np.floor(rng.uniform(50, 200, ssd.num_chips)),
        "flash.free_pages": np.float32(ssd.phys_pages * 0.9),
        "flash.valid_pages": np.float32(100.0),
        "flash.io_seq": np.int32(9), "flash.prog_seq": np.int32(3),
        "flash.gc_count": np.float32(0.0),
        "fabric.tx_busy": np.zeros(1), "fabric.rx_busy": np.zeros(1),
        "fabric.switch_tx": np.zeros(1), "fabric.switch_rx": np.zeros(1),
    }
    vals = {p: np.asarray(v, np.int32 if np.asarray(v).dtype == np.int32
                          else np.float32) for p, v in vals.items()}

    def build(mod_state, mk):
        def sub(prefix, cls):
            kw = {}
            for f in dataclasses.fields(cls):
                p = prefix + f.name
                kw[f.name] = mk(vals[p])
            return cls(**kw)

        return mod_state(
            tstate=sub("tstate.", jt.TimingState if mk is jnp.asarray
                       else tt.TimingState),
            disp_time=mk(vals["disp_time"]), work_time=mk(vals["work_time"]),
            dsa_time=mk(vals["dsa_time"]), lock_time=mk(vals["lock_time"]),
            map_time=mk(vals["map_time"]),
            flash=sub("flash.", jfl.FlashState if mk is jnp.asarray
                      else tfl.FlashState),
            fabric=sub("fabric.", jdev.FabricState if mk is jnp.asarray
                       else tdev.FabricState),
        )

    return (build(jdev.DeviceState, jnp.asarray),
            build(tdev.DeviceState, lambda v: torch.from_numpy(v.copy())))


@pytest.mark.parametrize("name,kw", [
    ("dsa", dict()),
    ("dsa_uncompacted", dict(use_compaction=False, use_sort_plan=False)),
    ("baseline", dict(batched_datapath=False)),
    ("baseline_kernels", dict(batched_datapath=False, use_pallas_segscan=True,
                              use_pallas_flash=True, use_pallas_reap=True)),
])
def test_device_process(name, kw):
    """One full pipeline pass from a shared DeviceState and CQ. The DSA
    datapath carries fractional costs, which both sides compute with the
    same combine tree and roundings: every leaf is exact."""
    rng = np.random.default_rng(21)
    q, f = 8, 16
    cfg_kw = dict(num_sqs=q, sq_depth=64, fetch_width=f, num_units=4,
                  workers_per_unit=2, **kw)
    ssd_kw = dict(INT_SSD, mapping_hit_rate=0.9)
    plat_kw = dict(per_req_map_us=3.0, txn_base_us=1.0,
                   link_bytes_per_us=512.0, lock_per_batch_us=1.0)
    cj, ct = jt.EngineConfig(**cfg_kw), tt.EngineConfig(**cfg_kw)
    sj, st = jt.SSDConfig(**ssd_kw), tt.SSDConfig(**ssd_kw)
    pj, pt = jt.PlatformModel(**plat_kw), tt.PlatformModel(**plat_kw)
    dj, dt = device_states(rng, cj, sj)
    fields = make_batch(rng, q, f, num_blocks=sj.num_blocks)
    jb, tb = batches(fields)
    fetch = np.floor(rng.uniform(60, 120, q * f)).astype(np.float32)
    jf, tf = pair(fetch)
    unit = np.repeat(np.arange(4), q * f // 4).astype(np.int32)
    ju, tu = pair(unit)
    jcq = jqp.CQRings.empty(q, 64)
    tcq = tqp.CQRings.empty(q, 64, "cpu")
    ref = jax.jit(lambda d, b, fd, u, c: jdev.DevicePipeline(
        cj, sj, pj).process(d, b, fd, u, c, ring_layout=True))(
        dj, jb, jf, ju, jcq)
    out = tdev.DevicePipeline(ct, st, pt).process(dt, tb, tf, tu, tcq,
                                                  ring_layout=True)
    agree(ref, out)
