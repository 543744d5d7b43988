"""Each of the sanitizer's fifteen checks, made to fire, in the port against
the reference's checkify.

One clean sanitized pass of ``DevicePipeline.process`` (the ready-time
lock, so the admission permutation is checked too, and the compacted ring
layout, so the per-CQ counts are) gives the values the checks observe:
the state before and after, the batch, the pass's result, the dispatch
order and the per-CQ counts. Both packages' passes are held equal on
them first. Then one fault is planted into those values (a row's SQ id,
a negative arrival, a cursor in the state before the pass moved past the
one after, a dispatch order that is no permutation, per-CQ counts off by
one, ...) and both packages' ``_sanitize_checks`` run on the same
values: the port must set exactly the bits named for the fault, on one
drive and on a 2-drive stack whose drive 1 alone holds it, and its
``SanitizeError`` must carry the message that the reference's checkify
reports. A fault with no bit named must leave both silent.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import checkify

from repro.core import device as jdev
from repro.core import engine as je
from repro.core import segops as jseg
from repro.core import types as jt
from repro_torch import convert
from repro_torch.core import device as tdev
from repro_torch.core import engine as te
from repro_torch.core import frontend as tfe
from repro_torch.core import segops as tseg
from repro_torch.core import types as tt
from test_torch_engine import SMALL
from test_torch_pipeline import flat
from port_threads import one_torch_thread  # noqa: F401

KW = dict(SMALL, num_units=4, sanitize=True, lock_order="ready_time")
WL = dict(io_depth=8, read_frac=0.8)  # half of each SQ's fetch is valid
WARM = 1  # round before the observed pass
ARGS = ("prev", "new", "batch", "res", "dispatch_order", "cq_counts")


def first_row(ctx, valid):
    return int(np.flatnonzero(ctx["valid"] == valid)[0])


def at_row(value, valid=True):
    """Set one valid (or invalid) row to ``value``."""
    def fn(a, ctx):
        a[first_row(ctx, valid)] = value
        return a
    return fn


def shift(by):
    def fn(a, ctx):
        return np.asarray(a + np.asarray(by, a.dtype))
    return fn


def reorder(kind):
    """A dispatch order that is no permutation, in one of four ways."""
    def fn(a, ctx):
        valid, n = ctx["valid"], a.shape[-1]
        if kind == "duplicate":    # one invalid row twice: same sum
            j, k = np.flatnonzero(~valid[a])[:2]
            a[k] = a[j]
        elif kind == "drop_valid":  # a valid row's place given to another
            k = int(np.flatnonzero(valid[a])[0])
            a[k] = first_row(ctx, False)
        else:                       # row n-1 read as n (clamped) or -1
            k = int(np.flatnonzero(a == n - 1)[0])
            a[k] = n if kind == "past_end" else -1
        return a
    return fn


def bump_first(a, ctx):
    a[0] += 1
    return a


def corrupt_plan(kind):
    """A compaction plan on the last drive made wrong (``pos`` not a
    permutation, or ``n_valid`` one too many)."""
    def fn(plan, to):
        pos, nv = np.array(plan.pos), np.array(plan.n_valid)
        if kind == "pos":
            last = pos.reshape(-1, pos.shape[-1])[-1]
            last[1] = last[0]
        else:
            nv.reshape(-1)[-1] += 1
        return dataclasses.replace(plan, pos=to(pos), n_valid=to(nv))
    return fn


# name -> (argument path, fault, the bits it must set)
FAULTS = {
    "clean": (None, None, ()),
    "sq_id_past_num_sqs": (("batch", "sq_id"), at_row(KW["num_sqs"] + 3),
                           (0,)),
    "sq_id_negative": (("batch", "sq_id"), at_row(-1), (0,)),
    "sq_id_on_invalid_row": (("batch", "sq_id"),
                             at_row(KW["num_sqs"] + 3, valid=False), ()),
    "slot_past_depth": (("batch", "slot"), at_row(KW["sq_depth"]), (1,)),
    "arrival_negative": (("res", "arrival"), at_row(-1.0), (2,)),
    "target_before_arrival": (("res", "target"), at_row(-1.0), (3,)),
    "ready_before_arrival": (("res", "ready"), at_row(-1.0), (4,)),
    "flash_done_negative": (("res", "flash_done"), at_row(-1.0), (5,)),
    "reaped_before_done": (("res", "reaped"), at_row(-1.0), (6,)),
    "disp_time_backwards": (("prev", "disp_time"), shift(1e6), (7,)),
    "lock_time_backwards": (("prev", "lock_time"), shift(1e6), (7,)),
    "dispatch_duplicate": (("dispatch_order",), reorder("duplicate"), (8,)),
    "dispatch_drops_valid_row": (("dispatch_order",),
                                 reorder("drop_valid"), (8, 9)),
    "dispatch_past_end": (("dispatch_order",), reorder("past_end"), (8,)),
    "dispatch_negative_from_end": (("dispatch_order",),
                                   reorder("negative"), ()),
    "compaction_pos_duplicate": ("compact_epoch", corrupt_plan("pos"),
                                 (10,)),
    "compaction_count_drift": ("compact_epoch", corrupt_plan("n_valid"),
                               (10,)),
    "cq_counts_off_by_one": (("cq_counts",), bump_first, (11,)),
    "free_pages_negative": (("new", "flash", "free_pages"), shift(-1e12),
                            (12,)),
    "valid_pages_negative": (("new", "flash", "valid_pages"), shift(-1e12),
                             (12,)),
    "chip_busy_backwards": (("prev", "flash", "chip_busy"), shift(1e6),
                            (13,)),
    **{f"{leaf}_backwards": (("prev", "fabric", leaf), shift(1e6), (14,))
       for leaf in ("tx_busy", "rx_busy", "switch_tx", "switch_rx")},
}


def plant(obj, path, fn, to, ctx):
    """``obj`` with the leaf at ``path`` replaced by ``fn`` of a numpy copy
    of it."""
    if not path:
        return to(fn(np.array(obj), ctx))
    if isinstance(obj, dict):
        return {**obj, path[0]: plant(obj[path[0]], path[1:], fn, to, ctx)}
    return dataclasses.replace(
        obj, **{path[0]: plant(getattr(obj, path[0]), path[1:], fn, to, ctx)})


def stack(a, b):
    """Two drives' values as one 2-drive array's."""
    if a is None:
        return None
    if dataclasses.is_dataclass(a):
        return dataclasses.replace(a, **{
            f.name: stack(getattr(a, f.name), getattr(b, f.name))
            for f in dataclasses.fields(a)})
    return torch.stack([a, b])


def recorder(seen):
    def record(cfg, prev, new, batch, res, dispatch_order, cq_counts,
               *flags):
        seen.update(zip(ARGS, (prev, new, batch, res, dispatch_order,
                               cq_counts)))
    return record


@pytest.fixture(scope="module")
def observed():
    """What one clean sanitized pass's checks observe, in each package:
    the reference's pass run through ``jax.jit`` on the port's fetched
    batch."""
    cj, ct = jt.EngineConfig(**KW), tt.EngineConfig(**KW)
    ssd, pt, twl = tt.SSDConfig(), tt.PlatformModel(), tt.WorkloadConfig(**WL)
    plain = ct.replace(sanitize=False)
    st = te.make_runner(plain, ssd, twl, pt, WARM, device="cpu")(
        te.init_state(plain, ssd, twl, device="cpu"))
    unit = tfe.fetch_row_units(ct, "cpu")
    _, disp, batch, fetch_done = tfe.fetch(st.rings, st.clock,
                                           st.device.disp_time, ct, pt)
    dev = dataclasses.replace(st.device, disp_time=disp)
    batch = dataclasses.replace(batch, arrival=fetch_done)
    port = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tdev, "_sanitize_checks", recorder(port))
        tdev.DevicePipeline(ct, ssd, pt).process(
            dev, batch, fetch_done, unit, st.cq, ring_layout=True,
            flags=tdev.new_flags("cpu"))

    jplain, jwl = cj.replace(sanitize=False), jt.WorkloadConfig(**WL)
    jst = je.make_runner(jplain, jt.SSDConfig(), jwl, jt.PlatformModel(),
                         WARM)(je.init_state(jplain, jt.SSDConfig(), jwl))
    jpipe = jdev.DevicePipeline(cj, jt.SSDConfig(), jt.PlatformModel())
    jdv = dataclasses.replace(jst.device, disp_time=jnp.asarray(disp.numpy()))
    jb = jt.RequestBatch(**{f.name: jnp.asarray(getattr(batch, f.name).numpy())
                            for f in dataclasses.fields(batch)})

    def go(b):
        seen = {}
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jdev, "_sanitize_checks", recorder(seen))
            jpipe.process(jdv, b, jnp.asarray(fetch_done.numpy()),
                          jnp.asarray(unit.numpy()), jst.cq,
                          ring_layout=True)
        return seen

    ref = jax.jit(go)(jb)
    return cj, ct, ref, port


def test_both_passes_observe_the_same_values(observed):
    """The planted faults start from equal values: the clean pass's
    observed leaves agree bit for bit, and the pass has valid and invalid
    rows, a dispatch order and per-CQ counts to plant into."""
    _, _, ref, port = observed
    assert not convert.leaf_differences(flat(tuple(ref[k] for k in ARGS)),
                                        flat(tuple(port[k] for k in ARGS)))
    valid = port["batch"].valid.numpy()
    assert valid.any() and not valid.all()
    assert port["dispatch_order"] is not None
    assert port["cq_counts"] is not None


def port_bits(ct, args, plan_fault):
    flags = tdev.new_flags("cpu")
    with pytest.MonkeyPatch.context() as mp:
        if plan_fault is not None:
            orig = tseg.compact_epoch
            mp.setattr(tseg, "compact_epoch", lambda v: plan_fault(
                orig(v), torch.from_numpy))
        tdev._sanitize_checks(ct, *(args[k] for k in ARGS), flags)
    return int(flags)


@pytest.mark.parametrize("name", list(FAULTS))
def test_planted_fault_sets_its_bit(observed, name):
    cj, ct, ref, port = observed
    path, fault, bits = FAULTS[name]
    ctx = {"valid": port["batch"].valid.numpy()}
    plan_fault = fault if path == "compact_epoch" else None
    if path is None or plan_fault is not None:
        bad_port, bad_ref = port, ref
    else:
        bad_port = plant(port, path, fault, torch.from_numpy, ctx)
        bad_ref = plant(ref, path, fault, jnp.asarray, ctx)
    want = sum(1 << b for b in bits)

    assert port_bits(ct, bad_port, plan_fault) == want
    pair = {k: stack(port[k], bad_port[k]) for k in ARGS}
    assert port_bits(ct, pair, plan_fault) == want

    with pytest.MonkeyPatch.context() as mp:
        if plan_fault is not None:  # built outside the checkify trace
            plan = plan_fault(jseg.compact_epoch(bad_ref["batch"].valid),
                              jnp.asarray)
            mp.setattr(jseg, "compact_epoch", lambda v: plan)
        err, _ = checkify.checkify(
            lambda a: jdev._sanitize_checks(cj, *(a[k] for k in ARGS)),
            errors=checkify.user_checks)(bad_ref)
    if not want:
        assert err.get() is None, err.get()
        return
    assert err.get() is not None
    assert str(tdev.SanitizeError(want)) in str(err.get())


def test_eager_run_and_direct_submit_check_their_own_flags():
    """``run`` and ``_submit_direct`` with ``cfg.sanitize`` make their own
    flags and raise nothing on a clean run, and change no bit of it."""
    ct = tt.EngineConfig(**KW)
    ssd, pt, twl = tt.SSDConfig(), tt.PlatformModel(), tt.WorkloadConfig(**WL)
    plain = ct.replace(sanitize=False)
    st = te.init_state(plain, ssd, twl, device="cpu")
    runs = [te.run(st, c, ssd, twl, pt, 2) for c in (plain, ct)]
    assert not convert.leaf_differences(
        *(convert.engine_state_to_numpy(r) for r in runs))
    rng = np.random.default_rng(0)
    b = tdev.make_direct_batch(
        torch.from_numpy(rng.integers(0, 1 << 12, 256).astype(np.int32)),
        torch.from_numpy((10 + 5 * rng.random(256)).astype(np.float32)),
        torch.from_numpy(rng.random(256) < 0.8))
    outs = []
    for c in (plain, ct):
        p = tdev.DevicePipeline(c, ssd, pt)
        outs.append(flat(p._submit_direct(p.init_state("cpu"), b)))
    assert not convert.leaf_differences(*outs)
