"""The engine's last variants in the port against the reference: the local
timing scope (``timing.local_scope_update`` and the pipeline's local
branches), the ring-less direct path (``frontend.direct_fetch_times``,
``DevicePipeline._fetch_direct``/``_submit_direct``,
``make_direct_batch``) and the sanitizer (``EngineConfig.sanitize``).

Per stage call on a shared input, the reference run through ``jax.jit``:
every leaf bit-exact. The local scope runs on a drive whose per-unit
``sched`` is fractional, and each case also shows that rounding the
timing core's three products apart from their adds would differ from the
reference there, so the fused products are pinned by these inputs. The
direct path's fetch times fuse both of their products the same way
(``frontend.direct_fetch_times``). Closed loops hold every leaf equal but
the metric sums, within ``SUM_ULP`` (the per-tenant sum within its
recursion's bound, ``test_torch_fabric.assert_states_agree``). A
sanitized run must raise nothing and leave every leaf of the unsanitized
run's state as it was, and a batch with an out-of-range SQ id must set
the flag whose message names it.
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
from repro.core import frontend as jfe
from repro.core import timing as jti
from repro.core import types as jt
from repro_torch import convert
from repro_torch.cuda_graph import map_leaves
from repro_torch.core import device as tdev
from repro_torch.core import engine as te
from repro_torch.core import frontend as tfe
from repro_torch.core import timing as tti
from repro_torch.core import types as tt
from test_torch_engine import SMALL, jleaves
from test_torch_fabric import assert_states_agree
from test_torch_pipeline import flat
from port_threads import one_torch_thread  # noqa: F401

D7 = dict(t_max_iops=2.47e6, l_min_us=50.0, n_instances=64)  # fractional
WL = dict(io_depth=16, read_frac=0.8)
ROUNDS = 6

# The four families of tests/test_sanitize.py: the baseline datapath, a
# switched remote fabric with WFQ, a coalescing QP and a cache.
FAMILIES = {
    "baseline_dp": dict(batched_datapath=False),
    "remote_qos": dict(fabric=dict(
        remote=True, tx_bytes_per_us=10_000.0, rx_bytes_per_us=10_000.0,
        rtt_us=2.0, wire_txn_us=0.1, mtu_batch=4, mtu_timeout_us=5.0,
        switch_bytes_per_us=20_000.0, switch_fanin=4,
        qos_weights=(2.0, 1.0))),
    "qp_coalesced": dict(qp=dict(
        cq_coalesce_n=4, cq_coalesce_us=5.0, cq_doorbell_us=0.2,
        cq_poll_us=0.1, cqe_reap_us=0.05)),
    "cached": dict(cache=dict(
        enabled=True, num_sets=8, ways=2, chase=2, readahead=1)),
}


def family(name, **kw):
    """(reference, port) EngineConfig of a family at ``SMALL``."""
    out = []
    for pkg in (jt, tt):
        f = dict(FAMILIES[name])
        for key, cls in (("fabric", pkg.FabricConfig), ("qp", pkg.QPConfig),
                         ("cache", pkg.CacheConfig)):
            if key in f:
                f[key] = cls(**f[key])
        out.append(pkg.EngineConfig(**SMALL, **f, **kw))
    return out


def unfused(a, b, c):
    return a * b + c


# -- the local timing scope ----------------------------------------------------

@pytest.mark.parametrize("units", [2, 4, 8])
@pytest.mark.parametrize("compact", [False, True])
def test_local_scope_update(units, compact, monkeypatch):
    """2048 unit-major rows on a 64-instance drive at 2.47e6 IOPS (each
    unit's ``sched`` 25.9 us, fractional), from a shared fractional state:
    completions, cursors and unit 0's round-robin cursor bit-exact with
    the compiled reference. The same call with the products rounded on
    their own differs, so the inputs pin the fused ones. Two drives
    stacked on a leading axis give each drive's own numbers."""
    rng = np.random.default_rng(units * 2 + compact)
    n, k = 2048, D7["n_instances"]
    arr = (rng.random((2, n)) * 300).astype(np.float32)
    valid = rng.random((2, n)) < 0.8
    busy = (rng.random((2, k)) * 300).astype(np.float32)
    rr = rng.integers(0, k, 2).astype(np.int32)
    sj, st = jt.SSDConfig(**D7), tt.SSDConfig(**D7)

    def port(d=slice(None)):
        state = tt.TimingState(torch.from_numpy(busy[d].copy()),
                               torch.from_numpy(np.array(rr[d])))
        s, c = tti.local_scope_update(
            state, torch.from_numpy(arr[d].copy()),
            torch.from_numpy(valid[d].copy()), st, units, compact)
        return {"busy": s.busy_until.numpy(), "rr": s.rr.numpy(),
                "comp": c.numpy()}

    call = jax.jit(lambda b, r, a, v: jti.local_scope_update(
        jt.TimingState(b, r), a, v, sj, units, use_compaction=compact))
    both = port()
    for d in range(2):
        s, c = call(busy[d], rr[d], arr[d], valid[d])
        ref = {"busy": np.asarray(s.busy_until), "rr": np.asarray(s.rr),
               "comp": np.asarray(c)}
        got = port(d)
        assert not convert.leaf_differences(ref, got)
        assert not convert.leaf_differences(
            ref, {key: v[d] for key, v in both.items()})
        monkeypatch.setattr(tti, "_fma32", unfused)
        assert convert.leaf_differences(ref, port(d))
        monkeypatch.undo()


def skewed(pkg, eng, cfg, ssd, device=None):
    """tests/test_engine.py's skewed load: io_depth 256 prefilled, every
    SQ but SQ 0 emptied, then 48 rounds at io_depth 1."""
    kw = {} if device is None else dict(device=device)
    st = eng.init_state(cfg, ssd, pkg.WorkloadConfig(io_depth=256), **kw)
    r = st.rings
    if device is None:
        rings = dataclasses.replace(
            r, submit_time=r.submit_time.at[1:].set(3e38),
            tail=r.tail.at[1:].set(r.head[1:]))
    else:
        tail = r.tail.clone()
        tail[1:] = r.head[1:]
        submit = r.submit_time.clone()
        submit[1:] = 3e38
        rings = dataclasses.replace(r, submit_time=submit, tail=tail)
    st = dataclasses.replace(st, rings=rings)
    return eng.make_runner(cfg, ssd, pkg.WorkloadConfig(io_depth=1),
                           pkg.PlatformModel(), 48, **kw)(st)


@pytest.mark.parametrize("scope", ["global", "local"])
def test_skewed_load_by_timing_scope(scope):
    """All load on SQ 0 of 8 (one unit of 8): every leaf of the final
    state equal to the reference's but the metric sums (``SUM_ULP``); the
    global scope sustains more than twice the local one's IOPS, as the
    reference's test_engine.py demands."""
    kw = dict(num_sqs=8, sq_depth=256, fetch_width=64, num_units=8,
              workers_per_unit=2, num_bufs=512, emulate_data=False)
    ssd_kw = dict(t_max_iops=1e7, l_min_us=30.0, n_instances=64,
                  num_blocks=1 << 12)
    out = {}
    for sc in ("global", "local"):
        cj = jt.EngineConfig(**kw, timing_scope=sc)
        ct = tt.EngineConfig(**kw, timing_scope=sc)
        if sc == scope:
            ref = jleaves(skewed(jt, je, cj, jt.SSDConfig(**ssd_kw)))
        out[sc] = skewed(tt, te, ct, tt.SSDConfig(**ssd_kw), "cpu")
    got = convert.engine_state_to_numpy(out[scope])
    assert_states_agree(ref, got)
    g, loc = (float(out[s].metrics.iops()) for s in ("global", "local"))
    assert g > 2 * loc, (g, loc)


# -- the ring-less direct path -------------------------------------------------

DIRECT_ROWS = 1024


def direct_inputs(name, seed, n=DIRECT_ROWS):
    rng = np.random.default_rng(seed)
    tenants = 2 if name == "remote_qos" else 1
    return dict(
        lba=rng.integers(0, 1 << 14, n).astype(np.int32),
        t=(100.0 + rng.random(n) * 40).astype(np.float32),
        valid=rng.random(n) < 0.85,
        opcode=(rng.random(n) < 0.3).astype(np.int32),
        nblocks=rng.integers(1, 3, n).astype(np.int32),
        tenant=rng.integers(0, tenants, n).astype(np.int32),
    )


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_direct_path(name):
    """``make_direct_batch``, ``direct_fetch_times``, ``_fetch_direct`` and
    two chained ``_submit_direct`` calls (the second from the first's
    state) on each family at the stock platform (fractional fetch and
    datapath costs), 1024 rows in the families' one unit: every leaf
    bit-exact with the compiled reference. (Below 384 rows in one unit
    the compiled reference rounds its fetch products apart:
    ``test_direct_fetch_rounding_by_compiled_loop``.)"""
    cj, ct = family(name)
    ssd = dict(num_blocks=1 << 14)
    pj, pt = jt.PlatformModel(), tt.PlatformModel()
    jpipe = jdev.DevicePipeline(cj, jt.SSDConfig(**ssd), pj)
    tpipe = tdev.DevicePipeline(ct, tt.SSDConfig(**ssd), pt)
    js, ts = jpipe.init_state(), tpipe.init_state("cpu")
    submit_j = jax.jit(jpipe._submit_direct)
    for call in range(2):
        x = direct_inputs(name, call)
        keys = ("valid", "opcode", "nblocks", "tenant")
        jb = jdev.make_direct_batch(
            jnp.asarray(x["lba"]), jnp.asarray(x["t"]),
            **{k: jnp.asarray(x[k]) for k in keys})
        tb = tdev.make_direct_batch(
            torch.from_numpy(x["lba"]), torch.from_numpy(x["t"]),
            **{k: torch.from_numpy(x[k]) for k in keys})
        assert not convert.leaf_differences(flat(jb), flat(tb))
        if call == 0:
            ref = jax.jit(lambda d, t, v: jfe.direct_fetch_times(
                d, t, v, cj, pj))(js.disp_time, jb.arrival, jb.valid)
            got = tfe.direct_fetch_times(ts.disp_time, tb.arrival, tb.valid,
                                         ct, pt)
            assert not convert.leaf_differences(flat(ref), flat(got))
            ref = jax.jit(jpipe._fetch_direct)(js, jb.arrival, jb.valid)
            got = tpipe._fetch_direct(ts, tb.arrival, tb.valid)
            assert not convert.leaf_differences(flat(ref), flat(got))
        js, jres = submit_j(js, jb)
        ts, tres = tpipe._submit_direct(ts, tb)
        assert not convert.leaf_differences(flat((js, jres)),
                                            flat((ts, tres)))
        ts = map_leaves(lambda _, r: torch.from_numpy(np.array(r)), ts, js)


@pytest.mark.parametrize("coalesced", [True, False])
@pytest.mark.parametrize("transport", ["p2p", "host"])
def test_direct_fetch_rounding_by_compiled_loop(coalesced, transport,
                                                monkeypatch):
    """Where the compiled reference's fetch loop runs vectorized (4 units
    of 1024 rows, one unit of 1024) it fuses both products of the fetch time
    into its adds, as the port does: bit-exact, and rounding them apart
    differs. With one unit of at most 256 rows XLA's CPU backend unrolls
    the loop and folds each product into a constant rounded on its own
    (``rank`` is known at compile time): the reference then equals the
    unfused form bit for bit, and the port, which keeps the vectorized
    loop's rounding, lies within 1 ULP of it (ROADMAP §C)."""
    kw = dict(num_sqs=16, sq_depth=64, fetch_width=16, transport=transport,
              coalesced=coalesced)
    rng = np.random.default_rng(7)
    pj, pt = jt.PlatformModel(), tt.PlatformModel()
    apart_differs = False
    for units, n, vectorized in ((4, 4096, True), (1, 1024, True),
                                 (1, 200, False)):
        cj = jt.EngineConfig(**kw, num_units=units)
        ct = tt.EngineConfig(**kw, num_units=units)
        t = (100.0 + rng.random(n) * 40).astype(np.float32)
        valid = rng.random(n) < 0.9
        disp = (rng.random(units) * 5).astype(np.float32)
        ref = np.asarray(jax.jit(lambda d, t, v: jfe.direct_fetch_times(
            d, t, v, cj, pj))(disp, t, valid)[0])

        def port():
            return tfe.direct_fetch_times(
                torch.from_numpy(disp), torch.from_numpy(t),
                torch.from_numpy(valid), ct, pt)[0].numpy()

        fused = port()
        monkeypatch.setattr(tfe, "_fma32", unfused)
        apart = port()
        monkeypatch.undo()
        if vectorized:
            assert convert.ulp_distance(ref, fused) == 0
            apart_differs |= convert.ulp_distance(ref, apart) > 0
        else:
            assert convert.ulp_distance(ref, apart) == 0
            assert convert.ulp_distance(ref, fused) <= 1
    assert apart_differs


# -- the sanitizer -------------------------------------------------------------

def states_equal(a, b):
    return not convert.leaf_differences(convert.engine_state_to_numpy(a),
                                        convert.engine_state_to_numpy(b))


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_sanitized_run_clean_and_bit_exact(name):
    """``make_runner(sanitize=True)`` raises nothing, and its final state
    is the unsanitized runner's bit for bit, as tests/test_sanitize.py
    demands of the reference's."""
    _, ct = family(name)
    twl = tt.WorkloadConfig(**WL)
    ssd, pt = tt.SSDConfig(), tt.PlatformModel()
    st = te.init_state(ct, ssd, twl, device="cpu")
    plain = te.make_runner(ct, ssd, twl, pt, ROUNDS, device="cpu")(st)
    sanitized = te.make_runner(ct, ssd, twl, pt, ROUNDS, device="cpu",
                               sanitize=True)(st)
    assert states_equal(plain, sanitized)


def test_sanitize_via_config_flag():
    """``cfg.sanitize=True`` is ``make_runner(sanitize=True)``, through
    ``simulate`` too, on a drive and on a local-scope drive."""
    _, ct = family("baseline_dp")
    ssd, pt, twl = tt.SSDConfig(), tt.PlatformModel(), tt.WorkloadConfig(**WL)
    for cfg in (ct, ct.replace(timing_scope="local")):
        plain = te.simulate(cfg, ssd, twl, pt, rounds=ROUNDS, device="cpu")
        flagged = te.simulate(cfg.replace(sanitize=True), ssd, twl, pt,
                              rounds=ROUNDS, device="cpu")
        assert states_equal(plain, flagged)


def test_sanitized_array_runner_clean():
    """A sanitized 2-drive array (global and local scope) raises nothing
    and equals the unsanitized array bit for bit."""
    ssd, pt, twl = tt.SSDConfig(), tt.PlatformModel(), tt.WorkloadConfig(**WL)
    for scope in ("global", "local"):
        cfg = tt.EngineConfig(**SMALL, timing_scope=scope)
        st = te.init_array_state(cfg, ssd, twl, 2, device="cpu")
        plain = te.make_array_runner(cfg, ssd, twl, pt, ROUNDS,
                                     device="cpu")(st)
        sanitized = te.make_array_runner(cfg, ssd, twl, pt, ROUNDS,
                                         device="cpu", sanitize=True)(st)
        assert states_equal(plain, sanitized)


def test_injected_oob_sq_id_caught():
    """A fetched batch through ``process`` with the flags given: clean, no
    bit set; with one valid row's SQ id past ``num_sqs``, the SQ-id bit
    is set, ``raise_if_flagged`` raises ``SanitizeError`` with the
    reference's message (the reference's checkify reports the same), and
    the pass's outputs are those of the unsanitized pass."""
    kw = dict(SMALL, sanitize=True)
    cj, ct = jt.EngineConfig(**kw), tt.EngineConfig(**kw)
    jwl, twl = jt.WorkloadConfig(**WL), tt.WorkloadConfig(**WL)
    ssd, pt = tt.SSDConfig(), tt.PlatformModel()
    st = te.init_state(ct, ssd, twl, device="cpu")
    pipe = tdev.DevicePipeline(ct, ssd, pt)
    unit = tfe.fetch_row_units(ct, "cpu")
    _, disp, batch, fetch_done = tfe.fetch(st.rings, st.clock,
                                           st.device.disp_time, ct, pt)
    dev = dataclasses.replace(st.device, disp_time=disp)
    batch = dataclasses.replace(batch, arrival=fetch_done)

    def go(b, flags):
        return pipe.process(dev, b, fetch_done, unit, st.cq,
                            ring_layout=True, flags=flags)

    flags = tdev.new_flags("cpu")
    go(batch, flags)
    assert int(flags) == 0
    tdev.raise_if_flagged(flags)
    with pytest.raises(ValueError, match="flag tensor"):
        go(batch, None)

    sq_id, valid = batch.sq_id.clone(), batch.valid.clone()
    sq_id[0], valid[0] = ct.num_sqs + 3, True
    bad = dataclasses.replace(batch, sq_id=sq_id, valid=valid)
    out = go(bad, flags)
    assert int(flags) & 1
    with pytest.raises(tdev.SanitizeError, match="SQ id") as caught:
        tdev.raise_if_flagged(flags)
    plain_pipe = tdev.DevicePipeline(ct.replace(sanitize=False), ssd, pt)
    plain = plain_pipe.process(dev, bad, fetch_done, unit, st.cq,
                               ring_layout=True)
    assert not convert.leaf_differences(flat(plain), flat(out))

    jst = je.init_state(cj, jt.SSDConfig(), jwl)
    jpipe = jdev.DevicePipeline(cj, jt.SSDConfig(), jt.PlatformModel())
    jb = jt.RequestBatch(**{f.name: jnp.asarray(getattr(bad, f.name).numpy())
                            for f in dataclasses.fields(bad)})
    jdv = jax.tree.map(jnp.asarray, jst.device)
    jdv = dataclasses.replace(jdv, disp_time=jnp.asarray(disp.numpy()))
    err, _ = jax.jit(checkify.checkify(
        lambda b: jpipe.process(jdv, b, jnp.asarray(fetch_done.numpy()),
                                jnp.asarray(unit.numpy()), jst.cq,
                                ring_layout=True),
        errors=checkify.user_checks))(jb)
    assert str(caught.value) in str(err.get())
