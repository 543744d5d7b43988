"""The NVMeVirt baseline of the port against the reference: per-request
timing, the per-request lock cost, the centralized fetch, the fig 11
averages, the client on a centralized drive, and whole closed-loop runs
of ``benchmarks/common.py::nvmevirt_cfg()``.

Inputs are made with numpy from a seed and handed to both packages. The
reference runs compiled (``jax.jit``), as the engine runs it. Integer and
bool leaves must be equal. Float leaves are bit-exact unless a test
states a bound: the compiled reference fuses two multiply-adds of the
centralized fetch into FMAs (``FETCH_ULP``, pinned per expression), and
the metrics' running sums add in XLA's order (``SUM_ULP``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.common import D7_PS1010, FUTURE_40M, nvmevirt_cfg, swarmio_cfg
from repro.core import device as jdev
from repro.core import engine as je
from repro.core import epoch as jep
from repro.core import frontend as jfe
from repro.core import timing as jti
from repro.core import types as jt
from repro.core.client import StorageClient as JClient
from repro.workloads import MixedReadWrite as JMixed
from repro_torch import bench, convert
from repro_torch.core import device as tdev
from repro_torch.core import engine as te
from repro_torch.core import epoch as tep
from repro_torch.core import frontend as tfe
from repro_torch.core import timing as tti
from repro_torch.core import types as tt
from repro_torch.core.client import StorageClient as TClient
from repro_torch.kernels import ops, ref
from repro_torch.workloads import MixedReadWrite as TMixed
from port_threads import one_torch_thread  # noqa: F401

SMALL = dict(num_sqs=8, sq_depth=64, fetch_width=16)
SUM_ULP = 16     # the metrics' float sums (XLA adds in another order)
FETCH_ULP = 2    # the compiled reference's FMAs in the centralized fetch
INT_PLAT = dict(
    cpu_sqe_fetch_us=10.0, cpu_coal_byte_us=0.0, cpu_coal_base_us=1.0,
    dsa_sqe_fetch_us=4.0, dsa_coal_base_us=18.0, dsa_desc_issue_us=1.0,
    dsa_batch_setup_us=1.0, dsa_bytes_per_us=64.0, doorbell_poll_us=1.0,
    host_txn_base_us=1.0, host_bytes_per_us=64.0, txn_base_us=1.0,
    link_bytes_per_us=64.0, per_req_map_us=3.0, lock_per_req_us=1.0,
    lock_per_batch_us=1.0,
)
STOCK_IOPS = 75251.7109375  # the reference's read run, 24 rounds
STOCK_COMPLETED = 2049.0


def t(x):
    return torch.from_numpy(np.array(x))


def jleaves(state):
    return {jax.tree_util.keystr(p).lstrip("."): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(state)[0]}


def port_cfg(cfg_j, cls=tt.EngineConfig):
    """The port's EngineConfig with the reference's field values."""
    return cls(**{f.name: getattr(cfg_j, f.name)
                  for f in dataclasses.fields(cls)
                  if not isinstance(getattr(cfg_j, f.name), (
                      jt.FabricConfig, jt.CacheConfig, jt.QPConfig))})


def port_ssd(ssd_j):
    return tt.SSDConfig(**{f.name: getattr(ssd_j, f.name)
                           for f in dataclasses.fields(tt.SSDConfig)})


def same_bits(want, got):
    want, got = np.asarray(want), got.numpy()
    assert want.dtype == got.dtype and want.shape == got.shape
    np.testing.assert_array_equal(want.reshape(-1).view(np.uint8),
                                  got.reshape(-1).view(np.uint8))


# -- stage 2b: per-request timing ---------------------------------------------

def request_rows(rng, n, k, p_valid=0.8):
    """(reference batch, port batch, busy cursors) of n random rows."""
    arrival = rng.uniform(0, 400, n).astype(np.float32)
    arrival[:2] = [-0.0, 0.0]           # a signed-zero pair
    busy = rng.uniform(0, 500, k).astype(np.float32)
    busy[:2] = [0.0, -0.0][:k]
    jb, tb = batches(n, arrival=arrival,
                     lba=rng.integers(0, 1 << 14, n).astype(np.int32),
                     valid=rng.random(n) < p_valid)
    return jb, tb, busy


def batches(n, **fields):
    """A RequestBatch of n rows for each package: ``fields`` as given,
    every other field zero (ones for ``nblocks``)."""
    z = np.zeros(n, np.int32)
    cols = dict(arrival=np.zeros(n, np.float32), sq_id=z, slot=z, opcode=z,
                lba=z, nblocks=np.ones(n, np.int32), buf_id=z, req_id=z,
                valid=np.ones(n, bool), tenant=z)
    cols.update(fields)
    return (jt.RequestBatch(**{f: jnp.asarray(v) for f, v in cols.items()}),
            tt.RequestBatch(**{f: t(v) for f, v in cols.items()}))


@pytest.mark.parametrize("routing", ["round_robin", "lba_hash"])
@pytest.mark.parametrize("n,k", [(1024, 512), (700, 64), (300, 1)])
def test_per_request_update_matches_reference(routing, n, k):
    """Random batches with invalid rows, an arrival and a cursor of each
    zero sign: completions, cursors and the round-robin cursor
    bit-exact."""
    rng = np.random.default_rng(n + k)
    jb, tb, busy = request_rows(rng, n, k)
    ssd_kw = dict(t_max_iops=40e6, l_min_us=30.0, n_instances=k,
                  routing=routing)
    ssd_j, ssd_t = jt.SSDConfig(**ssd_kw), tt.SSDConfig(**ssd_kw)
    rr = np.int32(rng.integers(0, k))
    js = jt.TimingState(jnp.asarray(busy), jnp.asarray(rr))
    ts = tt.TimingState(t(busy), torch.tensor(rr))
    want = jax.jit(lambda s, b: jti.update(s, b, ssd_j, "per_request"))(
        js, jb)
    got = tti.update(ts, tb, ssd_t, "per_request")
    same_bits(want[0].busy_until, got[0].busy_until)
    same_bits(want[0].rr, got[0].rr)
    same_bits(want[1], got[1])


@pytest.mark.parametrize("routing", ["round_robin", "lba_hash"])
def test_per_request_update_through_a_dispatch_order(routing):
    rng = np.random.default_rng(21)
    n, k = 256, 64
    jb, tb, busy = request_rows(rng, n, k)
    perm = rng.permutation(n).astype(np.int32)
    ssd_j = jt.SSDConfig(n_instances=k, routing=routing)
    ssd_t = tt.SSDConfig(n_instances=k, routing=routing)
    want = jax.jit(lambda s, b, d: jti.update(
        s, b, ssd_j, "per_request", dispatch_order=d))(
        jt.TimingState(jnp.asarray(busy), jnp.int32(5)), jb,
        jnp.asarray(perm))
    ts = tt.TimingState(t(busy), torch.tensor(5, dtype=torch.int32))
    got = tti.update(ts, tb, ssd_t, "per_request", dispatch_order=t(perm))
    same_bits(want[0].busy_until, got[0].busy_until)
    same_bits(want[1], got[1])


def jnp_max(a, b):
    """``jnp.maximum`` of two float32 scalars: a NaN propagates, and of
    two zeros +0 is the larger."""
    if np.isnan(a) or np.isnan(b):
        return np.float32(np.nan)
    if a == b:
        return a if np.signbit(a) and np.signbit(b) else np.abs(a)
    return a if a > b else b


def loop_fold(arrival, inst, valid, busy, sched, lmin):
    """The reference's scan step, literally, row by row."""
    busy = busy.copy()
    comp = np.zeros(arrival.shape[0], np.float32)
    for i in range(arrival.shape[0]):
        c = inst[i]
        b = np.float32(jnp_max(arrival[i], busy[c]) + np.float32(sched))
        if valid[i]:
            busy[c] = b
            comp[i] = jnp_max(b, np.float32(arrival[i] + np.float32(lmin)))
    return comp, busy


@pytest.mark.parametrize("n,k,special", [
    (2048, 512, False), (500, 1, False), (3000, 1024, False),
    (999, 37, True), (0, 8, False),
])
def test_per_request_fold_matches_a_python_loop(n, k, special):
    """The port's fold (on the CPU ``die_contention``'s plain version
    with cost = sched) against the recurrence run row by row: bit-exact, NaNs
    compared as NaNs. The ``special`` case adds signed zeros and NaNs."""
    rng = np.random.default_rng(n + k)
    arrival = rng.uniform(0, 1000, n).astype(np.float32)
    busy = rng.uniform(0, 1000, k).astype(np.float32)
    inst = rng.integers(0, k, n).astype(np.int32)
    valid = rng.random(n) < 0.7
    sched, lmin = np.float32(12.8), np.float32(30.0)
    if special:
        arrival[rng.random(n) < 0.05] = -0.0
        arrival[rng.random(n) < 0.01] = np.nan
        busy[::5] = -0.0
        busy[3] = np.nan
        sched, lmin = np.float32(0.0), np.float32(0.0)
    want = loop_fold(arrival, inst, valid, busy, sched, lmin)
    got = tti.per_request_fold(t(arrival), t(inst), t(valid), t(busy),
                               float(sched), float(lmin))
    for w, g in zip(want, got):
        g = g.numpy()
        nan = np.isnan(w)
        np.testing.assert_array_equal(nan, np.isnan(g))
        np.testing.assert_array_equal(w[~nan].view(np.uint32),
                                      g[~nan].view(np.uint32))


def test_per_request_fold_takes_the_plain_version_on_the_cpu():
    rng = np.random.default_rng(3)
    args = (t(rng.uniform(0, 9, 64).astype(np.float32)),
            t(rng.integers(0, 4, 64).astype(np.int32)),
            t(rng.random(64) < 0.5), t(np.zeros(4, np.float32)))
    before = dict(ops.LAUNCHES)
    comp, busy = tti.per_request_fold(*args, 1.5, 2.0)
    end, want_busy = ref.die_contention_ref(
        args[0], torch.full((64,), 1.5), args[1], args[2], args[3])
    assert torch.equal(busy, want_busy)
    assert torch.equal(comp, torch.where(args[2], torch.maximum(
        end, args[0] + 2.0), 0.0))
    assert ops.LAUNCHES == before


# -- stage 2a: the per-request lock cost --------------------------------------

@pytest.mark.parametrize("mode", ["per_request", "aggregated"])
@pytest.mark.parametrize("layout", ["ring", "direct"])
def test_acquire_lock_cost_by_mode(mode, layout):
    """Four units with 0-8 valid rows each on the stock platform: a unit
    pays ``n_valid * lock_per_req_us`` per request, or the batch cost;
    grants bit-exact."""
    rng = np.random.default_rng(7)
    n = 32
    valid = rng.random(n) < 0.6
    valid[8:16] = False                  # one unit with no valid row
    jb, tb = batches(n, arrival=rng.uniform(0, 9, n).astype(np.float32),
                     sq_id=np.repeat(np.arange(8), 4).astype(np.int32),
                     valid=valid)
    unit = np.repeat(np.arange(4), 8).astype(np.int32)
    ready = rng.uniform(0, 90, n).astype(np.float32)
    ej = jep.Epoch.from_batch(jb, jnp.asarray(ready), jnp.asarray(unit),
                              layout)
    et = tep.Epoch.from_batch(tb, t(ready), t(unit), layout)
    cfg_j = jt.EngineConfig(num_units=4, mode=mode)
    cfg_t = tt.EngineConfig(num_units=4, mode=mode)
    lt = np.float32(37.5)
    want = jax.jit(lambda lt_, e: jdev.acquire_lock(
        lt_, e, 4, cfg_j, jt.PlatformModel())[:2])(jnp.asarray(lt), ej)
    got = tdev.acquire_lock(torch.tensor(lt), et, 4, cfg_t,
                            tt.PlatformModel())[:2]
    same_bits(want[0], got[0])
    same_bits(want[1], got[1])


# -- stage 1: the centralized fetch -------------------------------------------

def central_rings(rng, q, d, fill, integer):
    z = np.zeros((q, d), np.int32)
    head = rng.integers(0, 4 * d, q).astype(np.int32)
    tail = head + rng.integers(0, fill + 1, q).astype(np.int32)
    submit = np.sort(rng.uniform(0, 40, (q, d)), axis=1)
    submit = np.floor(submit) if integer else submit
    fields = dict(
        submit_time=submit.astype(np.float32),
        opcode=(rng.random((q, d)) < 0.3).astype(np.int32),
        lba=rng.integers(0, 1000, (q, d)).astype(np.int32),
        nblocks=np.ones((q, d), np.int32), buf_id=z + 3,
        req_id=rng.integers(0, 9999, (q, d)).astype(np.int32), tenant=z,
        head=head, tail=tail,
    )
    return (jfe.SQRings(**{k: jnp.asarray(v) for k, v in fields.items()}),
            tfe.SQRings(**{k: t(v) for k, v in fields.items()}))


def fetch_both(seed, plat_kw, integer, clock, disp, cfg_kw=None):
    rng = np.random.default_rng(seed)
    cfg = dict(num_sqs=32, sq_depth=128, fetch_width=64, num_units=1,
               frontend="centralized", mode="per_request", coalesced=False,
               dsa_fetch=False, **(cfg_kw or {}))
    cj, ct = jt.EngineConfig(**cfg), tt.EngineConfig(**cfg)
    pj, pt = jt.PlatformModel(**plat_kw), tt.PlatformModel(**plat_kw)
    jr, tr = central_rings(rng, 32, 128, 100, integer)
    c, dt = np.float32(clock), np.array([disp], np.float32)

    def reference(r, c_, d_):
        return jfe.fetch(r, c_, d_, cj, pj)

    compiled = jax.jit(reference)(jr, jnp.asarray(c), jnp.asarray(dt))
    with jax.disable_jit():
        eager = reference(jr, jnp.asarray(c), jnp.asarray(dt))
    port = tfe.fetch(tr, torch.tensor(c), t(dt), ct, pt)
    return compiled, eager, port, (jr, c, dt, pj)


def flat(out):
    rings, disp, batch, done = out
    leaves = {"disp_time": disp, "fetch_done": done}
    for name in ("head", "tail"):
        leaves["rings." + name] = getattr(rings, name)
    for f in dataclasses.fields(batch):
        leaves["batch." + f.name] = getattr(batch, f.name)
    return {k: v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in leaves.items()}


@pytest.mark.parametrize("clock,disp", [(40.0, 0.0), (40.0, 39.0),
                                        (40.0, 55.0)])
def test_fetch_centralized_exact_on_the_integer_platform(clock, disp):
    """Every cost a whole microsecond: the compiled reference's FMAs round
    nothing, so every leaf is bit-exact. ``disp = 55`` is a dispatcher
    still busy: nothing is fetched this round."""
    compiled, _, port, _ = fetch_both(1, INT_PLAT, True, clock, disp)
    assert not convert.leaf_differences(flat(compiled), flat(port))
    fetched = int(flat(port)["batch.valid"].sum())
    assert (fetched == 0) == (disp > clock)


@pytest.mark.parametrize("kw", [{}, dict(transport="host")])
def test_fetch_centralized_on_the_stock_platform(kw):
    """The stock platform's fractional per-entry cost (10.3 us, or the
    host transport's): the port rounds every multiply and add apart, as
    the reference does run eagerly (bit-exact). Compiled, the reference
    contracts ``nf * per_entry + doorbell_poll_us`` and ``sq_base + (j +
    1) * per_entry`` into FMAs (pinned: its fetch times are exactly the
    FMA model's), which moves the fetch times by up to ``FETCH_ULP``;
    integer leaves stay equal."""
    compiled, eager, port, (jr, c, dt, pj) = fetch_both(
        2, {}, False, 30.0, 12.5, kw)
    assert not convert.leaf_differences(flat(eager), flat(port))
    assert not convert.leaf_differences(
        flat(compiled), flat(port), {"fetch_done": FETCH_ULP})
    f64 = np.float64
    cfg = jt.EngineConfig(num_sqs=32, sq_depth=128, fetch_width=64,
                          num_units=1, frontend="centralized",
                          coalesced=False, dsa_fetch=False, **kw)
    pe = f64(jfe._per_entry_cost(cfg, pj))
    poll = f64(np.float32(pj.doorbell_poll_us))
    nf = flat(port)["rings.head"] - np.asarray(jr.head)
    cost = np.float32(nf * pe + poll)                   # fma, one rounding
    cum = np.asarray(jnp.cumsum(jnp.asarray(cost)))
    start = np.float32(max(dt[0], c))
    base = np.float32(np.float32(start + cum) - cost)
    j1 = np.arange(1, 65)[None, :]
    fma_done = np.float32(base.astype(f64)[:, None] + j1 * pe).reshape(-1)
    np.testing.assert_array_equal(flat(compiled)["fetch_done"], fma_done)
    moved = flat(compiled)["fetch_done"] != flat(port)["fetch_done"]
    assert moved.any()


# -- metrics: fig 11's averages -----------------------------------------------

def test_avg_target_and_proc_of_a_reference_state():
    """The reference's baseline state after 6 rounds, converted: the port's
    ``avg_target_us``/``avg_proc_us``/``avg_e2e_us`` equal the
    reference's bit for bit (one division each)."""
    cj = nvmevirt_cfg(**SMALL)
    wl = jt.WorkloadConfig(io_depth=16)
    s = je.make_runner(cj, FUTURE_40M, wl, jt.PlatformModel(), 6)(
        je.init_state(cj, FUTURE_40M, wl))
    ts = convert.engine_state_from_numpy(jleaves(s), "cpu")
    assert float(ts.metrics.completed) > 0
    for name in ("avg_target_us", "avg_proc_us", "avg_e2e_us"):
        same_bits(getattr(s.metrics, name)(), getattr(ts.metrics, name)())


# -- the client on a centralized drive ----------------------------------------

def test_storage_client_on_a_centralized_drive():
    """``StorageClient.submit`` on ``nvmevirt_cfg``'s frontend, timing and
    datapath (one dispatcher, per-request timing and lock, baseline
    workers), 600 ops in two submits: integer leaves and data equal,
    completion and device times within ``FETCH_ULP`` (the compiled
    reference's fetch FMAs, carried downstream)."""
    rng = np.random.default_rng(600)
    n = 600
    lba = rng.permutation(1 << 13)[:n].astype(np.int32)
    t_sub = np.round(rng.uniform(0, 300, n), 1).astype(np.float32)
    op = (rng.random(n) < 0.3).astype(np.int32)
    valid = rng.random(n) < 0.85
    flash = rng.standard_normal((1 << 13, 8)).astype(np.float32)
    ssd_kw = dict(t_max_iops=1e6, l_min_us=20.0, n_instances=32,
                  num_blocks=1 << 13)
    cfg = dict(num_sqs=8, sq_depth=128, fetch_width=16, num_units=1,
               workers_per_unit=32, frontend="centralized",
               mode="per_request", coalesced=False, dsa_fetch=False,
               batched_datapath=False)
    cj = JClient(jt.SSDConfig(**ssd_kw), jt.EngineConfig(**cfg))
    ct = TClient(tt.SSDConfig(**ssd_kw), tt.EngineConfig(**cfg))
    sj, st = cj.init_state(), ct.init_state("cpu")
    submit_j = jax.jit(lambda s, f, o: cj.submit(s, f, o, with_data=True))
    fj, ft = jnp.asarray(flash), t(flash)
    for shift in (0.0, 5000.0):
        opj = jt.StorageOps.make(jnp.asarray(lba), jnp.asarray(t_sub + shift),
                                 opcode=jnp.asarray(op),
                                 valid=jnp.asarray(valid))
        opt = tt.StorageOps.make(t(lba), t(t_sub + shift), opcode=t(op),
                                 valid=t(valid))
        sj, fj, oj, dj = submit_j(sj, fj, opj)
        st, ft, ot, dt = ct.submit(st, ft, opt, with_data=True)
        assert float(dt.max()) > 0
        assert convert.ulp_distance(np.asarray(dj), dt.numpy()) <= FETCH_ULP
        np.testing.assert_array_equal(np.asarray(oj), ot.numpy())
        want = jleaves(sj.dev)
        got = convert.engine_state_to_numpy(st.dev)
        assert want.keys() == got.keys()
        bounds = {k: FETCH_ULP for k in want if want[k].dtype.kind == "f"}
        assert not convert.leaf_differences(want, got, bounds)


# -- whole runs: the baseline against the reference ---------------------------

WORKLOADS = {
    "read": lambda d: (jt.WorkloadConfig(io_depth=d),
                       tt.WorkloadConfig(io_depth=d)),
    "mixed_70_30": lambda d: (JMixed(read_frac=0.7, io_depth=d),
                              TMixed(read_frac=0.7, io_depth=d)),
}


def run_both(cfg_j, ssd_j, wl_name, depth, rounds, plat_kw=None):
    """(reference final state, port final state) of ``rounds`` rounds."""
    wj, wt = WORKLOADS[wl_name](depth)
    pj = jt.PlatformModel(**(plat_kw or {}))
    pt = tt.PlatformModel(**(plat_kw or {}))
    want = je.make_runner(cfg_j, ssd_j, wj, pj, rounds)(
        je.init_state(cfg_j, ssd_j, wj))
    got = te.simulate(port_cfg(cfg_j), port_ssd(ssd_j), wt, pt,
                      rounds=rounds, device="cpu")
    return want, got


def differing(want, got):
    return convert.leaf_differences(
        jleaves(want), convert.engine_state_to_numpy(got),
        dict.fromkeys(SUM_LEAVES, SUM_ULP))


SUM_LEAVES = ("metrics.sum_e2e", "metrics.sum_target", "metrics.sum_proc",
              "metrics.tenant_sum_e2e")


@pytest.mark.parametrize("wl_name", sorted(WORKLOADS))
@pytest.mark.parametrize("width", ["small", "stock"])
def test_nvmevirt_baseline_matches_reference(width, wl_name):
    """``simulate(nvmevirt_cfg())`` on ``FUTURE_40M`` for 24 rounds (stock:
    32 SQs x 1024, io_depth 256; small: 8 x 64, io_depth 16): every
    integer and bool leaf equal, every time leaf bit-exact (the fetch's
    FMAs round nothing here: a centralized round fetches at most one
    entry an SQ), the metric sums within ``SUM_ULP``. The stock read run
    gives the reference's 2049 completions and 75251.7109375 virtual
    IOPS."""
    kw = SMALL if width == "small" else {}
    depth = 16 if width == "small" else 256
    want, got = run_both(nvmevirt_cfg(**kw), FUTURE_40M, wl_name, depth, 24)
    assert float(want.metrics.completed) > 0
    assert not differing(want, got)
    if width == "stock" and wl_name == "read":
        assert float(got.metrics.completed) == STOCK_COMPLETED
        assert float(got.metrics.iops()) == STOCK_IOPS


def test_fig11_d7_ps1010_at_io_depth_512():
    """Fig 11's drive (``D7_PS1010``, 64 instances) at io_depth 512 for 32
    rounds: the state as above, and the averages within ``SUM_ULP`` of
    the reference's."""
    want, got = run_both(nvmevirt_cfg(), D7_PS1010, "read", 512, 32)
    assert not differing(want, got)
    for name in ("avg_target_us", "avg_proc_us", "avg_e2e_us"):
        a = np.asarray(getattr(want.metrics, name)())
        b = getattr(got.metrics, name)().numpy()
        assert convert.ulp_distance(a, b) <= SUM_ULP, name
    for name in ("iops", "p50_us", "p95_us", "p99_us"):
        same_bits(getattr(want.metrics, name)(), getattr(got.metrics, name)())


@pytest.mark.parametrize("name,cfg_kw,plat_kw", [
    ("fig14 swarmio per-request", dict(num_units=4, mode="per_request"),
     None),
    ("fig03 nvmevirt host transport", dict(transport="host"), None),
    ("nvmevirt integer platform", dict(batched_datapath=False), INT_PLAT),
])
def test_baseline_variants_match_reference(name, cfg_kw, plat_kw):
    """Fig 14's SwarmIO with per-request timing (4 units: the per-request
    lock cost over several units) and fig 03's baseline over the host
    transport, at small width for 6 rounds, and the baseline on the
    all-integer platform: integer leaves equal, time leaves bit-exact,
    sums within ``SUM_ULP``."""
    base = swarmio_cfg if name.startswith("fig14") else nvmevirt_cfg
    want, got = run_both(base(**SMALL, **cfg_kw), FUTURE_40M, "read", 16, 6,
                         plat_kw)
    assert float(want.metrics.completed) > 0
    assert not differing(want, got)


def test_nvmevirt_1drive_is_the_benchmarks_configuration():
    """The port's copies of ``nvmevirt_cfg()`` on ``FUTURE_40M`` and of
    fig 11's ``D7_PS1010`` keep every field."""
    cfg, ssd = bench.nvmevirt_1drive()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(nvmevirt_cfg())
    assert dataclasses.asdict(ssd) == dataclasses.asdict(FUTURE_40M)
    assert (dataclasses.asdict(bench.D7_PS1010)
            == dataclasses.asdict(D7_PS1010))


def test_building_the_baseline_pipeline_does_not_raise():
    cfg, ssd = bench.nvmevirt_1drive()
    pipe = tdev.DevicePipeline(cfg, ssd, tt.PlatformModel())
    state = pipe.init_state("cpu")
    assert pipe.num_units == 1 and tuple(state.disp_time.shape) == (1,)
    assert tuple(state.work_time.shape) == (1, 32)


# -- on the card --------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_per_request_fold_on_the_card_matches_the_cpu(card):
    """The fold through the die_contention kernel against its plain
    version on the CPU, at the baseline's shape and at edge shapes:
    bit-identical."""
    rng = np.random.default_rng(0)
    for n, k in ((2048, 512), (8192, 1), (5000, 1024), (0, 4)):
        args = (t(rng.uniform(0, 900, n).astype(np.float32)),
                t(rng.integers(0, k, n).astype(np.int32)),
                t(rng.random(n) < 0.8),
                t(rng.uniform(0, 900, k).astype(np.float32)))
        got = tti.per_request_fold(*(a.to(card) for a in args), 12.8, 30.0)
        want = tti.per_request_fold(*args, 12.8, 30.0)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu().view(torch.int32),
                               w.view(torch.int32))
