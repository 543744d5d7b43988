"""The port's workload generators against the reference: the float32 pow
and log of the request stream, every hook of each generator call by call,
and 24-round closed- and open-loop runs on a small drive.

Addresses, opcodes, tenants and validity are integers and must be equal.
The Zipf address and the Poisson gap are float32 draws that the port
computes with ``core.xla_math``, which reproduces XLA's CPU ``powf`` and
``log`` bit for bit. In whole runs every integer and bool leaf is equal;
the time leaves are bit-exact (``TIME_ULP``, 0: the port's timing core
fuses the multiply-adds that the reference's compiled one fuses, which
the Zipf run under ``lba_hash`` shows), and the metric sums are held to
``SUM_ULP`` (their reduction order differs).
"""
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import workloads as jw
from repro.core import engine as je
from repro.core import types as jt
from repro_torch import convert
from repro_torch import workloads as tw
from repro_torch.core import engine as te
from repro_torch.core import types as tt
from repro_torch.core import xla_math
from repro_torch.core.segops import hash_u32, uniform01
from repro_torch.workloads import generators as tgen
from port_threads import one_torch_thread  # noqa: F401

SMALL = dict(num_sqs=8, sq_depth=64, fetch_width=16)
SUM_ULP = 16
TIME_ULP = 0
SUMS = ("metrics.sum_e2e", "metrics.sum_target", "metrics.sum_proc",
        "metrics.tenant_sum_e2e")
TIMES = ("cq.done_time", "cq.visible_time", "device.tstate.busy_until",
         "last_submit", "rings.submit_time", "metrics.last_completion")
ROUNDS = 24


def same(a, b):
    a, b = np.asarray(a), b.numpy()
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a.view(np.int32) if a.dtype == np.float32
                                  else a,
                                  b.view(np.int32) if b.dtype == np.float32
                                  else b)


# -- the transcendental functions of the stream --------------------------------

def test_zipf_address_matches_reference_on_long_streams():
    """``MixedReadWrite(theta=0.9).address`` over every request id
    0..2^21-1 at the drive sizes 2^14 (``D7_PS1010``, ``FUTURE_40M``) and
    2^20, salts 0 and 5: equal to the reference's, including the five ids
    whose address a ``torch.pow`` moves by one block."""
    jwl, twl = jw.MixedReadWrite(theta=0.9), tw.MixedReadWrite(theta=0.9)
    five = np.array([33073, 809569, 862142, 1026780, 1152271], np.int32)
    sj, st = jt.SSDConfig(num_blocks=1 << 14), tt.SSDConfig(num_blocks=1 << 14)
    np.testing.assert_array_equal(
        twl.address(torch.from_numpy(five), st, 0).numpy(),
        [15492, 15109, 690, 15109, 9285])
    np.testing.assert_array_equal(
        np.asarray(jwl.address(jnp.asarray(five), sj, 0)),
        [15492, 15109, 690, 15109, 9285])
    ids = np.arange(1 << 21, dtype=np.int32)
    for blocks in (1 << 14, 1 << 20):
        sj = jt.SSDConfig(num_blocks=blocks)
        st = tt.SSDConfig(num_blocks=blocks)
        for salt in (0, 5):
            ref = np.asarray(jwl.address(jnp.asarray(ids), sj, salt))
            out = twl.address(torch.from_numpy(ids), st, salt).numpy()
            assert out.dtype == ref.dtype == np.int32
            bad = np.nonzero(ref != out)[0]
            assert bad.size == 0, (blocks, salt, bad.size, bad[:8])


def _stream_draws(n: int = 1 << 18) -> np.ndarray:
    """The uniform01 draws of request ids 0..n-1 (seed 0, salt 0)."""
    return uniform01(hash_u32(torch.arange(n, dtype=torch.int64))).numpy()


def _dense_unit_grid() -> np.ndarray:
    """Every 2003rd float32 in [2^-126, 1): all exponents, all mantissas."""
    return np.arange(0x00800000, 0x3F800000, 2003,
                     dtype=np.int32).view(np.float32)


@pytest.mark.parametrize("theta", [0.3, 0.5, 2 / 3, 0.9, 0.99])
def test_pow_f32_is_xla_powf(theta):
    """``pow_f32`` equals the compiled ``jnp.power`` with a constant
    exponent, as the reference's engine runs it, bit for bit on the
    stream's draws and on a dense grid of (0, 1). Theta 0.5 and 2/3
    (exponents 2 and 3) are products there; theta 0.99 (exponent 100)
    takes many results below 2^-126, which XLA flushes to zero."""
    alpha = 1.0 / (1.0 - theta)
    ref_pow = jax.jit(lambda u: jnp.power(u, jnp.float32(alpha)))
    for u in (_stream_draws(), _dense_unit_grid()):
        ref = np.asarray(ref_pow(u))
        out = xla_math.pow_f32(torch.from_numpy(u), alpha).numpy()
        assert int(np.sum(ref.view(np.int32) != out.view(np.int32))) == 0


@pytest.mark.parametrize("theta,eager_differs", [(0.5, (2, 1)),
                                                 (2 / 3, (182, 180))])
def test_square_and_cube_follow_the_compiled_engine(theta, eager_differs):
    """At exponents 2 and 3 XLA's simplifier turns the compiled power into
    products, while the reference's eager ``address`` calls ``powf``: the
    two disagree on a few ids of 0..2^21-1 (2^14 blocks, salts 0 and 5).
    The port gives the compiled engine's addresses, as ``simulate``
    needs."""
    ids = np.arange(1 << 21, dtype=np.int32)
    jwl, twl = jw.MixedReadWrite(theta=theta), tw.MixedReadWrite(theta=theta)
    sj, st = jt.SSDConfig(num_blocks=1 << 14), tt.SSDConfig(num_blocks=1 << 14)
    for salt, count in zip((0, 5), eager_differs):
        compiled = np.asarray(jax.jit(lambda i: jwl.address(i, sj, salt))(
            jnp.asarray(ids)))
        eager = np.asarray(jwl.address(jnp.asarray(ids), sj, salt))
        out = twl.address(torch.from_numpy(ids), st, salt).numpy()
        np.testing.assert_array_equal(out, compiled)
        assert int(np.sum(eager != compiled)) == count


def test_log_f32_is_xla_log():
    """``log_f32`` equals XLA's compiled ``jnp.log`` bit for bit on the
    stream's draws and on a dense grid of (0, 1), where ``torch.log``
    differs on many."""
    ref_log = jax.jit(jnp.log)
    for u in (_stream_draws(), _dense_unit_grid()):
        ref = np.asarray(ref_log(u))
        out = xla_math.log_f32(torch.from_numpy(u)).numpy()
        assert int(np.sum(ref.view(np.int32) != out.view(np.int32))) == 0
    u = _stream_draws()
    assert int(np.sum(torch.log(torch.from_numpy(u)).numpy()
                      != np.asarray(ref_log(u)))) > 0


@pytest.mark.parametrize("width", [64, 32])
def test_emulated_fma_rounds_once(width):
    """``_fma64``/``_fma32`` against exact rational arithmetic, including
    near-cancelling sums where two roundings would differ."""
    rng = np.random.default_rng(width)
    n = 4000
    dt = np.float64 if width == 64 else np.float32
    a = (rng.standard_normal(n) * 2.0 ** rng.integers(-20, 20, n)).astype(dt)
    b = (rng.standard_normal(n) * 2.0 ** rng.integers(-20, 20, n)).astype(dt)
    c = (-(a.astype(np.float64) * b) * (1 + rng.standard_normal(n) * 1e-6)
         ).astype(dt)
    c[: n // 2] = rng.standard_normal(n // 2).astype(dt)
    fma = xla_math._fma64 if width == 64 else xla_math._fma32
    out = fma(*(torch.from_numpy(x) for x in (a, b, c))).numpy()
    for i in range(n):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(
            float(c[i]))
        if width == 64:
            want = float(exact)
        else:  # the nearest float32, ties to even
            f = np.float32(float(exact))
            near = [np.nextafter(f, np.float32(-np.inf)), f,
                    np.nextafter(f, np.float32(np.inf))]
            want = min(near, key=lambda v: (abs(Fraction(float(v)) - exact),
                                            int(np.array(v).view(np.int32))
                                            & 1))
        assert out[i] == want, (i, a[i], b[i], c[i])


def test_uniform_addresses_skip_the_pow(monkeypatch):
    """``theta=0`` keeps the reference's exact ``u * N``: no pow at all."""
    def boom(*_):
        raise AssertionError("pow_f32 called at theta=0")

    monkeypatch.setattr(tgen, "pow_f32", boom)
    ids = np.arange(0, 50000, 7, dtype=np.int32)
    sj, st = jt.SSDConfig(num_blocks=1 << 14), tt.SSDConfig(num_blocks=1 << 14)
    np.testing.assert_array_equal(
        np.asarray(jw.MixedReadWrite(theta=0.0).address(jnp.asarray(ids),
                                                          sj, 3)),
        tw.MixedReadWrite(theta=0.0).address(torch.from_numpy(ids), st,
                                             3).numpy())


# -- every hook of each generator, call by call --------------------------------

def _trace(mod, cfg, n=200):
    rng = np.random.default_rng(n)
    t = np.cumsum(rng.exponential(0.4, n)).astype(np.float32)
    t[5:9] = t[5]                                  # equal times keep order
    return mod.TraceReplay.from_trace(
        t[rng.permutation(n)], rng.integers(0, 1000, n),
        (rng.random(n) < 0.3).astype(np.int32), cfg)


GENERATORS = {
    "zipf": lambda m, c: m.ZipfClosedLoop(io_depth=16, seed=2),
    "steady": lambda m, c: m.SteadyStateMixed(io_depth=16, read_frac=0.7,
                                              theta=0.9),
    "multi": lambda m, c: m.MultiTenant(io_depth=16,
                                        tenant_read_frac=(1.0, 0.3)),
    "multi_interleaved": lambda m, c: m.MultiTenant(
        io_depth=16, tenant_read_frac=(0.7, 0.0, 0.55), interleave=True),
    "poisson": lambda m, c: m.PoissonOpenLoop(io_depth=40, rate_iops=2e6,
                                              seed=1),
    "trace": _trace,
}


def _pair(name, cfg_kw=SMALL):
    cj, ct = jt.EngineConfig(**cfg_kw), tt.EngineConfig(**cfg_kw)
    return (cj, GENERATORS[name](jw, cj)), (ct, GENERATORS[name](tw, ct))


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generator_hooks_match_reference(name):
    """``tenant_of_sq``, ``address``, ``opcode`` (per tenant), ``prefill``
    and ``next_submit`` on shared inputs: integer leaves equal, times
    bit-exact."""
    (cj, wj), (ct, wt) = _pair(name)
    sj, st = jt.SSDConfig(num_blocks=1 << 14), tt.SSDConfig(num_blocks=1 << 14)
    rng = np.random.default_rng(7)
    n = cj.num_sqs * cj.fetch_width
    sqs = np.arange(cj.num_sqs, dtype=np.int32)
    ten = np.repeat(np.asarray(wj.tenant_of_sq(jnp.asarray(sqs), cj, 3)),
                    cj.fetch_width)
    same(wj.tenant_of_sq(jnp.asarray(sqs), cj, 3),
         wt.tenant_of_sq(torch.from_numpy(sqs), ct, 3))
    ids = (rng.integers(0, 1 << 30, n)).astype(np.int32)
    for salt in (0, 3):
        same(wj.address(jnp.asarray(ids), sj, salt),
             wt.address(torch.from_numpy(ids), st, salt))
        same(wj.opcode(jnp.asarray(ids), salt, tenant=jnp.asarray(ten)),
             wt.opcode(torch.from_numpy(ids), salt,
                       tenant=torch.from_numpy(ten)))
        for a, b in zip(wj.prefill(cj, sj, salt), wt.prefill(ct, st, salt,
                                                              "cpu")):
            same(a, b)
    done = np.sort(rng.uniform(0, 500, n)).astype(np.float32)
    valid = rng.random(n) < 0.7
    anchor = np.repeat(rng.uniform(0, 300, cj.num_sqs).astype(np.float32),
                       cj.fetch_width)
    ref = jax.jit(lambda *a: wj.next_submit(*a, cj, sj, 3))(
        jnp.asarray(ids), jnp.asarray(done), jnp.asarray(valid),
        jnp.asarray(anchor))
    out = wt.next_submit(*(torch.from_numpy(x) for x in (ids, done, valid,
                                                         anchor)),
                         ct, st, 3)
    for a, b in zip(ref, out):
        same(a, b)


@pytest.mark.parametrize("fetch_width,depth", [(16, 40), (64, 1024)])
def test_poisson_gaps_and_chains_match_reference(fetch_width, depth):
    """``gap_us`` over 2^20 ids, and ``prefill``'s cumulative arrivals over
    an io_depth of up to 1024 and ``next_submit``'s over a fetch width of
    64 (``jnp.cumsum`` adds axes longer than 16 in chunks of 16), compiled
    as the engine compiles them: bit-exact."""
    cfg_kw = dict(num_sqs=4, sq_depth=depth, fetch_width=fetch_width)
    cj, ct = jt.EngineConfig(**cfg_kw), tt.EngineConfig(**cfg_kw)
    wj = jw.PoissonOpenLoop(io_depth=depth, rate_iops=1.976e6)
    wt = tw.PoissonOpenLoop(io_depth=depth, rate_iops=1.976e6)
    ids = np.arange(1 << 20, dtype=np.int32)
    same(jax.jit(lambda i: wj.gap_us(i, cj, 5))(jnp.asarray(ids)),
         wt.gap_us(torch.from_numpy(ids), ct, 5))
    sj, st = jt.SSDConfig(), tt.SSDConfig()
    ref = jax.jit(lambda: wj.prefill(cj, sj, 2))()
    for a, b in zip(ref, wt.prefill(ct, st, 2, "cpu")):
        same(a, b)
    n = cj.num_sqs * fetch_width
    rng = np.random.default_rng(depth)
    ids = rng.integers(0, 1 << 30, n).astype(np.int32)
    valid = rng.random(n) < 0.8
    anchor = np.repeat(rng.uniform(0, 900, cj.num_sqs).astype(np.float32),
                       fetch_width)
    done = np.zeros(n, np.float32)
    ref = jax.jit(lambda *a: wj.next_submit(*a, cj, sj, 1))(
        *(jnp.asarray(x) for x in (ids, done, valid, anchor)))
    out = wt.next_submit(*(torch.from_numpy(x) for x in (ids, done, valid,
                                                         anchor)), ct, st, 1)
    for a, b in zip(ref, out):
        same(a, b)


@pytest.mark.parametrize("shards", [1, 3])
def test_trace_replay_build_and_shards(shards):
    """``from_trace`` (host numpy), ``num_requests`` and the sharded
    ``prefill`` of each drive's stripe: equal to the reference's."""
    cj, ct = jt.EngineConfig(**SMALL), tt.EngineConfig(**SMALL)
    wj, wt = _trace(jw, cj).sharded(shards), _trace(tw, ct).sharded(shards)
    assert (wj.submit, wj.lba, wj.ops, wj.mask, wj.io_depth) == (
        wt.submit, wt.lba, wt.ops, wt.mask, wt.io_depth)
    assert wj.num_requests == wt.num_requests == 200
    sj, st = jt.SSDConfig(), tt.SSDConfig()
    for salt in range(shards):
        for a, b in zip(wj.prefill(cj, sj, salt),
                        wt.prefill(ct, st, salt, "cpu")):
            same(a, b)
    ref = wj.next_submit(jnp.zeros(4, jnp.int32), jnp.ones(4), jnp.ones(
        4, bool), jnp.zeros(4), cj, sj)
    out = wt.next_submit(torch.zeros(4, dtype=torch.int32), torch.ones(4),
                         torch.ones(4, dtype=torch.bool), torch.zeros(4),
                         ct, st)
    for a, b in zip(ref, out):
        same(a, b)


def test_generators_refuse_what_the_reference_refuses():
    ct = tt.EngineConfig(**SMALL)
    for mod in (jw, tw):
        with pytest.raises(ValueError, match="name >= 1 tenant"):
            mod.MultiTenant(tenant_read_frac=())
        with pytest.raises(ValueError, match="must be in"):
            mod.MultiTenant(tenant_read_frac=(1.0, 1.5))
        with pytest.raises(ValueError, match="must be >= 1"):
            mod.TraceReplay().sharded(0)
        with pytest.raises(ValueError, match="sq_depth"):
            mod.TraceReplay.from_trace(np.zeros(600), np.zeros(600),
                                       np.zeros(600), ct)
    with pytest.raises(ValueError, match="cannot host"):
        tw.MultiTenant(tenant_read_frac=(1.0,) * 9).tenant_of_sq(
            torch.arange(8, dtype=torch.int32), ct)
    with pytest.raises(ValueError, match="theta"):
        tw.ZipfClosedLoop(theta=1.0).address(
            torch.arange(4, dtype=torch.int32), tt.SSDConfig())
    assert tw.SteadyStateMixed().precondition_drive
    assert tw.ZipfClosedLoop().sharded(4) == tw.ZipfClosedLoop()


# -- whole runs ----------------------------------------------------------------

RUN_SSD = {"zipf": dict(routing="lba_hash")}


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generator_run_matches_reference(name):
    """24 rounds of each generator through ``simulate`` on the small drive
    (the Zipf loop under ``routing="lba_hash"``, the steady-state mix on a
    preconditioned drive): every integer and bool leaf equal, time leaves
    within ``TIME_ULP`` (0; the Zipf run, where several rows share a flash
    instance, reaches the timing core's fused multiply-adds), the metric
    sums within ``SUM_ULP``."""
    (cj, wj), (ct, wt) = _pair(name)
    kw = RUN_SSD.get(name, {})
    sj, st = jt.SSDConfig(**kw), tt.SSDConfig(**kw)
    ref = je.make_runner(cj, sj, wj, jt.PlatformModel(), ROUNDS)(
        je.init_state(cj, sj, wj))
    out = te.simulate(ct, st, wt, tt.PlatformModel(), rounds=ROUNDS,
                      device="cpu")
    ref = {jax.tree_util.keystr(p).lstrip("."): np.asarray(v)
           for p, v in jax.tree_util.tree_flatten_with_path(ref)[0]}
    out = convert.engine_state_to_numpy(out)
    assert ref["metrics.completed"] > 0
    bounds = {**{k: SUM_ULP for k in SUMS}, **{k: TIME_ULP for k in TIMES}}
    assert not convert.leaf_differences(ref, out, bounds)
    if name == "steady":
        assert int(ref["device.flash.gc_count"]) == int(
            out["device.flash.gc_count"])
