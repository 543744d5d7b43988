"""The port's recurrent blocks (``repro_torch/models/recurrent.py``)
against the reference's (``repro/models/recurrent.py``): the causal conv,
Griffin's RG-LRU, xLSTM's mLSTM (chunkwise, several chunks) and sLSTM,
over a sequence and carried from a state, and their state initializers.

Inputs come from a numpy seed, parameters from the reference's
initializers. Bounds, with their reasons:
- the RG-LRU scan's combine ``a2*b1 + b2`` and the carried state's fold
  ``b0 + a0*h0``: bit for bit with the compiled reference, which fuses
  both into one rounding (``xla_math._fma32``);
- the causal conv: bit for bit with the eager reference; within 1e-5 of
  the compiled one, which contracts each tap's product into the running
  sum (the port rounds the products);
- softplus and log-sigmoid: within 2 ULP (XLA's own exp and log1p);
- block outputs and states: ``rtol=atol=1e-5`` (float32 products summed
  in another order and the above).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import recurrent as jrec
from repro_torch import configs
from repro_torch.convert import ulp_distance
from repro_torch.core import segops
from repro_torch.models import recurrent as rec
from port_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)


def t(x):
    return torch.from_numpy(np.array(x))


def cfgs(arch):
    return (jconfigs.get_config(arch, smoke=True),
            configs.get_config(arch, smoke=True))


def close(got, want):
    """Every leaf of a (nested) state within TOL, dtypes equal."""
    g = jax.tree.leaves(got, is_leaf=lambda x: isinstance(x, torch.Tensor))
    w = jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert str(a.dtype).removeprefix("torch.") == str(np.asarray(b).dtype)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 64)).astype(np.float32)
    w = rng.standard_normal((4, 64)).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    st = rng.standard_normal((2, 3, 64)).astype(np.float32) if with_state \
        else None
    eager = jrec._causal_conv(*map(jnp.asarray, (x, w, b)),
                              None if st is None else jnp.asarray(st))
    jitted = jax.jit(jrec._causal_conv)(x, w, b, st)
    got = rec._causal_conv(t(x), t(w), t(b), None if st is None else t(st))
    for g, e, j in zip(got, eager, jitted):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e))
        np.testing.assert_allclose(g.numpy(), np.asarray(j), **TOL)


@pytest.mark.parametrize("s", [1, 2, 7, 16, 33, 48])
def test_lru_scan_is_the_compiled_reference(s):
    """JAX's odd/even ``associative_scan`` tree with the combine fused as
    the compiled reference fuses it, and the state fold: bit for bit."""
    rng = np.random.default_rng(s)
    a = rng.uniform(0.5, 1.0, (2, s, 64)).astype(np.float32)
    b = rng.standard_normal((2, s, 64)).astype(np.float32)
    h0 = rng.standard_normal((2, 64)).astype(np.float32)

    def combine(lhs, rhs):
        return lhs[0] * rhs[0], rhs[0] * lhs[1] + rhs[1]

    want_h = jax.jit(lambda a, b: jax.lax.associative_scan(
        combine, (a, b), axis=1)[1])(a, b)
    got_h = segops.associative_scan(
        rec._lru_combine, [t(a).transpose(1, 2), t(b).transpose(1, 2)])[1]
    np.testing.assert_array_equal(got_h.transpose(1, 2).numpy(),
                                  np.asarray(want_h))
    want_b = jax.jit(lambda a, b, h: b.at[:, 0].add(a[:, 0] * h))(a, b, h0)
    got_b = rec.xla_math._fma32(t(a[:, 0]), t(h0), t(b[:, 0]))
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b)[:, 0])


def test_softplus_and_log_sigmoid_match_reference():
    v = (np.random.default_rng(1).standard_normal(4096) * 10).astype(
        np.float32)
    # No |input| above about 87: XLA flushes the subnormal results of
    # softplus(-x) and log_sigmoid(x) there to zero, the port keeps them
    # (ROADMAP, standing notes).
    v[:6] = [0.0, -0.0, 30.0, -30.0, 80.0, -80.0]
    for want, got in ((jax.nn.softplus, rec.softplus),
                      (jax.nn.log_sigmoid, rec.log_sigmoid)):
        assert ulp_distance(np.asarray(jax.jit(want)(v)),
                            got(t(v)).numpy()) <= 2
    assert bool(torch.isnan(rec.softplus(torch.tensor([float("nan")]))))


@pytest.mark.parametrize("with_state", [False, True])
def test_rglru_apply_matches_reference(with_state):
    jcfg, tcfg = cfgs("recurrentgemma-9b")
    p, _ = jrec.rglru_init(jax.random.PRNGKey(0), jcfg, jnp.float32)
    p = jax.tree.map(np.asarray, p)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 16, jcfg.d_model)).astype(np.float32)
    state = None
    if with_state:
        state = (rng.standard_normal((2, 3, 64)).astype(np.float32),
                 rng.standard_normal((2, 64)).astype(np.float32))
    y, st = jax.jit(lambda p, x, s: jrec.rglru_apply(p, x, jcfg, s))(
        p, x, state)
    t_state = None if state is None else tuple(map(t, state))
    yt, stt = rec.rglru_apply(jax.tree.map(t, p), t(x), tcfg, t_state)
    np.testing.assert_allclose(yt.numpy(), np.asarray(y), **TOL)
    close(stt, st)
    if with_state:                      # written into the given tensors
        assert stt[0] is t_state[0] and stt[1] is t_state[1]


def test_rglru_decode_steps_continue_the_sequence():
    """A prefill of 12 tokens, then 4 one-token steps from its state, give
    the outputs and state of one pass over all 16 (the reference's
    rglru_decode is rglru_apply at S = 1)."""
    jcfg, tcfg = cfgs("recurrentgemma-9b")
    p, _ = jrec.rglru_init(jax.random.PRNGKey(1), jcfg, jnp.float32)
    pt = jax.tree.map(lambda a: t(np.asarray(a)), p)
    x = np.random.default_rng(3).standard_normal(
        (2, 16, jcfg.d_model)).astype(np.float32)
    y_all, st_all = jax.jit(lambda p, x: jrec.rglru_apply(p, x, jcfg))(p, x)
    state = rec.rglru_init_state(tcfg, 2, torch.float32, "cpu")
    ys = [rec.rglru_apply(pt, t(x[:, :12]), tcfg, state)[0]]
    for i in range(12, 16):
        ys.append(rec.rglru_apply(pt, t(x[:, i:i + 1]), tcfg, state)[0])
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), np.asarray(y_all),
                               **TOL)
    close(state, st_all)


@pytest.mark.parametrize("with_state", [False, True])
def test_mlstm_apply_matches_reference(with_state):
    """chunk = 4 over S = 16: four chunks, so the (C, n, m) carry passes
    between chunks; from zeros (m at -3e38) and from a given state."""
    jcfg, tcfg = cfgs("xlstm-1.3b")
    p, _ = jrec.mlstm_init(jax.random.PRNGKey(2), jcfg, jnp.float32)
    p = jax.tree.map(np.asarray, p)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 16, jcfg.d_model)).astype(np.float32)
    hh, dh = jcfg.n_heads, jcfg.d_head
    state = None
    if with_state:
        state = (rng.standard_normal((2, 3, hh * dh)).astype(np.float32),
                 (rng.standard_normal((2, hh, dh, dh)).astype(np.float32),
                  rng.standard_normal((2, hh, dh)).astype(np.float32),
                  rng.standard_normal((2, hh)).astype(np.float32)))
    y, st = jax.jit(lambda p, x, s: jrec.mlstm_apply(p, x, jcfg, s, chunk=4))(
        p, x, state)
    t_state = None if state is None else jax.tree.map(t, state)
    yt, stt = rec.mlstm_apply(jax.tree.map(t, p), t(x), tcfg, t_state,
                              chunk=4)
    np.testing.assert_allclose(yt.numpy(), np.asarray(y), **TOL)
    close(stt, st)
    assert bool(torch.isfinite(stt[1][2]).all())


def test_mlstm_one_token_steps_match_reference():
    """Decode's chunk = 1 from a prefill's state, both packages."""
    jcfg, tcfg = cfgs("xlstm-1.3b")
    p, _ = jrec.mlstm_init(jax.random.PRNGKey(3), jcfg, jnp.float32)
    p = jax.tree.map(np.asarray, p)
    x = np.random.default_rng(5).standard_normal(
        (2, 8, jcfg.d_model)).astype(np.float32)

    def run(p, x):
        s0 = jrec.mlstm_init_state(jcfg, 2, jnp.float32)
        y, s = jrec.mlstm_apply(p, x[:, :6], jcfg, s0)
        ys = [y]
        for i in range(6, 8):
            y, s = jrec.mlstm_apply(p, x[:, i:i + 1], jcfg, s, chunk=1)
            ys.append(y)
        return jnp.concatenate(ys, 1), s

    y, st = jax.jit(run)(p, x)
    pt = jax.tree.map(t, p)
    state = rec.mlstm_init_state(tcfg, 2, torch.float32, "cpu")
    ys = [rec.mlstm_apply(pt, t(x[:, :6]), tcfg, state)[0]]
    for i in range(6, 8):
        ys.append(rec.mlstm_apply(pt, t(x[:, i:i + 1]), tcfg, state,
                                  chunk=1)[0])
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), np.asarray(y), **TOL)
    close(state, st)


@pytest.mark.parametrize("with_state", [False, True])
def test_slstm_apply_matches_reference(with_state):
    jcfg, tcfg = cfgs("xlstm-1.3b")
    p, _ = jrec.slstm_init(jax.random.PRNGKey(4), jcfg, jnp.float32)
    p = jax.tree.map(np.asarray, p)
    p["norm"] = np.random.default_rng(6).standard_normal(
        p["norm"].shape).astype(np.float32) * 0.1
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 12, jcfg.d_model)).astype(np.float32)
    state = None
    if with_state:
        shape = (2, jcfg.n_heads, jcfg.d_head)
        state = tuple(rng.standard_normal(shape).astype(np.float32)
                      for _ in range(3))
        state = (state[0], state[1], np.abs(state[2]) + 1.0,
                 rng.standard_normal(shape).astype(np.float32))
    y, st = jax.jit(lambda p, x, s: jrec.slstm_apply(p, x, jcfg, s))(
        p, x, state)
    t_state = None if state is None else tuple(map(t, state))
    yt, stt = rec.slstm_apply(jax.tree.map(t, p), t(x), tcfg, t_state)
    np.testing.assert_allclose(yt.numpy(), np.asarray(y), **TOL)
    close(stt, st)
    if with_state:
        assert all(a is b for a, b in zip(stt, t_state))


@pytest.mark.parametrize("arch,kind", [("recurrentgemma-9b", "rglru"),
                                       ("xlstm-1.3b", "mlstm"),
                                       ("xlstm-1.3b", "slstm")])
def test_state_init_matches_reference(arch, kind):
    """Zeros, but mLSTM's m at -3e38 and sLSTM's n at ones; float32 but
    the conv states, which are in the model dtype."""
    jcfg, tcfg = cfgs(arch)
    jcfg = jcfg.replace(dtype="bfloat16")
    want = getattr(jrec, f"{kind}_init_state")(jcfg, 3, jnp.bfloat16)
    got = getattr(rec, f"{kind}_init_state")(tcfg, 3, torch.bfloat16, "cpu")
    w = jax.tree.leaves(want)
    g = jax.tree.leaves(got, is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert len(w) == len(g)
    for a, b in zip(w, g):
        assert str(np.asarray(a).dtype) == str(b.dtype).removeprefix("torch.")
        np.testing.assert_array_equal(b.float().numpy(),
                                      np.asarray(a).astype(np.float32))
