"""The port's autograd pieces against the reference: the flash-attention
custom VJP (``models/flash_vjp.py``), the two repaired primitives the
RG-LRU differentiates through (``xla_math._fma32`` and
``segops.associative_scan``'s interleave), and the attention kernels'
refusal of autograd.

Bounds: flash forward within 1e-5 of the largest |o|, and dq, dk, dv
within ``VJP_REL`` = 1e-5 of the largest |g| of each, against
``jax.grad`` of the reference's ``flash_attention_jnp`` (jitted), and
against torch autograd through the plain full-softmax
``kernels/ref.attention_ref`` (float32 sums in another order: measured
below 1e-6). ``_fma32``'s gradient equals ``jax.grad`` of a jitted
``a*b + c`` bit for bit; the RG-LRU scan's gradients through
``associative_scan`` within ``SCAN_REL`` = 1e-6 of their largest
(XLA's own fused multiply-adds in its backward).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.flash_vjp import flash_attention_jnp as jflash
from repro_torch.core import segops, xla_math
from repro_torch.kernels import ops, ref
from repro_torch.models import attention, recurrent
from repro_torch.models.flash_vjp import flash_attention_jnp
from repro_torch import configs
from port_threads import one_torch_thread  # noqa: F401

CASES = [
    # (B, Hq, Hkv, S, D, causal, window, cap, qc, kc)
    (1, 2, 2, 64, 16, True, None, None, 16, 16),
    (2, 4, 2, 64, 16, True, None, None, 32, 16),
    (1, 4, 1, 128, 8, True, 32, None, 32, 32),
    (1, 2, 2, 64, 16, True, None, 30.0, 16, 32),
    (1, 4, 2, 128, 16, True, 64, 50.0, 64, 32),
    (1, 2, 2, 64, 16, False, None, None, 64, 64),
]
VJP_REL = 1e-5
SCAN_REL = 1e-6


def inputs(case, seed=3):
    b, hq, hkv, s, d = case[:5]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for shape in
            ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d), (b, hq, s, d))]


def close(got, want, rel):
    scale = float(np.abs(want).max())
    return float(np.abs(got - want).max()) <= rel * scale


def port_grads(fn, q, k, v, ct):
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = fn(*leaves)
    (out * torch.from_numpy(ct)).sum().backward()
    return out.detach().numpy(), [x.grad.numpy() for x in leaves]


@pytest.mark.parametrize("case", CASES)
def test_flash_vjp_matches_reference(case):
    _, _, _, _, d, causal, window, cap, qc, kc = case
    q, k, v, ct = inputs(case)
    scale = d ** -0.5

    def jfn(q, k, v):
        o = jflash(q, k, v, causal, window, cap, scale, qc, kc)
        return jnp.sum(o * ct), o

    (_, want_o), want_g = jax.jit(jax.value_and_grad(
        jfn, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    got_o, got_g = port_grads(
        lambda q, k, v: flash_attention_jnp(q, k, v, causal, window, cap,
                                            scale, qc, kc), q, k, v, ct)
    assert close(got_o, np.asarray(want_o), VJP_REL)
    for name, g, w in zip("qkv", got_g, want_g):
        assert close(g, np.asarray(w), VJP_REL), f"d{name}"

    # ... and against autograd through the plain full-softmax attention.
    naive_o, naive_g = port_grads(
        lambda q, k, v: ref.attention_ref(q, k, v, causal=causal,
                                          window=window, logit_softcap=cap,
                                          scale=scale), q, k, v, ct)
    assert close(got_o, naive_o, VJP_REL)
    for name, g, w in zip("qkv", got_g, naive_g):
        assert close(g, w, VJP_REL), f"d{name} against attention_ref"


def test_flash_vjp_saves_only_its_residuals():
    """The forward keeps (q, k, v, o, lse) for the backward and nothing
    else (plain autograd through the chunk loop would keep every chunk's
    carry); dq, dk, dv come back in the inputs' dtype (bf16 here)."""
    case = CASES[4]
    b, hq, hkv, s, d = case[:5]
    q, k, v, _ = (torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
                  for x in inputs(case))
    packed = []

    def pack(x):
        packed.append(tuple(x.shape))
        return x

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        o = flash_attention_jnp(q, k, v, True, 64, 50.0, d ** -0.5, 64, 32)
    assert packed == [(b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d),
                      (b, hq, s, d), (b, hq, s)]
    o.float().sum().backward()
    assert o.dtype == torch.bfloat16
    assert q.grad.dtype == k.grad.dtype == v.grad.dtype == torch.bfloat16


def test_fma32_gradient_matches_reference():
    """``_fma32`` keeps its single rounding and now carries the gradient
    of a*b + c: (g·b, g·a, g), as ``jax.grad`` of the jitted product and
    sum gives it."""
    rng = np.random.default_rng(5)
    a, b, c, g = (rng.standard_normal(257).astype(np.float32)
                  for _ in range(4))
    want = jax.jit(jax.grad(lambda a, b, c: jnp.sum((a * b + c) * g),
                            argnums=(0, 1, 2)))(a, b, c)
    ta, tb, tc = (torch.from_numpy(x).requires_grad_(True) for x in (a, b, c))
    out = xla_math._fma32(ta, tb, tc)
    assert out.requires_grad and out.grad_fn is not None
    assert torch.equal(out.detach(), xla_math._fma32(*(torch.from_numpy(x)
                                                       for x in (a, b, c))))
    (out * torch.from_numpy(g)).sum().backward()
    for got, w in zip((ta.grad, tb.grad, tc.grad), want):
        np.testing.assert_array_equal(got.numpy(), np.asarray(w))


def test_interleave_keeps_bits_under_autograd():
    """With a half requiring grad, the interleave gives the bits of the
    ``out=`` path (-0 made +0) at odd and even lengths."""
    for na, nb in ((4, 4), (5, 4)):
        a = torch.tensor([-0.0, 1.5, -2.0, 0.0, 3.0][:na])
        b = torch.tensor([0.0, -0.0, 7.0, -1.0][:nb])
        plain = segops._interleave(a, b)
        got = segops._interleave(a.clone().requires_grad_(True), b)
        assert got.grad_fn is not None
        assert torch.equal(got.detach().view(torch.int32),
                           plain.view(torch.int32))
        assert not torch.signbit(got.detach()).logical_and(
            got.detach() == 0).any()


def test_rglru_scan_gradient_matches_reference():
    """The RG-LRU combine through ``associative_scan`` (odd length, so the
    interleave's uneven halves too): forward bit for bit and gradients of
    a and b against ``jax.grad`` of the jitted ``lax.associative_scan``."""
    rng = np.random.default_rng(7)
    a = rng.uniform(0.5, 1.0, (2, 37, 8)).astype(np.float32)
    b = rng.standard_normal((2, 37, 8)).astype(np.float32)
    ct = rng.standard_normal((2, 37, 8)).astype(np.float32)

    def combine(lhs, rhs):
        return lhs[0] * rhs[0], rhs[0] * lhs[1] + rhs[1]

    def jfn(a, b):
        h = jax.lax.associative_scan(combine, (a, b), axis=1)[1]
        return jnp.sum(h * ct), h

    (_, want_h), want_g = jax.jit(jax.value_and_grad(
        jfn, argnums=(0, 1), has_aux=True))(a, b)
    ta, tb = (torch.from_numpy(x).requires_grad_(True) for x in (a, b))
    h = segops.associative_scan(recurrent._lru_combine,
                                [ta.transpose(1, 2), tb.transpose(1, 2)])[1]
    h = h.transpose(1, 2)
    np.testing.assert_array_equal(h.detach().numpy(), np.asarray(want_h))
    (h * torch.from_numpy(ct)).sum().backward()
    for got, w in zip((ta.grad, tb.grad), want_g):
        assert close(got.numpy(), np.asarray(w), SCAN_REL)


def test_attention_kernels_refuse_autograd():
    """The kernel route (``use_pallas=True``) has no backward: an input
    that requires grad raises, naming the training path; under no_grad,
    or with inputs that need none, the route runs."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((1, 4, 16, 8), (1, 2, 16, 8), (1, 2, 16, 8)))
    lengths = torch.full((1,), 16, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="use_pallas=False"):
        ops.flash_attention(q.requires_grad_(True), k, v, causal=True)
    with pytest.raises(RuntimeError, match="use_pallas=False"):
        ops.decode_attention(q[:, :, 0], k, v.requires_grad_(True), lengths)
    with torch.no_grad():
        ops.flash_attention(q, k, v, causal=True)
        ops.decode_attention(q[:, :, 0], k, v, lengths)
    ops.flash_attention(q.detach(), k, v.detach(), causal=True)

    cfg = configs.get_config("starcoder2-3b", smoke=True)
    from repro_torch.models import transformer
    params = transformer.init_model(torch.Generator().manual_seed(0), cfg)
    x = torch.randn(1, 16, cfg.d_model, requires_grad=True)
    pos = torch.arange(16, dtype=torch.int32)[None]
    p0 = {kk: vv[0] for kk, vv in params["periods"][0]["attn"].items()}
    with pytest.raises(RuntimeError, match="use_pallas=False"):
        attention.attention_apply(p0, x, cfg.replace(use_pallas=True),
                                  "attn", pos)
    attention.attention_apply(p0, x, cfg, "attn", pos).sum().backward()
    assert x.grad is not None


def test_refusal_comes_before_the_cuda_launch(monkeypatch):
    """On the card's route (stubbed here: no card) the refusal is raised
    before the kernel is called, and without grad the kernel is what
    runs."""
    calls = []
    monkeypatch.setattr(ops, "_on_cuda", lambda t, what: True)
    monkeypatch.setattr(ops._fa, "flash_attention",
                        lambda *a, **kw: calls.append("flash") or a[0])
    q = torch.zeros(1, 2, 8, 4)
    with pytest.raises(RuntimeError, match="use_pallas=False"):
        ops.flash_attention(q.requires_grad_(True), q, q)
    assert calls == []
    with torch.no_grad():
        ops.flash_attention(q, q, q)
    assert calls == ["flash"]
