"""The port's MoE (``repro_torch/models/moe.py``) against the reference's
single-device path (``repro/models/moe.py``): routing, capacity drops,
ties, the dispatched output and the aux loss.

Inputs come from a numpy seed; the parameters are the reference's
``moe_init`` leaves. The integer routing (expert choice, rank within the
expert, the capacity mask, the buffer slot) must be equal; the float
outputs agree within ``rtol=atol=1e-5`` (float32 products summed in
another order), the aux loss within 1e-6 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import segops as jseg
from repro.models import moe as jmoe
from repro_torch import configs
from repro_torch.models import moe
from port_threads import one_torch_thread  # noqa: F401

ARCHS = ["qwen2-moe-a2.7b", "qwen3-moe-30b-a3b"]
TOL = dict(rtol=1e-5, atol=1e-5)
T = 40


def t(x):
    return torch.from_numpy(np.array(x))


def reference_route(params, xt, cfg, t_for_cap):
    """The routing lines of the reference's ``_local_moe`` (its integer
    intermediates are not returned there)."""
    t_, _ = xt.shape
    e, k = cfg.n_experts, cfg.top_k
    logits = jnp.einsum("td,de->te", xt, params["router"].astype(xt.dtype),
                        preferred_element_type=jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    top_p, top_e = jax.lax.top_k(probs, k)
    top_p = top_p / jnp.sum(top_p, axis=-1, keepdims=True)
    cap = int(t_for_cap * k / e * cfg.capacity_factor + 0.999)
    cap = max(4, -(-cap // 4) * 4)
    e_flat = top_e.reshape(t_ * k)
    rank = jseg.segment_rank(e_flat)
    keep = rank < cap
    slot = jnp.where(keep, e_flat * cap + rank, e * cap)
    return dict(probs=probs, top_p=top_p, top_e=top_e, rank=rank,
                keep=keep, slot=slot)


def case(arch, capacity_factor, seed=0):
    jcfg = jconfigs.get_config(arch, smoke=True).replace(
        capacity_factor=capacity_factor)
    tcfg = configs.get_config(arch, smoke=True).replace(
        capacity_factor=capacity_factor)
    p, _ = jmoe.moe_init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    p = jax.tree.map(np.asarray, p)
    x = np.random.default_rng(seed).standard_normal(
        (T, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, p, jax.tree.map(t, p), x


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_local_moe_matches_reference(arch, capacity_factor):
    """At the config's capacity and at one that drops pairs (the spare
    buffer row of ``mode="drop"``): routing exact, output and stats within
    the bound."""
    jcfg, tcfg, p, pt, x = case(arch, capacity_factor)
    want_r = jax.jit(lambda p, x: reference_route(p, x, jcfg, T))(p, x)
    got_r = moe.route(pt, t(x), tcfg, T)
    for key in ("top_e", "rank", "keep", "slot"):
        w = np.asarray(want_r[key]).reshape(-1)
        np.testing.assert_array_equal(got_r[key].reshape(-1).numpy(), w)
    assert got_r["rank"].dtype == torch.int32
    for key in ("probs", "top_p"):
        np.testing.assert_allclose(got_r[key].numpy(),
                                   np.asarray(want_r[key]), **TOL)
    dropped = int((~got_r["keep"]).sum())
    assert (dropped > 0) == (capacity_factor < 1), dropped

    out, f_e, p_e = jax.jit(lambda p, x: jmoe._local_moe(p, x, jcfg, T))(p, x)
    got = moe._local_moe(pt, t(x), tcfg, T)
    for w, g in zip((out, f_e, p_e), got):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_output_and_aux_match_reference(arch):
    jcfg, tcfg, p, pt, _ = case(arch, jconfigs.get_config(
        arch, smoke=True).capacity_factor, seed=1)
    x = np.random.default_rng(5).standard_normal(
        (2, 8, jcfg.d_model)).astype(np.float32)
    y, aux = jax.jit(lambda p, x: jmoe.moe_apply(p, x, jcfg))(p, x)
    yt, auxt = moe.moe_apply(pt, t(x), tcfg)
    np.testing.assert_allclose(yt.numpy(), np.asarray(y), **TOL)
    assert auxt.dtype == torch.float32 and auxt.shape == ()
    assert float(auxt) == pytest.approx(float(aux), rel=1e-6)


def test_top_k_ties_resolve_as_lax_top_k():
    """Planted ties, within rows and across the k-th place: the lower
    expert index first, as ``lax.top_k`` (``torch.topk`` promises no
    order)."""
    rng = np.random.default_rng(2)
    probs = rng.integers(0, 4, (64, 60)).astype(np.float32) / 4
    probs[0] = 0.5
    probs[1, ::2] = 0.75
    for k in (1, 4, 8):
        wv, wi = jax.lax.top_k(probs, k)
        gv, gi = moe.top_k(t(probs), k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def test_router_ties_route_as_the_reference():
    """A router whose expert columns repeat gives equal logits for those
    experts: the same choices, ranks and slots as the reference's."""
    arch = "qwen3-moe-30b-a3b"
    jcfg, tcfg, p, _, x = case(arch, 1.25, seed=3)
    e = jcfg.n_experts
    p["router"] = np.tile(p["router"][:, : e // 2], (1, 2))
    pt = jax.tree.map(t, p)
    want = jax.jit(lambda p, x: reference_route(p, x, jcfg, T))(p, x)
    got = moe.route(pt, t(x), tcfg, T)
    top = np.asarray(want["top_e"])
    assert (top[:, 0] < e // 2).all()          # the lower copy wins
    for key in ("top_e", "rank", "keep", "slot"):
        np.testing.assert_array_equal(
            got[key].reshape(-1).numpy(), np.asarray(want[key]).reshape(-1))


@pytest.mark.parametrize("t_for_cap", [1, 4, 40, 128, 4096])
def test_capacity_matches_reference_arithmetic(t_for_cap):
    for arch in ARCHS:
        cfg = configs.get_config(arch)
        k, e = cfg.top_k, cfg.n_experts
        cap = int(t_for_cap * k / e * cfg.capacity_factor + 0.999)
        assert moe.capacity(cfg, t_for_cap) == max(4, -(-cap // 4) * 4)


def test_bf16_moe_keeps_float32_router_and_token_dtype():
    """In a bf16 model the router and shared gate stay float32, the
    output is bf16, and the routing equals the reference's on the same
    bf16 tokens (its float32-accumulated router product is exact for
    bf16 operands)."""
    arch = "qwen2-moe-a2.7b"
    jcfg = jconfigs.get_config(arch, smoke=True).replace(dtype="bfloat16")
    tcfg = configs.get_config(arch, smoke=True).replace(dtype="bfloat16")
    p, _ = jmoe.moe_init(jax.random.PRNGKey(4), jcfg, jnp.bfloat16)
    got_p = moe.moe_init(torch.Generator().manual_seed(0), tcfg,
                         torch.bfloat16)
    assert got_p["router"].dtype == torch.float32
    assert got_p["shared_gate"].dtype == torch.float32
    assert got_p["w_gate"].dtype == torch.bfloat16
    x = jnp.asarray(np.random.default_rng(6).standard_normal(
        (T, jcfg.d_model)), jnp.bfloat16)

    def bits(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.uint16).copy()).view(
                torch.bfloat16)
        return t(a)

    pt = jax.tree.map(bits, p)
    want = jax.jit(lambda p, x: reference_route(p, x, jcfg, T))(p, x)
    got = moe.route(pt, bits(x), tcfg, T)
    for key in ("top_e", "rank", "keep", "slot"):
        np.testing.assert_array_equal(
            got[key].reshape(-1).numpy(), np.asarray(want[key]).reshape(-1))
    out, _, _ = moe._local_moe(pt, bits(x), tcfg, T)
    assert out.dtype == torch.bfloat16 and out.shape == (T, jcfg.d_model)
