"""The port's LM substrate against the reference: configs, layers,
attention blocks, and prefill / decode of the dense smoke models.

Parameters come from the reference's ``init_model`` and cross over through
``convert.model_params_from_numpy``; token inputs come from a numpy seed.
The smoke configs are float32. Tolerances: ``rtol=atol=1e-5`` for single
layers, ``rtol=atol=1e-4`` on logits (sums run in another order), and
greedy tokens must be identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as jtr
from repro.serving import loop as jloop
from repro_torch import configs, convert
from repro_torch.kernels import ref as kref
from repro_torch.models import attention, layers, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.serving import loop
from port_threads import one_torch_thread  # noqa: F401

ARCHS = ["starcoder2-3b", "gemma2-27b", "yi-34b"]
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


def t(x):
    return torch.from_numpy(np.array(x))


def smoke(arch, use_pallas=False):
    return (jconfigs.get_config(arch, smoke=True).replace(
                use_pallas=use_pallas),
            configs.get_config(arch, smoke=True).replace(
                use_pallas=use_pallas))


def params_for(jcfg, tcfg, seed=0):
    tree = jtr.init_model(jax.random.PRNGKey(seed), jcfg)
    port = convert.model_params_from_numpy(
        jax.tree.map(np.asarray, tree), tcfg, "cpu")
    return tree, port


# -- configs -----------------------------------------------------------------

@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_configs_match_reference(arch):
    for smoke_ in (False, True):
        r = jconfigs.get_config(arch, smoke=smoke_)
        p = configs.get_config(arch, smoke=smoke_)
        assert dataclasses.asdict(r) == dataclasses.asdict(p)
        assert (r.param_count(), r.active_param_count(), r.n_periods,
                r.remainder) == (p.param_count(), p.active_param_count(),
                                 p.n_periods, p.remainder)


def test_registry_matches_reference():
    assert configs.ARCHS == jconfigs.ARCHS
    assert configs.SUBQUADRATIC == jconfigs.SUBQUADRATIC
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    assert configs.cells() == jconfigs.cells()
    assert [configs.runnable(*c) for c in configs.cells()] == [
        jconfigs.runnable(*c) for c in jconfigs.cells()]
    assert [f.name for f in dataclasses.fields(ModelConfig)] == [
        f.name for f in dataclasses.fields(jconfigs.get_config("yi-34b"))]


# -- layers ------------------------------------------------------------------

def test_norms_softcap_and_rope_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 5, 16)).astype(np.float32) * 3
    w = rng.standard_normal(16).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    pos = rng.integers(0, 5000, (2, 5)).astype(np.int32)
    pairs = [
        (jlayers.rms_norm(x, w), layers.rms_norm(t(x), t(w))),
        (jlayers.layer_norm(x, w, b), layers.layer_norm(t(x), t(w), t(b))),
        (jlayers.softcap(x, 2.5), layers.softcap(t(x), 2.5)),
        (jlayers.apply_rope(x, pos, 999999.0),
         layers.apply_rope(t(x), t(pos), 999999.0)),
    ]
    for want, got in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)
    assert layers.softcap(t(x), None) is not None


@pytest.mark.parametrize("act,gated,bias", [
    ("gelu", False, True), ("silu", True, False), ("gelu", True, True),
])
def test_mlp_matches_reference(act, gated, bias):
    p, _ = jlayers.mlp_init(jax.random.PRNGKey(3), 16, 32, gated, bias,
                            jnp.float32)
    if bias:
        p = {k: v + 0.1 for k, v in p.items()}
    x = np.random.default_rng(1).standard_normal((2, 4, 16)).astype(np.float32)
    want = jlayers.mlp_apply(p, x, act, gated)
    got = layers.mlp_apply({k: t(np.asarray(v)) for k, v in p.items()},
                           t(x), act, gated)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


# -- attention ---------------------------------------------------------------

@pytest.fixture(scope="module")
def attn_ref():
    """The reference's attention block outputs, once per arch (its plain
    path; its Pallas path agrees with it and is held against the port's
    kernels' plain versions in test_torch_attention.py)."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jcfg, _ = smoke(arch)
            kind = jcfg.pattern[0]
            p, _ = jattn.attn_init(jax.random.PRNGKey(1), jcfg, jnp.float32)
            rng = np.random.default_rng(2)
            s = 64 if arch == "gemma2-27b" else 16  # past gemma2's window
            x = rng.standard_normal((2, s, jcfg.d_model)).astype(np.float32)
            pos = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s))
            y, kv = jax.jit(lambda p, x: jattn.attention_prefill(
                p, x, jcfg, kind, pos, cache_len=s + 2))(p, x)
            x1 = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
            y1, (k1, _) = jax.jit(lambda p, x, c: jattn.attention_decode(
                p, x, c, jnp.int32(s), jcfg, kind))(p, x1, kv)
            cache[arch] = dict(p=p, x=x, pos=pos, x1=x1, y=y, kv=kv, y1=y1,
                               k1=k1, s=s, kind=kind)
        return cache[arch]

    return get


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("use_pallas", [False, True])
def test_attention_prefill_and_decode_match_reference(arch, use_pallas,
                                                      attn_ref):
    r = attn_ref(arch)
    _, tcfg = smoke(arch, use_pallas)
    pt = {k: t(v) for k, v in r["p"].items()}
    yt, (kt, vt) = attention.attention_prefill(pt, t(r["x"]), tcfg, r["kind"],
                                               t(r["pos"]), r["s"] + 2)
    for want, got in ((r["y"], yt), (r["kv"][0], kt), (r["kv"][1], vt)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)
    ya = attention.attention_apply(pt, t(r["x"]), tcfg, r["kind"],
                                   t(r["pos"]))
    np.testing.assert_allclose(ya.numpy(), np.asarray(r["y"]), **LAYER_TOL)
    y1t, (k1t, _) = attention.attention_decode(pt, t(r["x1"]), (kt, vt),
                                               r["s"], tcfg, r["kind"])
    np.testing.assert_allclose(y1t.numpy(), np.asarray(r["y1"]), **LAYER_TOL)
    np.testing.assert_allclose(k1t.numpy(), np.asarray(r["k1"]), **LAYER_TOL)


def _host_slicing_decode(params, x, cache, pos: int, cfg, kind):
    """The decode attention as the port computed it with a host-integer
    position before the position became a device tensor: the cache row
    written by slicing, the lengths filled from the integer, a local
    layer's window sliced at a host start."""
    window, scale = attention._window_scale(cfg, kind)
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int32)
    q, k_new, v_new = attention._project_qkv(params, x, cfg, positions)
    k_cache, v_cache = cache
    k_cache[:, :, pos:pos + 1] = k_new
    v_cache[:, :, pos:pos + 1] = v_new
    s_max, length = k_cache.shape[2], pos + 1
    if cfg.use_pallas:
        o = kref.decode_attention_ref(
            q[:, :, 0], k_cache, v_cache,
            torch.full((b,), length, dtype=torch.int32), window=window,
            logit_softcap=cfg.attn_softcap, scale=scale)[:, :, None, :]
        return attention._out_proj(params, o, cfg), (k_cache, v_cache)
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    qg = (q.float() * scale).to(q.dtype).reshape(b, hkv, hq // hkv,
                                                 cfg.d_head)
    if window is not None and window < s_max:
        start = min(max(length - window, 0), s_max - window)
        k_att = k_cache[:, :, start:start + window]
        v_att = v_cache[:, :, start:start + window]
        cols = start + torch.arange(window)
    else:
        k_att, v_att = k_cache, v_cache
        cols = torch.arange(s_max)
    logits = torch.matmul(qg.float(), k_att.float().transpose(-1, -2))
    if cfg.attn_softcap is not None:
        logits = layers.softcap(logits, cfg.attn_softcap)
    mask = cols < length
    if window is not None:
        mask &= cols > length - 1 - window
    p = torch.softmax(torch.where(mask, logits, attention.NEG), dim=-1)
    o = torch.matmul(p.to(v_att.dtype).float(), v_att.float())
    o = o.reshape(b, hq, 1, cfg.d_head).to(x.dtype)
    return attention._out_proj(params, o, cfg), (k_cache, v_cache)


@pytest.mark.parametrize("kind", ["attn_local", "attn"])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_attention_decode_device_position_equals_host_slicing(kind,
                                                              use_pallas):
    """gemma2's smoke layers (window 32, cache 80): at positions before,
    at and past the window's slide, the device-tensor position gives the
    host-integer computation's output and cache bit for bit."""
    _, tcfg = smoke("gemma2-27b", use_pallas)
    assert kind in tcfg.pattern
    p, _ = jattn.attn_init(jax.random.PRNGKey(1), smoke("gemma2-27b")[0],
                           jnp.float32)
    pt = {k: t(np.asarray(v)) for k, v in p.items()}
    rng = np.random.default_rng(9)
    shape = (2, tcfg.n_kv_heads, 80, tcfg.d_head)
    for pos in (5, 31, 32, 64, 79):
        k0 = rng.standard_normal(shape).astype(np.float32)
        v0 = rng.standard_normal(shape).astype(np.float32)
        x = t(rng.standard_normal((2, 1, tcfg.d_model)).astype(np.float32))
        want, (wk, wv) = _host_slicing_decode(pt, x, (t(k0), t(v0)), pos,
                                              tcfg, kind)
        got, (gk, gv) = attention.attention_decode(
            pt, x, (t(k0), t(v0)), torch.tensor(pos, dtype=torch.int32),
            tcfg, kind)
        for w, g in ((want, got), (wk, gk), (wv, gv)):
            np.testing.assert_array_equal(g.numpy(), w.numpy())


# -- whole model -------------------------------------------------------------

@pytest.fixture(scope="module")
def model_ref():
    """The reference's prefill and three greedy decode steps, once per
    arch, on its jitted plain path."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jcfg, tcfg = smoke(arch)
            jp, _ = params_for(jcfg, tcfg)
            s = 64 if arch == "gemma2-27b" else 16
            toks = np.random.default_rng(4).integers(
                0, jcfg.vocab, (2, s)).astype(np.int32)
            pre = jax.jit(lambda p, x: jtr.prefill(p, jcfg, tokens=x,
                                                   cache_len=s + 3))
            step = jax.jit(lambda p, x, c, i: jtr.decode_step(p, jcfg, x, c,
                                                              i))
            logits, c = pre(jp, jnp.asarray(toks))
            out = [np.asarray(logits)]
            for i in range(3):
                tok = jnp.argmax(logits, -1).astype(jnp.int32)
                logits, c = step(jp, tok, c, jnp.int32(s + i))
                out.append(np.asarray(logits))
            cache[arch] = (jp, toks, out, jax.tree.leaves(c))
        return cache[arch]

    return get


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("position", ["host_int", "device_tensor"])
def test_prefill_and_decode_steps_match_reference(arch, use_pallas, position,
                                                  model_ref):
    """Decode positions as host integers and as () int32 tensors (the
    reference's traced ``jnp.int32``, what the captured step reads)."""
    jp, toks, want, want_caches = model_ref(arch)
    _, tcfg = smoke(arch, use_pallas)
    tp = convert.model_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                         "cpu")
    s = toks.shape[1]
    tl, tc = transformer.prefill(tp, tcfg, t(toks), cache_len=s + 3)
    np.testing.assert_allclose(tl.numpy(), want[0], **LOGIT_TOL)
    for i in range(3):
        tok = np.argmax(want[i], -1).astype(np.int32)
        pos = (s + i if position == "host_int"
               else torch.tensor(s + i, dtype=torch.int32))
        tl, tc = transformer.decode_step(tp, tcfg, t(tok), tc, pos)
        np.testing.assert_allclose(tl.numpy(), want[i + 1], **LOGIT_TOL)
    got_caches = jax.tree.leaves(
        tc, is_leaf=lambda x: isinstance(x, torch.Tensor))
    for w, g in zip(want_caches, got_caches):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **LOGIT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_logits_match_reference(arch):
    jcfg, tcfg = smoke(arch)
    jp, tp = params_for(jcfg, tcfg, seed=5)
    toks = np.random.default_rng(6).integers(0, jcfg.vocab, (2, 64)).astype(
        np.int32)
    h, _ = jtr.forward(jp, jcfg, tokens=jnp.asarray(toks))
    ht, aux = transformer.forward(tp, tcfg, t(toks))
    assert float(aux) == 0.0
    np.testing.assert_allclose(ht.numpy(), np.asarray(h), **LOGIT_TOL)
    np.testing.assert_allclose(
        transformer.logits_fn(tp, tcfg, ht).numpy(),
        np.asarray(jtr.logits_fn(jp, jcfg, h)), **LOGIT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_tokens_match_reference(arch):
    """The port's kernel path against the reference's plain path."""
    jcfg, _ = smoke(arch)
    _, tcfg = smoke(arch, use_pallas=True)
    jp, tp = params_for(jcfg, tcfg, seed=7)
    toks = np.random.default_rng(8).integers(0, jcfg.vocab, (2, 16)).astype(
        np.int32)
    want = jloop.generate(jcfg, jp, jnp.asarray(toks),
                          jloop.ServeConfig(batch=2, prompt_len=16,
                                            gen_tokens=5))
    got = loop.generate(tcfg, tp, t(toks),
                        loop.ServeConfig(batch=2, prompt_len=16,
                                         gen_tokens=5), keep_logits=True)
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))
    assert got["tokens"].dtype == torch.int32 and len(got["logits"]) == 5


@pytest.mark.parametrize("arch", ARCHS)
def test_init_model_has_the_reference_tree(arch):
    jcfg, tcfg = smoke(arch)
    ref_tree = jax.eval_shape(lambda k: jtr.init_model(k, jcfg),
                              jax.random.PRNGKey(0))
    port = transformer.init_model(torch.Generator().manual_seed(0), tcfg)
    ref_leaves, ref_def = jax.tree.flatten(ref_tree)
    port_leaves, port_def = jax.tree.flatten(
        port, is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert str(ref_def) == str(port_def)
    for r, p in zip(ref_leaves, port_leaves):
        assert tuple(r.shape) == tuple(p.shape) and p.dtype == torch.float32
    # Projections are N(0, 1/fan_in), the embedding N(0, 1/d_model).
    wq = port["periods"][0]["attn"]["wq"]
    assert abs(float(wq.std()) * tcfg.d_model ** 0.5 - 1.0) < 0.1
    assert abs(float(port["embed"].std()) * tcfg.d_model ** 0.5 - 1.0) < 0.1


def test_caches_layout_matches_reference():
    jcfg, tcfg = smoke("gemma2-27b")
    want = jtr.init_caches(jcfg, 2, 24)
    got = transformer.init_caches(tcfg, 2, 24, "cpu")
    assert [tuple(x.shape) for x in jax.tree.leaves(want)] == [
        tuple(x.shape) for x in jax.tree.leaves(
            got, is_leaf=lambda x: isinstance(x, torch.Tensor))]


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "xlstm-1.3b",
                                  "recurrentgemma-9b", "musicgen-large"])
def test_unported_blocks_raise(arch):
    """Every block kind of the reference is ported (these configs build;
    tests/test_torch_archs.py holds them against the reference); a kind
    that neither package has raises ``ValueError``, as the reference's
    ``block_init`` does."""
    cfg = configs.get_config(arch, smoke=True)
    transformer.init_model(torch.Generator().manual_seed(0), cfg)
    bad = cfg.replace(pattern=("mamba",) + cfg.pattern[1:])
    with pytest.raises(ValueError, match="mamba"):
        transformer.init_model(torch.Generator().manual_seed(0), bad)
    with pytest.raises(ValueError, match="mamba"):
        transformer.init_caches(bad, 1, 4, "cpu")


def test_converter_rejects_a_tree_of_another_model():
    jcfg, _ = smoke("gemma2-27b")
    tree = jax.tree.map(np.asarray, jtr.init_model(jax.random.PRNGKey(0),
                                                   jcfg))
    with pytest.raises(ValueError, match="layer pattern"):
        convert.model_params_from_numpy(
            tree, configs.get_config("yi-34b", smoke=True), "cpu")
    with pytest.raises(ValueError, match="dtype"):
        convert.model_params_from_numpy(
            tree, configs.get_config("gemma2-27b", smoke=True).replace(
                dtype="bfloat16"), "cpu")


def test_converter_carries_bf16_bit_for_bit():
    jcfg = jconfigs.get_config("starcoder2-3b", smoke=True).replace(
        dtype="bfloat16")
    tcfg = configs.get_config("starcoder2-3b", smoke=True).replace(
        dtype="bfloat16")
    tree = jax.tree.map(np.asarray, jtr.init_model(jax.random.PRNGKey(0),
                                                   jcfg))
    port = convert.model_params_from_numpy(tree, tcfg, "cpu")
    emb = port["embed"]
    assert emb.dtype == torch.bfloat16
    np.testing.assert_array_equal(emb.view(torch.int16).numpy(),
                                  tree["embed"].view(np.int16))


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_equals_a_loop_of_decode_steps(arch):
    """``generate``'s ``DecodeStep`` (token and position in buffers, the
    argmax inside the step) against a plain loop of
    ``transformer.decode_step`` at host positions: the same tokens and
    bit-identical logits at every step."""
    jcfg, tcfg = smoke(arch)
    _, tp = params_for(jcfg, tcfg, seed=10)
    toks = t(np.random.default_rng(11).integers(0, jcfg.vocab, (2, 16))
             .astype(np.int32))
    scfg = loop.ServeConfig(batch=2, prompt_len=16, gen_tokens=6)
    got = loop.generate(tcfg, tp, toks, scfg, keep_logits=True)
    logits, caches = transformer.prefill(tp, tcfg, toks, cache_len=22)
    out, kept = [torch.argmax(logits, -1).to(torch.int32)], [logits]
    for i in range(5):
        logits, caches = transformer.decode_step(tp, tcfg, out[-1], caches,
                                                 16 + i)
        out.append(torch.argmax(logits, -1).to(torch.int32))
        kept.append(logits)
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  torch.stack(out, 1).numpy())
    for w, g in zip(kept, got["logits"]):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
