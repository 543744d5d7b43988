"""The port's serving path for every architecture against the reference:
the MoE, recurrent and modality configs at SMOKE size (float32) through
``forward``, ``prefill`` (with a frontend's embeddings and M-RoPE ids
where ``tests/test_smoke_archs.py::_inputs`` uses them) and two
``decode_step``s; M-RoPE, the vision stub's position ids, and a bf16 tree
with its float32 leaves.

Parameters are numpy draws on the reference's ``init_model`` tree
(``numpy_params``) carried to the port by
``convert.model_params_from_numpy``; token ids come from a numpy seed,
the embeddings from the reference's stubs. Bounds: logits, hidden states and
every cache leaf within ``rtol=atol=1e-4`` (float32 sums in another
order, XLA's own exp/log/tanh a few ULP from torch's, and the compiled
reference's fused multiply-adds, through up to 8 layers); the aux loss
within 1e-6; greedy tokens, cache dtypes and shapes, M-RoPE ids exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as jlayers
from repro.models import modality as jmod
from repro.models import transformer as jtr
from repro_torch import configs, convert
from repro_torch.models import layers, modality, transformer
from repro_torch.serving import loop
from port_threads import one_torch_thread  # noqa: F401

ARCHS = ["qwen3-moe-30b-a3b", "qwen2-moe-a2.7b", "xlstm-1.3b",
         "recurrentgemma-9b", "musicgen-large", "qwen2-vl-72b"]
TOL = dict(rtol=1e-4, atol=1e-4)
B, S = 2, 16


def t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def leaves(tree):
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, torch.Tensor))


def numpy_params(jcfg, seed=0):
    """The reference's ``init_model`` tree (keys, stacking, shapes and
    dtypes from ``jax.eval_shape``) filled from a numpy seed: a matrix
    N(0, 1/fan_in) over its next-to-last axis (the embedding over
    d_model), a vector N(0, 0.1^2); a stacked leaf's period axis is not a
    fan-in. (The reference's own eager init takes seconds an arch.)"""
    shapes = jax.eval_shape(lambda k: jtr.init_model(k, jcfg),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        keys = [getattr(k, "key", None) for k in path]
        core = leaf.shape[1:] if keys[0] == "periods" else leaf.shape
        if keys[-1] == "embed":
            scale = jcfg.d_model ** -0.5
        elif len(core) >= 2:
            scale = core[-2] ** -0.5
        else:
            scale = 0.1
        x = rng.standard_normal(leaf.shape).astype(np.float32) * scale
        return np.asarray(jnp.asarray(x).astype(leaf.dtype))

    return jax.tree_util.tree_map_with_path(fill, shapes)


def inputs(jcfg):
    """tests/test_smoke_archs.py::_inputs at (2, 16): token ids, and the
    audio or vision stub's embeddings (and M-RoPE ids)."""
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (B, S)).astype(
        np.int32)
    key = jax.random.PRNGKey(1)
    emb = mrope = None
    if jcfg.modality == "audio":
        emb = np.asarray(jmod.audio_frame_embeddings(key, jcfg, B, S))
    elif jcfg.modality == "vision":
        e, m = jmod.vision_patch_embeddings(key, jcfg, B, S)
        emb, mrope = np.asarray(e), np.asarray(m)
    return toks, emb, mrope


@pytest.fixture(scope="module")
def ref():
    """One jitted reference per arch: forward, prefill and two greedy
    decode steps."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jcfg = jconfigs.get_config(arch, smoke=True)
            jp = numpy_params(jcfg)
            toks, emb, mrope = inputs(jcfg)

            def run(p, x, e, m):
                kw = dict(tokens=None if e is not None else x, embeds=e,
                          mrope_positions=m)
                h, aux = jtr.forward(p, jcfg, **kw)
                logits, c = jtr.prefill(p, jcfg, cache_len=S + 3, **kw)
                out = [logits]
                for i in range(2):
                    tok = jnp.argmax(out[-1], -1).astype(jnp.int32)
                    logits, c = jtr.decode_step(p, jcfg, tok, c,
                                                jnp.int32(S + i))
                    out.append(logits)
                return h, aux, out, c

            h, aux, out, c = jax.jit(run)(jp, toks, emb, mrope)
            cache[arch] = dict(
                params=jp, toks=toks, emb=emb,
                mrope=mrope, h=np.asarray(h), aux=float(aux),
                logits=[np.asarray(x) for x in out],
                caches=[np.asarray(x) for x in jax.tree.leaves(c)])
        return cache[arch]

    return get


def port_run(arch, r):
    tcfg = configs.get_config(arch, smoke=True)
    tp = convert.model_params_from_numpy(r["params"], tcfg, "cpu")
    kw = dict(tokens=None if r["emb"] is not None else t(r["toks"]),
              embeds=t(r["emb"]), mrope_positions=t(r["mrope"]))
    logits, caches = transformer.prefill(tp, tcfg, cache_len=S + 3, **kw)
    out = [logits]
    for i in range(2):
        tok = torch.argmax(out[-1], -1).to(torch.int32)
        logits, got = transformer.decode_step(tp, tcfg, tok, caches, S + i)
        assert got is caches                   # written in place
        out.append(logits)
    return tcfg, tp, kw, out, caches


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_reference(arch, ref):
    r = ref(arch)
    _, _, _, out, _ = port_run(arch, r)
    for want, got in zip(r["logits"], out):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                      want.argmax(-1))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_caches_match_reference(arch, ref):
    """Every cache leaf after prefill and two steps: the (k, v) rows, the
    RG-LRU (conv, h), the mLSTM (conv, (C, n, m)) and sLSTM (h, c, n, m)
    states; same dtypes, shapes and order."""
    r = ref(arch)
    _, _, _, _, caches = port_run(arch, r)
    got = leaves(caches)
    assert len(got) == len(r["caches"])
    for want, g in zip(r["caches"], got):
        assert str(want.dtype) == str(g.dtype).removeprefix("torch.")
        assert tuple(want.shape) == tuple(g.shape)
        np.testing.assert_allclose(g.numpy(), want, **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, ref):
    """``forward`` returns (hidden, aux) as the reference's: the MoE aux
    loss, zero for the others."""
    r = ref(arch)
    tcfg = configs.get_config(arch, smoke=True)
    tp = convert.model_params_from_numpy(r["params"], tcfg, "cpu")
    h, aux = transformer.forward(
        tp, tcfg, None if r["emb"] is not None else t(r["toks"]),
        embeds=t(r["emb"]), mrope_positions=t(r["mrope"]))
    np.testing.assert_allclose(h.numpy(), r["h"], **TOL)
    assert aux.dtype == torch.float32
    assert float(aux) == pytest.approx(r["aux"], rel=1e-6, abs=1e-9)
    assert (r["aux"] > 0) == bool(tcfg.n_experts)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_model_has_the_reference_tree(arch):
    """The port's own initializer builds the reference's tree: keys,
    stacking, shapes, and float32 where the reference keeps float32 in a
    bf16 model."""
    jcfg = jconfigs.get_config(arch, smoke=True).replace(dtype="bfloat16")
    tcfg = configs.get_config(arch, smoke=True).replace(dtype="bfloat16")
    want = jax.eval_shape(lambda k: jtr.init_model(k, jcfg),
                          jax.random.PRNGKey(0))
    got = transformer.init_model(torch.Generator().manual_seed(0), tcfg)
    w_leaves, w_def = jax.tree.flatten(want)
    g_leaves, g_def = jax.tree.flatten(
        got, is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert str(w_def) == str(g_def)
    for w, g in zip(w_leaves, g_leaves):
        assert tuple(w.shape) == tuple(g.shape)
        assert str(w.dtype) == str(g.dtype).removeprefix("torch.")


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "recurrentgemma-9b",
                                  "xlstm-1.3b"])
def test_bf16_tree_carries_across_leaf_by_leaf(arch):
    """A bf16 SMOKE tree of the reference: every leaf bit for bit, the
    float32 ones (router, shared_gate, lambda_, b_if, b_in, w_rec) as
    float32."""
    jcfg = jconfigs.get_config(arch, smoke=True).replace(dtype="bfloat16")
    tcfg = configs.get_config(arch, smoke=True).replace(dtype="bfloat16")
    tree = numpy_params(jcfg, seed=3)
    port = convert.model_params_from_numpy(tree, tcfg, "cpu")
    paths = jax.tree_util.tree_flatten_with_path(tree)[0]
    got = leaves(port)
    assert len(paths) == len(got)
    f32 = set()
    for (path, want), g in zip(paths, got):
        name = getattr(path[-1], "key", None)
        assert str(want.dtype) == str(g.dtype).removeprefix("torch.")
        if want.dtype == np.float32:
            f32.add(name)
            np.testing.assert_array_equal(g.numpy(), want)
        else:
            np.testing.assert_array_equal(g.view(torch.int16).numpy(),
                                          want.view(np.int16))
    assert f32 and f32 <= set(convert.FLOAT32_LEAVES)


def test_mrope_matches_reference():
    """qwen2-vl's sections at its full head dim (16, 24, 24 of 64) and the
    SMOKE ones (2, 1, 1 of 4), on the vision stub's ids and on random
    ids: the same frequencies as ``apply_rope`` (``torch.pow``, within a
    ULP of XLA's), hence its tolerance at positions up to 5000."""
    rng = np.random.default_rng(0)
    for sections, d in (((16, 24, 24), 128), ((2, 1, 1), 8)):
        x = rng.standard_normal((2, 3, 40, d)).astype(np.float32)
        _, stub = jmod.vision_patch_embeddings(
            jax.random.PRNGKey(0), jconfigs.get_config("qwen2-vl-72b"), 2, 40)
        rand = rng.integers(0, 5000, (3, 2, 40)).astype(np.int32)
        for pos in (np.asarray(stub), rand):
            want = jax.jit(lambda x, p: jlayers.apply_mrope(
                x, p, sections, 1e6))(x, pos)
            got = layers.apply_mrope(t(x), t(pos), sections, 1e6)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="sections"):
        layers.apply_mrope(t(x), t(rand), (1, 1, 1), 1e6)


@pytest.mark.parametrize("seq,image_tokens", [(64, None), (32, 8), (16, 1),
                                              (40, 17)])
def test_vision_position_ids_match_reference(seq, image_tokens):
    """The stub's (3, B, S) M-RoPE ids, exact (image grid, then text
    continuing past the grid's side), and the embeddings' shape and dtype."""
    jcfg = jconfigs.get_config("qwen2-vl-72b", smoke=True)
    tcfg = configs.get_config("qwen2-vl-72b", smoke=True)
    _, want = jmod.vision_patch_embeddings(jax.random.PRNGKey(0), jcfg, 3,
                                           seq, image_tokens)
    emb, got = modality.vision_patch_embeddings(
        torch.Generator().manual_seed(0), tcfg, 3, seq, image_tokens)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert emb.shape == (3, seq, tcfg.d_model) and emb.dtype == torch.float32
    audio = modality.audio_frame_embeddings(
        torch.Generator().manual_seed(0),
        configs.get_config("musicgen-large"), 2, 5)
    assert audio.shape == (2, 5, 2048) and audio.dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "xlstm-1.3b",
                                  "qwen2-moe-a2.7b"])
def test_graphable_decode_step_carries_recurrent_state(arch, ref):
    """``generate``'s ``DecodeStep`` drops what ``decode_step`` returns, so
    the recurrent states must be written in place: its logits equal a
    loop of ``decode_step`` bit for bit, and match the reference's."""
    r = ref(arch)
    tcfg = configs.get_config(arch, smoke=True)
    tp = convert.model_params_from_numpy(r["params"], tcfg, "cpu")
    toks = t(r["toks"])
    got = loop.generate(tcfg, tp, toks, loop.ServeConfig(
        batch=B, prompt_len=S, gen_tokens=3), keep_logits=True)
    _, _, _, out, _ = port_run(arch, r)
    for a, b in zip(got["logits"], out):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_allclose(got["logits"][2].numpy(), r["logits"][2],
                               **TOL)
