"""The port's ``loss_fn`` and its gradients against the reference's, one
architecture of each block kind: starcoder2-3b (ATTN), gemma2-27b
(ATTN_LOCAL and both softcaps), recurrentgemma-9b (RG-LRU), xlstm-1.3b
(mLSTM + sLSTM) and qwen2-moe-a2.7b (MoE with a shared expert and the
aux loss).

Each SMOKE config runs with ``remat`` on and chunks of 32 for the
attention and the loss at (B, S) = (2, 64), so that the checkpointed
periods, two flash chunks a side (gemma2's window of 32 inside them) and
two loss chunks are all differentiated. Float32 parameters are numpy
draws on the reference's tree, carried to the port by
``convert.model_params_from_numpy``; one jitted ``value_and_grad`` of
the reference per architecture is shared by the module's cases.

Bounds: the loss within 1e-5 relative; every gradient leaf within
``GRAD_REL`` = 1e-4 of the largest |g| of that leaf (float32 sums in
another order, XLA's own exp/log/tanh, and its fused multiply-adds,
through up to 8 layers and their backward); every float leaf gets a
gradient (none is None).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as jtr
from repro_torch import configs, convert
from repro_torch.train import loop
from repro_torch.train.tree import jax_leaves
from port_threads import one_torch_thread  # noqa: F401

ARCHS = ["starcoder2-3b", "gemma2-27b", "recurrentgemma-9b", "xlstm-1.3b",
         "qwen2-moe-a2.7b"]
B, S = 2, 64
CUT = dict(remat=True, attn_chunk=32, loss_chunk=32)
LOSS_REL = 1e-5
GRAD_REL = 1e-4


def numpy_params(jcfg, seed=0):
    """The reference's ``init_model`` tree filled from a numpy seed: a
    matrix N(0, 1/fan_in) over its next-to-last axis (the embedding over
    d_model), a vector N(0, 0.1^2)."""
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


def batch(vocab, seed=1):
    toks = np.random.default_rng(seed).integers(
        0, vocab, (B, S + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


@pytest.fixture(scope="module")
def ref():
    cache = {}

    def get(arch):
        if arch not in cache:
            jcfg = jconfigs.get_config(arch, smoke=True).replace(**CUT)
            jp = numpy_params(jcfg)
            tokens, labels = batch(jcfg.vocab)
            fn = jax.jit(jax.value_and_grad(
                lambda p, t, l: jtr.loss_fn(p, jcfg, t, l)))
            loss, g = fn(jp, tokens, labels)
            flat, _ = jax.tree_util.tree_flatten_with_path(g)
            cache[arch] = dict(
                params=jp, tokens=tokens, labels=labels, loss=float(loss),
                grads={jax.tree_util.keystr(k): np.asarray(v)
                       for k, v in flat})
        return cache[arch]

    return get


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(ref, arch):
    r = ref(arch)
    cfg = configs.get_config(arch, smoke=True).replace(**CUT)
    params = convert.model_params_from_numpy(r["params"], cfg, "cpu")
    loss, grads = loop.value_and_grad(
        params, cfg, torch.from_numpy(r["tokens"]),
        torch.from_numpy(r["labels"]))
    assert abs(float(loss) - r["loss"]) <= LOSS_REL * abs(r["loss"])
    got = dict(jax_leaves(grads))
    assert set(got) == set(r["grads"])
    bad = []
    for key, want in r["grads"].items():
        g = got[key]
        assert g is not None, f"{key}: no gradient"
        assert g.dtype == torch.float32 and tuple(g.shape) == want.shape
        err = float(np.abs(g.numpy() - want).max())
        scale = float(np.abs(want).max())
        if not err <= GRAD_REL * scale:
            bad.append(f"{key}: {err} > {GRAD_REL} * {scale}")
    assert not bad, bad


def test_remat_changes_no_gradient():
    """Recomputing each period in the backward gives the gradients of the
    plain forward bit for bit (the same ops, run twice)."""
    cfg = configs.get_config("starcoder2-3b", smoke=True).replace(**CUT)
    params = convert.model_params_from_numpy(
        numpy_params(jconfigs.get_config("starcoder2-3b",
                                         smoke=True).replace(**CUT)),
        cfg, "cpu")
    tokens, labels = (torch.from_numpy(x) for x in batch(cfg.vocab))
    l1, g1 = loop.value_and_grad(params, cfg, tokens, labels)
    l2, g2 = loop.value_and_grad(params, cfg.replace(remat=False), tokens,
                                 labels)
    assert torch.equal(l1, l2)
    for (k, a), (_, b) in zip(jax_leaves(g1), jax_leaves(g2)):
        assert torch.equal(a, b), k
