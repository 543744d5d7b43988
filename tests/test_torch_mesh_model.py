"""The model's mesh paths on a world of 4 gloo CPU ranks as a (data = 2,
model = 2) mesh under ``sharding.use_rules``, held against the reference
under ``use_rules`` on an Auto-axes ``jax.sharding.Mesh`` of 4 virtual
CPU devices (``tests/torch_mesh_reference.py``), float32 SMOKE configs:

- ``attention_apply`` on the Megatron-SP route (starcoder2-3b: 4 heads,
  2 KV heads, S = 32), and falling through it where ``n_heads % model``
  is not 0 (3 heads on 1 KV head);
- ``_sharded_flash`` with ``use_pallas=True`` (q heads over ``model``;
  on the CPU the port takes the plain flash, the reference its Pallas
  kernel in interpret mode);
- ``moe_apply`` with expert parallelism (qwen3-moe-30b-a3b,
  ``moe_ep=True``) and with replicated experts (qwen2-moe-a2.7b, whose
  shared experts keep it off the EP route);
- ``forward``, ``loss_fn`` and the reduced gradients of
  ``train.loop.value_and_grad`` for starcoder2-3b and recurrentgemma-9b
  (one period: RG-LRU blocks through the recurrent hooks, local
  attention), and for starcoder2-3b at S = 15, which the sequence rule
  cannot split over ``model`` (each data rank's rows on both model
  ranks).

Bounds, with their reasons: outputs within ``OUT_REL`` = 1e-5 of the
largest |value| (float32 sums split over the ranks in another order than
GSPMD's; the reference's own sharded and unsharded losses differ by
2e-7 relative); the loss within ``LOSS_REL`` = 1e-5 relative and the aux
loss within 1e-6 absolute; every gradient leaf within ``GRAD_REL`` =
1e-4 of its largest |g| (the bound of ``tests/test_torch_train_grads.py``
for one device). Expert parallelism sizes each rank's capacity from its
own tokens, so these MoE outputs are the mesh's function, not one
device's.
"""
import numpy as np
import pytest

from repro_torch.distributed.world import run_world

import mesh_worlds
import torch_mesh_bodies
from port_threads import one_torch_thread  # noqa: F401
from test_torch_train_grads import numpy_params
from repro import configs as jconfigs

OUT_REL = 1e-5
LOSS_REL = 1e-5
AUX_ABS = 1e-6
GRAD_REL = 1e-4
B, S = 4, 32
S_ODD = 15
CUT = dict(remat=True, attn_chunk=16, loss_chunk=16)
# recurrentgemma-9b SMOKE cut to one period (RG-LRU, RG-LRU, local
# attention), which every hook and route of its blocks is in.
RG_CUT = dict(CUT, n_layers=3)


def layer0(tree):
    return {k: layer0(v) if isinstance(v, dict) else np.asarray(v)[0]
            for k, v in tree.items()}


def inputs():
    rng = np.random.default_rng(7)

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    attn, moe_cases, model = {}, {}, {}
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    for name, cut in (("megatron", {}),
                      ("fallthrough", dict(n_heads=3, n_kv_heads=1))):
        jcfg = jconfigs.get_config("starcoder2-3b", smoke=True).replace(
            **CUT, **cut)
        attn[name] = dict(arch="starcoder2-3b", cut=dict(CUT, **cut),
                          kind="attn", x=normal(B, S, jcfg.d_model),
                          positions=pos,
                          params=layer0(numpy_params(jcfg)["periods"][0]
                                        ["attn"]))
    attn["sharded_flash"] = dict(
        arch="starcoder2-3b", cut=dict(CUT, use_pallas=True),
        q=normal(B, 4, S, 16), k=normal(B, 2, S, 16), v=normal(B, 2, S, 16))
    for name, arch, cut in (("ep", "qwen3-moe-30b-a3b", dict(moe_ep=True)),
                            ("replicated", "qwen2-moe-a2.7b", {})):
        jcfg = jconfigs.get_config(arch, smoke=True).replace(**CUT, **cut)
        moe_cases[name] = dict(arch=arch, cut=dict(CUT, **cut),
                               x=normal(B, S, jcfg.d_model),
                               params=layer0(numpy_params(jcfg)["periods"][0]
                                             ["moe"]))
    for arch, cut in (("starcoder2-3b", CUT), ("recurrentgemma-9b", RG_CUT)):
        jcfg = jconfigs.get_config(arch, smoke=True).replace(**cut)
        toks = rng.integers(0, jcfg.vocab, (B, S + 1)).astype(np.int32)
        model[arch] = dict(arch=arch, cut=cut, params=numpy_params(jcfg),
                           tokens=toks[:, :-1].copy(),
                           labels=toks[:, 1:].copy())
    # S = 15 does not divide over ``model``: the residual's rows stay
    # whole there, so both model ranks of a data rank hold the same rows.
    jcfg = jconfigs.get_config("starcoder2-3b", smoke=True).replace(**CUT)
    toks = rng.integers(0, jcfg.vocab, (B, S_ODD + 1)).astype(np.int32)
    model["starcoder2-3b-seq15"] = dict(
        arch="starcoder2-3b", cut=CUT, params=numpy_params(jcfg),
        tokens=toks[:, :-1].copy(), labels=toks[:, 1:].copy())
    return dict(attention=attn, moe=moe_cases, model=model)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_model")
    inp = inputs()
    ref = mesh_worlds.start_reference("model", inp, tmp)
    port = run_world(torch_mesh_bodies.model_body, 4, inp,
                     timeout_s=mesh_worlds.WORLD_TIMEOUT_S,
                     store_dir=str(tmp))
    return mesh_worlds.reference_result(ref), port[0]


def rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("name", ["megatron", "fallthrough",
                                  "sharded_flash"])
def test_attention_routes_match_reference(results, name):
    ref, port = results
    got, kind = port[name]
    assert kind == "DTensor" and got.shape == ref[name].shape
    assert rel(got, ref[name]) <= OUT_REL


@pytest.mark.parametrize("name", ["ep", "replicated"])
def test_moe_routes_match_reference(results, name):
    ref, port = results
    (want, want_aux), (got, got_aux) = ref[name], port[name]
    assert rel(got, want) <= OUT_REL
    assert abs(got_aux - want_aux) <= AUX_ABS


@pytest.mark.parametrize("case", ["starcoder2-3b", "recurrentgemma-9b",
                                  "starcoder2-3b-seq15"])
def test_forward_loss_and_grads_match_reference(results, case):
    ref, port = results
    r, p = ref[case], port[case]
    assert rel(p["hidden"], r["hidden"]) <= OUT_REL
    assert abs(p["aux"] - r["aux"]) <= AUX_ABS
    assert abs(p["loss"] - r["loss"]) <= LOSS_REL * abs(r["loss"])
    assert set(p["grads"]) == set(r["grads"])
    bad = [k for k, want in r["grads"].items()
           if not np.abs(p["grads"][k] - want).max()
           <= GRAD_REL * np.abs(want).max()]
    assert not bad, bad
