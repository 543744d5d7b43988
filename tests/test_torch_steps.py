"""The port's step builders and their shardings (``repro_torch.launch.steps``)
against the reference's (``repro.launch.steps``):

- ``cell_step_and_shardings``' ``in_shardings`` for every runnable cell at
  (16, 16) and (2, 16, 16) equal the reference's ``spec_for`` over the
  reference's ``input_specs`` trees, entry for entry, and the donations
  are the reference's. Both take a stand-in mesh (axis names and a
  devices array; ``tests/test_torch_sharding.py``), so no process group
  is needed.
- At SMOKE size on the CPU with real tensors the builders match the
  reference's jitted ones: ``build_train_step`` at ``grad_accum`` 1 and 2
  for starcoder2-3b over two steps, within the bounds of
  ``tests/test_torch_train.py`` (loss 1e-5 relative, parameters 1e-6, m
  and v 1e-4 of the leaf's largest |value|); ``build_prefill_step`` and
  ``build_decode_step`` for starcoder2-3b and for qwen2-vl-72b (embeds
  and M-RoPE), logits and caches within ``tests/test_torch_archs.py``'s
  ``rtol=atol=1e-4``.
- ``decode_step`` on a (2, 2) mesh of 4 gloo CPU ranks, its parameters
  and caches placed by the dry run's shardings, against one device over
  four steps that cross the caches' block boundary: KV heads split over
  ``model`` (starcoder2-3b), the sequence split over ``model`` (one KV
  head; also at batch 1, which does not split over ``data``), and
  recurrentgemma-9b's RG-LRU states (split over ``model`` by the cache
  axes, gathered by the decode route) with its local attention window.
  Logits and every cache leaf within ``MESH_OUT_REL`` = 1e-5 of their
  largest |value|: a rank's rows go through products of fewer rows,
  which the CPU's BLAS may round otherwise (measured 9.5e-7 absolute),
  and the sequence-split route combines the blocks' softmax in float32
  where one device normalises over the whole cache.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.distributed import sharding as jshd
from repro.launch import specs as jspecs
from repro.launch import steps as jsteps
from repro.train import data as jdata
from repro.train import optimizer as jopt
from repro_torch import configs, convert
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.world import run_world
from repro_torch.launch import steps
from repro_torch.train import optimizer as opt

import mesh_worlds
import torch_mesh_bodies
from test_torch_archs import TOL
from test_torch_archs import inputs as arch_inputs
from test_torch_specs import flat
from test_torch_train import (STEP_LOSS_REL, STEP_MV_REL, STEP_P_REL,
                              worst_rel)
from test_torch_train_grads import numpy_params
from port_threads import one_torch_thread  # noqa: F401

CELLS = [c for c in configs.cells() if configs.runnable(*c)]
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
MESH_OUT_REL = 1e-5


@dataclasses.dataclass
class StandIn:
    axis_names: tuple
    devices: np.ndarray


def as_tuple(spec):
    """A spec's entries, a one-axis tuple as its axis (``PartitionSpec``
    keeps ``("data",)`` as ``"data"``)."""
    def entry(e):
        if isinstance(e, (tuple, list)):
            return e[0] if len(e) == 1 else tuple(e)
        return e

    return tuple(entry(e) for e in spec)


@pytest.fixture(scope="module")
def reference():
    """The reference's ``input_specs``, its ``abstract_params`` computed
    once an arch."""
    cache = {}

    def get(arch, shape):
        jcfg = jconfigs.get_config(arch)
        if arch not in cache:
            cache[arch] = jspecs.abstract_params(jcfg)
        mp = pytest.MonkeyPatch()
        mp.setattr(jspecs, "abstract_params", lambda cfg: cache[arch])
        try:
            return jspecs.input_specs(arch, shape)
        finally:
            mp.undo()

    return get


def reference_specs(sp, mesh):
    """The reference's ``cell_step_and_shardings`` in_shardings as
    partition specs: ``spec_for`` of every leaf's axes at its shape."""
    pairs = {"train": (("param_axes", "params"), ("opt_axes", "opt_state"),
                       ("batch_axes", "batch")),
             "prefill": (("param_axes", "params"), ("batch_axes", "batch")),
             "decode": (("param_axes", "params"), ("batch_axes", "batch"),
                        ("cache_axes", "caches"))}[sp["shape"].kind]
    out = []
    for axes_key, tree_key in pairs:
        shapes = dict(flat(sp[tree_key]))
        out.append([(k, as_tuple(jshd.spec_for(ax, jshd.DEFAULT_RULES, mesh,
                                               shapes[k].shape)))
                    for k, ax in flat(sp[axes_key])])
    return out


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch,shape", CELLS)
def test_in_shardings_match_reference(reference, arch, shape, mesh_name):
    dims, names = MESHES[mesh_name]
    mesh = StandIn(names, np.zeros(dims, np.int8))
    fn, args, in_sh, donate, cfg, sh = steps.cell_step_and_shardings(
        arch, shape, mesh)
    want = reference_specs(reference(arch, shape), mesh)
    got = [[(k, as_tuple(s.spec)) for k, s in flat(tree)] for tree in in_sh]
    assert got == want
    assert all(s.mesh is mesh for tree in in_sh for _, s in flat(tree))
    assert donate == {"train": (0, 1), "prefill": (),
                      "decode": (2,)}[sh.kind]
    assert len(args) == len(in_sh) and sh == configs.SHAPES[shape]


# ---------------------------------------------------------------------------
# The builders at SMOKE size, real tensors.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_step_builder_matches_reference(grad_accum):
    jcfg = jconfigs.get_config("starcoder2-3b", smoke=True).replace(
        remat=True)
    tcfg = configs.get_config("starcoder2-3b", smoke=True).replace(
        remat=True)
    jp = jax.tree.map(jnp.asarray, numpy_params(jcfg))
    js = jopt.init_opt_state(jp)
    tp = convert.model_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                         "cpu")
    ts = opt.init_opt_state(tp)
    jstep = jax.jit(jsteps.build_train_step(jcfg, grad_accum=grad_accum))
    tstep = steps.build_train_step(tcfg, grad_accum=grad_accum)
    for i in range(2):
        b = jdata.synth_batch(i, 4, 32, jcfg.vocab, 0)
        jp, js, jm = jstep(jp, js, {k: jnp.asarray(v) for k, v in b.items()})
        tp, ts, tm = tstep(tp, ts, {k: torch.from_numpy(np.asarray(v))
                                    for k, v in b.items()})
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= (
            STEP_LOSS_REL * abs(float(jm["loss"])))
        assert int(ts["step"]) == int(js["step"]) == i + 1
        assert worst_rel(jp, tp) <= STEP_P_REL
        assert worst_rel(js["m"], ts["m"]) <= STEP_MV_REL
        assert worst_rel(js["v"], ts["v"]) <= STEP_MV_REL


def serve_inputs(jcfg, b, s):
    """(prefill batch, decode batch) as numpy: the arch's tokens or
    frontend embeddings and M-RoPE ids (``tests/test_torch_archs.py``),
    then one token (or one embedding) at position ``s``."""
    toks, emb, mrope = arch_inputs(jcfg)
    rng = np.random.default_rng(3)
    pre, dec = {}, {"pos": np.int32(s),
                    "token": rng.integers(0, jcfg.vocab, (b,)).astype(
                        np.int32)}
    if emb is None:
        pre["tokens"] = toks
    else:
        pre["embeds"] = emb
        dec["embeds"] = rng.standard_normal((b, jcfg.d_model)).astype(
            np.float32)
    if mrope is not None:
        pre["mrope_positions"] = mrope
    return pre, dec


@pytest.mark.parametrize("arch", ["starcoder2-3b", "qwen2-vl-72b"])
def test_prefill_and_decode_builders_match_reference(arch):
    from test_torch_archs import B, S

    jcfg = jconfigs.get_config(arch, smoke=True)
    tcfg = configs.get_config(arch, smoke=True)
    jp = numpy_params(jcfg)
    tp = convert.model_params_from_numpy(jp, tcfg, "cpu")
    pre, dec = serve_inputs(jcfg, B, S)
    jlog, jc = jax.jit(jsteps.build_prefill_step(jcfg, cache_len=S + 3))(
        jp, pre)
    tlog, tc = steps.build_prefill_step(tcfg, cache_len=S + 3)(
        tp, {k: torch.from_numpy(np.array(v)) for k, v in pre.items()})
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    jlog, jc = jax.jit(jsteps.build_decode_step(jcfg))(jp, dec, jc)
    tlog, got = steps.build_decode_step(tcfg)(
        tp, {k: torch.from_numpy(np.asarray(v)) for k, v in dec.items()}, tc)
    assert got is tc                       # written in place
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    jl, tl = jax.tree.leaves(jc), [x for _, x in flat(tc)]
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)


# ---------------------------------------------------------------------------
# decode_step on a mesh of 4 gloo ranks.
# ---------------------------------------------------------------------------

DECODE_CASES = {
    "kv_heads": ("starcoder2-3b", {}, 4),
    "kv_seq": ("starcoder2-3b", dict(n_heads=3, n_kv_heads=1), 4),
    "kv_seq_batch1": ("starcoder2-3b", dict(n_heads=3, n_kv_heads=1), 1),
    "recurrent_window": ("recurrentgemma-9b", dict(n_layers=3, window=4), 4),
}
PROMPT, CACHE_LEN, DECODE_STEPS = 6, 16, 4


@pytest.fixture(scope="module")
def mesh_decode(tmp_path_factory):
    rng = np.random.default_rng(11)
    inp = {}
    for name, (arch, cut, b) in DECODE_CASES.items():
        vocab = configs.get_config(arch, smoke=True).vocab
        inp[name] = dict(
            arch=arch, cut=cut, prompt=PROMPT, cache_len=CACHE_LEN,
            tokens=rng.integers(0, vocab, (b, PROMPT + DECODE_STEPS)).astype(
                np.int64))
    return run_world(torch_mesh_bodies.decode_body, 4, inp,
                     timeout_s=mesh_worlds.WORLD_TIMEOUT_S,
                     store_dir=str(tmp_path_factory.mktemp("mesh_decode")))[0]


@pytest.mark.parametrize("name", list(DECODE_CASES))
def test_decode_on_a_mesh_matches_one_device(mesh_decode, name):
    r = mesh_decode[name]
    assert len(r["got"]) == DECODE_STEPS
    for got, want in zip(r["got"], r["want"]):
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= MESH_OUT_REL * np.abs(want).max()
    for got, want in zip(r["caches_got"], r["caches_want"]):
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= MESH_OUT_REL * np.abs(want).max()
    # The attention caches are split over ``model`` as the case says,
    # and come back in their layout (written in place).
    split = "S(2)" if name == "kv_heads" else "S(3)"
    assert any(r["attention"])
    for attn, placed, returned in zip(r["attention"], r["placed"],
                                      r["returned"]):
        if attn:
            assert placed[1] == split and returned == placed
