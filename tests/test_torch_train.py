"""The port's training substrate against the reference: AdamW, the
synthetic data, gradient compression, checkpoints (written by either
package, read by the other), the train step over three steps, the loop's
checkpoint/restart, and the ``launch.train`` command, all on the CPU.

Bounds (each measured on the CPU, far inside):
- AdamW (``OPT_*``): the step exact; the learning rate exact here (the
  cosine phase may differ by 1 ULP where glibc's ``cosf`` is not
  correctly rounded, up to ``COS_ULP`` = 4 ULP of the rate,
  ``test_schedule``); the gradient norm within 2 ULP
  (per-leaf squares summed in another order); parameters within 2 ULP,
  v within 16 ULP and m within 4 ULP of its leaf's largest |m| (the
  compiled reference fuses the update's multiply-adds, the port does
  not).
- Data and compression: equal (integers; the quantized tree bit for bit
  against the reference's jitted ``compress_tree``).
- The train step over three steps on ``synth_batch`` batches: the loss
  within 1e-5 relative, every parameter leaf within 1e-6, m and v within
  1e-4 of that leaf's largest |value| (the gradients agree to ~1e-6 of
  their largest, ``test_torch_train_grads.py``); with compressed
  gradients m and v within 1/64 (a gradient 1e-6 off may quantize one
  int8 step of its block's scale, max/127, away) and the parameters
  within 1e-5.
- Checkpoints and restarts: bit for bit.
"""
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro import configs as jconfigs
from repro.distributed import compression as jcomp
from repro.train import data as jdata
from repro.train import loop as jloop
from repro.train import optimizer as jopt
from repro_torch import checkpoint, configs, convert
from repro_torch.distributed import compression
from repro_torch.launch import train as launch_train
from repro_torch.train import data, loop
from repro_torch.train import optimizer as opt
from repro_torch.train.tree import jax_leaves

from test_torch_train_grads import numpy_params
from port_threads import one_torch_thread  # noqa: F401

OPT_P_ULP = 2
OPT_V_ULP = 16
OPT_M_ULP_OF_MAX = 4
OPT_NORM_ULP = 2
COS_ULP = 4
STEP_LOSS_REL = 1e-5
STEP_P_REL = 1e-6
STEP_MV_REL = 1e-4
COMPRESSED_P_REL = 1e-5
COMPRESSED_MV_REL = 1 / 64


def t(x):
    return torch.from_numpy(np.array(x))


def pairs(jtree, ttree):
    """(key, reference numpy leaf, port numpy leaf) in JAX's order."""
    flat, _ = jax.tree_util.tree_flatten_with_path(jtree)
    port = jax_leaves(ttree)
    assert [jax.tree_util.keystr(k) for k, _ in flat] == [k for k, _ in port]
    return [(k, np.asarray(a), b.detach().numpy())
            for (_, a), (k, b) in zip(flat, port)]


def worst_rel(jtree, ttree):
    """Largest |Δ| over the leaf's largest |value|, over the leaves."""
    return max(float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))
               for _, a, b in pairs(jtree, ttree))


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

OPT_SHAPES = {"w": (8, 300), "b": (300,), "a": {"z": (4,), "c": (3, 5)},
              "periods": ({"k": (2, 40, 7)},)}


def opt_tree(rng, scale):
    def draw(node):
        if isinstance(node, dict):
            return {k: draw(v) for k, v in node.items()}
        if isinstance(node, tuple) and isinstance(node[0], dict):
            return tuple(draw(v) for v in node)
        return (rng.standard_normal(node) * scale).astype(np.float32)
    return draw(OPT_SHAPES)


@pytest.mark.parametrize("clip", [1.0, 1e9], ids=["clip_on", "clip_off"])
def test_apply_updates_matches_reference(clip):
    """Ten steps through warmup (3 steps) and the cosine (to step 8) and
    past it, clipping every step (``clip_on``: |g| ~ 27) or never."""
    rng = np.random.default_rng(0)
    kw = dict(warmup_steps=3, total_steps=8, grad_clip=clip)
    jcfg, tcfg = jopt.AdamWConfig(**kw), opt.AdamWConfig(**kw)
    p0 = opt_tree(rng, 1.0)
    jp = jax.tree.map(jnp.asarray, p0)
    js = jopt.init_opt_state(jp)
    tp = jax.tree.map(t, p0)
    ts = opt.init_opt_state(tp)
    assert ts["step"].dtype == torch.int32
    assert all(x.dtype == torch.float32 for _, x in jax_leaves(ts["m"]))
    upd = jax.jit(lambda p, g, s: jopt.apply_updates(p, g, s, jcfg))
    for _ in range(10):
        g = opt_tree(rng, 0.5)
        jp, js, jm = upd(jp, jax.tree.map(jnp.asarray, g), js)
        tp, ts, tm = opt.apply_updates(tp, jax.tree.map(t, g), ts, tcfg)
        assert int(ts["step"]) == int(js["step"])
        assert np.float32(tm["lr"]).view(np.int32) == np.asarray(
            jm["lr"]).view(np.int32)
        assert convert.ulp_distance(np.asarray(jm["grad_norm"]),
                                    tm["grad_norm"].numpy()) <= OPT_NORM_ULP
        for k, a, b in pairs(jp, tp):
            assert convert.ulp_distance(a, b) <= OPT_P_ULP, k
        for k, a, b in pairs(js["v"], ts["v"]):
            assert convert.ulp_distance(a, b) <= OPT_V_ULP, k
        for k, a, b in pairs(js["m"], ts["m"]):
            ulp = np.spacing(np.float32(np.abs(a).max()))
            assert np.abs(a - b).max() <= OPT_M_ULP_OF_MAX * ulp, k
    if clip == 1.0:
        assert float(tm["grad_norm"]) > 10 * clip


@pytest.mark.parametrize("warmup,total", [(100, 10000), (3, 10), (7, 300)])
def test_schedule(warmup, total):
    """The learning rate at every step to twice the schedule's end (at
    most 20001): equal in the warmup and after the end, within
    ``COS_ULP`` in the cosine phase (glibc's cosf against the double
    cosine rounded once: 1 ULP of a cosine near -1 is up to 4 ULP of
    min_lr_frac + 0.45·(1 + cos)); ``b1 ** step``'s bias corrections
    equal at every step."""
    jcfg = jopt.AdamWConfig(warmup_steps=warmup, total_steps=total)
    tcfg = opt.AdamWConfig(warmup_steps=warmup, total_steps=total)
    n = min(2 * total + 5, 20001)
    steps = np.arange(n, dtype=np.int32)
    # lax.map compiles the scalar step as apply_updates sees it.
    sched = jax.jit(lambda ss: jnp.stack(jax.lax.map(
        lambda s: (jopt._schedule(jcfg, s),
                   1 - jcfg.b1 ** s.astype(jnp.float32),
                   1 - jcfg.b2 ** s.astype(jnp.float32)), ss), 1))
    want = np.asarray(sched(jnp.asarray(steps)))
    s = torch.from_numpy(steps)
    got_lr = opt._schedule(tcfg, s).numpy()     # elementwise over steps
    sf = s.float()
    for col, b in ((1, tcfg.b1), (2, tcfg.b2)):
        got = (1 - opt.pow_f32(torch.full_like(sf, b), sf)).numpy()
        assert np.array_equal(got.view(np.int32), want[:, col].view(np.int32))
    cosine = (steps > warmup) & (steps < total)
    same = got_lr.view(np.int32) == want[:, 0].view(np.int32)
    assert same[~cosine].all()
    assert convert.ulp_distance(got_lr[cosine], want[cosine, 0]) <= COS_ULP


def test_adamw_descends_quadratic():
    cfg = opt.AdamWConfig(lr=0.1, warmup_steps=1, total_steps=100,
                          weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = opt.init_opt_state(params)
    for _ in range(60):
        g = {"w": 2 * params["w"]}
        params, state, _ = opt.apply_updates(params, g, state, cfg)
    assert float(torch.sum(params["w"] ** 2)) < 0.05


def test_update_in_slices_changes_no_bit(monkeypatch):
    """A stacked leaf updated in slices of its leading axis equals the
    update of the whole leaf."""
    rng = np.random.default_rng(3)
    p0 = {"periods": ({"k": rng.standard_normal((6, 5, 7)).astype(
        np.float32)},)}
    g = {"periods": ({"k": rng.standard_normal((6, 5, 7)).astype(
        np.float32)},)}
    out = []
    for chunk in (1 << 27, 35):
        monkeypatch.setattr(opt, "UPDATE_CHUNK", chunk)
        p = jax.tree.map(t, p0)
        s = opt.init_opt_state(p)
        for _ in range(3):
            p, s, _ = opt.apply_updates(p, jax.tree.map(t, g), s,
                                        opt.AdamWConfig())
        out.append((p, s))
    for a, b in zip(jax_leaves(out[0]), jax_leaves(out[1])):
        assert torch.equal(a[1], b[1]), a[0]


# ---------------------------------------------------------------------------
# Data and compression
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("idx,seed", [(0, 0), (7, 0), (3, 5)])
def test_synth_batch_equal(idx, seed):
    a = jdata.synth_batch(idx, 4, 16, 1000, seed)
    b = data.synth_batch(idx, 4, 16, 1000, seed)
    for k in ("tokens", "labels"):
        assert a[k].dtype == b[k].dtype == np.int32
        np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_prefetcher_orders_batches_on_device():
    pf = data.Prefetcher(2, 8, 100, start_idx=3, device="cpu")
    it = iter(pf)
    got = [next(it) for _ in range(4)]
    pf.close()
    assert [i for i, _ in got] == [3, 4, 5, 6]
    for i, b in got:
        assert b["tokens"].dtype == torch.int32
        np.testing.assert_array_equal(
            b["tokens"].numpy(), data.synth_batch(i, 2, 8, 100)["tokens"])


def test_compress_tree_matches_reference():
    """The error-feedback quantization over a tree with a tiny leaf (rides
    uncompressed), an unpadded and a padded one, for three steps: the
    decompressed gradients and the residuals bit for bit against the
    reference's jitted ``compress_tree``; ``compressed_bytes`` equal."""
    rng = np.random.default_rng(1)
    shapes = {"w": (64, 40), "b": (100,), "z": (3, 300)}
    jc = jax.jit(jcomp.compress_tree)
    jres = jcomp.init_residuals({k: jnp.zeros(s) for k, s in shapes.items()})
    tres = compression.init_residuals(
        {k: torch.zeros(s) for k, s in shapes.items()})
    for _ in range(3):
        g = {k: (rng.standard_normal(s) * 3).astype(np.float32)
             for k, s in shapes.items()}
        jg, jres = jc(jax.tree.map(jnp.asarray, g), jres)
        tg, tres = compression.compress_tree(jax.tree.map(t, g), tres)
        for tree_j, tree_t in ((jg, tg), (jres, tres)):
            for k, a, b in pairs(tree_j, tree_t):
                assert np.array_equal(a.view(np.int32), b.view(np.int32)), k
    params = {k: torch.zeros(s) for k, s in shapes.items()}
    assert compression.compressed_bytes(params) == jcomp.compressed_bytes(
        {k: jnp.zeros(s) for k, s in shapes.items()})
    assert np.array_equal(tg["b"].numpy(), g["b"])   # under BLOCK: as is


def test_compression_error_feedback_converges():
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.normal(size=(1024,)).astype(np.float32))
    res = torch.zeros(1024)
    total = torch.zeros(1024)
    for _ in range(50):
        deq, res = compression.compress_leaf(g, res)
        total = total + deq
    np.testing.assert_allclose((total / 50).numpy(), g.numpy(), atol=2e-2)


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def bf16_params(arch="gemma2-27b"):
    """A bf16 SMOKE tree (with its float32 leaves) in both packages."""
    jcfg = jconfigs.get_config(arch, smoke=True).replace(dtype="bfloat16")
    tcfg = configs.get_config(arch, smoke=True).replace(dtype="bfloat16")
    jp = numpy_params(jcfg)
    return jcfg, tcfg, jp, convert.model_params_from_numpy(jp, tcfg, "cpu")


def test_checkpoint_written_by_port_loads_in_reference(tmp_path):
    jcfg, tcfg, jp, tp = bf16_params()
    ts = opt.init_opt_state(tp)
    ts["step"] = torch.tensor(7, dtype=torch.int32)
    ts["m"]["embed"].normal_(generator=torch.Generator().manual_seed(2))
    checkpoint.save(str(tmp_path), 7, {"params": tp, "opt": ts})
    manifest = json.load(open(tmp_path / "step_00000007" / "manifest.json"))
    assert manifest["leaves"]["['params']['embed']"]["dtype"] == "bfloat16"
    template = {"params": jax.tree.map(jnp.zeros_like, jp),
                "opt": jopt.init_opt_state(jp)}
    loaded, m = jckpt.load(str(tmp_path), template)
    assert m["step"] == 7
    want_p = convert.model_params_to_numpy(tp, tcfg)
    want_o = convert.opt_state_to_numpy(ts, tcfg)
    for tree_j, tree_w in ((loaded["params"], want_p),
                           (loaded["opt"], want_o)):
        for a, b in zip(jax.tree.leaves(tree_j), jax.tree.leaves(tree_w)):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()


def test_checkpoint_written_by_reference_loads_in_port(tmp_path):
    jcfg, tcfg, jp, _ = bf16_params()
    js = jopt.init_opt_state(jp)
    js = {**js, "step": jnp.int32(5),
          "v": jax.tree.map(lambda x: x + 0.25, js["v"])}
    jckpt.save(str(tmp_path), 5, {"params": jp, "opt": js})
    _, _, _, template_p = bf16_params()
    template = {"params": template_p, "opt": opt.init_opt_state(template_p)}
    loaded, m = checkpoint.load(str(tmp_path), template, device="cpu")
    assert m["step"] == 5
    assert loaded["params"]["embed"].dtype == torch.bfloat16
    got_p = convert.model_params_to_numpy(loaded["params"], tcfg)
    got_o = convert.opt_state_to_numpy(loaded["opt"], tcfg)
    for tree_j, tree_t in ((jp, got_p), (js, got_o)):
        for a, b in zip(jax.tree.leaves(tree_j), jax.tree.leaves(tree_t)):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    back = convert.opt_state_from_numpy(got_o, tcfg, "cpu")
    assert int(back["step"]) == 5 and back["step"].dtype == torch.int32


def test_params_to_numpy_inverts_from_numpy():
    _, tcfg, jp, tp = bf16_params("recurrentgemma-9b")
    back = convert.model_params_to_numpy(tp, tcfg)
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert any(a.dtype == ml_dtypes.bfloat16 for a in jax.tree.leaves(back))


def test_checkpoint_atomicity_and_gc(tmp_path):
    tree = {"x": torch.zeros((2,))}
    for s in (1, 2, 3, 4):
        checkpoint.save(str(tmp_path), s, tree)
    os.makedirs(tmp_path / "step_00000099.tmp", exist_ok=True)
    assert checkpoint.latest_step(str(tmp_path)) == 4
    checkpoint.gc_old(str(tmp_path), keep=2)
    kept = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert kept == ["step_00000003", "step_00000004"]
    assert sorted(os.listdir(tmp_path / "step_00000004")) == [
        "leaf_00000.npy", "manifest.json"]
    with pytest.raises(ValueError, match="shape mismatch"):
        checkpoint.load(str(tmp_path), {"x": torch.zeros((3,))})
    with pytest.raises(FileNotFoundError):
        checkpoint.load(str(tmp_path / "none"), tree)


# ---------------------------------------------------------------------------
# The train step and the loop
# ---------------------------------------------------------------------------

def run_steps(arch, n, **kw):
    """``n`` steps of both packages' train step on ``synth_batch`` batches
    from the same parameters; yields (reference, port) after each."""
    jcfg = jconfigs.get_config(arch, smoke=True).replace(remat=True)
    tcfg = configs.get_config(arch, smoke=True).replace(remat=True)
    jt = jloop.TrainConfig(batch=4, seq=32, **kw)
    tt = loop.TrainConfig(batch=4, seq=32, **kw)
    jp = jax.tree.map(jnp.asarray, numpy_params(jcfg))
    js = jopt.init_opt_state(jp)
    jr = jcomp.init_residuals(jp) if jt.compress_grads else {}
    tp = convert.model_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                         "cpu")
    ts = opt.init_opt_state(tp)
    tr = compression.init_residuals(tp) if tt.compress_grads else {}
    jstep = jloop.make_train_step(jcfg, jt)
    tstep = loop.make_train_step(tcfg, tt)
    for i in range(n):
        b = jdata.synth_batch(i, jt.batch, jt.seq, jcfg.vocab, jt.seed)
        jp, js, jr, jm = jstep(jp, js, jr,
                               {k: jnp.asarray(v) for k, v in b.items()})
        tp, ts, tr, tm = tstep(tp, ts, tr, data.to_device(
            data.synth_batch(i, tt.batch, tt.seq, tcfg.vocab, tt.seed),
            "cpu"))
        yield (jp, js, jm), (tp, ts, tm)


@pytest.mark.parametrize("kw", [{}, {"grad_accum": 2}],
                         ids=["plain", "grad_accum"])
def test_train_step_matches_reference(kw):
    for (jp, js, jm), (tp, ts, tm) in run_steps("starcoder2-3b", 3, **kw):
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= (
            STEP_LOSS_REL * abs(float(jm["loss"])))
        assert int(ts["step"]) == int(js["step"])
        assert worst_rel(jp, tp) <= STEP_P_REL
        assert worst_rel(js["m"], ts["m"]) <= STEP_MV_REL
        assert worst_rel(js["v"], ts["v"]) <= STEP_MV_REL


def test_train_step_compressed_matches_reference():
    for (jp, js, jm), (tp, ts, tm) in run_steps("starcoder2-3b", 3,
                                                compress_grads=True):
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= (
            STEP_LOSS_REL * abs(float(jm["loss"])))
        assert worst_rel(jp, tp) <= COMPRESSED_P_REL
        assert worst_rel(js["m"], ts["m"]) <= COMPRESSED_MV_REL
        assert worst_rel(js["v"], ts["v"]) <= COMPRESSED_MV_REL


def tiny_cfg():
    return configs.get_config("yi-34b", smoke=True).replace(
        n_layers=1, loss_chunk=32)


def test_train_loop_runs_and_checkpoints(tmp_path):
    tcfg = loop.TrainConfig(batch=2, seq=32, steps=6, ckpt_every=3,
                            ckpt_dir=str(tmp_path))
    res = loop.train(tiny_cfg(), tcfg, resume=False, device="cpu")
    assert res.step == 6 and len(res.losses) == 6
    assert all(np.isfinite(x) for x in res.losses)
    assert checkpoint.latest_step(str(tmp_path)) == 6
    assert sorted(os.listdir(tmp_path)) == ["step_00000003",
                                            "step_00000006"]


def test_train_loop_failure_restart(tmp_path):
    """A crash at step 5 restarts from the step-4 checkpoint: the run ends
    at step 8, and its losses are an uninterrupted run's, steps 5-8
    (indices 4-7) taken twice."""
    cfg = tiny_cfg()
    kw = dict(batch=2, seq=32, steps=8, ckpt_every=2)
    res = loop.train(cfg, loop.TrainConfig(ckpt_dir=str(tmp_path / "a"),
                                           **kw),
                     resume=False, fail_at={5}, device="cpu")
    ref = loop.train(cfg, loop.TrainConfig(ckpt_dir=str(tmp_path / "b"),
                                           **kw),
                     resume=False, device="cpu")
    assert res.restarts == 1 and res.step == 8
    assert checkpoint.latest_step(str(tmp_path / "a")) == 8
    assert res.losses == ref.losses[:5] + ref.losses[4:]


def test_grad_accum_equivalence(tmp_path):
    """grad_accum=2 over a doubled batch == one large-batch step."""
    cfg = tiny_cfg()
    r = [loop.train(cfg, loop.TrainConfig(batch=4, seq=32, steps=1,
                                          grad_accum=a,
                                          ckpt_dir=str(tmp_path / str(a))),
                    resume=False, device="cpu") for a in (1, 2)]
    assert r[0].losses[0] == pytest.approx(r[1].losses[0], rel=1e-4)


def test_launch_train_smoke(tmp_path, capsys):
    res = launch_train.main(["--arch", "starcoder2-3b", "--smoke",
                             "--steps", "4", "--device", "cpu",
                             "--compress-grads", "--ckpt", str(tmp_path)])
    assert res.step == 4 and res.restarts == 0
    assert checkpoint.latest_step(str(tmp_path)) == 4
    assert "done: step=4" in capsys.readouterr().out
    # A mesh of ranks runs under torchrun (tests/test_torch_mesh_train.py
    # runs one); without a process group of its ranks it is refused.
    with pytest.raises(ValueError, match="torchrun"):
        launch_train.main(["--data", "2", "--device", "cpu"])
    with pytest.raises(ValueError, match="process group"):
        launch_train.setup("starcoder2-3b", smoke=True, model=2,
                           device="cpu")
