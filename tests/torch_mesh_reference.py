"""The reference's side of the port's mesh tests, in a process of its own.

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/torch_mesh_reference.py <case> <inputs.pkl> <out.pkl>

The tests of ``tests/test_torch_mesh_*.py`` write their numpy inputs to
``inputs.pkl`` and run this script while their own world of ranks runs;
it computes the reference's results on 4 virtual CPU devices and pickles
them to ``out.pkl``. Meshes are built with ``jax.sharding.Mesh`` directly,
whose axes are ``Auto`` (``jax.make_mesh`` builds ``Explicit`` axes under
JAX 0.9, under which ``with_sharding_constraint`` refuses the reference's
model code). ``<case>`` is ``engine``, ``model`` or ``train``.
"""
import os
import pickle
import sys

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=4")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh, PartitionSpec as P  # noqa: E402


def mesh_of(shape, names):
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), names)


def leaves(tree):
    return {jax.tree_util.keystr(p).lstrip("."): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def engine_case(inp):
    from repro.core import engine, timing
    from repro.core.types import (EngineConfig, PlatformModel, RequestBatch,
                                  SSDConfig, TimingState, WorkloadConfig)
    from repro.distributed.sharding import shard_map

    ssd = SSDConfig(**inp["ssd"])
    cfg = EngineConfig(**inp["cfg"])
    wl = WorkloadConfig(io_depth=inp["io_depth"])
    out = {"runner": {}, "update": {}}
    for m, n in inp["runner_cases"]:
        states = engine.init_array_state(cfg, ssd, wl, m)
        mesh = mesh_of((n,), ("dev",))
        run = engine.make_sharded_array_runner(
            cfg, ssd, wl, PlatformModel(), inp["rounds"], mesh=mesh)
        out["runner"][(m, n)] = leaves(run(states))
    for routing, n in inp["update_cases"]:
        u = inp["update"][(routing, n)]
        tssd = SSDConfig(**dict(inp["timing_ssd"], routing=routing))
        state = TimingState(jnp.asarray(u["busy"]), jnp.asarray(u["rr"]))
        arr, lba = jnp.asarray(u["arrival"]), jnp.asarray(u["lba"])
        valid = jnp.asarray(u["valid"])
        z = jnp.zeros_like(lba)
        batch = RequestBatch(arrival=arr, sq_id=z, slot=z, opcode=z, lba=lba,
                             nblocks=jnp.ones_like(lba), buf_id=z, req_id=z,
                             valid=valid)
        mesh = mesh_of((n,), ("u",))

        def body(st, b):
            return timing.update(st, b, tssd, axis_name="u")

        bspec = RequestBatch(*([P("u")] * 9))
        fn = jax.jit(shard_map(body, mesh, in_specs=(P(), bspec),
                               out_specs=(P(), P("u"))))
        st2, comp = fn(state, batch)
        st1, comp1 = jax.jit(lambda s, b: timing.update(s, b, tssd))(state,
                                                                    batch)
        out["update"][(routing, n)] = dict(
            busy=np.asarray(st2.busy_until), rr=np.asarray(st2.rr),
            comp=np.asarray(comp), busy_whole=np.asarray(st1.busy_until),
            rr_whole=np.asarray(st1.rr), comp_whole=np.asarray(comp1))
    return out


def model_case(inp):
    from repro import configs
    from repro.distributed import sharding as shd
    from repro.models import attention, moe, transformer

    mesh = mesh_of((2, 2), ("data", "model"))
    out = {}

    def cfg_of(arch, **kw):
        return configs.get_config(arch, smoke=True).replace(**kw)

    def under_rules(fn, *args):
        with mesh, shd.use_rules(mesh, shd.DEFAULT_RULES):
            return jax.jit(fn)(*args)

    for name, case in inp["attention"].items():
        cfg = cfg_of(case["arch"], **case["cut"])
        if name == "sharded_flash":
            win, scale = None, cfg.d_head ** -0.5
            y = under_rules(
                lambda q, k, v: attention._sharded_flash(q, k, v, cfg, win,
                                                         scale),
                jnp.asarray(case["q"]), jnp.asarray(case["k"]),
                jnp.asarray(case["v"]))
        else:
            y = under_rules(
                lambda p, x_, pos_: attention.attention_apply(
                    p, x_, cfg, case["kind"], pos_),
                case["params"], jnp.asarray(case["x"]),
                jnp.asarray(case["positions"]))
        out[name] = np.asarray(y)
    for name, case in inp["moe"].items():
        cfg = cfg_of(case["arch"], **case["cut"])
        y, aux = under_rules(lambda p, x_: moe.moe_apply(p, x_, cfg),
                             case["params"], jnp.asarray(case["x"]))
        out[name] = (np.asarray(y), float(aux))
    for name, case in inp["model"].items():
        cfg = cfg_of(case["arch"], **case["cut"])
        tok, lab = jnp.asarray(case["tokens"]), jnp.asarray(case["labels"])
        h, aux = under_rules(lambda p, t: transformer.forward(p, cfg, t),
                             case["params"], tok)
        loss, g = under_rules(
            jax.value_and_grad(lambda p, t, l: transformer.loss_fn(
                p, cfg, t, l)),
            case["params"], tok, lab)
        out[name] = dict(hidden=np.asarray(h), aux=float(aux),
                         loss=float(loss), grads=leaves(g))
    return out


def train_case(inp):
    from repro import checkpoint, configs
    from repro.distributed import sharding as shd
    from repro.train import data as data_lib
    from repro.train import loop

    cfg = configs.get_config(inp["arch"], smoke=True)
    tcfg = loop.TrainConfig(batch=inp["batch"], seq=inp["seq"],
                            steps=inp["steps"])
    mesh = mesh_of((2, 2), ("data", "model"))
    step = loop.make_train_step(cfg, tcfg)
    params = jax.tree.map(jnp.asarray, inp["params"])
    from repro.train import optimizer as opt_lib
    opt = opt_lib.init_opt_state(params)
    losses = []
    with mesh, shd.use_rules(mesh, shd.DEFAULT_RULES):
        for i in range(inp["steps"]):
            b = data_lib.synth_batch(i, inp["batch"], inp["seq"], cfg.vocab)
            b = {k: jnp.asarray(v) for k, v in b.items()}
            params, opt, _, metrics = step(params, opt, {}, b)
            losses.append(float(metrics["loss"]))
    checkpoint.save(inp["ckpt_dir"], inp["steps"],
                    {"params": params, "opt": opt})
    return dict(losses=losses, params=leaves(params))


def main():
    case, in_path, out_path = sys.argv[1:4]
    with open(in_path, "rb") as f:
        inp = pickle.load(f)
    out = {"engine": engine_case, "model": model_case,
           "train": train_case}[case](inp)
    with open(out_path + ".tmp", "wb") as f:
        pickle.dump(out, f)
    os.rename(out_path + ".tmp", out_path)


if __name__ == "__main__":
    main()
