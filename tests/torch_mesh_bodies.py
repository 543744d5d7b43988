"""The port's side of the mesh tests: what each gloo rank runs
(``repro_torch.distributed.world.run_world`` pickles these by name, so
they live in a module that imports no JAX). Each body returns numpy
results for the test to hold against the reference's."""
import numpy as np
import torch


def _np(t):
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# The emulator: the sharded array runner and the distributed timing update.
# ---------------------------------------------------------------------------

def engine_body(rank, inp):
    from repro_torch import convert
    from repro_torch.core import engine, timing
    from repro_torch.core.types import (EngineConfig, PlatformModel,
                                        RequestBatch, SSDConfig, TimingState,
                                        WorkloadConfig)
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_axis_mesh

    ssd = SSDConfig(**inp["ssd"])
    cfg = EngineConfig(**inp["cfg"])
    wl = WorkloadConfig(io_depth=inp["io_depth"])
    meshes = {4: make_axis_mesh("dev", "cpu"),
              2: make_axis_mesh("dev", "cpu", ranks=[0, 1])}
    out = {"runner": {}, "array": {}, "update": {}}
    for m, n in inp["port_runner_cases"]:
        states = engine.init_array_state(cfg, ssd, wl, m, device="cpu")
        if rank < n:
            run = engine.make_sharded_array_runner(
                cfg, ssd, wl, PlatformModel(), inp["rounds"],
                mesh=meshes[n], device="cpu")
            got = convert.engine_state_to_numpy(run(states))
            if rank == 0:
                out["runner"][(m, n)] = got
        if rank == 0 and m not in out["array"]:
            one = engine.make_array_runner(cfg, ssd, wl, PlatformModel(),
                                           inp["rounds"], device="cpu")
            out["array"][m] = convert.engine_state_to_numpy(one(states))
    try:
        engine.make_sharded_array_runner(
            cfg, ssd, wl, PlatformModel(), inp["rounds"], mesh=meshes[4],
            device="cpu")(engine.init_array_state(cfg, ssd, wl, 6,
                                                  device="cpu"))
        out["indivisible"] = None
    except ValueError as e:
        out["indivisible"] = str(e)

    for routing, n in inp["update_cases"]:
        u = inp["update"][(routing, n)]
        tssd = SSDConfig(**dict(inp["timing_ssd"], routing=routing))
        state = TimingState(torch.from_numpy(u["busy"]),
                            torch.from_numpy(u["rr"]))
        nl = len(u["arrival"]) // n

        def rows(a):
            return torch.from_numpy(a[rank * nl:(rank + 1) * nl].copy())

        if rank < n:
            lba = rows(u["lba"])
            z = torch.zeros_like(lba)
            batch = RequestBatch(arrival=rows(u["arrival"]), sq_id=z, slot=z,
                                 opcode=z, lba=lba,
                                 nblocks=torch.ones_like(lba), buf_id=z,
                                 req_id=z, valid=rows(u["valid"]))
            with shd.region(meshes[n]):
                st, comp = timing.update(state, batch, tssd, axis_name="dev")
            got = dict(busy=_np(st.busy_until), rr=_np(st.rr),
                       comp=_np(comp))
            out["update"][(routing, n, rank)] = got
        if rank == 0:
            lba = torch.from_numpy(u["lba"])
            z = torch.zeros_like(lba)
            whole = RequestBatch(arrival=torch.from_numpy(u["arrival"]),
                                 sq_id=z, slot=z, opcode=z, lba=lba,
                                 nblocks=torch.ones_like(lba), buf_id=z,
                                 req_id=z, valid=torch.from_numpy(u["valid"]))
            st, comp = timing.update(state, whole, tssd)
            out["update"][(routing, n, "whole")] = dict(
                busy=_np(st.busy_until), rr=_np(st.rr), comp=_np(comp))
    return out


# ---------------------------------------------------------------------------
# The model's mesh paths.
# ---------------------------------------------------------------------------

def _tree(x):
    if isinstance(x, dict):
        return {k: _tree(v) for k, v in x.items()}
    return torch.from_numpy(np.ascontiguousarray(x))


def model_body(rank, inp):
    from repro_torch import configs, convert
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import attention, moe
    from repro_torch.models import transformer
    from repro_torch.train import loop
    from repro_torch.train.tree import jax_leaves

    mesh = make_mesh(2, 2, device="cpu")
    full = shd.full_tensor
    out = {}

    def cfg_of(arch, **kw):
        return configs.get_config(arch, smoke=True).replace(**kw)

    with shd.use_rules(mesh, shd.DEFAULT_RULES):
        for name, case in inp["attention"].items():
            cfg = cfg_of(case["arch"], **case["cut"])
            if name == "sharded_flash":
                y = attention._sharded_flash(
                    _tree(case["q"]), _tree(case["k"]), _tree(case["v"]),
                    cfg, None, cfg.d_head ** -0.5)
            else:
                y = attention.attention_apply(
                    _tree(case["params"]), _tree(case["x"]), cfg,
                    case["kind"], _tree(case["positions"]))
            out[name] = (_np(full(y)), type(y).__name__)
        for name, case in inp["moe"].items():
            cfg = cfg_of(case["arch"], **case["cut"])
            y, aux = moe.moe_apply(_tree(case["params"]), _tree(case["x"]),
                                   cfg)
            out[name] = (_np(full(y)), float(full(aux)))
        for name, case in inp["model"].items():
            cfg = cfg_of(case["arch"], **case["cut"])
            params = convert.model_params_from_numpy(case["params"], cfg,
                                                     "cpu")
            tok, lab = _tree(case["tokens"]), _tree(case["labels"])
            h, aux = transformer.forward(params, cfg, tok)
            dparams = shd.distribute_tree(params, mesh)
            loss, grads = loop.value_and_grad(dparams, cfg, tok, lab)
            out[name] = dict(
                hidden=_np(full(h)), aux=float(full(aux)), loss=float(loss),
                grads={k: _np(full(g)) for k, g in jax_leaves(grads)})
    return out if rank == 0 else None


# ---------------------------------------------------------------------------
# Training on the mesh, the elastic downsize and reshard-on-load.
# ---------------------------------------------------------------------------

def _steps(step_fn, params, opt, first, n, inp):
    from repro_torch.train import data

    losses = []
    for i in range(first, first + n):
        b = data.synth_batch(i, inp["batch"], inp["seq"], inp["vocab"])
        b = {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in b.items()}
        params, opt, _, metrics = step_fn(params, opt, {}, b)
        losses.append(float(metrics["loss"]))
    return params, opt, losses


def _placed(params, opt, cfg, mesh):
    """The parameters and AdamW state placed by the rules on ``mesh``
    (``sharding_tree`` of ``model_axes``), and their shardings."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import transformer

    axes = transformer.model_axes(cfg)
    p_sh = shd.sharding_tree(axes, shd.DEFAULT_RULES, mesh, params)
    o_sh = {"m": p_sh, "v": p_sh,
            "step": shd.NamedSharding(mesh, shd.P())}
    return p_sh, o_sh


def train_body(rank, inp):
    import os
    import time

    from repro_torch import checkpoint, convert
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import launcher
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import loop
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.tree import jax_leaves

    cfg, tcfg, device, mesh = launch_train.setup(
        inp["arch"], smoke=True, batch=inp["batch"], seq=inp["seq"],
        steps=inp["steps"], ckpt=inp["port_ckpt"], data=2, model=2,
        device="cpu")
    step_fn = loop.make_train_step(cfg, tcfg)

    def fresh():
        p = convert.model_params_from_numpy(inp["params"], cfg, device)
        return p, opt_lib.init_opt_state(p)

    def whole(tree):
        return {k: _np(shd.full_tensor(t)) for k, t in jax_leaves(tree)}

    out = {"placements": str(mesh.mesh_dim_names)}
    # Three steps on (2, 2), the parameters replicated (the command's).
    with shd.use_rules(mesh, shd.DEFAULT_RULES):
        p, o = fresh()
        p, o = shd.distribute_tree(p, mesh), shd.distribute_tree(o, mesh)
        p, o, out["losses"] = _steps(step_fn, p, o, 0, inp["steps"], inp)
        out["params"] = whole(p)

        # The elastic run: parameters and AdamW state placed by the rules,
        # two steps, a checkpoint (rank 0 writes it).
        p, o = fresh()
        p_sh, o_sh = _placed(p, o, cfg, mesh)
        p = shd.distribute_tree(p, mesh, p_sh)
        o = shd.distribute_tree(o, mesh, o_sh)
        out["sharded_leaves"] = sum(
            any(pl.is_shard() for pl in t.placements)
            for _, t in jax_leaves(p))
        p, o, first = _steps(step_fn, p, o, 0, inp["steps"] - 1, inp)
        checkpoint.save(inp["port_ckpt"], inp["steps"] - 1,
                        {"params": p, "opt": o})

    # One of the two data-parallel replicas stops beating: the supervisor
    # downsizes to one, and the other resumes on (data = 1, model = 2).
    sup = launcher.Supervisor(2, launcher.SupervisorConfig(
        heartbeat_timeout_s=10, allowed_data_sizes=(2, 1)))
    sup.heartbeat(0, 100.0)
    sup.heartbeat(1, 100.0)
    sup.heartbeat(0, 115.0)
    act = sup.handle_failures(115.0)
    out["action"] = act
    small = make_mesh(act["new_data_parallel"], 2, device="cpu",
                      ranks=[0, 1])
    if rank < 2:
        with shd.use_rules(small, shd.DEFAULT_RULES):
            p, o = fresh()
            p_sh, o_sh = _placed(p, o, cfg, small)
            state, manifest = checkpoint.load(
                inp["port_ckpt"], {"params": p, "opt": o},
                shardings={"params": p_sh, "opt": o_sh})
            p, o = state["params"], state["opt"]
            out["resumed_mesh"] = tuple(p["embed"].device_mesh.shape)
            p, o, last = _steps(step_fn, p, o, manifest["step"], 1, inp)
            out["elastic_losses"] = first + last
            out["elastic_params"] = whole(p)

    # The reference's checkpoint, once written, onto the port's mesh.
    deadline = time.monotonic() + inp["wait_s"]
    while not os.path.exists(inp["ref_done"]):
        if time.monotonic() > deadline:
            raise TimeoutError("the reference's checkpoint did not appear")
        time.sleep(0.5)
    with shd.use_rules(mesh, shd.DEFAULT_RULES):
        p, o = fresh()
        p_sh, o_sh = _placed(p, o, cfg, mesh)
        state, _ = checkpoint.load(inp["ref_ckpt"], {"params": p, "opt": o},
                                   shardings={"params": p_sh, "opt": o_sh})
        out["ref_ckpt_params"] = whole(state["params"])
    return out if rank == 0 else None


# ---------------------------------------------------------------------------
# Decode on a mesh against one device.
# ---------------------------------------------------------------------------

def decode_body(rank, inp):
    """Each case: ``prefill`` on one device, then ``decode_step`` over the
    same tokens on one device and on a (2, 2) mesh, the parameters and
    caches placed by the dry run's shardings (``model_axes``,
    ``specs.cache_axes``). Returns the logits of every step and the
    caches after the last, gathered whole, and each cache leaf's
    placements before and after and whether it is an attention cache."""
    from repro_torch import configs
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer
    from repro_torch.models.config import ATTN, ATTN_LOCAL
    from repro_torch.train.tree import leaves, tree_map

    def placements(tree):
        return [tuple(str(p) for p in t.placements) for t in leaves(tree)]

    mesh = make_mesh(2, 2, device="cpu")
    rules = shd.DEFAULT_RULES
    out = {}
    for name, case in inp.items():
        cfg = configs.get_config(case["arch"], smoke=True).replace(
            **case["cut"])
        params = transformer.init_model(torch.Generator().manual_seed(0), cfg)
        tokens = torch.from_numpy(case["tokens"])
        b, first = tokens.shape[0], case["prompt"]
        _, caches = transformer.prefill(params, cfg, tokens[:, :first],
                                        cache_len=case["cache_len"])
        one = tree_map(torch.clone, caches)
        want = []
        for pos in range(first, tokens.shape[1]):
            logits, one = transformer.decode_step(params, cfg, tokens[:, pos],
                                                  one, pos)
            want.append(_np(logits))
        dparams = shd.distribute_tree(params, mesh, shd.sharding_tree(
            transformer.model_axes(cfg), rules, mesh, params))
        dcaches = shd.distribute_tree(caches, mesh, shd.sharding_tree(
            specs.cache_axes(cfg), rules, mesh, caches))
        placed = placements(dcaches)
        attention = []
        for members, kinds in zip(caches, (cfg.pattern, cfg.remainder)):
            for c, kind in zip(members, kinds):
                attention += [kind in (ATTN, ATTN_LOCAL)] * len(leaves(c))
        dp = shd.spec_for(("batch",), rules, mesh, (b,))
        got = []
        with shd.use_rules(mesh, rules):
            for pos in range(first, tokens.shape[1]):
                tok = shd.distribute(tokens[:, pos], mesh, dp)
                logits, dcaches = transformer.decode_step(
                    dparams, cfg, tok, dcaches, pos)
                got.append(_np(shd.full_tensor(logits)))
        out[name] = dict(
            want=want, got=got, placed=placed, attention=attention,
            returned=placements(dcaches),
            caches_want=[_np(t) for t in leaves(one)],
            caches_got=[_np(shd.full_tensor(t)) for t in leaves(dcaches)])
    return out if rank == 0 else None
