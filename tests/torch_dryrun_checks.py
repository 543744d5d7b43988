"""The dry run's counts on a fake process group of 4 ranks, for
``tests/test_torch_dryrun.py``, which runs this file in a subprocess (the
fake group is this process's default group while it runs, so no pytest
worker initialises one):

    python tests/torch_dryrun_checks.py OUT.json

Writes a JSON object: a DTensor matmul as ``FlopCounterMode`` and as
``roofline.count_step`` charge it, the collective bytes of an all-gather
on each of the port's two routes, and the counts of starcoder2-3b SMOKE's
train, prefill and decode steps on a (2, 2) mesh and on one device.
"""
import json
import sys

import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore

M, K, N = 8, 16, 32
B, S = 8, 64


def matmul(mesh, mode):
    """(FlopCounterMode's count, count_step's flops) of an (M, K) @ (K, N)
    bf16 product whose rows are split over ``data``."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch import roofline

    with mode:
        a = torch.empty(M // 2, K, dtype=torch.bfloat16)
        b = torch.empty(K, N, dtype=torch.bfloat16)
        da = DTensor.from_local(a, mesh, [Shard(0), Replicate()],
                                run_check=False, shape=(M, K),
                                stride=(K, 1))
        db = DTensor.from_local(b, mesh, [Replicate(), Replicate()],
                                run_check=False)
        with FlopCounterMode(display=False) as fc:
            da @ db
    counted = roofline.count_step(lambda x, y: x @ y, (da, db), mode)
    return {"flop_counter_mode": fc.get_total_flops(),
            "count_step": counted["flops"], "bytes": counted["bytes"]}


def all_gathers(mesh, mode):
    """count_step's collective bytes of a (4, 32) float32 block gathered
    over the 2 ``model`` ranks: through ``sharding._gather`` (c10d) and
    through a DTensor's redistribution (``_c10d_functional``)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import roofline

    with mode:
        x = torch.empty(4, 32)
        dx = DTensor.from_local(x, mesh, [Replicate(), Shard(0)],
                                run_check=False, shape=(8, 32),
                                stride=(32, 1))
    group = mesh.get_group("model")
    c10d = roofline.count_step(lambda t: shd._gather(t, group, 0), (x,), mode)
    functional = roofline.count_step(
        lambda t: t.redistribute(mesh, [Replicate(), Replicate()]), (dx,),
        mode)
    return {"operand_bytes": 4 * 32 * 4,
            "c10d": c10d["collective_by_op"],
            "functional": functional["collective_by_op"]}


def abstract_step(cfg, kind, mode):
    """(step, abstract arguments, their logical axes) of one SMOKE step at
    B = 8, S = 64 (decode: against a 64-token cache), made in ``mode``."""
    from repro_torch.launch import specs, steps
    from repro_torch.models import transformer

    params = specs.abstract_params(cfg, mode)
    p_axes = transformer.model_axes(cfg)
    if kind == "train":
        batch, b_axes = specs.train_batch_specs(cfg, B, S, mode)
        return (steps.build_train_step(cfg),
                (params, specs.abstract_opt_state(params, mode), batch),
                (p_axes, specs.opt_axes(p_axes), b_axes))
    if kind == "prefill":
        batch, b_axes = specs.prefill_batch_specs(cfg, B, S, mode)
        return (steps.build_prefill_step(cfg, S), (params, batch),
                (p_axes, b_axes))
    batch, b_axes = specs.decode_batch_specs(cfg, B, mode)
    return (steps.build_decode_step(cfg),
            (params, batch, specs.abstract_caches(cfg, B, S, mode)),
            (p_axes, b_axes, specs.cache_axes(cfg)))


def smoke_steps(mesh):
    """starcoder2-3b SMOKE's three steps: counts on the mesh (rank 0, the
    arguments placed by the rules) and on one device."""
    from repro_torch import configs
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import dryrun, roofline, specs

    cfg = configs.get_config("starcoder2-3b", smoke=True)
    out = {}
    for kind in ("train", "prefill", "decode"):
        mode = specs.fake_mode()
        fn, args, _ = abstract_step(cfg, kind, mode)
        one = roofline.count_step(fn, args, mode)
        mode = specs.fake_mode()
        fn, args, axes = abstract_step(cfg, kind, mode)
        in_sh = tuple(shd.sharding_tree(ax, shd.DEFAULT_RULES, mesh, a)
                      for ax, a in zip(axes, args))
        with shd.use_rules(mesh, shd.DEFAULT_RULES):
            on_mesh = roofline.count_step(
                fn, dryrun.place(args, in_sh, mesh, mode), mode)
        out[kind] = {"one_device": one, "mesh": on_mesh,
                     "model_flops": dryrun.model_flops(
                         cfg, configs.ShapeSpec(kind, S, B, kind))}
    return out


def main(path: str) -> None:
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.specs import fake_mode

    dist.init_process_group("fake", rank=0, world_size=4, store=FakeStore())
    try:
        mesh = make_mesh(2, 2, device="cpu")
        out = {"matmul": matmul(mesh, fake_mode()),
               "all_gather": all_gathers(mesh, fake_mode()),
               "smoke": smoke_steps(mesh)}
    finally:
        dist.destroy_process_group()
    with open(path, "w") as f:
        json.dump(out, f, default=str)


if __name__ == "__main__":
    main(sys.argv[1])
