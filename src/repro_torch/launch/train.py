"""Training command (port of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b \
        [--smoke] [--steps N] [--batch B --seq S] [--ckpt DIR] \
        [--compress-grads] [--fail-at STEP] [--device cuda]

Runs on the card unless ``--device cpu`` is given. The loop checkpoints
every ``max(steps // 4, 1)`` steps and at its last: at full width a
checkpoint holds the bf16 parameters and the float32 m and v (about
30 GB for starcoder2-3b).

``--data D --model M`` trains on a (data, model) mesh of D·M ranks under
``torchrun``, which gives each rank its process group:

    torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch starcoder2-3b --smoke --data 2 --model 2

Each rank builds the mesh (``launch/mesh.py``) and runs the loop under
``use_rules(mesh, DEFAULT_RULES)``: NCCL with one card a rank where
there are enough cards, else gloo (ranks sharing a card, or CPU ranks).
``setup`` builds the objects the command drives; ``chip_smoke.py``
drives the same objects.
"""
from __future__ import annotations

import argparse
import os
import tempfile


def setup(arch: str, smoke: bool = False, batch: int = 4, seq: int = 128,
          steps: int = 20, ckpt: "str | None" = None,
          compress_grads: bool = False, data: int = 1, model: int = 1,
          device: str = "cuda"):
    """(cfg, tcfg, device, mesh) of one training run: the config, the
    loop's settings at the reference command's cadence, this rank's
    device, and for ``data``·``model`` > 1 the (data, model) mesh over the
    initialised process group (else None)."""
    from repro_torch import configs
    from repro_torch.core.types import resolve_device
    from repro_torch.launch.mesh import make_mesh, rank_device
    from repro_torch.train import loop as train_loop

    cfg = configs.get_config(arch, smoke=smoke)
    tcfg = train_loop.TrainConfig(
        batch=batch, seq=seq, steps=steps,
        ckpt_every=max(steps // 4, 1),
        ckpt_dir=ckpt or os.path.join(tempfile.gettempdir(),
                                      "repro_torch_train_ckpt"),
        compress_grads=compress_grads,
    )
    device = resolve_device(device)
    if data * model == 1:
        return cfg, tcfg, device, None
    mesh = make_mesh(data, model, device=device.type)
    return cfg, tcfg, rank_device(device.type), mesh


def init_world(device: str) -> None:
    """The process group of a ``torchrun`` rank (its environment names
    the rendezvous, rank and world size): NCCL where every rank has a
    card of its own, else gloo."""
    import torch
    import torch.distributed as dist

    if dist.is_initialized():
        return
    if "WORLD_SIZE" not in os.environ:
        raise ValueError(
            "--data/--model of more than one rank run under torchrun "
            "(torchrun --nproc-per-node D*M -m repro_torch.launch.train)")
    world = int(os.environ["WORLD_SIZE"])
    nccl = (device.startswith("cuda") and torch.cuda.is_available()
            and torch.cuda.device_count() >= world)
    dist.init_process_group("nccl" if nccl else "gloo")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-34b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a crash at this step (restart test)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.distributed.sharding import DEFAULT_RULES, use_rules
    from repro_torch.train import loop as train_loop

    if args.data * args.model > 1:
        init_world(args.device)
    cfg, tcfg, device, mesh = setup(
        args.arch, args.smoke, args.batch, args.seq, args.steps, args.ckpt,
        args.compress_grads, args.data, args.model, args.device,
    )
    fail = {args.fail_at} if args.fail_at is not None else None
    if mesh is None:
        res = train_loop.train(cfg, tcfg, resume=True, fail_at=fail,
                               log=print, device=device)
    else:
        import torch.distributed as dist

        log = print if dist.get_rank() == 0 else (lambda s: None)
        with use_rules(mesh, DEFAULT_RULES):
            res = train_loop.train(cfg, tcfg, resume=True, fail_at=fail,
                                   log=log, device=device)
        if dist.get_rank() != 0:
            return res
    losses = (f"loss {res.losses[0]:.4f} -> {res.losses[-1]:.4f} "
              if res.losses else "no step left to run ")
    where = device if mesh is None else f"{device}, mesh {tuple(mesh.shape)}"
    print(f"done: step={res.step} restarts={res.restarts} {losses}"
          f"({res.wall_s:.1f}s) on {where}")
    return res


if __name__ == "__main__":
    main()
