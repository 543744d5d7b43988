"""Training command (port of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b \
        [--smoke] [--steps N] [--batch B --seq S] [--ckpt DIR] \
        [--compress-grads] [--fail-at STEP] [--device cuda]

Runs on the card unless ``--device cpu`` is given. The loop checkpoints
every ``max(steps // 4, 1)`` steps and at its last: at full width a
checkpoint holds the bf16 parameters and the float32 m and v (about
30 GB for starcoder2-3b). ``--data``/``--model`` other than 1 (a mesh of
cards) raise: multi-GPU training is ROADMAP A19. ``setup`` builds the
objects the command drives; ``chip_smoke.py`` drives the same objects.
"""
from __future__ import annotations

import argparse
import os
import tempfile


def setup(arch: str, smoke: bool = False, batch: int = 4, seq: int = 128,
          steps: int = 20, ckpt: "str | None" = None,
          compress_grads: bool = False, data: int = 1, model: int = 1,
          device: str = "cuda"):
    """(cfg, tcfg, device) of one training run: the config, the loop's
    settings at the reference command's cadence, and the resolved device.
    Raises ``ValueError`` for a mesh of more than one card."""
    from repro_torch import configs
    from repro_torch.core.types import resolve_device
    from repro_torch.train import loop as train_loop

    if data != 1 or model != 1:
        raise ValueError(
            f"--data {data} --model {model}: training on a mesh of cards "
            "(ROADMAP A19) is not ported; the port trains on one device")
    cfg = configs.get_config(arch, smoke=smoke)
    tcfg = train_loop.TrainConfig(
        batch=batch, seq=seq, steps=steps,
        ckpt_every=max(steps // 4, 1),
        ckpt_dir=ckpt or os.path.join(tempfile.gettempdir(),
                                      "repro_torch_train_ckpt"),
        compress_grads=compress_grads,
    )
    return cfg, tcfg, resolve_device(device)


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

    from repro_torch.train import loop as train_loop

    cfg, tcfg, device = setup(
        args.arch, args.smoke, args.batch, args.seq, args.steps, args.ckpt,
        args.compress_grads, args.data, args.model, args.device,
    )
    fail = {args.fail_at} if args.fail_at is not None else None
    res = train_loop.train(cfg, tcfg, resume=True, fail_at=fail, log=print,
                           device=device)
    losses = (f"loss {res.losses[0]:.4f} -> {res.losses[-1]:.4f} "
              if res.losses else "no step left to run ")
    print(f"done: step={res.step} restarts={res.restarts} {losses}"
          f"({res.wall_s:.1f}s) on {device}")
    return res


if __name__ == "__main__":
    main()
