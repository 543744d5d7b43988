"""Multi-pod dry run: count every (arch x shape x mesh) cell on fake
tensors (port of ``repro/launch/dryrun.py``).

For each cell: build the real step function (train step / prefill /
decode step, ``launch/steps.py``), place its abstract arguments on the
production mesh by the logical-axis rules, run it once on FakeTensors as
rank 0 of a fake process group of 256 (16 x 16) or 512 (2 x 16 x 16)
ranks, and record the counts and the roofline terms
(``launch/roofline.py``) to a JSON file a cell.

The reference lowers and compiles each cell (its record's ``lower_s``
and ``compile_s``); the port compiles nothing, and its record has
``count_s`` in their place: the seconds to build the abstract trees,
place them and run the counted step.

The dry run needs no card and allocates nothing: its tensors are fake,
its process group (``torch.testing._internal.distributed.fake_pg``)
hallucinates every collective in one process, and its mesh is of CPU
ranks. So it is the one entry point of the port that does not run on the
card, as the reference's runs on host devices. It never creates a CUDA
tensor, and it takes the configs' plain attention paths, whose FLOPs it
counts. It leaves the process group as it found it: none (it refuses to
run where one is initialised).

Usage:
    python -m repro_torch.launch.dryrun --arch yi-34b --shape train_4k --mesh single
    python -m repro_torch.launch.dryrun --all [--mesh both] [--out experiments/dryrun]
"""
import argparse
import contextlib
import json
import os
import time
import traceback

SKIP_REASON = ("long_500k needs sub-quadratic attention; this arch is pure "
               "full-attention (see DESIGN.md §Arch-applicability)")


def model_flops(cfg, sh) -> float:
    """Useful FLOPs: 6·N_active·D for training, 2·N_active·D for a
    prefill, 2·N_active·B for one decode step."""
    n_active = cfg.active_param_count()
    if sh.kind == "train":
        return 6.0 * n_active * sh.global_batch * sh.seq_len
    if sh.kind == "prefill":
        return 2.0 * n_active * sh.global_batch * sh.seq_len
    return 2.0 * n_active * sh.global_batch


def place(args, in_sh, mesh, mode):
    """The abstract arguments as DTensors under their shardings: each
    rank's block a fake tensor of its own (a copy, so that its storage is
    the block's, not the global value's)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed import sharding as shd
    from repro_torch.train.tree import tree_map

    def one(x, sh):
        local = shd.local_block(x, sh.spec, mesh).clone()
        return DTensor.from_local(local, mesh, shd.placements(sh.spec, mesh),
                                  run_check=False, shape=x.shape,
                                  stride=x.contiguous().stride())

    with mode:
        return tuple(tree_map(one, a, s) for a, s in zip(args, in_sh))


@contextlib.contextmanager
def fake_world(n: int):
    """A fake process group of ``n`` ranks, this process rank 0, for the
    ``with`` block."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry run runs in a fake process group of its "
                           "own; this process has one initialised")
    dist.init_process_group("fake", rank=0, world_size=n, store=FakeStore())
    try:
        yield
    finally:
        dist.destroy_process_group()


def run_cell(arch: str, shape: str, multi_pod: bool, out_dir: str) -> dict:
    from repro_torch import configs
    from repro_torch.distributed.sharding import DEFAULT_RULES, use_rules
    from repro_torch.launch import roofline
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.specs import fake_mode
    from repro_torch.launch.steps import cell_step_and_shardings

    tag = f"{arch}__{shape}__{'multi' if multi_pod else 'single'}"
    if not configs.runnable(arch, shape):
        rec = {"cell": tag, "status": "skipped", "reason": SKIP_REASON}
        _write(out_dir, tag, rec)
        return rec

    with fake_world(512 if multi_pod else 256):
        t0 = time.time()
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        mode = fake_mode()
        fn, args, in_sh, donate, cfg, sh = cell_step_and_shardings(
            arch, shape, mesh, mode=mode
        )
        try:
            with use_rules(mesh, DEFAULT_RULES):
                counts = roofline.count_step(fn, place(args, in_sh, mesh,
                                                       mode), mode)
            t_count = time.time() - t0
            ana = roofline.analyze(counts, mesh.size(), model_flops(cfg, sh))
            rec = {
                "cell": tag, "status": "ok",
                "arch": arch, "shape": shape,
                "mesh": "2x16x16" if multi_pod else "16x16",
                "count_s": round(t_count, 2),
                "memory_analysis": str({k: counts[k] for k in (
                    "argument_bytes", "output_bytes", "temp_bytes")}),
                "flops_by_op": counts["flops_by_op"],
                **ana,
            }
        except Exception as e:  # noqa: BLE001 — report failures as data
            rec = {
                "cell": tag, "status": "error",
                "error": f"{type(e).__name__}: {e}",
                "trace": traceback.format_exc()[-2000:],
            }
    _write(out_dir, tag, rec)
    return rec


def _write(out_dir: str, tag: str, rec: dict):
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, tag + ".json"), "w") as f:
        json.dump(rec, f, indent=1, default=str)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    args = ap.parse_args(argv)

    from repro_torch import configs

    meshes = {"single": [False], "multi": [True], "both": [False, True]}[
        args.mesh
    ]
    cells = (
        configs.cells() if args.all else [(args.arch, args.shape)]
    )
    for arch, shape in cells:
        for mp in meshes:
            rec = run_cell(arch, shape, mp, args.out)
            status = rec["status"]
            extra = ""
            if status == "ok":
                extra = (
                    f" bottleneck={rec['bottleneck']}"
                    f" compute={rec['compute_s']:.3e}s"
                    f" mem={rec['memory_s']:.3e}s"
                    f" coll={rec['collective_s']:.3e}s"
                    f" frac={rec['roofline_fraction']:.2f}"
                    f" count={rec['count_s']}s"
                )
            elif status == "error":
                extra = " " + rec["error"][:160]
            print(f"[{rec['cell']}] {status}{extra}", flush=True)


if __name__ == "__main__":
    main()
