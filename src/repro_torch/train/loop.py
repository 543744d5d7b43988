"""Training loop (port of ``repro/train/loop.py``): gradient accumulation,
compressed gradients, checkpoint/restart and failure injection, on one
device or, under ``sharding.use_rules``, on a mesh of ranks.

The loop is host-driven (one ``train_step`` per iteration) so the fault
tolerance (checkpoint cadence, failure injection, deterministic data
re-dispatch) lives in ordinary Python around the step. The step takes
the gradient of ``transformer.loss_fn`` with autograd and updates the
parameters, m and v in place (the reference donates them to its jitted
step).

On a mesh the parameters and the AdamW state are DTensors: replicated,
as the reference's command leaves them uncommitted, or placed by the
caller (``sharding.sharding_tree(transformer.model_axes(cfg), ...)``).
The global batch is drawn on every rank and ``loss_fn`` splits it by the
rules; each rank's gradient is its part, summed over the ranks by
``sharding.reduce_gradients`` (GSPMD's all-reduce), and AdamW updates
each rank's blocks with the global gradient norm. Rank 0 alone writes a
checkpoint (the parameters gathered), and every rank reads it back onto
the current mesh.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable

import torch

from repro_torch import checkpoint
from repro_torch.core.xla_math import const_div
from repro_torch.core.types import resolve_device
from repro_torch.distributed import compression
from repro_torch.distributed import sharding as shd
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.train import data as data_lib
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.tree import leaves, tree_map, unflatten


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    batch: int = 8
    seq: int = 128
    steps: int = 20
    grad_accum: int = 1
    ckpt_every: int = 10
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    compress_grads: bool = False
    seed: int = 0
    opt: opt_lib.AdamWConfig = opt_lib.AdamWConfig()


def value_and_grad(params, cfg: ModelConfig, tokens, labels, embeds=None,
                   mrope_positions=None):
    """(loss, gradient tree) of ``loss_fn`` at ``params``; a leaf the loss
    does not reach has the gradient None. Each gradient has its leaf's
    dtype."""
    flat = [p.detach().requires_grad_(True) for p in leaves(params)]
    with torch.enable_grad():
        loss = transformer.loss_fn(unflatten(params, flat), cfg, tokens,
                                   labels, embeds=embeds,
                                   mrope_positions=mrope_positions)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = unflatten(params, grads)
    if shd.is_global(loss):
        loss = loss.to_local()
        grads = shd.reduce_gradients(params, grads)
    return loss.detach(), grads


def _microbatch(batch: dict, i: int, n: int) -> dict:
    """Microbatch ``i`` of ``n`` over the leading batch dim (the
    reference's reshape to (n, B / n, ...)); ``mrope_positions`` (3, B, S)
    splits on its batch axis."""
    out = {}
    for k, v in batch.items():
        axis = 1 if k == "mrope_positions" else 0
        rows = v.shape[axis] // n
        out[k] = v.narrow(axis, i * rows, rows)
    return out


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig) -> Callable:
    """The (params, opt_state, residuals, batch) -> (params, opt_state,
    residuals, metrics) step; params, m and v are written in place. The
    batch holds ``labels`` and ``tokens`` or a frontend's ``embeds``, and
    ``mrope_positions`` where the config takes M-RoPE."""

    def grads_of(params, mb):
        loss, g = value_and_grad(params, cfg, mb.get("tokens"), mb["labels"],
                                 embeds=mb.get("embeds"),
                                 mrope_positions=mb.get("mrope_positions"))
        return loss, tree_map(
            lambda p, x: torch.zeros_like(p) if x is None else x, params, g)

    def step(params, opt_state, residuals, batch):
        if tcfg.grad_accum > 1:
            gsum = tree_map(
                lambda p: torch.zeros_like(p, dtype=torch.float32), params)
            lsum = torch.zeros((), dtype=torch.float32,
                               device=batch["labels"].device)
            for i in range(tcfg.grad_accum):
                loss, g = grads_of(params,
                                   _microbatch(batch, i, tcfg.grad_accum))
                tree_map(lambda acc, x: acc.add_(x), gsum, g)
                lsum = lsum + loss
                del g
            grads = tree_map(lambda x: const_div(x, tcfg.grad_accum), gsum)
            loss = const_div(lsum, tcfg.grad_accum)
        else:
            loss, grads = grads_of(params, batch)

        if tcfg.compress_grads:
            grads, residuals = compression.compress_tree(grads, residuals)

        if shd.is_global(leaves(params)[0]):
            # Each rank updates its blocks, clipped by the global norm.
            _, local_opt, metrics = opt_lib.apply_updates(
                shd.local_tree(params), shd.local_tree(grads),
                shd.local_tree(opt_state), tcfg.opt,
                gnorm=shd.global_norm(grads))
            opt_state = dict(opt_state, step=shd.distribute(
                local_opt["step"], opt_state["step"].device_mesh, shd.P()))
        else:
            params, opt_state, metrics = opt_lib.apply_updates(
                params, grads, opt_state, tcfg.opt
            )
        metrics["loss"] = loss
        return params, opt_state, residuals, metrics

    return step


def cold_start(cfg: ModelConfig, tcfg: TrainConfig, device):
    """(params, opt_state, residuals) of a fresh run: the port's seeded
    ``init_model`` on ``device``, zero AdamW state, zero residuals when
    the gradients are compressed (else an empty dict)."""
    device = resolve_device(device)
    params = transformer.init_model(
        torch.Generator(device=device).manual_seed(tcfg.seed), cfg)
    opt_state = opt_lib.init_opt_state(params)
    residuals = (compression.init_residuals(params)
                 if tcfg.compress_grads else {})
    return params, opt_state, residuals


@dataclasses.dataclass
class TrainResult:
    step: int
    losses: list
    restarts: int
    wall_s: float


def train(
    cfg: ModelConfig,
    tcfg: TrainConfig,
    resume: bool = True,
    fail_at: set | None = None,
    log: Callable[[str], None] = lambda s: None,
    device: "torch.device | str | None" = None,
) -> TrainResult:
    """Run the loop on ``device`` (``cuda`` unless named); ``fail_at``
    injects a simulated crash at those steps (the loop then restarts from
    the latest checkpoint, proving checkpoint/restart end to end)."""
    device = resolve_device(device)
    fail_at = set(fail_at or ())
    step_fn = make_train_step(cfg, tcfg)
    losses: list = []
    restarts = 0
    t0 = time.time()

    params, opt_state, residuals = cold_start(cfg, tcfg, device)
    ctx = shd.current_context()
    start = checkpoint.latest_step(tcfg.ckpt_dir) if resume else None
    if start is not None:
        state, _ = checkpoint.load(
            tcfg.ckpt_dir, {"params": params, "opt": opt_state}, step=start
        )
        params, opt_state = state["params"], state["opt"]
    if ctx is not None:
        params = shd.distribute_tree(params, ctx[0])
        opt_state = shd.distribute_tree(opt_state, ctx[0])
    if start is not None:
        step0 = start
        log(f"resumed from step {start}")
    else:
        step0 = 0

    prefetch = data_lib.Prefetcher(
        tcfg.batch, tcfg.seq, cfg.vocab, tcfg.seed, start_idx=step0,
        device=device,
    )
    try:
        it = iter(prefetch)
        step = step0
        while step < tcfg.steps:
            _, batch = next(it)
            if step in fail_at:
                fail_at.discard(step)
                restarts += 1
                log(f"injected failure at step {step}; restarting")
                prefetch.close()
                del params, opt_state, residuals
                inner = train(cfg, tcfg, resume=True, fail_at=fail_at,
                              log=log, device=device)
                return TrainResult(inner.step, losses + inner.losses,
                                   restarts + inner.restarts,
                                   time.time() - t0)
            params, opt_state, residuals, metrics = step_fn(
                params, opt_state, residuals, batch
            )
            losses.append(float(metrics["loss"]))
            step += 1
            if step % tcfg.ckpt_every == 0 or step == tcfg.steps:
                checkpoint.save(
                    tcfg.ckpt_dir, step,
                    {"params": params, "opt": opt_state},
                )
                checkpoint.gc_old(tcfg.ckpt_dir, keep=2)
                log(f"step {step} ckpt saved loss={losses[-1]:.4f}")
    finally:
        prefetch.close()
    return TrainResult(step, losses, restarts, time.time() - t0)
