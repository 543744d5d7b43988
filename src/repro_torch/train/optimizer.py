"""AdamW (port of ``repro/train/optimizer.py``): m and v in float32, a
linear warmup into a cosine decay, global-norm clipping.

The scalars are the reference's bit for bit where its float32 allows:
the schedule's divisions by constants as products with float32
reciprocals (``xla_math.const_div``, as XLA compiles them), its product
and add fused (``xla_math._fma32``), the bias corrections' ``b1 ** step``
through ``xla_math.pow_f32`` (a constant base and a float32 exponent:
glibc's ``powf``), the step count; the cosine is the double one rounded
once, within 1 ULP of the reference's glibc ``cosf``. The gradient norm
sums the leaves in JAX's order (``tree.jax_leaves``), each leaf's squares
in another order than XLA's (1-2 ULP). The update keeps the compiled
reference's division, m2 / (b1c · (sqrt(v2 / b2c) + eps)), but not its
four fused multiply-adds (b1·m + ..., b2·v + ..., wd·p + ..., p − lr·δ):
emulated exactly (``_fma32``) each would take some twenty float64 passes
over every parameter. Against the reference (``tests/test_torch_train.py``)
parameters stay within 2 ULP, v within 16 ULP, and m within 4 ULP of its
leaf's largest |m| (where b1·m and (1−b1)·g cancel, the fused and unfused
sums differ by more ULP of the small result).

The update is written in place into the parameters, m and v (the
reference donates them to its jitted step), in slices of the leading
axis of at most ``UPDATE_CHUNK`` elements, so that the float32
temporaries of a stacked (n_periods, ...) leaf take a slice's room, not
the leaf's; the update is elementwise, so the slices change no bit.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Tuple

import torch

from repro_torch.core.xla_math import _fma32, const_div, pow_f32
from repro_torch.train.tree import leaves, jax_leaves, tree_map

UPDATE_CHUNK = 1 << 27      # elements of a leaf updated at once


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def init_opt_state(params) -> dict:
    """Zero m and v (float32, each leaf's shape and device) and step 0
    (int32)."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    dev = leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    s = step.to(torch.float32)
    warm = const_div(s, max(cfg.warmup_steps, 1))
    t = torch.clamp(
        const_div(s - cfg.warmup_steps,
                  max(cfg.total_steps - cfg.warmup_steps, 1)),
        0.0, 1.0,
    )
    # The compiled reference calls glibc's cosf (within 1 ULP, not always
    # correctly rounded); the port rounds the double cosine once, so the
    # rate may differ by 1 ULP in the cosine phase (47 of the default
    # schedule's 10001 steps there). It fuses the product and the add.
    cos = _fma32(
        torch.full_like(t, (1 - cfg.min_lr_frac) * 0.5),
        1 + torch.cos((math.pi * t).to(torch.float64)).to(torch.float32),
        torch.full_like(t, cfg.min_lr_frac),
    )
    return cfg.lr * torch.minimum(warm, cos)


def _chunks(x: torch.Tensor):
    """Slices of ``x`` along its leading axis of at most ``UPDATE_CHUNK``
    elements each (one row at least), or ``x`` whole."""
    if x.dim() == 0 or x.numel() <= UPDATE_CHUNK:
        return [x]
    rows = max(1, UPDATE_CHUNK // max(1, x[0].numel()))
    return list(x.split(rows))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the float32 sum of squares over every leaf, the leaves added
    in JAX's order."""
    total = 0
    for _, g in jax_leaves(tree):
        total = total + torch.sum(torch.square(g.to(torch.float32)))
    return torch.sqrt(total)


def apply_updates(
    params, grads, state: dict, cfg: AdamWConfig,
    gnorm: "torch.Tensor | None" = None,
) -> Tuple[Any, dict, dict]:
    """One AdamW step. Returns (params', state', metrics); params, m and v
    are updated in place and returned. ``gnorm`` is the gradient's global
    norm where the caller holds only blocks of it (default: the norm of
    ``grads``)."""
    step = state["step"] + 1
    dev = step.device
    if gnorm is None:
        gnorm = global_norm(grads)
    clip = torch.clamp(
        torch.full((), cfg.grad_clip, dtype=torch.float32, device=dev)
        / torch.clamp(gnorm, min=1e-12), max=1.0)
    lr = _schedule(cfg, step)
    s = step.to(torch.float32)
    b1c = 1 - pow_f32(torch.full((), cfg.b1, dtype=torch.float32,
                                 device=dev), s)
    b2c = 1 - pow_f32(torch.full((), cfg.b2, dtype=torch.float32,
                                 device=dev), s)

    def upd(p, g, m, v):
        for pc, gc, mc, vc in zip(*(_chunks(x) for x in (p, g, m, v))):
            gc = gc.to(torch.float32) * clip
            m2 = cfg.b1 * mc + (1 - cfg.b1) * gc
            v2 = cfg.b2 * vc + (1 - cfg.b2) * gc * gc
            # mh / (sqrt(vh) + eps) with mh = m2 / b1c, as XLA rewrites
            # (A / B) / C: A / (B · C).
            delta = m2 / (b1c * (torch.sqrt(v2 / b2c) + cfg.eps)) + (
                cfg.weight_decay * pc.to(torch.float32))
            pc.copy_((pc.to(torch.float32) - lr * delta).to(pc.dtype))
            mc.copy_(m2)
            vc.copy_(v2)

    with torch.no_grad():
        tree_map(upd, params, grads, state["m"], state["v"])
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, {"m": state["m"], "v": state["v"], "step": step}, metrics
