"""Shared layer primitives: norms, RoPE, MLPs, softcap (port of
``repro/models/layers.py``).

Parameters are plain dicts of tensors with the reference's names and
layouts (``x @ w`` with ``w`` of shape (in, out)), so a reference
parameter tree carries over one to one (``convert.model_params_from_numpy``).
Initializers draw from an explicit ``torch.Generator`` on the target
device; ``stack`` prepends leading axes (the per-pattern-member layer
stacks of ``transformer.init_model``).
"""
from __future__ import annotations

import itertools

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + w.float())).to(dt)


def layer_norm(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(dt)


def softcap(x: torch.Tensor, cap: "float | None") -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# Rotary position embeddings (rotate-half, not interleaved).
# ---------------------------------------------------------------------------

def _rope_freq(half: int, theta: float, device) -> torch.Tensor:
    """The (half,) float32 frequencies ``theta ** (-arange(half) / half)``."""
    exponent = -torch.arange(0, half, dtype=torch.float32,
                             device=device) / half
    return torch.pow(torch.full((), theta, dtype=torch.float32,
                                device=device), exponent)


def _rope_angles(
    positions: torch.Tensor, d_head: int, theta: float
) -> "tuple[torch.Tensor, torch.Tensor]":
    """cos/sin tables for ``positions`` (..., S) -> (..., S, d_head/2)."""
    freq = _rope_freq(d_head // 2, theta, positions.device)
    ang = positions.float()[..., None] * freq
    return torch.cos(ang), torch.sin(ang)


def _rotate_half(x: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor) -> torch.Tensor:
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(
    x: torch.Tensor,          # (B, H, S, D)
    positions: torch.Tensor,  # (B, S)
    theta: float = 10000.0,
) -> torch.Tensor:
    cos, sin = _rope_angles(positions, x.shape[-1], theta)  # (B, S, D/2)
    return _rotate_half(x, cos[:, None], sin[:, None])


def apply_mrope(
    x: torch.Tensor,          # (B, H, S, D)
    positions: torch.Tensor,  # (3, B, S): temporal / height / width streams
    sections,
    theta: float = 10000.0,
) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE: the half head-dim is split into
    ``sections`` (in half-dim units), each rotated by its own position
    stream."""
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum to "
                         f"the half head-dim {half}")
    freq = _rope_freq(half, theta, x.device)
    # Section of each half-dim column, from device ops alone (no host
    # copy, so a captured decode step may call this).
    col = torch.arange(half, device=x.device)
    sec_id = torch.zeros_like(col)
    for edge in itertools.accumulate(sections[:-1]):
        sec_id += col >= edge                                   # (half,)
    pos = positions.float()[sec_id]                             # (half, B, S)
    ang = pos.movedim(0, -1) * freq                             # (B, S, half)
    return _rotate_half(x, torch.cos(ang)[:, None], torch.sin(ang)[:, None])


# ---------------------------------------------------------------------------
# MLPs.
# ---------------------------------------------------------------------------

def _act(name: str, h: torch.Tensor) -> torch.Tensor:
    if name == "silu":
        return F.silu(h)
    if name == "gelu":
        # jax.nn.gelu defaults to the tanh approximation.
        return F.gelu(h, approximate="tanh")
    raise ValueError(f"unknown activation {name!r}")


def mlp_apply(params: dict, x: torch.Tensor, act: str, gated: bool) -> torch.Tensor:
    """Gated (SwiGLU/GeGLU) or plain two-layer MLP."""
    if gated:
        g = x @ params["w_gate"]
        u = x @ params["w_up"]
        if "b_gate" in params:
            g = g + params["b_gate"]
            u = u + params["b_up"]
        h = _act(act, g) * u
    else:
        h = x @ params["w_up"]
        if "b_up" in params:
            h = h + params["b_up"]
        h = _act(act, h)
    y = h @ params["w_down"]
    if "b_down" in params:
        y = y + params["b_down"]
    return y


def normal(gen: torch.Generator, shape, scale: float, dtype) -> torch.Tensor:
    """Standard normal draws in ``dtype`` times ``scale`` (the reference's
    ``jax.random.normal(key, shape, dtype) * scale``)."""
    return torch.randn(shape, generator=gen, dtype=dtype,
                       device=gen.device) * scale


def mlp_init(
    gen: torch.Generator, d_model: int, d_ff: int, gated: bool,
    use_bias: bool, dtype, stack: tuple = (),
) -> dict:
    s_in = d_model ** -0.5
    s_out = d_ff ** -0.5
    p = {
        "w_up": normal(gen, (*stack, d_model, d_ff), s_in, dtype),
        "w_down": normal(gen, (*stack, d_ff, d_model), s_out, dtype),
    }
    if gated:
        p["w_gate"] = normal(gen, (*stack, d_model, d_ff), s_in, dtype)
    if use_bias:
        z = dict(dtype=dtype, device=gen.device)
        p["b_up"] = torch.zeros((*stack, d_ff), **z)
        p["b_down"] = torch.zeros((*stack, d_model), **z)
        if gated:
            p["b_gate"] = torch.zeros((*stack, d_ff), **z)
    return p


def norm_init(kind: str, d: int, dtype, device, stack: tuple = ()) -> dict:
    z = dict(dtype=dtype, device=device)
    if kind == "rmsnorm":
        return {"w": torch.zeros((*stack, d), **z)}
    return {"w": torch.ones((*stack, d), **z),
            "b": torch.zeros((*stack, d), **z)}


def norm_apply(kind: str, params: dict, x: torch.Tensor) -> torch.Tensor:
    if kind == "rmsnorm":
        return rms_norm(x, params["w"])
    return layer_norm(x, params["w"], params["b"])


def mlp_axes(gated: bool, use_bias: bool) -> dict:
    """The logical axes of ``mlp_init``'s leaves (the reference's)."""
    a = {"w_up": ("embed", "mlp"), "w_down": ("mlp", "embed")}
    if gated:
        a["w_gate"] = ("embed", "mlp")
    if use_bias:
        a["b_up"] = ("mlp",)
        a["b_down"] = ("embed",)
        if gated:
            a["b_gate"] = ("mlp",)
    return a


def norm_axes(kind: str) -> dict:
    """The logical axes of ``norm_init``'s leaves."""
    if kind == "rmsnorm":
        return {"w": ("embed",)}
    return {"w": ("embed",), "b": ("embed",)}
