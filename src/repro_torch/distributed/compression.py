"""Gradient compression: int8 quantization with error feedback (port of
``repro/distributed/compression.py``).

Per-block scales over ``BLOCK`` elements, an int8 payload (4x smaller
than float32), and a float32 residual carried to the next step so that
quantization error does not bias the optimizer (EF-SGD). On one card
nothing crosses a wire: the step applies the compression to its
gradients before the update, as the reference's single-device step does.
``torch.round`` rounds half to even, as ``jnp.round`` does, and the
scale's division and the residual's multiply-add round as the compiled
reference's (``xla_math.const_div``, ``_fma32``), so the quantized tree
is the reference's bit for bit.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.core.xla_math import _fma32, const_div
from repro_torch.train.tree import tree_map, jax_leaves

BLOCK = 256


def _pad_to_block(x: torch.Tensor) -> tuple[torch.Tensor, int]:
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % BLOCK
    return torch.nn.functional.pad(flat, (0, pad)), flat.shape[0]


def quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-block symmetric int8. Returns (q (N/B, B) int8, scale (N/B, 1)
    float32)."""
    flat, _ = _pad_to_block(g)
    blocks = flat.reshape(-1, BLOCK)
    scale = const_div(torch.amax(torch.abs(blocks), dim=1, keepdim=True),
                      127.0)
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def dequantize(q: torch.Tensor, scale: torch.Tensor, shape,
               n: int) -> torch.Tensor:
    flat = (q.to(torch.float32) * scale).reshape(-1)[:n]
    return flat.reshape(shape)


def compress_leaf(
    g: torch.Tensor, residual: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """EF step for one tensor: returns (decompressed grad, new residual)."""
    if g.dim() == 0 or g.numel() < BLOCK:
        return g, residual  # tiny tensors ride uncompressed
    target = g.to(torch.float32) + residual
    q, s = quantize(target)
    deq = dequantize(q, s, g.shape, g.numel())
    # target - q·scale: the compiled reference fuses the product into the
    # subtraction (one rounding).
    blocks = _pad_to_block(target)[0].reshape(-1, BLOCK)
    res = _fma32(-q.to(torch.float32), s.expand_as(blocks), blocks)
    return deq.to(g.dtype), res.reshape(-1)[:g.numel()].reshape(g.shape)


def compress_tree(grads, residuals):
    """EF-int8 compression across a gradient tree: (grads', residuals')."""
    pairs = tree_map(compress_leaf, grads, residuals)
    first = tree_map(lambda _, pr: pr[0], grads, pairs)
    second = tree_map(lambda _, pr: pr[1], grads, pairs)
    return first, second


def init_residuals(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compressed_bytes(params) -> int:
    """Wire bytes per step with int8 + per-block float32 scales."""
    total = 0
    for _, p in jax_leaves(params):
        n = math.prod(p.shape)
        if n < BLOCK:
            total += n * 4
        else:
            total += n + -(-n // BLOCK) * 4
    return total
