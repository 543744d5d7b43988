"""Attention: GQA projections, RoPE, local windows, softcap and a KV-cache
decode path (port of ``repro/models/attention.py``).

With ``ModelConfig.use_pallas`` the two products go through the port's
kernels (``kernels/ops.py``: the CUDA ``flash_attention`` and
``decode_attention`` for CUDA tensors, their plain versions for CPU
tensors), forward only: they raise on inputs that require grad, as the
reference's kernel path cannot be differentiated. Without it, prefill and
training run the chunked plain-PyTorch ``flash_attention_jnp`` (with the
flash backward) and decode the reference's einsum branch. One card
holds whole tensors, so the reference's sharding constraints are the
identity here; its tensor- and sequence-parallel attention
(``_sharded_flash``'s mesh branch, ``_megatron_attention``) waits for
ROADMAP A19.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models import layers
from repro_torch.models.config import ATTN_LOCAL, ModelConfig
from repro_torch.models.flash_vjp import flash_attention_jnp

NEG = -3e38


def attn_init(gen: torch.Generator, cfg: ModelConfig, dtype,
              stack: tuple = ()) -> dict:
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    s = d ** -0.5
    p = {
        "wq": layers.normal(gen, (*stack, d, hq * dh), s, dtype),
        "wk": layers.normal(gen, (*stack, d, hkv * dh), s, dtype),
        "wv": layers.normal(gen, (*stack, d, hkv * dh), s, dtype),
        "wo": layers.normal(gen, (*stack, hq * dh, d), (hq * dh) ** -0.5,
                            dtype),
    }
    z = dict(dtype=dtype, device=gen.device)
    if cfg.use_bias or cfg.qkv_bias:
        p.update(
            bq=torch.zeros((*stack, hq * dh), **z),
            bk=torch.zeros((*stack, hkv * dh), **z),
            bv=torch.zeros((*stack, hkv * dh), **z),
        )
    if cfg.use_bias:
        p["bo"] = torch.zeros((*stack, d), **z)
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((*stack, dh), **z)
        p["k_norm"] = torch.zeros((*stack, dh), **z)
    return p


def _project_qkv(params, x, cfg: ModelConfig, positions,
                 mrope_positions=None):
    b, s, _ = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.use_bias or cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = q.reshape(b, s, hq, dh).transpose(1, 2)
    k = k.reshape(b, s, hkv, dh).transpose(1, 2)
    v = v.reshape(b, s, hkv, dh).transpose(1, 2)
    if cfg.qk_norm:
        q = layers.rms_norm(q, params["q_norm"])
        k = layers.rms_norm(k, params["k_norm"])
    if cfg.rope == "rope":
        q = layers.apply_rope(q, positions, cfg.rope_theta)
        k = layers.apply_rope(k, positions, cfg.rope_theta)
    elif cfg.rope == "mrope":
        q = layers.apply_mrope(q, mrope_positions, cfg.mrope_sections,
                               cfg.rope_theta)
        k = layers.apply_mrope(k, mrope_positions, cfg.mrope_sections,
                               cfg.rope_theta)
    return q, k, v


def _flash_core(q, k, v, cfg: ModelConfig, window, scale):
    """Causal flash attention over whole (one-card) tensors."""
    if cfg.use_pallas:
        return kops.flash_attention(
            q, k, v, causal=True, window=window,
            logit_softcap=cfg.attn_softcap, scale=scale,
        )
    s_len = q.shape[2]
    return flash_attention_jnp(
        q, k, v, True, window, cfg.attn_softcap, scale,
        min(cfg.attn_chunk, s_len), min(cfg.attn_chunk, s_len),
    )


def _window_scale(cfg: ModelConfig, kind: str):
    window = cfg.window if kind == ATTN_LOCAL else None
    scale = cfg.attn_scale if cfg.attn_scale is not None else cfg.d_head ** -0.5
    return window, scale


def _out_proj(params, o, cfg: ModelConfig):
    b, _, s, _ = o.shape
    y = o.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.d_head) @ params["wo"]
    if cfg.use_bias:
        y = y + params["bo"]
    return y


def attention_apply(
    params: dict,
    x: torch.Tensor,          # (B, S, D)
    cfg: ModelConfig,
    kind: str,
    positions: torch.Tensor,  # (B, S)
    mrope_positions: "torch.Tensor | None" = None,  # (3, B, S)
) -> torch.Tensor:
    """Training / prefill self-attention. Returns (B, S, D)."""
    window, scale = _window_scale(cfg, kind)
    q, k, v = _project_qkv(params, x, cfg, positions, mrope_positions)
    return _out_proj(params, _flash_core(q, k, v, cfg, window, scale), cfg)


def attention_prefill(
    params, x, cfg: ModelConfig, kind, positions,
    cache_len: "int | None" = None, mrope_positions=None,
):
    """Prefill: as ``attention_apply``, and also the (k, v) cache, zero
    padded along the sequence to ``cache_len``."""
    window, scale = _window_scale(cfg, kind)
    q, k, v = _project_qkv(params, x, cfg, positions, mrope_positions)
    y = _out_proj(params, _flash_core(q, k, v, cfg, window, scale), cfg)
    s = x.shape[1]
    if cache_len is not None and cache_len > s:
        k = F.pad(k, (0, 0, 0, cache_len - s))
        v = F.pad(v, (0, 0, 0, cache_len - s))
    return y, (k, v)


def as_position(pos: "torch.Tensor | int", device) -> torch.Tensor:
    """A decode position as the () int32 tensor that the decode path takes
    (a host integer is copied to ``device``)."""
    if isinstance(pos, torch.Tensor):
        return pos
    return torch.tensor(pos, dtype=torch.int32, device=device)


def attention_decode(
    params: dict,
    x: torch.Tensor,                          # (B, 1, D)
    cache: Tuple[torch.Tensor, torch.Tensor],  # k, v: (B, Hkv, S_max, Dh)
    pos: "torch.Tensor | int",                # () i32 current position
    cfg: ModelConfig,
    kind: str,
    mrope_positions: "torch.Tensor | None" = None,  # (3, B, 1)
) -> "tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]":
    """One-token decode. The new k/v row is written into ``cache`` in
    place (the reference returns an updated copy); the same tensors are
    returned. ``pos`` is a () int32 tensor on ``x``'s device, as the
    reference's traced position is (a host integer is made into one): the
    cache row, the rotary positions, the kernel's lengths and the local
    window all come from it on the device, so a captured decode step
    takes each new position from a buffer."""
    window, scale = _window_scale(cfg, kind)
    b = x.shape[0]
    pos = as_position(pos, x.device).reshape(1)
    positions = pos.expand(b, 1)
    q, k_new, v_new = _project_qkv(params, x, cfg, positions,
                                   mrope_positions)
    k_cache, v_cache = cache
    row = pos.long()
    k_cache.index_copy_(2, row, k_new)
    v_cache.index_copy_(2, row, v_new)
    s_max = k_cache.shape[2]
    length = pos + 1

    if cfg.use_pallas:
        o = kops.decode_attention(
            q[:, :, 0], k_cache, v_cache, length.expand(b).contiguous(),
            window=window, logit_softcap=cfg.attn_softcap, scale=scale,
        )[:, :, None, :]
    else:
        hq, hkv = cfg.n_heads, cfg.n_kv_heads
        group = hq // hkv
        # q is scaled in float32 and cast back to the cache type; both
        # products take float32 copies of their operands, whose float32
        # sums equal the reference's float32-accumulated products.
        qg = (q.float() * scale).to(q.dtype)
        qg = qg.reshape(b, hkv, group, cfg.d_head)
        if window is not None and window < s_max:
            # Local layers touch only the last `window` entries: the
            # reference's dynamic_slice, as a gather at a device index.
            start = torch.clamp(length - window, 0, s_max - window)
            cols = start + torch.arange(window, device=x.device)
            k_att = k_cache.index_select(2, cols)
            v_att = v_cache.index_select(2, cols)
        else:
            k_att, v_att = k_cache, v_cache
            cols = torch.arange(s_max, device=x.device)
        logits = torch.matmul(qg.float(), k_att.float().transpose(-1, -2))
        if cfg.attn_softcap is not None:
            logits = layers.softcap(logits, cfg.attn_softcap)
        mask = cols < length
        if window is not None:
            mask &= cols > length - 1 - window
        logits = torch.where(mask, logits, NEG)
        p = torch.softmax(logits, dim=-1)
        o = torch.matmul(p.to(v_att.dtype).float(), v_att.float())
        o = o.reshape(b, hq, 1, cfg.d_head).to(x.dtype)

    return _out_proj(params, o, cfg), (k_cache, v_cache)
