"""Block assembly, model forward, prefill and decode (port of
``repro/models/transformer.py``) for the attention blocks (``ATTN``,
``ATTN_LOCAL``).

Parameters keep the reference's tree: ``periods`` holds one dict per
pattern member whose leaves are stacked over the ``n_periods`` periods,
``remainder`` the unrolled tail layers. The reference scans over the
periods; here a Python loop over the period index takes the place of the
scan. Caches keep the same layout (per pattern member a (k, v) pair
stacked over periods) and decode writes them in place. MoE, recurrent
and modality blocks raise ``NotImplementedError`` (ROADMAP A18).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.types import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models.config import ATTN, ATTN_LOCAL, ModelConfig

_ATTN_KINDS = (ATTN, ATTN_LOCAL)


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _check_ported(cfg: ModelConfig, kind: str) -> None:
    if kind not in _ATTN_KINDS:
        raise NotImplementedError(
            f"{kind!r} blocks are not ported yet (ROADMAP A18)"
        )
    if cfg.n_experts:
        raise NotImplementedError("MoE blocks are not ported yet (ROADMAP A18)")
    if cfg.modality != "none":
        raise NotImplementedError(
            f"the {cfg.modality} frontend is not ported yet (ROADMAP A18)"
        )


def _take(tree, i: int):
    """Layer ``i`` of a stacked parameter or cache tree."""
    if isinstance(tree, dict):
        return {k: _take(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_take(v, i) for v in tree)
    return tree[i]


# ---------------------------------------------------------------------------
# Single block.
# ---------------------------------------------------------------------------

def block_init(gen: torch.Generator, cfg: ModelConfig, kind: str,
               stack: tuple = ()) -> dict:
    _check_ported(cfg, kind)
    dt = _dtype(cfg)
    d = cfg.d_model
    p = {"norm1": layers.norm_init(cfg.norm, d, dt, gen.device, stack)}
    p["attn"] = attn.attn_init(gen, cfg, dt, stack)
    if not cfg.parallel_block:
        p["norm2"] = layers.norm_init(cfg.norm, d, dt, gen.device, stack)
    p["mlp"] = layers.mlp_init(gen, d, cfg.d_ff, cfg.mlp_gated, cfg.use_bias,
                               dt, stack)
    if cfg.post_norms:
        p["post1"] = layers.norm_init(cfg.norm, d, dt, gen.device, stack)
        p["post2"] = layers.norm_init(cfg.norm, d, dt, gen.device, stack)
    return p


def _mlp_branch(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return layers.mlp_apply(p["mlp"], x, cfg.mlp_act, cfg.mlp_gated)


def _finish(p, x, y, n1, cfg: ModelConfig):
    """The residual tail shared by apply, prefill and decode: parallel
    block, or post-norms and the MLP sub-block."""
    if cfg.parallel_block:
        return x + y + _mlp_branch(p, n1, cfg)
    if cfg.post_norms:
        y = layers.norm_apply(cfg.norm, p["post1"], y)
    x = x + y
    n2 = layers.norm_apply(cfg.norm, p["norm2"], x)
    m = _mlp_branch(p, n2, cfg)
    if cfg.post_norms:
        m = layers.norm_apply(cfg.norm, p["post2"], m)
    return x + m


def block_apply(p: dict, x, cfg: ModelConfig, kind: str, positions):
    """Plain forward of one block. Returns x'."""
    _check_ported(cfg, kind)
    n1 = layers.norm_apply(cfg.norm, p["norm1"], x)
    y = attn.attention_apply(p["attn"], n1, cfg, kind, positions)
    return _finish(p, x, y, n1, cfg)


def block_init_cache(cfg: ModelConfig, kind: str, batch: int, cache_len: int,
                     device, stack: tuple = ()) -> Any:
    """Zero (k, v) cache, full length for local layers too (in-place
    position indexing, as the reference)."""
    _check_ported(cfg, kind)
    shape = (*stack, batch, cfg.n_kv_heads, cache_len, cfg.d_head)
    return (torch.zeros(shape, dtype=_dtype(cfg), device=device),
            torch.zeros(shape, dtype=_dtype(cfg), device=device))


def block_prefill(p, x, cfg: ModelConfig, kind, positions, cache_len):
    """Forward + this block's decode cache."""
    _check_ported(cfg, kind)
    n1 = layers.norm_apply(cfg.norm, p["norm1"], x)
    y, cache = attn.attention_prefill(p["attn"], n1, cfg, kind, positions,
                                      cache_len)
    return _finish(p, x, y, n1, cfg), cache


def block_decode(p, x, cache, pos, cfg: ModelConfig, kind):
    """One-token decode step. Returns (x', cache) with ``cache`` written
    in place."""
    _check_ported(cfg, kind)
    n1 = layers.norm_apply(cfg.norm, p["norm1"], x)
    y, cache = attn.attention_decode(p["attn"], n1, cache, pos, cfg, kind)
    return _finish(p, x, y, n1, cfg), cache


# ---------------------------------------------------------------------------
# Whole model.
# ---------------------------------------------------------------------------

def init_model(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Random parameters on ``gen.device``, with the reference's scales:
    embedding and untied head N(0, 1/d_model), projections N(0, 1/fan_in),
    norms at identity, biases zero."""
    for kind in cfg.pattern + cfg.remainder:
        _check_ported(cfg, kind)
    dt = _dtype(cfg)
    p: dict = {"embed": layers.normal(gen, (cfg.vocab, cfg.d_model),
                                      cfg.d_model ** -0.5, dt)}
    p["periods"] = tuple(
        block_init(gen, cfg, kind, (cfg.n_periods,)) for kind in cfg.pattern
    )
    p["remainder"] = tuple(block_init(gen, cfg, kind)
                           for kind in cfg.remainder)
    p["final_norm"] = layers.norm_init(cfg.norm, cfg.d_model, dt, gen.device)
    if not cfg.tie_embeddings:
        p["lm_head"] = layers.normal(gen, (cfg.d_model, cfg.vocab),
                                     cfg.d_model ** -0.5, dt)
    return p


def _layers(p: dict, cfg: ModelConfig):
    """(params, kind, period index or None, member index) of every layer
    in execution order: the periods, then the remainder."""
    for i in range(cfg.n_periods):
        for j, kind in enumerate(cfg.pattern):
            yield _take(p["periods"][j], i), kind, i, j
    for j, kind in enumerate(cfg.remainder):
        yield p["remainder"][j], kind, None, j


def _embed_tokens(p, cfg: ModelConfig, tokens):
    h = p["embed"][tokens.long()]
    if cfg.embed_scale_by_dim:
        h = h * torch.full((), cfg.d_model ** 0.5, dtype=h.dtype,
                           device=h.device)
    return h


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def forward(p: dict, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Backbone forward of (B, S) tokens. Returns the final-normed hidden
    states (B, S, D). (The reference also returns the MoE aux loss, which
    is zero for the attention blocks ported here.)"""
    h = _embed_tokens(p, cfg, tokens)
    positions = _positions(*h.shape[:2], h.device)
    for lp, kind, _, _ in _layers(p, cfg):
        h = block_apply(lp, h, cfg, kind, positions)
    return layers.norm_apply(cfg.norm, p["final_norm"], h)


def _head_matrix(p, cfg: ModelConfig):
    return p["embed"].T if cfg.tie_embeddings else p["lm_head"]


def logits_fn(p, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    logits = (h @ _head_matrix(p, cfg)).float()
    return layers.softcap(logits, cfg.final_softcap)


# ---------------------------------------------------------------------------
# Serving: prefill + decode.
# ---------------------------------------------------------------------------

def prefill(p: dict, cfg: ModelConfig, tokens: torch.Tensor,
            cache_len: "int | None" = None):
    """Run the prompt; returns (last-token logits (B, V), caches)."""
    h = _embed_tokens(p, cfg, tokens)
    b, s = h.shape[:2]
    cache_len = cache_len or s
    positions = _positions(b, s, h.device)
    per_member = [[] for _ in cfg.pattern]
    rem = []
    for lp, kind, i, j in _layers(p, cfg):
        h, cache = block_prefill(lp, h, cfg, kind, positions, cache_len)
        (rem if i is None else per_member[j]).append(cache)
    caches = tuple(
        (torch.stack([c[0] for c in cs]), torch.stack([c[1] for c in cs]))
        for cs in per_member
    )
    h = layers.norm_apply(cfg.norm, p["final_norm"], h)
    logits = logits_fn(p, cfg, h[:, -1:])
    return logits[:, 0], (caches, tuple(rem))


def init_caches(cfg: ModelConfig, batch: int, cache_len: int,
                device: "torch.device | str | None" = None):
    """Zero caches shaped for decode, on ``device`` (``cuda`` unless
    named)."""
    device = resolve_device(device)
    period = tuple(
        block_init_cache(cfg, kind, batch, cache_len, device,
                         (cfg.n_periods,))
        for kind in cfg.pattern
    )
    rem = tuple(block_init_cache(cfg, kind, batch, cache_len, device)
                for kind in cfg.remainder)
    return period, rem


def decode_step(p: dict, cfg: ModelConfig, token: torch.Tensor, caches,
                pos: "torch.Tensor | int"):
    """One decode step of (B,) tokens at position ``pos``, a () int32
    tensor on the tokens' device (a host integer is made into one).
    Returns (logits (B, V), caches), the caches written in place. Nothing
    in it reads a value back to the host, so ``serving/loop.py`` captures
    it into a CUDA graph."""
    pos = attn.as_position(pos, token.device)
    h = _embed_tokens(p, cfg, token)[:, None, :]
    period_caches, rem_caches = caches
    for lp, kind, i, j in _layers(p, cfg):
        cache = rem_caches[j] if i is None else _take(period_caches[j], i)
        h, _ = block_decode(lp, h, cache, pos, cfg, kind)
    h = layers.norm_apply(cfg.norm, p["final_norm"], h)
    return logits_fn(p, cfg, h)[:, 0], caches
