"""Block assembly, model forward and loss, prefill and decode (port of
``repro/models/transformer.py``) for every block kind: attention
(``ATTN``, ``ATTN_LOCAL``, with a dense or a MoE MLP), Griffin's
``RGLRU`` and xLSTM's ``MLSTM`` and ``SLSTM``, fed token ids or a
modality frontend's embeddings, with RoPE or M-RoPE positions.

Parameters keep the reference's tree: ``periods`` holds one dict per
pattern member whose leaves are stacked over the ``n_periods`` periods,
``remainder`` the unrolled tail layers. The reference scans over the
periods; here a Python loop over the period index takes the place of the
scan (``forward`` unbinds each stacked leaf once, so that the backward
stacks the layers' gradients in one kernel, and under ``cfg.remat``
recomputes each period in the backward). Caches keep the same layout
(per pattern member the block's cache tree, every leaf stacked over
periods: (k, v) for attention, (conv, h) for RG-LRU, (conv, (C, n, m))
for mLSTM, (h, c, n, m) for sLSTM) and decode writes them in place.

Under ``sharding.use_rules`` ``forward``, ``loss_fn`` and ``prefill``
take global arrays (DTensors, or plain tensors every rank holds whole)
and run on each rank's blocks (``shard_map``): the residual stream is
split over the batch axes and, where the sequence divides, over
``model`` (the reference's ``("batch", "seq", "embed")`` rule), the
positions over the batch axes only; the attention, MoE and recurrent
blocks take their mesh routes, and the token-local layers (norms, MLPs,
the loss's vocab products) run on the local rows. ``loss_fn`` returns the
global loss, whose gradient on each rank is that rank's part
(``sharding.reduce_gradients`` sums them). ``decode_step`` on a mesh runs
each rank's rows against its blocks of the caches (``_decode_on_mesh``).
``model_axes`` gives the reference's logical axes of every parameter.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.utils.checkpoint

from repro_torch.core.types import resolve_device
from repro_torch.core.xla_math import const_div
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import P
from repro_torch.models import attention as attn
from repro_torch.models import layers, moe, recurrent
from repro_torch.models.config import (
    ATTN, ATTN_LOCAL, MLSTM, RGLRU, SLSTM, ModelConfig,
)

_ATTN_KINDS = (ATTN, ATTN_LOCAL)


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _take(tree, i: int):
    """Layer ``i`` of a stacked parameter or cache tree (views, so a cache
    written through them is written in the stack)."""
    if isinstance(tree, dict):
        return {k: _take(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_take(v, i) for v in tree)
    return tree[i]


def _stack(trees: list):
    """Leaf-wise ``torch.stack`` of equally shaped cache trees."""
    if isinstance(trees[0], tuple):
        return tuple(_stack(list(leaves)) for leaves in zip(*trees))
    return torch.stack(trees)


# ---------------------------------------------------------------------------
# Single block.
# ---------------------------------------------------------------------------

def block_init(gen: torch.Generator, cfg: ModelConfig, kind: str,
               stack: tuple = ()) -> dict:
    dt = _dtype(cfg)
    d = cfg.d_model
    dev = gen.device

    def mlp():
        return layers.mlp_init(gen, d, cfg.d_ff, cfg.mlp_gated, cfg.use_bias,
                               dt, stack)

    p = {"norm1": layers.norm_init(cfg.norm, d, dt, dev, stack)}
    if kind in _ATTN_KINDS:
        p["attn"] = attn.attn_init(gen, cfg, dt, stack)
        if not cfg.parallel_block:
            p["norm2"] = layers.norm_init(cfg.norm, d, dt, dev, stack)
        if cfg.n_experts:
            p["moe"] = moe.moe_init(gen, cfg, dt, stack)
        else:
            p["mlp"] = mlp()
        if cfg.post_norms:
            p["post1"] = layers.norm_init(cfg.norm, d, dt, dev, stack)
            p["post2"] = layers.norm_init(cfg.norm, d, dt, dev, stack)
    elif kind == RGLRU:
        p["rec"] = recurrent.rglru_init(gen, cfg, dt, stack)
        p["norm2"] = layers.norm_init(cfg.norm, d, dt, dev, stack)
        p["mlp"] = mlp()
    elif kind == MLSTM:
        p["cell"] = recurrent.mlstm_init(gen, cfg, dt, stack)
    elif kind == SLSTM:
        p["cell"] = recurrent.slstm_init(gen, cfg, dt, stack)
    else:
        raise ValueError(kind)
    return p


def _mlp_branch(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """(MLP or MoE output, aux loss)."""
    if cfg.n_experts:
        return moe.moe_apply(p["moe"], x, cfg)
    return layers.mlp_apply(p["mlp"], x, cfg.mlp_act, cfg.mlp_gated), 0.0


def _finish(p, x, y, n1, cfg: ModelConfig):
    """The residual tail of an attention block, shared by apply, prefill
    and decode: parallel block, or post-norms and the MLP sub-block.
    Returns (x', aux)."""
    if cfg.parallel_block:
        m, aux = _mlp_branch(p, n1, cfg)
        return x + y + m, aux
    if cfg.post_norms:
        y = layers.norm_apply(cfg.norm, p["post1"], y)
    x = x + y
    n2 = layers.norm_apply(cfg.norm, p["norm2"], x)
    m, aux = _mlp_branch(p, n2, cfg)
    if cfg.post_norms:
        m = layers.norm_apply(cfg.norm, p["post2"], m)
    return x + m, aux


def _recurrent(p, x, n1, cfg: ModelConfig, kind: str, state, chunk=256):
    """A recurrent block's mixer and residual (and RG-LRU's MLP
    sub-block) from ``state`` (None: zeros). Returns (x', state')."""
    if kind == RGLRU:
        y, state = recurrent.rglru_apply(p["rec"], n1, cfg, state)
        x = x + y
        n2 = layers.norm_apply(cfg.norm, p["norm2"], x)
        return x + _mlp_branch(p, n2, cfg)[0], state
    if kind == MLSTM:
        y, state = recurrent.mlstm_apply(p["cell"], n1, cfg, state, chunk)
    elif kind == SLSTM:
        y, state = recurrent.slstm_apply(p["cell"], n1, cfg, state)
    else:
        raise ValueError(kind)
    return x + y, state


def block_apply(p: dict, x, cfg: ModelConfig, kind: str, positions,
                mrope_positions=None):
    """Plain forward of one block. Returns (x', aux)."""
    n1 = layers.norm_apply(cfg.norm, p["norm1"], x)
    if kind in _ATTN_KINDS:
        y = attn.attention_apply(p["attn"], n1, cfg, kind, positions,
                                 mrope_positions)
        return _finish(p, x, y, n1, cfg)
    return _recurrent(p, x, n1, cfg, kind, None)[0], 0.0


def block_init_cache(cfg: ModelConfig, kind: str, batch: int, cache_len: int,
                     device, stack: tuple = ()) -> Any:
    """Zero decode state of one block: a (k, v) cache, full length for
    local layers too (in-place position indexing, as the reference), or
    a recurrent block's state."""
    dt = _dtype(cfg)
    if kind in _ATTN_KINDS:
        shape = (*stack, batch, cfg.n_kv_heads, cache_len, cfg.d_head)
        return (torch.zeros(shape, dtype=dt, device=device),
                torch.zeros(shape, dtype=dt, device=device))
    init = {RGLRU: recurrent.rglru_init_state,
            MLSTM: recurrent.mlstm_init_state,
            SLSTM: recurrent.slstm_init_state}
    if kind not in init:
        raise ValueError(kind)
    return init[kind](cfg, batch, dt, device, stack)


def block_prefill(p, x, cfg: ModelConfig, kind, positions, cache_len,
                  mrope_positions=None):
    """Forward + this block's decode cache."""
    n1 = layers.norm_apply(cfg.norm, p["norm1"], x)
    if kind in _ATTN_KINDS:
        y, cache = attn.attention_prefill(p["attn"], n1, cfg, kind, positions,
                                          cache_len, mrope_positions)
        return _finish(p, x, y, n1, cfg)[0], cache
    state0 = block_init_cache(cfg, kind, x.shape[0], cache_len, x.device)
    return _recurrent(p, x, n1, cfg, kind, state0)


def block_decode(p, x, cache, pos, cfg: ModelConfig, kind,
                 mrope_positions=None, cache_len: "int | None" = None):
    """One-token decode step. Returns (x', cache) with ``cache`` written
    in place. ``cache_len`` is the global cache length inside a mesh
    body (``attention_decode``)."""
    n1 = layers.norm_apply(cfg.norm, p["norm1"], x)
    if kind in _ATTN_KINDS:
        y, cache = attn.attention_decode(p["attn"], n1, cache, pos, cfg, kind,
                                         mrope_positions, cache_len)
        return _finish(p, x, y, n1, cfg)[0], cache
    return _recurrent(p, x, n1, cfg, kind, cache, chunk=1)


# ---------------------------------------------------------------------------
# Whole model.
# ---------------------------------------------------------------------------

def init_model(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Random parameters on ``gen.device``, with the reference's scales:
    embedding and untied head N(0, 1/d_model), projections N(0, 1/fan_in),
    norms at identity, biases zero."""
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


def block_axes(cfg: ModelConfig, kind: str) -> dict:
    """Logical axes for one block (the reference's ``block_axes``)."""
    a: dict = {"norm1": layers.norm_axes(cfg.norm)}
    mlp = layers.mlp_axes(cfg.mlp_gated, cfg.use_bias)
    if kind in _ATTN_KINDS:
        a["attn"] = attn.attn_axes(cfg)
        if not cfg.parallel_block:
            a["norm2"] = layers.norm_axes(cfg.norm)
        if cfg.n_experts:
            a["moe"] = moe.moe_axes(cfg)
        else:
            a["mlp"] = mlp
        if cfg.post_norms:
            a["post1"] = layers.norm_axes(cfg.norm)
            a["post2"] = layers.norm_axes(cfg.norm)
    elif kind == RGLRU:
        a["rec"] = dict(recurrent.RGLRU_AXES)
        a["norm2"] = layers.norm_axes(cfg.norm)
        a["mlp"] = mlp
    elif kind == MLSTM:
        a["cell"] = dict(recurrent.MLSTM_AXES)
    elif kind == SLSTM:
        a["cell"] = dict(recurrent.SLSTM_AXES)
    else:
        raise ValueError(kind)
    return a


def _prepend_layers(axes_tree):
    if shd._is_axes(axes_tree):
        return ("layers", *axes_tree)
    return {k: _prepend_layers(v) for k, v in axes_tree.items()}


def model_axes(cfg: ModelConfig) -> dict:
    """Logical-axis tree mirroring init_model's structure."""
    a: dict = {"embed": ("vocab", "embed")}
    a["periods"] = tuple(
        _prepend_layers(block_axes(cfg, kind)) for kind in cfg.pattern
    )
    a["remainder"] = tuple(block_axes(cfg, kind) for kind in cfg.remainder)
    a["final_norm"] = layers.norm_axes(cfg.norm)
    if not cfg.tie_embeddings:
        a["lm_head"] = ("embed", "vocab")
    return a


def _layers(p: dict, cfg: ModelConfig):
    """(params, kind, period index or None, member index) of every layer
    in execution order: the periods, then the remainder."""
    for i in range(cfg.n_periods):
        for j, kind in enumerate(cfg.pattern):
            yield _take(p["periods"][j], i), kind, i, j
    for j, kind in enumerate(cfg.remainder):
        yield p["remainder"][j], kind, None, j


def _embed(p, cfg: ModelConfig, tokens=None, embeds=None):
    """Token ids through the embedding, or a frontend's embeds in the
    model dtype; times sqrt(d_model) where the config says so."""
    if embeds is None:
        h = p["embed"][tokens.long()]
    else:
        h = embeds.to(_dtype(cfg))
    if cfg.embed_scale_by_dim:
        h = h * torch.full((), cfg.d_model ** 0.5, dtype=h.dtype,
                           device=h.device)
    return h


def _embed_tokens(p, cfg: ModelConfig, tokens=None, embeds=None):
    """``_embed`` of (B, S) ids or (B, S, D) embeds under the residual's
    constraint."""
    return shd.constrain(_embed(p, cfg, tokens, embeds),
                         ("batch", "seq", "embed"))


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def _default_mrope(cfg: ModelConfig, positions, mrope_positions):
    """M-RoPE ids: the given ones, else all three streams at ``positions``
    (None for a config without M-RoPE)."""
    if cfg.rope == "mrope" and mrope_positions is None:
        return positions.expand(3, *positions.shape)
    return mrope_positions


def _unstack(tree, n: int) -> list:
    """The ``n`` layers of a stacked parameter tree, each leaf through one
    ``unbind``: its backward stacks the layers' gradients in one kernel
    (indexing layer by layer would add a zero-filled full-size gradient
    per layer)."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    if isinstance(tree, tuple):
        parts = [_unstack(v, n) for v in tree]
        return [tuple(v[i] for v in parts) for i in range(n)]
    return list(tree.unbind(0))


def _on_mesh(body, cfg: ModelConfig, p, tokens, embeds, positions,
             mrope_positions, extra=(), extra_specs=(), out_specs=None):
    """``body(p, tokens, embeds, positions, mrope_positions, *extra)`` on
    each rank's blocks of a global batch: tokens (B, S) and embeds
    (B, S, D) as the residual's rule splits them, positions (B, S) and
    M-RoPE ids (3, B, S) over the batch axes only (default: 0 .. S-1),
    ``extra`` by ``extra_specs``. ``out_specs`` is a function of the
    residual's spec (default: the residual and a replicated aux)."""
    mesh, rules = shd.current_context()
    x = tokens if embeds is None else embeds
    b, s = x.shape[:2]
    spec = attn._residual_spec((b, s, cfg.d_model), mesh, rules)
    if positions is None:
        positions = _positions(b, s, x.device)
    mrope_positions = _default_mrope(cfg, positions, mrope_positions)
    dp = spec[0]

    def local(pp, tok, emb, pos, mpos, *rest):
        with shd.region_dims(b, s):
            return body(pp, tok, emb, pos, mpos, *rest)

    outs = out_specs(spec) if out_specs else (spec, P())
    return shd.shard_map(
        local, mesh,
        (P(), P(spec[0], spec[1]), spec, P(dp, None), P(None, dp, None),
         *extra_specs),
        outs,
    )(p, tokens, embeds, positions, mrope_positions, *extra)


def forward(p: dict, cfg: ModelConfig, tokens=None, embeds=None,
            positions=None, mrope_positions=None):
    """Backbone forward of (B, S) token ids or (B, S, D) embeds. Returns
    (final-normed hidden states (B, S, D), the MoE aux loss).

    Under ``cfg.remat`` each period (one pass over ``cfg.pattern``) is
    recomputed in the backward (``torch.utils.checkpoint``, non-reentrant):
    only its input is kept, the reference's ``jax.checkpoint`` with
    ``nothing_saveable`` around its scanned period. The remainder layers
    are not wrapped, as in the reference."""
    if shd.current_context() is not None and not shd.in_region():
        return _on_mesh(
            lambda pp, tok, emb, pos, mpos: forward(pp, cfg, tok, emb, pos,
                                                    mpos),
            cfg, p, tokens, embeds, positions, mrope_positions)
    h = _embed_tokens(p, cfg, tokens, embeds)
    b, s = h.shape[:2]
    if positions is None:
        positions = _positions(b, s, h.device)
    mrope_positions = _default_mrope(cfg, positions, mrope_positions)

    def period_fn(h, pp):
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        for j, kind in enumerate(cfg.pattern):
            h, a = block_apply(pp[j], h, cfg, kind, positions,
                               mrope_positions)
            aux = aux + a
        return h, aux

    # Each period's aux is summed, then the periods' in order, as the
    # reference's scan and ``jnp.sum`` (for the few float32 terms the
    # order of the reference's reduction is not kept).
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for pp in _unstack(p["periods"], cfg.n_periods):
        if cfg.remat:
            h, a = torch.utils.checkpoint.checkpoint(
                period_fn, h, pp, use_reentrant=False,
                context_fn=shd.recompute_context)
        else:
            h, a = period_fn(h, pp)
        aux = aux + a
    for j, kind in enumerate(cfg.remainder):
        h, a = block_apply(p["remainder"][j], h, cfg, kind, positions,
                           mrope_positions)
        aux = aux + a
    return layers.norm_apply(cfg.norm, p["final_norm"], h), aux


def _head_matrix(p, cfg: ModelConfig):
    return p["embed"].T if cfg.tie_embeddings else p["lm_head"]


def logits_fn(p, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    logits = (h @ _head_matrix(p, cfg)).float()
    return layers.softcap(logits, cfg.final_softcap)


def _chunk_loss(h_c, w, y_c, final_softcap):
    """Σ (logsumexp − gold logit) over one chunk's (B, c) positions,
    float32."""
    logits = layers.softcap((h_c @ w).float(), final_softcap)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, y_c.long()[..., None])[..., 0]
    return torch.sum(logz - gold)


def _loss_sum(p: dict, cfg: ModelConfig, h, labels) -> torch.Tensor:
    """The float32 sum of the chunks' losses over ``h``'s (B, S) rows."""
    s = h.shape[1]
    w = _head_matrix(p, cfg)
    c = min(cfg.loss_chunk, s)
    if s % c:
        raise ValueError(f"S={s} is not a multiple of the loss chunk {c}")
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, s, c):
        total = total + torch.utils.checkpoint.checkpoint(
            _chunk_loss, h[:, i:i + c], w, labels[:, i:i + c],
            cfg.final_softcap, use_reentrant=False)
    return total


def loss_fn(p: dict, cfg: ModelConfig, tokens, labels, embeds=None,
            mrope_positions=None) -> torch.Tensor:
    """Mean next-token cross-entropy (plus the MoE aux loss), the vocab
    projection chunked over S by ``min(cfg.loss_chunk, S)`` so the
    (B, S, V) logits never materialize; each chunk is recomputed in the
    backward (checkpointed, as the reference's ``jax.checkpoint`` around
    its chunk step) and the float32 running sum adds the chunks in
    order; the mean divides as the compiled reference does
    (``xla_math.const_div``).

    On a mesh each rank sums the losses of its own rows (chunked over its
    block of the sequence), and the global loss is the ``psum`` of the
    ranks' parts, each part its mean share plus aux / ranks; the returned
    value is the global loss and its gradient on a rank is that rank's
    part's. Where the rules leave the batch or the sequence whole on some
    mesh axes (a dim that does not divide), the ranks along them hold the
    same rows, and each one's mean share is divided by their number."""
    ctx = shd.current_context()
    if ctx is not None and not shd.in_region():
        mesh, rules = ctx
        b, s = (tokens if embeds is None else embeds).shape[:2]
        axes = tuple(shd.axis_sizes(mesh))
        n = shd.axis_size(axes, mesh)
        rows = attn._residual_spec((b, s, cfg.d_model), mesh, rules)[:2]
        copies = n // shd.axis_size(
            shd._entry_axes(rows[0]) + shd._entry_axes(rows[1]), mesh)

        def body(pp, tok, emb, pos, mpos, lab):
            h, aux = forward(pp, cfg, tok, emb, pos, mpos)
            share = const_div(_loss_sum(pp, cfg, h, lab), b * s)
            if copies > 1:
                share = share / copies
            part = share + aux / n
            return part + (shd.psum(part.detach(), axes) - part.detach())

        return _on_mesh(
            body, cfg, p, tokens, embeds, None, mrope_positions,
            extra=(labels,), extra_specs=(P(*rows),),
            out_specs=lambda spec: P())
    h, aux = forward(p, cfg, tokens=tokens, embeds=embeds,
                     mrope_positions=mrope_positions)
    b, s, _ = h.shape
    return const_div(_loss_sum(p, cfg, h, labels), b * s) + aux


# ---------------------------------------------------------------------------
# Serving: prefill + decode.
# ---------------------------------------------------------------------------

def _cache_specs(cfg: ModelConfig, b: int, cache_len: int, mesh, rules,
                 seq_axis: str = "seq"):
    """Specs of the caches on a mesh: attention k/v under the rule of
    (batch, kv_heads, ``seq_axis``, head_dim) (kv heads, else the
    sequence, over ``model``: the reference's constraint in ``prefill``,
    its cache axes in decode), recurrent states over the batch axes."""
    kv = shd.spec_for(("batch", "kv_heads", seq_axis, "head_dim"), rules,
                      mesh, (b, cfg.n_kv_heads, cache_len, cfg.d_head))
    dp = kv[0]

    def member(kind, lead):
        if kind in _ATTN_KINDS:
            return (P(*lead, *kv), P(*lead, *kv))
        meta = block_init_cache(cfg, kind, b, cache_len, "meta")

        def spec(t):
            return P(*lead, dp, *([None] * (t.dim() - 1)))

        return tuple(spec(t) if isinstance(t, torch.Tensor)
                     else tuple(spec(u) for u in t) for t in meta)

    return (tuple(member(kind, (None,)) for kind in cfg.pattern),
            tuple(member(kind, ()) for kind in cfg.remainder))


def prefill(p: dict, cfg: ModelConfig, tokens=None, embeds=None,
            cache_len: "int | None" = None, mrope_positions=None):
    """Run the prompt (token ids or embeds); returns (last-token logits
    (B, V), caches). On a mesh each rank runs its blocks and the caches
    are global arrays of ``_cache_specs``' layout."""
    if shd.current_context() is not None and not shd.in_region():
        mesh, rules = shd.current_context()
        x = tokens if embeds is None else embeds
        b, s = x.shape[:2]
        clen = cache_len or s
        return _on_mesh(
            lambda pp, tok, emb, pos, mpos: prefill(pp, cfg, tok, emb, clen,
                                                    mpos),
            cfg, p, tokens, embeds, None, mrope_positions,
            out_specs=lambda spec: (P(spec[0], None),
                                    _cache_specs(cfg, b, clen, mesh, rules)))
    h = _embed_tokens(p, cfg, tokens, embeds)
    b, s = h.shape[:2]
    # In a body the rows may be a block of the sequence; the positions
    # and the cache cover the whole of it.
    s = shd.global_seq() or s
    cache_len = cache_len or s
    positions = _positions(b, s, h.device)
    mrope_positions = _default_mrope(cfg, positions, mrope_positions)
    per_member = [[] for _ in cfg.pattern]
    rem = []
    for lp, kind, i, j in _layers(p, cfg):
        h, cache = block_prefill(lp, h, cfg, kind, positions, cache_len,
                                 mrope_positions)
        (rem if i is None else per_member[j]).append(cache)
    caches = tuple(_stack(cs) for cs in per_member)
    h = layers.norm_apply(cfg.norm, p["final_norm"], h)
    last = h[:, -1:]
    if shd.in_region():
        # The last position lives on the last model rank's block.
        last = shd.all_gather(last, "model", 1)[:, -1:]
    logits = logits_fn(p, cfg, last)
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


def _cache_len(cfg: ModelConfig, caches) -> int:
    """The length of the attention caches (1 where there are none)."""
    period, rem = caches
    for members, kinds in ((period, cfg.pattern), (rem, cfg.remainder)):
        for cache, kind in zip(members, kinds):
            if kind in _ATTN_KINDS:
                return cache[0].shape[-2]
    return 1


def _decode_on_mesh(p: dict, cfg: ModelConfig, token, caches, pos,
                    embeds=None):
    """``decode_step`` on each rank's rows and its blocks of the caches:
    the parameters replicated, the tokens (or embeds) and the recurrent
    states over the batch axes, the attention caches under the
    reference's cache axes (batch, kv_heads, kv_seq, head_dim), which
    ``attention_decode`` reads in a body."""
    mesh, rules = shd.current_context()
    b = token.shape[0]
    cache_len = _cache_len(cfg, caches)
    specs = _cache_specs(cfg, b, cache_len, mesh, rules, seq_axis="kv_seq")
    dp = shd.spec_for(("batch",), rules, mesh, (b,))[0]
    pos = attn.as_position(pos, token.device)

    def body(pp, tok, cc, ps, emb):
        with shd.region_dims(b, 1):
            return _decode(pp, cfg, tok, cc, ps, emb, cache_len)

    return shd.shard_map(
        body, mesh, (P(), P(dp), specs, P(), P(dp, None)),
        (P(dp, None), specs),
    )(p, token, caches, pos, embeds)


def _decode(p: dict, cfg: ModelConfig, token, caches, pos, embeds=None,
            cache_len: "int | None" = None):
    # Unconstrained, as the reference's decode step embeds.
    if embeds is None:
        h = _embed(p, cfg, token)[:, None, :]
    else:
        h = _embed(p, cfg, embeds=embeds[:, None, :])
    pos = attn.as_position(pos, h.device)
    b = h.shape[0]
    mrope = (pos.to(torch.int32).expand(3, b, 1)
             if cfg.rope == "mrope" else None)
    period_caches, rem_caches = caches
    for lp, kind, i, j in _layers(p, cfg):
        cache = rem_caches[j] if i is None else _take(period_caches[j], i)
        h, _ = block_decode(lp, h, cache, pos, cfg, kind, mrope, cache_len)
    h = layers.norm_apply(cfg.norm, p["final_norm"], h)
    return logits_fn(p, cfg, h)[:, 0], caches


def decode_step(p: dict, cfg: ModelConfig, token, caches,
                pos: "torch.Tensor | int", embeds=None):
    """One decode step of (B,) tokens (or (B, D) embeds) at position
    ``pos``, a () int32 tensor on the inputs' device (a host integer is
    made into one); M-RoPE ids are ``pos`` on all three streams. Returns
    (logits (B, V), caches), the caches written in place. Nothing in it
    reads a value back to the host, so ``serving/loop.py`` captures it
    into a CUDA graph. Under ``sharding.use_rules`` the inputs are global
    arrays and each rank decodes its blocks (``_decode_on_mesh``); the
    caches come back in that route's layout, written in place where they
    came in it."""
    if shd.current_context() is not None and not shd.in_region():
        return _decode_on_mesh(p, cfg, token, caches, pos, embeds)
    return _decode(p, cfg, token, caches, pos, embeds)
