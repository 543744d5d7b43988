"""Attention: GQA projections, RoPE, local windows, softcap and a KV-cache
decode path (port of ``repro/models/attention.py``).

With ``ModelConfig.use_pallas`` the two products go through the port's
kernels (``kernels/ops.py``: the CUDA ``flash_attention`` and
``decode_attention`` for CUDA tensors, their plain versions for CPU
tensors), forward only: they raise on inputs that require grad, as the
reference's kernel path cannot be differentiated. Without it, prefill and
training run the chunked plain-PyTorch ``flash_attention_jnp`` (with the
flash backward) and decode the reference's einsum branch.

Under ``sharding.use_rules`` on a mesh with a ``model`` axis the
reference's tensor- and sequence-parallel routes run on each rank's local
blocks (``shard_map``): ``_sharded_flash`` shards the q heads over
``model`` with K/V replicated, each rank mapping its heads to their GQA
KV heads through the global head index (under ``use_pallas`` every rank
launches the ``flash_attention`` kernel on its own heads), and
``_megatron_attention`` all-gathers the seq-sharded residual, projects
its q heads (column-parallel), runs the local flash core and finishes the
row-parallel ``wo`` with a reduce-scatter onto the sequence. A global
argument (a DTensor, or a plain tensor every rank holds whole) enters
through ``shard_map`` with the residual's rule; inside a body the
functions take local blocks, and the residual's rows are seq-sharded
where ``sharding.global_seq`` exceeds them.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import P
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


def attn_axes(cfg: ModelConfig) -> dict:
    """The logical axes of ``attn_init``'s leaves (the reference's)."""
    a = {
        "wq": ("embed", "heads"),
        "wk": ("embed", "kv_heads"),
        "wv": ("embed", "kv_heads"),
        "wo": ("heads", "embed"),
    }
    if cfg.use_bias or cfg.qkv_bias:
        a.update(bq=("heads",), bk=("kv_heads",), bv=("kv_heads",))
    if cfg.use_bias:
        a["bo"] = ("embed",)
    if cfg.qk_norm:
        a["q_norm"] = ("head_dim",)
        a["k_norm"] = ("head_dim",)
    return a


def _project_qkv(params, x, cfg: ModelConfig, positions,
                 mrope_positions=None, q_heads: "tuple | None" = None):
    """q, k, v as (B, H, S, Dh). ``q_heads`` = (first, count) projects
    only those q heads (a column block of ``wq``)."""
    b, s, _ = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    wq, bq = params["wq"], params.get("bq")
    if q_heads is not None:
        cols = slice(q_heads[0] * dh, (q_heads[0] + q_heads[1]) * dh)
        hq, wq = q_heads[1], wq[:, cols]
        bq = None if bq is None else bq[cols]
    q = x @ wq
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.use_bias or cfg.qkv_bias:
        q, k, v = q + bq, k + params["bk"], v + params["bv"]
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
    q = shd.constrain(q, ("batch", "heads", "seq", "head_dim"))
    k = shd.constrain(k, ("batch", "kv_heads", "seq", "head_dim"))
    v = shd.constrain(v, ("batch", "kv_heads", "seq", "head_dim"))
    return q, k, v


def _flash_core(q, k, v, cfg: ModelConfig, window, scale):
    """Flash attention on *local* tensors (no sharded dims inside)."""
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


def _model_size(mesh) -> int:
    return shd.axis_sizes(mesh).get("model", 1)


def _head_split(cfg: ModelConfig, mesh) -> "tuple | None":
    """(first q head, count) of this rank when the q heads split over
    ``model``, else None."""
    msize = _model_size(mesh)
    if msize == 1 or cfg.n_heads % msize != 0:
        return None
    hq_loc = cfg.n_heads // msize
    return shd.axis_index("model", mesh) * hq_loc, hq_loc


def _local_kv(k, v, cfg: ModelConfig, first: int, count: int):
    """The GQA KV heads of q heads first .. first + count - 1."""
    group = cfg.n_heads // cfg.n_kv_heads
    kv_idx = torch.div(first + torch.arange(count, device=k.device), group,
                       rounding_mode="floor")
    return k.index_select(1, kv_idx), v.index_select(1, kv_idx)


def _sharded_flash(q, k, v, cfg: ModelConfig, window, scale):
    """Tensor-parallel flash attention via explicit shard_map.

    q heads are sharded over "model", K/V are replicated per shard (the
    GQA KV block is small), each shard expands its local q heads' KV via
    the global head map and runs the flash core on fully local tensors.
    Called with global q, k, v it enters ``shard_map``; inside a body, q
    holds this rank's heads (or all of them, which it then cuts) and K/V
    every KV head."""
    ctx = shd.current_context()
    if ctx is None:
        return _flash_core(q, k, v, cfg, window, scale)
    mesh, rules = ctx
    split = _head_split(cfg, mesh)
    if split is None:
        if not shd.in_region():
            q, k, v = (shd.full_tensor(t) for t in (q, k, v))
        return _flash_core(q, k, v, cfg, window, scale)
    if not shd.in_region():
        dp = shd.spec_for(("batch",), rules, mesh, (q.shape[0],))[0]
        qspec, kvspec = P(dp, "model", None, None), P(dp, None, None, None)
        return shd.shard_map(
            lambda ql, kl, vl: _sharded_flash(ql, kl, vl, cfg, window, scale),
            mesh, (qspec, kvspec, kvspec), qspec)(q, k, v)
    first, count = split
    if q.shape[1] == cfg.n_heads:
        q = q.narrow(1, first, count)
    k_sel, v_sel = _local_kv(k, v, cfg, first, count)
    return _flash_core(q, k_sel, v_sel, cfg, window, scale)


def _row_parallel_out(params, o_loc, cfg: ModelConfig, first: int,
                      seq_sharded: bool):
    """This rank's heads (B, h, S, Dh) through their rows of ``wo``, the
    partial sums reduce-scattered onto the sequence (all-reduced where the
    residual keeps it whole), then ``bo``."""
    b, h, s, dh = o_loc.shape
    rows = slice(first * dh, (first + h) * dh)
    part = o_loc.transpose(1, 2).reshape(b, s, h * dh) @ params["wo"][rows]
    y = (shd.psum_scatter(part, "model", 1) if seq_sharded
         else shd.psum(part, "model"))
    if cfg.use_bias:
        y = y + params["bo"]
    return y


def _megatron_attention(params, x, cfg: ModelConfig, window, scale,
                        positions, mrope_positions, mesh):
    """Sequence-parallel attention block on one rank's blocks (the body of
    the reference's ``shard_map``).

    Megatron-SP schedule: all-gather the seq-sharded residual, run
    column-parallel QKV (local q heads, replicated GQA KV), the local flash
    core, then row-parallel output projection finished with a
    reduce-scatter back onto the seq dim."""
    first, count = _head_split(cfg, mesh)
    x_full = shd.all_gather(x, "model", 1)
    q, k, v = _project_qkv(params, x_full, cfg, positions, mrope_positions,
                           q_heads=(first, count))
    k_sel, v_sel = _local_kv(k, v, cfg, first, count)
    o = _flash_core(q, k_sel, v_sel, cfg, window, scale)
    return _row_parallel_out(params, o, cfg, first, True)


def _residual_spec(x_shape, mesh, rules) -> P:
    spec = shd.spec_for(("batch", "seq", "embed"), rules, mesh,
                        tuple(x_shape))
    if spec[2] is not None:
        raise ValueError(
            f"a residual of shape {tuple(x_shape)} would shard its embed "
            f"dim ({spec}); the port's mesh path needs the batch to divide "
            "over the data axes")
    return spec


def _global_entry(fn, mesh, rules, params, x, positions, mrope_positions,
                  out_specs):
    """``fn(params, x, positions, mrope_positions)`` on each rank's blocks
    of a global residual ``x`` (B, S, D): the parameters replicated, the
    positions split over the batch axes only."""
    spec = _residual_spec(x.shape, mesh, rules)
    dp = spec[0]

    def body(pp, xl, pos, mpos):
        with shd.region_dims(x.shape[0], positions.shape[1]):
            return fn(pp, xl, pos, mpos)

    return shd.shard_map(
        body, mesh, (P(), spec, P(dp, None), P(None, dp, None)),
        spec if out_specs is None else out_specs,
    )(params, x, positions, mrope_positions)


def _local_attention(params, x, cfg: ModelConfig, window, scale, positions,
                     mrope_positions, mesh):
    """The GSPMD route of ``attention_apply``/``attention_prefill`` on one
    rank's residual block: the sequence gathered to project, q, k, v
    through ``_sharded_flash`` (this rank's q heads where they split over
    ``model``), ``wo`` row-parallel onto the residual's layout. Returns
    (y, k, v) with k, v whole."""
    s = positions.shape[1]
    seq_sharded = x.shape[1] != s
    x_full = shd.all_gather(x, "model", 1) if seq_sharded else x
    split = _head_split(cfg, mesh)
    q, k, v = _project_qkv(params, x_full, cfg, positions, mrope_positions,
                           q_heads=split)
    o = _sharded_flash(q, k, v, cfg, window, scale)
    if split is not None:
        y = _row_parallel_out(params, o, cfg, split[0], seq_sharded)
    else:
        y = _out_proj(params, o, cfg)
        if seq_sharded:
            y = shd.local_constrain(y, ("batch", "seq", "embed"),
                                    (shd.global_batch(), s, y.shape[2]))
    return y, k, v


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
    ctx = shd.current_context()
    if ctx is None:
        q, k, v = _project_qkv(params, x, cfg, positions, mrope_positions)
        return _out_proj(params, _flash_core(q, k, v, cfg, window, scale),
                         cfg)
    mesh, rules = ctx
    if not shd.in_region():
        return _global_entry(
            lambda pp, xl, pos, mpos: attention_apply(pp, xl, cfg, kind, pos,
                                                      mpos),
            mesh, rules, params, x, positions, mrope_positions, None)
    msize = _model_size(mesh)
    s = positions.shape[1]
    if (msize > 1 and cfg.n_heads % msize == 0 and s % msize == 0
            and not cfg.use_pallas):
        y = _megatron_attention(params, x, cfg, window, scale, positions,
                                mrope_positions, mesh)
        return shd.constrain(y, ("batch", "seq", "embed"))
    y, _, _ = _local_attention(params, x, cfg, window, scale, positions,
                               mrope_positions, mesh)
    return shd.constrain(y, ("batch", "seq", "embed"))


def attention_prefill(
    params, x, cfg: ModelConfig, kind, positions,
    cache_len: "int | None" = None, mrope_positions=None,
):
    """Prefill: as ``attention_apply``, and also the (k, v) cache, zero
    padded along the sequence to ``cache_len``. On a mesh the cache keeps
    this rank's block under the reference's constraint on k and v
    (kv heads, else the sequence, over ``model``)."""
    window, scale = _window_scale(cfg, kind)
    s = positions.shape[1]
    ctx = shd.current_context()
    if ctx is None:
        q, k, v = _project_qkv(params, x, cfg, positions, mrope_positions)
        y = _out_proj(params, _flash_core(q, k, v, cfg, window, scale), cfg)
    else:
        mesh, rules = ctx
        if not shd.in_region():
            raise ValueError("attention_prefill takes local blocks on a "
                             "mesh; call transformer.prefill")
        y, k, v = _local_attention(params, x, cfg, window, scale, positions,
                                   mrope_positions, mesh)
        y = shd.constrain(y, ("batch", "seq", "embed"))
    if cache_len is not None and cache_len > s:
        k = F.pad(k, (0, 0, 0, cache_len - s))
        v = F.pad(v, (0, 0, 0, cache_len - s))
    if ctx is not None:
        full = (shd.global_batch(), cfg.n_kv_heads, k.shape[2], cfg.d_head)
        k = shd.local_constrain(k, ("batch", "kv_heads", "seq", "head_dim"),
                                full)
        v = shd.local_constrain(v, ("batch", "kv_heads", "seq", "head_dim"),
                                full)
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
    cache_len: "int | None" = None,
) -> "tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]":
    """One-token decode. The new k/v row is written into ``cache`` in
    place (the reference returns an updated copy); the same tensors are
    returned. ``pos`` is a () int32 tensor on ``x``'s device, as the
    reference's traced position is (a host integer is made into one): the
    cache row, the rotary positions, the kernel's lengths and the local
    window all come from it on the device, so a captured decode step
    takes each new position from a buffer.

    In a mesh body (``transformer.decode_step`` on a mesh, ``cache_len``
    the global cache length) the cache is this rank's block: where it
    holds some of the KV heads (kv_heads over ``model``) the rank attends
    its heads' q heads and the heads' outputs are all-gathered before
    ``wo``; where it holds a block of the positions (kv_seq over
    ``model``) ``_seq_block_decode`` runs."""
    window, scale = _window_scale(cfg, kind)
    b = x.shape[0]
    pos = as_position(pos, x.device).reshape(1)
    positions = pos.expand(b, 1)
    q, k_new, v_new = _project_qkv(params, x, cfg, positions,
                                   mrope_positions)
    k_cache, v_cache = cache
    hkv = k_cache.shape[1]
    group = cfg.n_heads // cfg.n_kv_heads
    heads_split = hkv != cfg.n_kv_heads
    if heads_split:
        first = shd.axis_index("model") * hkv
        q = q.narrow(1, first * group, hkv * group)
        k_new, v_new = k_new.narrow(1, first, hkv), v_new.narrow(1, first, hkv)
    hq = q.shape[1]
    if cache_len is not None and k_cache.shape[2] != cache_len:
        o = _seq_block_decode(q, k_new, v_new, k_cache, v_cache, pos, cfg,
                              window, scale).to(x.dtype)
        return _decode_out(params, o, cfg, heads_split), (k_cache, v_cache)
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
    return _decode_out(params, o, cfg, heads_split), (k_cache, v_cache)


def _decode_out(params, o, cfg: ModelConfig, heads_split: bool):
    """``wo`` of a decode step's (B, H, 1, Dh) output, all heads gathered
    first where this rank attended only its own."""
    if heads_split:
        o = shd.all_gather(o, "model", 1)
    return shd.constrain(_out_proj(params, o, cfg), ("batch", "seq", "embed"))


def _seq_block_decode(q, k_new, v_new, k_cache, v_cache, pos,
                      cfg: ModelConfig, window, scale) -> torch.Tensor:
    """One-token attention on a rank whose cache holds one block of the
    positions (kv_seq over ``model``, in rank order): the new k/v row is
    written where this rank holds ``pos``, each rank takes the softmax
    statistics of its block (running max, sum, unnormalised output, in
    float32), and the blocks are combined over ``model`` (flash
    decoding). Returns (B, H, 1, Dh) float32. The probabilities stay in
    float32 where the whole-cache path rounds them to the cache type
    before the second product, so the two agree to that rounding."""
    if cfg.use_pallas:
        raise ValueError("the decode_attention kernel takes a whole cache; "
                         "a cache split over the sequence decodes with "
                         "use_pallas=False")
    b, hq = q.shape[:2]
    hkv, s_loc = k_cache.shape[1], k_cache.shape[2]
    first = shd.axis_index("model") * s_loc
    local = pos - first
    row = torch.clamp(local, 0, s_loc - 1).long()
    mine = (local >= 0) & (local < s_loc)
    for c, new in ((k_cache, k_new), (v_cache, v_new)):
        c.index_copy_(2, row, torch.where(mine, new, c.index_select(2, row)))
    length = pos + 1
    cols = first + torch.arange(s_loc, device=q.device)
    qg = (q.float() * scale).to(q.dtype).reshape(b, hkv, hq // hkv,
                                                  cfg.d_head)
    logits = torch.matmul(qg.float(), k_cache.float().transpose(-1, -2))
    if cfg.attn_softcap is not None:
        logits = layers.softcap(logits, cfg.attn_softcap)
    mask = cols < length
    if window is not None:
        mask &= cols > length - 1 - window
    logits = torch.where(mask, logits, NEG)
    m = logits.amax(-1, keepdim=True)
    e = torch.where(mask, torch.exp(logits - m), 0.0)
    stats = [shd.all_gather(t[None], "model", 0) for t in (
        m, e.sum(-1, keepdim=True), torch.matmul(e, v_cache.float()))]
    ms, ls, os_ = stats
    w = torch.exp(ms - ms.amax(0))
    o = (w * os_).sum(0) / (w * ls).sum(0)
    return o.reshape(b, hq, 1, cfg.d_head)
