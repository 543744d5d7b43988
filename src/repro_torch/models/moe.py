"""Mixture-of-Experts: top-k routing, capacity and sort-based local dispatch
(port of ``repro/models/moe.py``).

Dispatch is Megablocks-style: rank the (token, expert) pairs within their
expert, scatter the kept ones into an (E, C, D) buffer, batched
per-expert products, weighted sum back onto the tokens. qwen2-moe's
always-on shared experts (sigmoid gate) and the Switch load-balancing aux
loss are included.

With no sharding context ``moe_apply`` runs ``_local_moe`` over all B·S
tokens. Under ``sharding.use_rules`` it runs on each rank's tokens
(``shard_map``, as the reference): ``_ep_moe`` when ``cfg.moe_ep`` and
the experts and the sequence divide over ``model`` (no shared experts) —
each model rank all-gathers the seq-sharded tokens, routes all of them
(replicated routing, float32 accumulation), dispatches only the pairs
its E/msize experts own, with the capacity of the gathered token count,
and adds its partial combine through one reduce-scatter back onto the
sequence; otherwise every rank runs all the experts on its own tokens.
Either way capacity comes from a rank's own token count, so a mesh's MoE
is a different function from one device's wherever a pair is dropped;
the aux loss's statistics are averaged over the ranks (``pmean``).

Every step is a device op with static shapes (no host read-back), so a
captured decode step may route, and the routing is deterministic: ties
in the router resolve to the lower expert index (``lax.top_k``'s rule)
and each token's k expert rows are added in index order.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.segops import segment_rank
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import P
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig


def moe_init(gen: torch.Generator, cfg: ModelConfig, dtype,
             stack: tuple = ()) -> dict:
    """The reference's leaves and scales; ``router`` and ``shared_gate``
    stay float32 in a bf16 model, as there."""
    d, e, de = cfg.d_model, cfg.n_experts, cfg.d_expert
    s_in, s_out = d ** -0.5, de ** -0.5
    p = {
        "router": layers.normal(gen, (*stack, d, e), s_in, torch.float32),
        "w_gate": layers.normal(gen, (*stack, e, d, de), s_in, dtype),
        "w_up": layers.normal(gen, (*stack, e, d, de), s_in, dtype),
        "w_down": layers.normal(gen, (*stack, e, de, d), s_out, dtype),
    }
    if cfg.n_shared_experts:
        p["shared"] = layers.mlp_init(gen, d, cfg.d_shared_expert,
                                      cfg.mlp_gated, False, dtype, stack)
        p["shared_gate"] = layers.normal(gen, (*stack, d, 1), s_in,
                                         torch.float32)
    return p


def moe_axes(cfg: ModelConfig) -> dict:
    """The logical axes of ``moe_init``'s leaves (the reference's)."""
    a = {
        "router": ("embed", "experts"),
        "w_gate": ("experts", "embed", "expert_mlp"),
        "w_up": ("experts", "embed", "expert_mlp"),
        "w_down": ("experts", "expert_mlp", "embed"),
    }
    if cfg.n_shared_experts:
        a["shared"] = layers.mlp_axes(cfg.mlp_gated, False)
        a["shared_gate"] = ("embed", None)
    return a


def capacity(cfg: ModelConfig, t_for_cap: int) -> int:
    """Rows per expert: ``t·k/E`` times the capacity factor, rounded up to
    a multiple of 4 and at least 4 (the reference's Python arithmetic)."""
    cap = int(t_for_cap * cfg.top_k / cfg.n_experts * cfg.capacity_factor
              + 0.999)
    return max(4, -(-cap // 4) * 4)


def top_k(probs: torch.Tensor, k: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` along the last axis: the k largest, ties in index
    order (a stable descending sort; ``torch.topk`` promises no order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _expert_mlp(params: dict, buf: torch.Tensor, cfg: ModelConfig
                ) -> torch.Tensor:
    """(E, C, D) rows through each expert's MLP: (E, C, D)."""
    if cfg.mlp_gated:
        g = torch.bmm(buf, params["w_gate"])
        u = torch.bmm(buf, params["w_up"])
        h = layers._act(cfg.mlp_act, g) * u
    else:
        h = layers._act(cfg.mlp_act, torch.bmm(buf, params["w_up"]))
    return torch.bmm(h, params["w_down"])


def route(params: dict, xt: torch.Tensor, cfg: ModelConfig,
          t_for_cap: int) -> dict:
    """The routing of (T, D) tokens: router ``probs`` (T, E) float32, the
    renormalized ``top_p`` and int64 ``top_e`` (T, k), and per (token,
    expert) pair in token-major order the int32 ``rank`` within its
    expert, ``keep`` (rank below the capacity ``cap``, rows an expert)
    and the buffer ``slot`` (int64; E·C for a dropped pair)."""
    t = xt.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    # The reference casts the router to the token dtype and accumulates in
    # float32 without rounding the product: float32 copies of both
    # operands give those products exactly.
    logits = xt.float() @ params["router"].to(xt.dtype).float()   # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = top_k(probs, k)
    top_p = top_p / torch.sum(top_p, dim=-1, keepdim=True)
    cap = capacity(cfg, t_for_cap)
    e_flat = top_e.reshape(t * k).to(torch.int32)
    rank = segment_rank(e_flat)
    keep = rank < cap
    slot = torch.where(keep, e_flat * cap + rank, e * cap).long()
    return dict(probs=probs, top_p=top_p, top_e=top_e, rank=rank,
                keep=keep, slot=slot, cap=cap)


def _local_moe(params: dict, xt: torch.Tensor, cfg: ModelConfig,
               t_for_cap: int):
    """Dispatch and expert compute of (T, D) tokens. Returns (out (T, D),
    f_e, p_e): the output and the aux loss's per-expert routed fraction
    and mean probability."""
    t, d = xt.shape
    e, k = cfg.n_experts, cfg.top_k
    r = route(params, xt, cfg, t_for_cap)
    keep, slot, cap = r["keep"], r["slot"], r["cap"]

    # Load-balance stats (Switch): fraction routed + mean prob per expert.
    experts = torch.arange(e, device=xt.device)
    f_e = torch.mean((r["top_e"][:, :1] == experts).float(), dim=0)
    p_e = torch.mean(r["probs"], dim=0)

    tok_flat = torch.arange(t, device=xt.device).repeat_interleave(k)

    # Dropped pairs go to slot E·C, one past the end (the reference's
    # mode="drop"): a spare row takes them and is cut off.
    buf = xt.new_zeros((e * cap + 1, d))
    buf[slot] = xt[tok_flat]
    y_e = _expert_mlp(params, buf[:-1].reshape(e, cap, d), cfg)
    y_e = y_e.reshape(e * cap, d)

    # Each token's k rows, added one at a time in index order in the token
    # dtype (no atomics, so the sum is the same on every run).
    out = _combine(y_e, slot, keep, r["top_p"], t, k, xt.dtype)

    if cfg.n_shared_experts:
        sh = layers.mlp_apply(params["shared"], xt, cfg.mlp_act,
                              cfg.mlp_gated)
        gate = torch.sigmoid(xt.float() @ params["shared_gate"]).to(xt.dtype)
        out = out + sh * gate
    return out, f_e, p_e


def _combine(y_e, slot, keep, top_p, t: int, k: int, dtype):
    """The kept pairs' expert rows, weighted, added onto their tokens in
    index order (``out.at[tok_flat].add(...)``): (T, D)."""
    n_rows, d = y_e.shape
    y_rows = y_e[torch.clamp(slot, max=n_rows - 1)]
    y_rows = torch.where(keep[:, None], y_rows, 0.0)
    w = torch.where(keep, top_p.reshape(t * k), 0.0).to(dtype)
    contrib = (y_rows * w[:, None]).reshape(t, k, d)
    out = y_e.new_zeros((t, d))
    for j in range(k):
        out = out + contrib[:, j]
    return out


def _ep_moe(params: dict, x: torch.Tensor, cfg: ModelConfig, mesh):
    """Expert-parallel MoE on one rank's (B_loc, S/msize, D) tokens, the
    body of the reference's ``shard_map``: experts sharded over "model".

    Each model rank all-gathers the seq-sharded tokens, routes them
    (replicated routing math), dispatches only the (token, expert) pairs
    owned locally, runs its E/msize experts, and contributes its partial
    combine through one reduce-scatter back onto the seq dim. Returns
    (out, aux)."""
    bl, _, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    dp_axes = tuple(a for a in shd.axis_sizes(mesh) if a != "model")
    msize = shd.axis_size("model", mesh)
    e_loc = e // msize
    my = shd.axis_index("model", mesh)

    x_full = shd.all_gather(x, "model", 1)
    s = x_full.shape[1]
    t = bl * s
    xt = x_full.reshape(t, d)
    r = route(params, xt, cfg, t)
    experts = torch.arange(e, device=xt.device)
    f_e = torch.mean((r["top_e"][:, :1] == experts).float(), dim=0)
    p_e = torch.mean(r["probs"], dim=0)
    f_e = shd.pmean(f_e, dp_axes)
    p_e = shd.pmean(p_e, dp_axes)
    aux = cfg.router_aux_coef * e * torch.sum(f_e * p_e)

    cap = r["cap"]
    e_flat = r["top_e"].reshape(t * k).to(torch.int32)
    tok_flat = torch.arange(t, device=xt.device).repeat_interleave(k)
    mine = torch.div(e_flat, e_loc, rounding_mode="floor") == my
    e_local = torch.where(mine, torch.remainder(e_flat, e_loc), e_loc)
    rank = segment_rank(e_local.to(torch.int32))
    keep = mine & (rank < cap)
    slot = torch.where(keep, e_local * cap + rank, e_loc * cap).long()

    buf = xt.new_zeros((e_loc * cap + 1, d))
    buf[slot] = xt[tok_flat]
    mine_w = {n: params[n].narrow(0, my * e_loc, e_loc)
              for n in ("w_gate", "w_up", "w_down")}
    y_e = _expert_mlp(mine_w, buf[:-1].reshape(e_loc, cap, d), cfg)
    part = _combine(y_e.reshape(e_loc * cap, d), slot, keep, r["top_p"], t,
                    k, xt.dtype)
    # Sum partial expert outputs across shards + scatter back to seq.
    return shd.psum_scatter(part.reshape(bl, s, d), "model", 1), aux


def moe_apply(params: dict, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output (B, S, D), aux load-balancing loss, a float32
    scalar)."""
    b, s, d = x.shape
    e = cfg.n_experts
    ctx = shd.current_context()
    if ctx is None:
        # Single-device path.
        out, f_e, p_e = _local_moe(params, x.reshape(b * s, d), cfg, b * s)
        aux = cfg.router_aux_coef * e * torch.sum(f_e * p_e)
        return out.reshape(b, s, d), aux

    mesh, rules = ctx
    if not shd.in_region():
        x_spec = shd.spec_for(("batch", "seq", None), rules, mesh, x.shape)

        def body(pp, xl):
            with shd.region_dims(b, s):
                return moe_apply(pp, xl, cfg)

        return shd.shard_map(body, mesh, (P(), x_spec), (x_spec, P()))(
            params, x)

    msize = shd.axis_size("model", mesh)
    s_glob = shd.global_seq()
    if (cfg.moe_ep and msize > 1 and e % msize == 0 and s_glob % msize == 0
            and not cfg.n_shared_experts):
        return _ep_moe(params, x, cfg, mesh)

    # Replicated experts: each rank dispatches its own tokens.
    out, f_e, p_e = _local_moe(params, x.reshape(b * s, d), cfg, b * s)
    # Global stats: mean across every mesh axis (tokens are sharded over
    # batch+seq axes; replicated elsewhere — pmean is exact for equal
    # local token counts).
    axes = tuple(shd.axis_sizes(mesh))
    f_e = shd.pmean(f_e, axes)
    p_e = shd.pmean(p_e, axes)
    aux = cfg.router_aux_coef * e * torch.sum(f_e * p_e)
    return out.reshape(b, s, d), aux
