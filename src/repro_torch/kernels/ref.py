"""Plain PyTorch versions of the port's kernels (port of
``repro/kernels/ref.py``, plus the sequential contracts of
``die_contention`` and ``fused_reap``).

Each function computes what its CUDA kernel computes, on any device:
exactly for the engine's four kernels, and with the kernels' float32
arithmetic (scale applied to q in float32, float32 scores, softmax and
p @ v, output in q's type) for the two attention kernels, whose sums run
in another order on the card. ``kernels/ops.py`` sends a CPU tensor here;
the CUDA kernels are held against these functions on the card.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import segops
from repro_torch.core.types import F32, I32

NEG = -3e38

jax_max = segops.jax_max


def block_gather_ref(flash: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather rows: ``out[i] = flash[idx[i]]`` with JAX's index rule — a
    negative index counts from the end, then indices clamp into range."""
    nb = flash.shape[0]
    safe = torch.where(idx < 0, idx + nb, idx).clamp(0, nb - 1).long()
    return flash[safe]


def block_gather_tiled_ref(flash: torch.Tensor, idx: torch.Tensor, *,
                           tile: int = 8) -> torch.Tensor:
    """The gather with ``tile`` descriptors per step: the same rows as
    ``block_gather_ref`` (the reference's interpret mode applies the same
    index rule), for ``n % tile == 0`` only, as the reference asserts."""
    if tile < 1 or idx.shape[0] % tile:
        raise ValueError(f"descriptor count {idx.shape[0]} is not a "
                         f"multiple of tile={tile}")
    return block_gather_ref(flash, idx)


def seg_scan_ref(values: torch.Tensor, heads: torch.Tensor) -> torch.Tensor:
    """Segmented inclusive prefix max restarting where ``heads[i]``; the
    rows before the first head continue a segment seeded with ``NEG`` (the
    sequential fold ``run = where(h, v, max(run, v))`` from ``run = NEG``)
    with ``jnp.maximum``'s max; a NaN comes out as 0x7FFFFFFF (the card's
    canonical NaN, which the CUDA kernel's ``max.NaN.f32`` returns)."""
    out = segops.segmented_prefix_jax_max(values, heads)
    no_head_yet = torch.cumsum(heads.to(I32), 0, dtype=I32) == 0
    return torch.where(no_head_yet, jax_max(out, _neg(values)), out)


def _neg(like: torch.Tensor) -> torch.Tensor:
    return torch.full((), NEG, dtype=F32, device=like.device)


def die_contention_ref(
    ready: torch.Tensor,      # (N,) f32
    cost: torch.Tensor,       # (N,) f32
    chip: torch.Tensor,       # (N,) i32 in [0, K)
    event: torch.Tensor,      # (N,) bool
    chip_busy: torch.Tensor,  # (K,) f32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sequential per-die fold, dies in parallel: step r advances
    every die by its r-th event row (row order within a die), each step
    the same ``max(cur, ready) + cost`` the sequential loop performs, with
    ``jnp.maximum``'s max (``jax_max``)."""
    n = ready.shape[0]
    k = chip_busy.shape[0]
    dev = ready.device
    if n == 0:
        return torch.zeros((0,), dtype=F32, device=dev), chip_busy.clone()
    key = torch.where(event, chip, k)
    _, rank, counts, _ = segops.counting_positions(key, k + 1)
    steps = int(counts[:k].max().item()) if k else 0
    # table[c, r] = row of die c's r-th event (n where there is none)
    table = torch.full((k + 1, max(steps, 1)), n, dtype=torch.int64,
                       device=dev)
    rows = torch.arange(n, dtype=torch.int64, device=dev)
    # Non-event rows all land on the discarded row k, column 0.
    table[key.long(), torch.where(event, rank, 0).long()] = rows
    table = table[:k]
    cur = chip_busy.clone()
    busy = torch.zeros((n + 1,), dtype=F32, device=dev)
    ready_p = torch.cat([ready, torch.zeros((1,), dtype=F32, device=dev)])
    cost_p = torch.cat([cost, torch.zeros((1,), dtype=F32, device=dev)])
    for r in range(steps):
        rows_r = table[:, r]
        has = rows_r < n
        b = jax_max(cur, ready_p[rows_r]) + cost_p[rows_r]
        cur = torch.where(has, b, cur)
        busy[rows_r] = torch.where(has, b, 0.0)
    return busy[:n], cur


def fused_reap_ref(
    done_time: torch.Tensor,     # (Q, D) f32
    visible_time: torch.Tensor,  # (Q, D) f32
    req_id_ring: torch.Tensor,   # (Q, D) i32
    tail: torch.Tensor,          # (Q,) i32
    key: torch.Tensor,           # (N,) i32, == Q for invalid rows
    done: torch.Tensor,          # (N,) f32
    req_id: torch.Tensor,        # (N,) i32
    valid: torch.Tensor,         # (N,) bool
):
    """The one-pass neutral CQ post: every valid row of CQ
    ``c = clip(key, 0, Q-1)`` writes ``(done, done, req_id)`` at
    ``(tail[c] + rank) % D`` (int32 wrapping add, floor modulo) where
    ``rank`` counts the earlier valid rows of its CQ; where several rows
    land on one slot the last one wins. Returns the new rings and the
    (Q,) per-CQ counts."""
    q, d = done_time.shape
    n = key.shape[0]
    if n == 0:
        return (done_time.clone(), visible_time.clone(), req_id_ring.clone(),
                torch.zeros((q,), dtype=I32, device=key.device))
    safe = key.clamp(0, q - 1)
    k2 = torch.where(valid, safe, q)
    _, rank, counts, _ = segops.counting_positions(k2, q + 1)
    counts = counts[:q]
    pos = torch.remainder(tail[safe.long()] + rank, d)
    # A slot's writer is the valid row with the largest index among the
    # rows of its CQ that land on it (ranks grow with the row index). Not
    # "the last D ranks": where tail + rank wraps past 2^31 and D does not
    # divide 2^32, the slots of consecutive ranks jump, and some slot's
    # last writer is an earlier rank.
    flat = torch.where(valid, safe.long() * d + pos.long(), q * d)
    rows = torch.arange(n, dtype=torch.int64, device=key.device)
    win = torch.full((q * d + 1,), -1, dtype=torch.int64, device=key.device)
    win = win.scatter_reduce(0, flat, rows, "amax")[: q * d]
    src = torch.where(win >= 0, win, n)

    def post(ring, vals):
        vals = torch.cat([vals, vals.new_zeros((1,))])
        return torch.where(win >= 0, vals[src], ring.reshape(-1)).reshape(q, d)

    return (
        post(done_time, done), post(visible_time, done),
        post(req_id_ring, req_id), counts,
    )


def _softmax_pv(logits: torch.Tensor, mask: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
    """``softmax(where(mask, logits, NEG)) @ v`` in float32, where a row
    with nothing unmasked gives zeros (the kernels' ``l == 0`` rule).
    Works in place on ``logits``, but where autograd records (an input
    requires grad: the training tests differentiate through this version)
    out of place, the same values."""
    if torch.is_grad_enabled() and logits.requires_grad:
        logits = logits.masked_fill(~mask, NEG)
        m = torch.amax(logits, dim=-1, keepdim=True)
        p = torch.exp(logits - m).masked_fill(~mask, 0.0)
        l = torch.sum(p, dim=-1, keepdim=True)
        return torch.matmul(p, v) / torch.where(l > 0, l, 1.0)
    logits.masked_fill_(~mask, NEG)
    m = torch.amax(logits, dim=-1, keepdim=True)
    p = logits.sub_(m).exp_().masked_fill_(~mask, 0.0)
    l = torch.sum(p, dim=-1, keepdim=True)
    return torch.matmul(p, v) / torch.where(l > 0, l, 1.0)


def attention_ref(
    q: torch.Tensor,   # (B, Hq, S, D)
    k: torch.Tensor,   # (B, Hkv, S, D)
    v: torch.Tensor,   # (B, Hkv, S, D)
    *,
    causal: bool = True,
    window: "int | None" = None,
    logit_softcap: "float | None" = None,
    scale: "float | None" = None,
) -> torch.Tensor:
    """Multi-head attention with GQA (q head h reads KV head
    ``h // group``), causal mask, local window and logit softcap."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    qf = q.float().reshape(b, hkv, g, s, d) * scale
    logits = torch.matmul(qf, k.float()[:, :, None].transpose(-1, -2))
    if logit_softcap is not None:
        logits = logit_softcap * torch.tanh(logits / logit_softcap)
    rows = torch.arange(s, device=q.device)[:, None]
    cols = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= cols <= rows
    if window is not None:
        mask &= cols > rows - window
    out = _softmax_pv(logits, mask, v.float()[:, :, None])
    return out.reshape(b, hq, s, d).to(q.dtype)


def decode_attention_ref(
    q: torch.Tensor,        # (B, Hq, D): one new token per sequence
    k_cache: torch.Tensor,  # (B, Hkv, S, D)
    v_cache: torch.Tensor,  # (B, Hkv, S, D)
    lengths: torch.Tensor,  # (B,) i32 valid cache lengths
    *,
    window: "int | None" = None,
    logit_softcap: "float | None" = None,
    scale: "float | None" = None,
) -> torch.Tensor:
    """Single-token decode attention against a KV cache: position ``j``
    of sequence ``b`` is seen iff ``j < lengths[b]`` (and
    ``j > lengths[b] - 1 - window`` with a window)."""
    b, hq, d = q.shape
    hkv, s = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    qf = q.float().reshape(b, hkv, g, 1, d) * scale
    logits = torch.matmul(qf, k_cache.float()[:, :, None].transpose(-1, -2))
    if logit_softcap is not None:
        logits = logit_softcap * torch.tanh(logits / logit_softcap)
    pos = torch.arange(s, device=q.device)[None, :]
    length = lengths.to(torch.int64)[:, None]
    mask = pos < length
    if window is not None:
        mask &= pos > length - 1 - window
    out = _softmax_pv(logits, mask[:, None, None, None, :],
                      v_cache.float()[:, :, None])
    return out.reshape(b, hq, d).to(q.dtype)
