"""NVMeVirt simple timing model + SwarmIO aggregated batch updates
(port of ``repro/core/timing.py``).

For request i in dispatch order on instance k:

    start_i      = max(arrival_i, busy[k])
    busy[k]      = start_i + Sched
    completion_i = max(start_i + Sched, arrival_i + L_min)

``per_request_update`` (the NVMeVirt baseline) runs the recurrence one
request after another in dispatch order. Instances never read each
other's cursor, so it is ``die_contention``'s fold with ``cost = Sched``
(one instance's chain in row order, all instances at once), plus the
completion's max with ``arrival + L_min``.
``aggregated_update`` computes this for a whole fetched batch with one
segmented (max,+) prefix scan and a single write of the shared state,
through the closed form

    b_j = max(arrival_j - j*Sched, b_{j-1}),  b_{-1} = busy[k]
    start_j = b_j + j*Sched,   busy'[k] = b_last + m_k*Sched

where j is the within-instance rank inside the batch. Eager PyTorch
rounds every multiply and add on its own, on the CPU and on the card
alike; the three products the compiled reference fuses with their add
(see ``_sorted_batch_core``) go through ``xla_math._fma32`` instead.
Every update takes one drive's state and batch or an array's, with a
leading ``(M,)`` axis on every tensor.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.segops import (
    NEG,
    compact_epoch,
    jax_max,
    segment_max,
    segment_sum,
    segmented_prefix_max,
    sort_by_segment,
    take,
    unsort,
)
from repro_torch.core.types import (
    F32, I32, RequestBatch, SSDConfig, TimingState,
)
from repro_torch.core.xla_math import _fma32


def f32(x: float) -> float:
    """A Python float rounded to float32 (the reference's jnp.float32)."""
    return float(np.float32(x))


def lba_hash_instance(lba: torch.Tensor, n_instances: int) -> torch.Tensor:
    """Map a request to an instance by address (channel striping)."""
    h = ((lba.to(torch.int64) & 0xFFFFFFFF) * 2654435761) & 0xFFFFFFFF
    return ((h >> 16) % n_instances).to(I32)


def assign_rr(
    rr: torch.Tensor, valid: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Round-robin instance assignment in dispatch order. Invalid rows get
    an arbitrary instance and do not advance the cursor. Returns
    (inst, rr')."""
    pos = torch.cumsum(valid.to(I32), -1, dtype=I32) - 1
    inst = torch.remainder(rr[..., None] + torch.clamp(pos, min=0), k)
    n_valid = torch.sum(valid.to(I32), dim=-1, dtype=I32)
    return inst.to(I32), torch.remainder(rr + n_valid, k).to(I32)


def assign_instances(
    state: TimingState, batch: RequestBatch, ssd: SSDConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Instance per request (dispatch order) + advanced round-robin cursor."""
    k = ssd.n_instances
    if ssd.routing == "lba_hash":
        return lba_hash_instance(batch.lba, k), state.rr
    return assign_rr(state.rr, batch.valid, k)


def per_request_fold(
    arrival: torch.Tensor,  # (N,) f32 dispatch-order arrivals
    inst: torch.Tensor,     # (N,) i32 instance per row, in [0, K)
    valid: torch.Tensor,    # (N,) bool
    busy: torch.Tensor,     # (K,) f32 instance busy-until cursors
    sched: float,
    lmin: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's scan step row by row: ``start = max(arrival,
    busy[k])``; a valid row sets ``busy[k] = start + sched`` and completes
    at ``max(start + sched, arrival + lmin)``, an invalid row completes at
    0 and leaves ``busy`` as it is. Returns (completion, busy')."""
    from repro_torch.kernels import ops as kops

    end, busy = kops.die_contention(
        arrival, torch.full_like(arrival, sched), inst, valid, busy
    )
    return torch.where(valid, jax_max(end, arrival + lmin), 0.0), busy


def per_request_update(
    state: TimingState, batch: RequestBatch, ssd: SSDConfig
) -> Tuple[TimingState, torch.Tensor]:
    """Sequential per-request timing updates (the reference's
    ``lax.scan``). Returns (state', completion)."""
    inst, rr = assign_instances(state, batch, ssd)
    completion, busy = per_request_fold(
        batch.arrival, inst, batch.valid, state.busy_until,
        f32(ssd.sched_us), f32(ssd.l_min_us),
    )
    return TimingState(busy, rr), completion


def _sorted_batch_core(
    busy_init: torch.Tensor,  # (K,) f32
    s_arr: torch.Tensor,      # (N,) f32 arrivals in instance-major layout
    s_inst: torch.Tensor,     # (N,) i32 instance key, K for invalid rows
    s_valid: torch.Tensor,    # (N,) bool
    head: torch.Tensor,       # (N,) bool segment starts
    rank: torch.Tensor,       # (N,) i32 within-segment rank
    order: torch.Tensor,      # (N,) i32 sorted index -> dispatch index
    ssd: SSDConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (max,+) closed form on an instance-major layout, shared by the
    stable-sort and the compacted layouts (one expression tree).

    The compiled reference contracts each of the three products with
    the add that consumes it into one fused multiply-add:
    ``s_arr - rank*sched``, ``b + rank*sched`` and
    ``last_b + seg_counts*sched``. That holds on every path that reaches
    the core (the stable sort, the compaction, both vmapped over an
    array's drives, and the engine round and the client's submit that
    call them); inputs that make a fused and an unfused rounding differ,
    run through ``jax.jit``, pin each one. The three are computed here
    with ``_fma32``, rounded once on the CPU and the card alike; every
    other operation rounds on its own, as in the reference."""
    k = ssd.n_instances
    sched = f32(ssd.sched_us)
    lmin = f32(ssd.l_min_us)

    safe_inst = torch.clamp(s_inst, 0, k - 1)
    seed = take(busy_init, safe_inst)
    rank_f = rank.to(F32)
    sched_t = torch.full_like(s_arr, sched)
    a = _fma32(-rank_f, sched_t, s_arr)
    a = torch.where(head, torch.maximum(a, seed), a)
    a = torch.where(s_valid, a, NEG)
    b = segmented_prefix_max(a, head)

    start = _fma32(rank_f, sched_t, b)
    comp_sorted = torch.maximum(start + sched, s_arr + lmin)
    comp_sorted = torch.where(s_valid, comp_sorted, 0.0)

    seg_counts = segment_sum(s_valid.to(F32), safe_inst, k)
    last_b = segment_max(torch.where(s_valid, b, NEG), safe_inst, k)
    new_busy = torch.where(
        seg_counts > 0,
        _fma32(seg_counts, torch.full_like(seg_counts, sched), last_b),
        busy_init,
    )
    return unsort(comp_sorted, order), new_busy


def aggregated_batch_times(
    busy_init: torch.Tensor,
    arrival: torch.Tensor,
    inst: torch.Tensor,
    valid: torch.Tensor,
    ssd: SSDConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Vectorized exact batch timing. Returns (completion, new_busy)."""
    k = ssd.n_instances
    key = torch.where(valid, inst, k).to(I32)  # invalid rows sort last
    order, head, rank = sort_by_segment(key)
    o = order.long()
    return _sorted_batch_core(
        busy_init, take(arrival, o), take(key, o), take(valid, o), head,
        rank, order, ssd,
    )


def compact_rr_batch_times(
    busy_init: torch.Tensor,  # (K,) f32 shared busy-until state
    arrival: torch.Tensor,    # (N,) f32 dispatch-order arrivals
    rr: torch.Tensor,         # ()  i32 round-robin cursor
    valid: torch.Tensor,      # (N,) bool
    ssd: SSDConfig,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sort-free aggregated timing on the compacted epoch: round-robin
    routing gives the instance-major layout in closed form, and the float
    arithmetic runs through the same ``_sorted_batch_core``. Returns
    ``(completion, new_busy, rr')``."""
    k = ssd.n_instances
    n = arrival.shape[-1]
    dev = arrival.device
    plan = compact_epoch(valid)
    pos, n_valid = plan.pos, plan.n_valid
    idx = torch.arange(n, dtype=I32, device=dev).expand(valid.shape)
    rr_, n_valid_ = rr[..., None], n_valid[..., None]

    q_of_c = torch.remainder(
        torch.arange(k, dtype=I32, device=dev) - rr_, k)
    m_c = torch.clamp(
        -torch.div(-(n_valid_ - q_of_c), k, rounding_mode="floor"), min=0
    )
    offsets = torch.cumsum(m_c, -1, dtype=I32) - m_c

    inst_row = torch.remainder(rr_ + pos, k)
    pk = torch.div(pos, k, rounding_mode="floor")
    spos = torch.where(valid, take(offsets, inst_row) + pk, pos)
    rank_row = torch.where(valid, pk, pos - n_valid_)
    key_row = torch.where(valid, inst_row, k)
    page = torch.stack([idx, rank_row, key_row], dim=-1).to(I32)
    s = unsort(page, spos)
    order, rank, s_inst = s[..., 0], s[..., 1], s[..., 2]
    head = rank == 0

    o = order.long()
    completion, new_busy = _sorted_batch_core(
        busy_init, take(arrival, o), s_inst, take(valid, o), head, rank,
        order, ssd,
    )
    return completion, new_busy, torch.remainder(rr + n_valid, k).to(I32)


def aggregated_update(
    state: TimingState,
    batch: RequestBatch,
    ssd: SSDConfig,
    use_compaction: bool = False,
) -> Tuple[TimingState, torch.Tensor]:
    """SwarmIO aggregated timing update (single shared-state write)."""
    if use_compaction and ssd.routing == "round_robin":
        completion, new_busy, rr = compact_rr_batch_times(
            state.busy_until, batch.arrival, state.rr, batch.valid, ssd
        )
        return TimingState(new_busy, rr), completion
    inst, rr = assign_instances(state, batch, ssd)
    completion, new_busy = aggregated_batch_times(
        state.busy_until, batch.arrival, inst, batch.valid, ssd
    )
    return TimingState(new_busy, rr), completion


def local_scope_update(
    state: TimingState,
    arrival: torch.Tensor,  # (N,) f32, N % num_units == 0, unit-major
    valid: torch.Tensor,    # (N,) bool
    ssd: SSDConfig,
    num_units: int,
    use_compaction: bool = False,
) -> Tuple[TimingState, torch.Tensor]:
    """The paper's rejected design (§IV-D ablation): per-unit timing state.

    Each service unit owns a 1/U slice of the drive's instances and
    capacity (``t_max_iops / U``, ``n_instances // U``), so skewed load
    caps at 1/U of the target. Rows must be unit-major with equal counts
    per unit. The reference vmaps the per-unit update over the U units;
    here the unit axis is one more leading axis of the batched forms, (N,)
    as (U, N/U) and the (K,) cursors as (U, K/U), each unit then priced as
    a drive of its own. Every unit starts from the shared cursor, and the
    new cursor is unit 0's, as in the reference. Returns (state',
    completion)."""
    u = num_units
    k_u = max(ssd.n_instances // u, 1)
    local_ssd = ssd.replace(t_max_iops=ssd.t_max_iops / u, n_instances=k_u)
    lead = tuple(arrival.shape[:-1])

    def units(x):
        return x.reshape(lead + (u, -1))

    bu = units(state.busy_until)
    rr = state.rr[..., None].expand(lead + (u,))
    val, arr = units(valid), units(arrival)
    if use_compaction and ssd.routing == "round_robin":
        comp, nb, rr_new = compact_rr_batch_times(bu, arr, rr, val, local_ssd)
    else:
        inst, rr_new = assign_rr(rr, val, k_u)
        comp, nb = aggregated_batch_times(bu, arr, inst, val, local_ssd)
    return (TimingState(nb.reshape(lead + (-1,)), rr_new[..., 0]),
            comp.reshape(lead + (-1,)))


def distributed_aggregated_update(
    state: TimingState,
    batch: RequestBatch,
    ssd: SSDConfig,
    axis_name: str,
) -> Tuple[TimingState, torch.Tensor]:
    """Global timing model across service units inside ``shard_map``.

    Each rank contributes its local batch; the descriptors (arrival, lba,
    valid) are all-gathered once per batch in one collective (the paper's
    single critical section: the three rows packed as int32 words, the
    arrival as its bit pattern), every rank runs the identical replicated
    segmented scan over the concatenated global batch (dispatch order =
    rank-major, preserving per-SQ order), and keeps its own slice of the
    completions. ``state`` is replicated and evolves identically on every
    rank."""
    from repro_torch.distributed import sharding as shd

    ax = shd.axis_index(axis_name)
    n_local = batch.arrival.shape[0]
    words = torch.stack([batch.arrival.view(I32), batch.lba.to(I32),
                         batch.valid.to(I32)])
    g = shd.all_gather(words, axis_name, dim=1)
    g_arr = g[0].contiguous().view(F32)
    g_lba = g[1].contiguous()
    g_valid = g[2] != 0
    g_batch = RequestBatch(
        arrival=g_arr,
        sq_id=torch.zeros_like(g_lba), slot=torch.zeros_like(g_lba),
        opcode=torch.zeros_like(g_lba), lba=g_lba,
        nblocks=torch.ones_like(g_lba), buf_id=torch.zeros_like(g_lba),
        req_id=torch.zeros_like(g_lba), valid=g_valid,
    )
    inst, rr = assign_instances(state, g_batch, ssd)
    completion, new_busy = aggregated_batch_times(
        state.busy_until, g_arr, inst, g_valid, ssd
    )
    local = completion.narrow(0, ax * n_local, n_local)
    return TimingState(new_busy, rr), local


def update(
    state: TimingState,
    batch: RequestBatch,
    ssd: SSDConfig,
    mode: str = "aggregated",
    use_compaction: bool = False,
    dispatch_order: "torch.Tensor | None" = None,
    axis_name: "str | None" = None,
) -> Tuple[TimingState, torch.Tensor]:
    """Dispatch to the configured update mechanism.

    ``dispatch_order`` is an optional (N,) row permutation giving the
    order requests enter the shared timing state: the batch is gathered
    through it, priced, and completions scatter back (data movement only).
    ``axis_name`` (inside ``shard_map``) prices the ranks' batches as one
    global batch (``distributed_aggregated_update``).
    """
    if dispatch_order is not None:
        d = dispatch_order.long()
        permuted = dataclasses.replace(
            batch,
            arrival=take(batch.arrival, d),
            lba=take(batch.lba, d),
            valid=take(batch.valid, d),
        )
        state, comp_p = update(state, permuted, ssd, mode, use_compaction,
                               axis_name=axis_name)
        return state, unsort(comp_p, dispatch_order)
    if axis_name is not None and mode == "aggregated":
        return distributed_aggregated_update(state, batch, ssd, axis_name)
    if mode == "per_request":
        return per_request_update(state, batch, ssd)
    if mode == "aggregated":
        return aggregated_update(state, batch, ssd, use_compaction)
    raise ValueError(f"unknown timing mode: {mode}")
