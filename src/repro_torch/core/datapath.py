"""Backend data path: functional block copies + worker/DSA cost model
(port of ``repro/core/datapath.py``).

Functional emulation: the flash address space is a device-resident table
of blocks; a read gathers ``flash[lba] -> bufs[buf_id]``, a write scatters
the reverse. With ``use_pallas`` the read gather runs as the
``block_gather`` kernel (the DSA batch-copy analogue).

Both copies scatter with duplicate destinations (``buf_id`` repeats
within a round, random LBAs collide). The reference's scatter keeps the
last row for each destination; PyTorch leaves the winner of a duplicate
scatter undefined on the card, so the port picks the last valid row per
destination explicitly and scatters only the winners.

An array's drives each carry their own flash table, (M, num_blocks, W),
and buffers, (M, num_bufs, W); every function here takes one drive's
tensors or an array's, with a leading ``(M,)`` axis on each.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core.segops import (
    counting_sort_plan,
    queueing_scan,
    scatter_last,
    segment_max,
    segment_heads,
    segment_rank,
    stable_argsort,
    take,
    take_rows,
    true_div,
    unsort,
)
from repro_torch.core.types import (
    F32,
    I32,
    EngineConfig,
    PlatformModel,
    RequestBatch,
    SSDConfig,
)


def apply_reads(
    flash: torch.Tensor, bufs: torch.Tensor, batch: RequestBatch,
    use_pallas: bool = False,
) -> torch.Tensor:
    """Copy flash[lba] into bufs[buf_id] for valid read requests."""
    is_read = batch.valid & (batch.opcode == 0)
    src = torch.where(is_read, batch.lba, 0)
    if use_pallas:
        from repro_torch.kernels import ops as kops

        data = kops.block_gather(flash, src)
    else:
        data = take_rows(flash, src.clamp(0, flash.shape[-2] - 1))
    dst = torch.where(is_read, batch.buf_id, bufs.shape[-2])
    return scatter_last(bufs, dst, data)


def apply_writes(
    flash: torch.Tensor, bufs: torch.Tensor, batch: RequestBatch
) -> torch.Tensor:
    """Copy bufs[buf_id] into flash[lba] for valid write requests."""
    is_write = batch.valid & (batch.opcode == 1)
    src = torch.where(is_write, batch.buf_id, 0)
    data = take_rows(bufs, src.clamp(0, bufs.shape[-2] - 1))
    dst = torch.where(is_write, batch.lba, flash.shape[-2])
    return scatter_last(flash, dst, data)


def _bytes(batch: RequestBatch, ssd: SSDConfig) -> torch.Tensor:
    return (batch.nblocks * ssd.block_bytes).to(F32)


def baseline_worker_times(
    work_time: torch.Tensor,       # (U, W) worker busy-until cursors
    map_time: torch.Tensor,        # ()  global map/unmap lock busy-until
    fetch_done: torch.Tensor,      # (N,) per request
    batch: RequestBatch,
    cfg: EngineConfig,
    plat: PlatformModel,
    ssd: SSDConfig,
    unit: "torch.Tensor | None" = None,
    unit_rank: "torch.Tensor | None" = None,
    use_counting_sort: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """NVMeVirt backend: a global map/unmap queue feeding W copy lanes per
    unit. Returns (work_time', map_time', ready)."""
    u, w = work_time.shape[-2:]
    lead = tuple(work_time.shape[:-2])
    n = fetch_done.shape[-1]
    dev = fetch_done.device
    pallas = cfg.resolve_pallas_segscan(ssd, plat)
    txn, bw = _p2p(cfg, plat)
    idx = torch.arange(n, dtype=I32, device=dev)
    if unit is None:
        unit = torch.div(idx, n // u, rounding_mode="floor")
        rank_in_unit = torch.remainder(idx, n // u)
    elif unit_rank is not None:
        rank_in_unit = unit_rank
    else:
        rank_in_unit = segment_rank(unit)

    # -- global map/unmap serialization (requests in dispatch order).
    map_cost = torch.where(
        batch.valid, float(np.float32(plat.per_req_map_us)), 0.0
    )
    heads0 = idx == 0
    seed0 = map_time[..., None].expand(lead + (n,))
    mapped = queueing_scan(
        fetch_done, map_cost, heads0, seed0, use_pallas=pallas
    )
    new_map = torch.maximum(torch.amax(mapped, dim=-1), map_time)

    # -- per-lane p2p copy after mapping.
    cost = txn + true_div(_bytes(batch, ssd), bw)
    cost = torch.where(batch.valid, cost, 0.0)
    lane = (unit * w + torch.remainder(rank_in_unit, w)).expand(
        lead + (n,))
    if use_counting_sort:
        plan = counting_sort_plan(lane, u * w)
        order, heads = plan.order, plan.heads
    else:
        order, heads = stable_argsort(lane), None
    o = order.long()
    s_lane = take(lane, o)
    if heads is None:
        heads = segment_heads(s_lane)
    lanes = work_time.reshape(lead + (u * w,))
    seed = take(lanes, s_lane)
    busy = queueing_scan(take(mapped, o), take(cost, o), heads, seed,
                         use_pallas=pallas)
    ready = unsort(busy, order)

    new_work = segment_max(busy, s_lane, u * w)
    new_work = torch.maximum(new_work, lanes).reshape(work_time.shape)
    return new_work, new_map, torch.where(batch.valid, ready, 0.0)


def dsa_worker_times(
    dsa_time: torch.Tensor,        # (U,) DSA-engine busy-until cursors
    fetch_done: torch.Tensor,      # (N,)
    batch: RequestBatch,
    cfg: EngineConfig,
    plat: PlatformModel,
    ssd: SSDConfig,
    dsa_batch_size: int = 16,
    unit: "torch.Tensor | None" = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """SwarmIO backend: batched async DSA offload, a pipelined single
    server per unit at ``dsa_bytes_per_us``. Returns (dsa_time', ready)."""
    u = dsa_time.shape[-1]
    n = fetch_done.shape[-1]
    dev = fetch_done.device
    issue = plat.dsa_desc_issue_us + plat.dsa_batch_setup_us / dsa_batch_size
    ready_in = fetch_done + issue
    cost = true_div(_bytes(batch, ssd), plat.dsa_bytes_per_us) + 0.01
    cost = torch.where(batch.valid, cost, 0.0)

    if unit is None:
        unit = torch.div(torch.arange(n, dtype=I32, device=dev), n // u,
                         rounding_mode="floor")
    heads = segment_heads(unit)
    seed = take(dsa_time, unit)
    busy = queueing_scan(ready_in, cost, heads, seed)

    new_dsa = segment_max(busy, unit, u)
    new_dsa = torch.maximum(new_dsa, dsa_time)
    return new_dsa, torch.where(batch.valid, busy, 0.0)


def _p2p(cfg: EngineConfig, plat: PlatformModel):
    if cfg.transport == "p2p":
        return plat.txn_base_us, plat.link_bytes_per_us
    return plat.host_txn_base_us, plat.host_bytes_per_us
