"""Flash-level backend: channels/chips, writes, GC, mapping misses
(port of ``repro/core/flash.py``).

Pipeline stage 4. Writes occupy their die for ``flash_program_us`` and
serialize per chip, mapping misses charge a translation-page read on the
mapped die, and greedy GC steals die time when the free-page pool drops
below the watermark. One ``flash_stage`` call prices a whole epoch; with
``mapping_hit_rate=1.0`` and no writes it is an exact no-op.

The die contention runs in one of three layouts, all giving the same
times on integer-valued timestamps: the stable die sort (reference), the
counting-sort layout (``use_counting_sort``), and the ``die_contention``
kernel (``use_pallas_flash``), a sequential per-die fold. An array's
drives each have their own dies and page pool: every tensor may carry a
leading ``(M,)`` axis.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.segops import (
    NEG,
    counting_positions,
    hash_u32,
    queueing_scan,
    sort_by_segment,
    segment_max,
    take,
    true_div,
    uniform01,
    unsort,
)
from repro_torch.core.types import F32, I32, OP_WRITE, RequestBatch, SSDConfig

_U32 = 0xFFFFFFFF


def _f32(x: float) -> float:
    return float(np.float32(x))


@dataclasses.dataclass(frozen=True)
class FlashState:
    """Flash-array state for one emulated device."""

    chip_busy: torch.Tensor    # (C*W,) f32 per-die busy-until cursors
    free_pages: torch.Tensor   # () f32 free (erased) physical pages
    valid_pages: torch.Tensor  # () f32 physical pages holding live data
    io_seq: torch.Tensor       # () i32 ops priced so far (CMT-miss hash salt)
    prog_seq: torch.Tensor     # () i32 programs placed (rr write cursor)
    gc_count: torch.Tensor     # () f32 total GC invocations

    @staticmethod
    def init(ssd: SSDConfig, device) -> "FlashState":
        """Fresh or steady-state drive per ``ssd.preconditioned``."""
        phys = np.float32(ssd.phys_pages)
        valid = np.float32(ssd.num_blocks if ssd.preconditioned else 0.0)

        def scalar(v, dtype):
            return torch.tensor(v, dtype=dtype, device=device)

        return FlashState(
            chip_busy=torch.zeros((ssd.num_chips,), dtype=F32, device=device),
            free_pages=scalar(float(np.float32(phys - valid)), F32),
            valid_pages=scalar(float(valid), F32),
            io_seq=scalar(0, I32),
            prog_seq=scalar(0, I32),
            gc_count=scalar(0.0, F32),
        )

    @property
    def num_chips(self) -> int:
        return self.chip_busy.shape[-1]


def chip_of(lba: torch.Tensor, ssd: SSDConfig) -> torch.Tensor:
    """Map an LBA to its die (channel striping by address hash)."""
    h = ((lba.to(torch.int64) & _U32) * 2654435761) & _U32
    return ((h >> 16) % ssd.num_chips).to(I32)


def mapping_miss(
    fstate: FlashState, batch: RequestBatch, ssd: SSDConfig
) -> torch.Tensor:
    """Which valid reads miss the cached mapping table this epoch
    (counter-based hash of request id, LBA and the running op count)."""
    if ssd.mapping_hit_rate >= 1.0:
        return torch.zeros_like(batch.valid)
    is_read = batch.valid & (batch.opcode != OP_WRITE)

    def u32(x):
        return x.to(torch.int64) & _U32

    salt = (
        u32(batch.req_id)
        + ((u32(batch.lba) * 0x85EBCA6B) & _U32)
        + ((u32(fstate.io_seq[..., None]) * 0x9E3779B9) & _U32)
    ) & _U32
    h = hash_u32(salt)
    return is_read & (uniform01(h) >= _f32(ssd.mapping_hit_rate))


def flash_stage(
    fstate: FlashState,
    batch: RequestBatch,
    arrival: torch.Tensor,   # (N,) f32 post-lock dispatch times
    target: torch.Tensor,    # (N,) f32 stage-2 timing-model completions
    ssd: SSDConfig,
    use_pallas: bool = False,
    use_counting_sort: bool = False,
    use_pallas_flash: bool = False,
) -> Tuple[FlashState, torch.Tensor]:
    """Price one epoch's flash-level events. Returns (state', flash_done);
    the pipeline takes ``max(target, ready, flash_done)``."""
    k = ssd.num_chips
    valid = batch.valid
    is_write = valid & (batch.opcode == OP_WRITE)
    miss = mapping_miss(fstate, batch, ssd)

    # Reads go where the data lives; writes are placed log-structured,
    # round-robin across dies from the ``prog_seq`` cursor.
    chip = chip_of(batch.lba, ssd)
    w_rank = torch.cumsum(is_write.to(I32), -1, dtype=I32) - 1
    w_chip = torch.remainder(
        fstate.prog_seq[..., None] + torch.clamp(w_rank, min=0), k)
    chip = torch.where(is_write, w_chip, chip)
    cost = torch.where(is_write, _f32(ssd.flash_program_us), 0.0)
    cost = cost + torch.where(miss, _f32(ssd.flash_read_us), 0.0)
    event = cost > 0.0

    key = torch.where(event, chip, k).to(I32)
    safe_key = torch.clamp(key, 0, k - 1)
    if use_pallas_flash:
        from repro_torch.kernels import ops as kops

        busy, chip_busy = kops.die_contention(
            arrival, cost, safe_key, event, fstate.chip_busy,
        )
    elif use_counting_sort:
        position, rank_in_key, _, _ = counting_positions(key, k + 1)
        page = torch.stack(
            [
                arrival,
                cost,
                take(fstate.chip_busy, safe_key),
                (rank_in_key == 0).to(F32),
            ],
            dim=-1,
        )
        s = unsort(page, position)
        busy_sorted = queueing_scan(
            s[..., 0], s[..., 1], s[..., 3] > 0.0, s[..., 2],
            use_pallas=use_pallas,
        )
        busy = take(busy_sorted, position)
    else:
        order, heads, _ = sort_by_segment(key)
        o = order.long()
        safe = torch.clamp(take(key, o), 0, k - 1)
        busy_sorted = queueing_scan(
            take(arrival, o), take(cost, o), heads,
            take(fstate.chip_busy, safe), use_pallas=use_pallas,
        )
        busy = unsort(busy_sorted, order)
    if not use_pallas_flash:
        chip_busy = torch.maximum(
            fstate.chip_busy,
            segment_max(torch.where(event, busy, NEG), safe_key, k),
        )

    # Non-event rows see the die work scheduled in previous epochs.
    epoch_view = torch.maximum(arrival, take(fstate.chip_busy, chip))
    flash_done = torch.where(
        is_write,
        busy,
        torch.where(miss, busy + (target - arrival), epoch_view),
    )
    flash_done = torch.where(valid, flash_done, 0.0)

    # -- page-pool accounting + greedy GC (once per epoch) ----------------
    cap = _f32(ssd.num_blocks)
    phys = _f32(ssd.phys_pages)
    n_w = torch.sum(is_write.to(F32), dim=-1, dtype=F32)
    valid_pages = torch.clamp(
        fstate.valid_pages
        + n_w * (1.0 - true_div(fstate.valid_pages, cap)),
        max=cap,
    )
    free_pages = fstate.free_pages - n_w
    gc_count = fstate.gc_count
    if ssd.gc_watermark > 0.0:
        live = torch.clamp(true_div(valid_pages, phys), 0.0, 1.0)
        net = torch.clamp(ssd.pages_per_block * (1.0 - live), min=1.0)
        per_gc_us = (
            ssd.pages_per_block
            * live
            * (ssd.flash_read_us + ssd.flash_program_us)
            + ssd.flash_erase_us
        )
        invalid = torch.clamp(phys - free_pages - valid_pages, min=0.0)
        deficit = _f32(np.float32(ssd.gc_watermark) * np.float32(phys)) \
            - free_pages
        n_gc = torch.ceil(torch.clamp(deficit, min=0.0) / net)
        n_gc = torch.minimum(torch.clamp(n_gc, min=0.0),
                             torch.floor(invalid / net))
        free_pages = free_pages + n_gc * net
        t_now = torch.amax(torch.where(valid, arrival, 0.0), dim=-1)
        chip_busy = torch.where(
            n_gc[..., None] > 0.0,
            torch.maximum(chip_busy, t_now[..., None])
            + true_div(n_gc * per_gc_us, k)[..., None],
            chip_busy,
        )
        gc_count = gc_count + n_gc

    new_state = FlashState(
        chip_busy=chip_busy,
        free_pages=free_pages,
        valid_pages=valid_pages,
        io_seq=fstate.io_seq + torch.sum(valid.to(I32), dim=-1, dtype=I32),
        prog_seq=torch.remainder(
            fstate.prog_seq + torch.sum(is_write.to(I32), dim=-1, dtype=I32),
            k,
        ),
        gc_count=gc_count,
    )
    return new_state, flash_done
