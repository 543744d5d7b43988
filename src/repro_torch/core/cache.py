"""GPU-side set-associative page cache, pipeline stage 0 (port of
``repro/core/cache.py``).

Every read first probes a device-resident set-associative tag array; a
hit completes at GPU-local latency (``hit_us``) without posting an SQE,
so it takes no ring slot, no frontend transaction and no device time.
Replacement is FIFO per set (a round-robin victim cursor ``rr``);
``readahead`` also fills the next R sequential blocks of every fill.
Lookups within an epoch probe the epoch-start tags.

Every function takes one drive's cache, tags (S, W) and batches (N,), or
an array's, with a leading ``(M,)`` axis on every tensor: lookups gather
each drive's rows (``segops.take_rows``), and the fills scatter through
``segops.scatter_last`` with the drives laid end to end. Two fills of one
call that land on the same (set, way) — more than ``ways`` fills to one
set — leave the later row's block, as the reference's scatter does on the
CPU; an indexed assignment would leave either on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.segops import (
    scatter_last,
    segment_rank,
    segment_sum,
    take,
    take_rows,
)
from repro_torch.core.types import F32, I32, CacheConfig


@dataclasses.dataclass(frozen=True)
class CacheState:
    """Tag array of one drive's page cache (or an array's, stacked)."""

    tags: torch.Tensor  # (S, W) i32 cached LBA per way, -1 = empty
    rr: torch.Tensor    # (S,) i32 FIFO victim cursor per set

    @staticmethod
    def init(ccfg: CacheConfig, device) -> "CacheState":
        return CacheState(
            tags=torch.full((ccfg.num_sets, ccfg.ways), -1, dtype=I32,
                            device=device),
            rr=torch.zeros((ccfg.num_sets,), dtype=I32, device=device),
        )

    @property
    def num_sets(self) -> int:
        return self.tags.shape[-2]

    @property
    def ways(self) -> int:
        return self.tags.shape[-1]


def set_of(lba: torch.Tensor, ccfg: CacheConfig) -> torch.Tensor:
    """Set index of an LBA: the floor modulo of ``jnp.remainder`` (so -1
    maps to the last set), sequential blocks in consecutive sets."""
    return torch.remainder(lba, ccfg.num_sets).to(I32)


def lookup(
    state: CacheState,
    lba: torch.Tensor,    # (..., N) i32
    valid: torch.Tensor,  # (..., N) bool
    ccfg: CacheConfig,
) -> torch.Tensor:
    """Hits (..., N) bool against the epoch-start tags."""
    ways = take_rows(state.tags, set_of(lba, ccfg))       # (..., N, W)
    hit = torch.any(ways == lba[..., None], dim=-1)
    return hit & valid & (lba >= 0)


def _insert_once(
    state: CacheState, lba: torch.Tensor, fill: torch.Tensor,
    ccfg: CacheConfig,
) -> CacheState:
    """Insert one batch of fills: fills to one set take consecutive victim
    ways from its cursor, in row order; ``rr`` advances by the set's
    fills."""
    s, w = ccfg.num_sets, ccfg.ways
    key = torch.where(fill, set_of(lba, ccfg), s)
    rank = segment_rank(key)
    row = torch.clamp(key, 0, s - 1)
    way = torch.remainder(take(state.rr, row) + rank, w)
    slot = torch.where(fill, row * w + way, s * w)        # non-fills drop
    counts = segment_sum(fill.to(I32), key, s + 1)[..., :s]
    flat = state.tags.reshape(tuple(state.tags.shape[:-2]) + (s * w,))
    tags = scatter_last(flat, slot, lba.to(I32)).reshape(state.tags.shape)
    return CacheState(tags=tags,
                      rr=torch.remainder(state.rr + counts, w).to(I32))


def insert(
    state: CacheState,
    lba: torch.Tensor,    # (..., N) i32 blocks that just became resident
    valid: torch.Tensor,  # (..., N) bool
    ccfg: CacheConfig,
) -> CacheState:
    """Fill completed reads (and ``readahead`` sequential blocks after
    each) into the cache. Blocks already present are skipped; two fills of
    one block in one call may hold two ways for a while, as in the
    reference."""
    for r in range(ccfg.readahead + 1):
        fill_lba = lba + r
        fill = valid & (fill_lba >= 0)
        fill = fill & ~lookup(state, fill_lba, fill, ccfg)
        state = _insert_once(state, fill_lba, fill, ccfg)
    return state


def serve(
    state: CacheState,
    lba: torch.Tensor,       # (..., N) i32 proposed read addresses
    is_read: torch.Tensor,   # (..., N) bool row is a valid read request
    t_submit: torch.Tensor,  # (..., N) f32 virtual submission times
    ccfg: CacheConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stage-0 filter: (hit, done). Hit rows complete at ``t_submit +
    hit_us`` without entering the rings; other rows' ``done`` is 0."""
    hit = lookup(state, lba, is_read, ccfg)
    done = torch.where(hit, t_submit + float(np.float32(ccfg.hit_us)), 0.0)
    return hit, done.to(F32)
