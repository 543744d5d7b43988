"""Queue-pair layer: completion-queue rings, the CQ half (port of
``repro/core/qp.py``).

The device *posts* a completion entry to the CQ paired with the
request's SQ, rings a CQ doorbell, and the GPU consumer *polls* the ring
and *reaps* the entry. The neutral path (no coalescing, zero posting and
poll cost, the default) stores the entries but adds no virtual time; with
``use_pallas_reap`` its posting runs as the ``fused_reap`` kernel. A
non-neutral ``QPConfig`` prices completion coalescing (``cq_coalesce_n``
entries a doorbell, flushed after ``cq_coalesce_us``), the per-CQ
doorbell poster (``cq_doorbell_us`` a doorbell, serialised by a queueing
scan, on the ``seg_scan`` kernel under ``use_pallas_segscan``) and the
consumer's poll and per-entry reap costs. An array's rings carry a
leading ``(M,)`` drive axis, (M, Q, D).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

import numpy as np

from repro_torch.core.frontend import scatter_drop
from repro_torch.core.segops import (
    NEG,
    lex_sort_by_segment,
    queueing_scan,
    segment_max,
    segment_rank,
    segment_sum,
    segmented_prefix_max,
    take,
    unsort,
)
from repro_torch.core.types import F32, I32, QPConfig


@dataclasses.dataclass(frozen=True)
class CQRings:
    """Struct-of-arrays NVMe completion queues (one ring per CQ; CQ q is
    paired with SQ q). ``head``/``tail`` are free-running indices and
    ``bell_time`` the per-CQ doorbell-poster busy-until cursor."""

    done_time: torch.Tensor     # (Q, D) f32 — device-side completion time
    visible_time: torch.Tensor  # (Q, D) f32 — doorbell-visible time
    req_id: torch.Tensor        # (Q, D) i32
    head: torch.Tensor          # (Q,) i32 free-running consumer index
    tail: torch.Tensor          # (Q,) i32 free-running producer index
    bell_time: torch.Tensor     # (Q,) f32 doorbell-poster busy-until

    @property
    def num_cqs(self) -> int:
        return self.done_time.shape[-2]

    @property
    def depth(self) -> int:
        return self.done_time.shape[-1]

    @staticmethod
    def empty(num_cqs: int, depth: int, device,
              lead: Tuple[int, ...] = ()) -> "CQRings":
        """Empty rings; ``lead=(M,)`` gives an array's, one set a drive."""
        shape = tuple(lead) + (num_cqs, depth)

        def full(v):
            return torch.full(shape, v, dtype=F32, device=device)

        return CQRings(
            done_time=full(3e38),
            visible_time=full(3e38),
            req_id=torch.zeros(shape, dtype=I32, device=device),
            head=torch.zeros(shape[:-1], dtype=I32, device=device),
            tail=torch.zeros(shape[:-1], dtype=I32, device=device),
            bell_time=torch.zeros(shape[:-1], dtype=F32, device=device),
        )


def _scatter_entries(
    cq: CQRings,
    key: torch.Tensor,   # (N,) i32 CQ per row, num_cqs for invalid rows
    rank: torch.Tensor,  # (N,) i32 posting order within the row's CQ
    done: torch.Tensor,
    visible: torch.Tensor,
    req_id: torch.Tensor,
    valid: torch.Tensor,
    counts: "torch.Tensor | None" = None,  # (Q,) i32 valid entries per CQ
    fused: bool = False,
) -> CQRings:
    """Write posted entries into the rings and advance the tails.

    ``counts`` hands in per-CQ valid counts the caller already knows.
    ``fused`` moves the three channels in one stacked (N, 3) scatter, the
    i32 ``req_id`` riding as raw float32 bits.
    """
    q, d = cq.num_cqs, cq.depth
    row = torch.clamp(key, 0, q - 1)
    pos = torch.remainder(take(cq.tail, row) + rank, d)
    pos = torch.where(valid, pos, d)  # invalid rows drop out of bounds
    if counts is None:
        counts = segment_sum(valid.to(I32), key, q + 1)[..., :q]
    if fused:
        page = torch.stack([done, visible, req_id.view(F32)], dim=-1)
        rings = torch.stack(
            [cq.done_time, cq.visible_time, cq.req_id.view(F32)], dim=-1
        )
        rings = scatter_drop(rings, row, pos, page)
        return dataclasses.replace(
            cq,
            done_time=rings[..., 0].contiguous(),
            visible_time=rings[..., 1].contiguous(),
            req_id=rings[..., 2].contiguous().view(I32),
            tail=cq.tail + counts,
            head=cq.head + counts,
        )
    return dataclasses.replace(
        cq,
        done_time=scatter_drop(cq.done_time, row, pos, done),
        visible_time=scatter_drop(cq.visible_time, row, pos, visible),
        req_id=scatter_drop(cq.req_id, row, pos, req_id),
        tail=cq.tail + counts,
        head=cq.head + counts,
    )


def post_and_reap(
    cq: CQRings,
    cq_id: torch.Tensor,   # (N,) i32 target CQ (= source SQ) per completion
    done: torch.Tensor,    # (N,) f32 device-side completion times
    req_id: torch.Tensor,  # (N,) i32
    valid: torch.Tensor,   # (N,) bool
    qp: QPConfig,
    posted_rank: "torch.Tensor | None" = None,  # (N,) epoch-plan CQ ranks
    use_pallas: bool = False,
    posted_counts: "torch.Tensor | None" = None,  # (Q,) per-CQ counts
    fused_scatter: bool = False,
    use_pallas_reap: bool = False,
) -> Tuple[CQRings, torch.Tensor]:
    """Post one epoch's completions and reap them. Returns (cq', reaped):
    when the consumer observes each valid row's completion (0 for invalid
    rows). On the neutral path ``reaped == done``.

    ``posted_rank``/``posted_counts`` hand in the epoch plan's per-CQ ranks
    and counts; ``use_pallas`` runs the non-neutral path's doorbell queue
    on the ``seg_scan`` kernel. That path orders its CQEs with
    ``lex_sort_by_segment``: the reference's ``fused_sort`` and two-sort
    branches give the same permutation, so the port has one;
    ``fused_scatter`` moves the three ring channels in one scatter and
    ``use_pallas_reap`` the neutral posting in the ``fused_reap`` kernel.
    """
    q = cq.num_cqs
    key = torch.where(valid, cq_id, q).to(I32)

    if qp.neutral:
        if use_pallas_reap:
            from repro_torch.kernels import ops as kops

            dt, vt, rid, counts = kops.fused_reap(
                cq.done_time, cq.visible_time, cq.req_id, cq.tail,
                key, done, req_id, valid,
            )
            cq = dataclasses.replace(
                cq, done_time=dt, visible_time=vt, req_id=rid,
                tail=cq.tail + counts, head=cq.head + counts,
            )
            return cq, torch.where(valid, done, 0.0)
        rank = posted_rank if posted_rank is not None else segment_rank(key)
        cq = _scatter_entries(
            cq, key, rank, done, done, req_id, valid,
            counts=posted_counts, fused=fused_scatter,
        )
        return cq, torch.where(valid, done, 0.0)

    n_coal = qp.cq_coalesce_n

    # CQEs post in completion-time order within each CQ.
    order, heads, rank = lex_sort_by_segment(key, done)
    o = order.long()
    s_done = take(done, o)
    s_valid = take(valid, o)
    s_key = take(key, o)
    safe = torch.clamp(s_key, 0, q - 1)

    # Coalescing groups: contiguous runs of n_coal entries per CQ.
    gheads = heads | (torch.remainder(rank, n_coal) == 0)
    last = torch.ones(tuple(gheads.shape[:-1]) + (1,), dtype=torch.bool,
                      device=gheads.device)
    tails = torch.cat([gheads[..., 1:], last], dim=-1)

    # The doorbell fires when the group fills (its last member's time) or
    # its timer expires (first member + cq_coalesce_us), whichever is
    # earlier; an entry completing after that posts at its own time.
    first = segmented_prefix_max(torch.where(gheads, s_done, NEG), gheads)
    full = segmented_prefix_max(
        torch.where(tails, s_done, NEG).flip(-1), tails.flip(-1)
    ).flip(-1)
    bell_raw = torch.minimum(full, first + _f32(qp.cq_coalesce_us))
    ready = torch.maximum(s_done, bell_raw)

    # Doorbell serialisation: one cq_doorbell_us of poster time a group,
    # charged at its head, in a queue per CQ.
    cost = torch.where(gheads & s_valid, _f32(qp.cq_doorbell_us), 0.0)
    posted = queueing_scan(
        ready, cost, heads, take(cq.bell_time, safe), use_pallas=use_pallas
    )
    bell_time = torch.maximum(
        cq.bell_time,
        segment_max(torch.where(s_valid, posted, NEG), safe, q),
    )

    # Consumer reap: one poll pass a doorbell batch plus a ring read an
    # entry, in posting order within the batch.
    reap_rank = torch.remainder(rank, n_coal).to(F32)
    reaped_s = (posted + _f32(qp.cq_poll_us)) + (reap_rank + 1.0) * _f32(
        qp.cqe_reap_us)

    cq = dataclasses.replace(
        _scatter_entries(
            cq, s_key, rank, s_done, posted, take(req_id, o), s_valid,
            counts=posted_counts, fused=fused_scatter,
        ),
        bell_time=bell_time,
    )
    reaped = unsort(reaped_s, order)
    return cq, torch.where(valid, reaped, 0.0)


def _f32(x: float) -> float:
    """A Python float holding the float32 value of ``x``."""
    return float(np.float32(x))

