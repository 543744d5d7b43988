"""Queue-pair layer: completion-queue rings, the CQ half (port of
``repro/core/qp.py``).

The device *posts* a completion entry to the CQ paired with the
request's SQ and the GPU consumer *reaps* it. This slice ports the
neutral completion path (no coalescing, zero posting and poll cost),
which stores the entries but adds no virtual time; a non-neutral
``QPConfig`` is rejected when ``DevicePipeline`` is built (ROADMAP A8).
With ``use_pallas_reap`` the posting runs as the ``fused_reap`` kernel.
An array's rings carry a leading ``(M,)`` drive axis, (M, Q, D).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.core.frontend import scatter_drop
from repro_torch.core.segops import segment_rank, segment_sum, take
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
    posted_counts: "torch.Tensor | None" = None,  # (Q,) per-CQ counts
    fused_scatter: bool = False,
    use_pallas_reap: bool = False,
) -> Tuple[CQRings, torch.Tensor]:
    """Post one epoch's completions and reap them. Returns (cq', reaped);
    on the neutral path ``reaped == done`` for valid rows (0 otherwise)."""
    if not qp.neutral:
        raise NotImplementedError(
            "a non-neutral QPConfig is not ported (ROADMAP A8)"
        )
    q = cq.num_cqs
    key = torch.where(valid, cq_id, q).to(I32)
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
