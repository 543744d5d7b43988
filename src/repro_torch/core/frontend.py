"""Frontend: submission-queue rings, doorbells and request fetching
(port of ``repro/core/frontend.py``).

SQ entries live in contiguous ring buffers, so a coalesced fetch of n
entries is one bulk transfer costing ``txn_base + n*sqe_bytes/bw``. The
*distributed* frontend partitions the SQs across service units and
fetches all units' SQs in parallel; the *centralized* NVMeVirt baseline
has one dispatcher that serializes over all SQs, one entry a transaction.
``submit`` and ``deal_sqs`` post a flat application batch
(``core/client.py``).
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
    seq_cumsum,
    true_div,
)
from repro_torch.core.types import (
    F32,
    I32,
    EngineConfig,
    PlatformModel,
    RequestBatch,
)


@dataclasses.dataclass(frozen=True)
class SQRings:
    """Struct-of-arrays NVMe submission queues (one ring per SQ)."""

    submit_time: torch.Tensor  # (Q, D) f32 — virtual time the entry was posted
    opcode: torch.Tensor       # (Q, D) i32
    lba: torch.Tensor          # (Q, D) i32
    nblocks: torch.Tensor      # (Q, D) i32
    buf_id: torch.Tensor       # (Q, D) i32
    req_id: torch.Tensor       # (Q, D) i32
    tenant: torch.Tensor       # (Q, D) i32 — QoS/tenant class of the entry
    head: torch.Tensor         # (Q,) i32 free-running consumer index
    tail: torch.Tensor         # (Q,) i32 free-running producer index

    @property
    def num_sqs(self) -> int:
        return self.submit_time.shape[0]

    @property
    def depth(self) -> int:
        return self.submit_time.shape[1]

    @staticmethod
    def empty(num_sqs: int, depth: int, device) -> "SQRings":
        def z():
            return torch.zeros((num_sqs, depth), dtype=I32, device=device)

        return SQRings(
            submit_time=torch.full((num_sqs, depth), 3e38, dtype=F32,
                                   device=device),
            opcode=z(), lba=z(),
            nblocks=torch.ones((num_sqs, depth), dtype=I32, device=device),
            buf_id=z(), req_id=z(), tenant=z(),
            head=torch.zeros((num_sqs,), dtype=I32, device=device),
            tail=torch.zeros((num_sqs,), dtype=I32, device=device),
        )


_RING_FIELDS = ("submit_time", "opcode", "lba", "nblocks", "buf_id",
                "req_id", "tenant")


def scatter_drop(
    field: torch.Tensor, rows: torch.Tensor, pos: torch.Tensor,
    val: torch.Tensor,
) -> torch.Tensor:
    """``field.at[rows, pos].set(val, mode="drop")`` on a (Q, D, ...) ring
    field: entries whose ``pos`` is outside ``[0, D)`` are dropped, and of
    several entries for one slot the last one wins."""
    q, d = field.shape[0], field.shape[1]
    rest = tuple(field.shape[2:])
    keep = (pos >= 0) & (pos < d)
    flat = torch.where(keep, rows.long() * d + pos.long(), q * d)
    out = scatter_last(field.reshape((q * d,) + rest), flat.reshape(-1),
                       val.reshape((-1,) + rest))
    return out.reshape(field.shape)


def submit(
    rings: SQRings,
    sq_id: torch.Tensor,        # (M,) i32 target SQ per new entry
    submit_time: torch.Tensor,  # (M,) f32
    opcode: torch.Tensor,
    lba: torch.Tensor,
    nblocks: torch.Tensor,
    buf_id: torch.Tensor,
    req_id: torch.Tensor,
    valid: torch.Tensor,        # (M,) bool
    tenant: "torch.Tensor | None" = None,
) -> SQRings:
    """Append entries to their SQs (ring the doorbells). Entries for one
    SQ land in array order; callers pre-sort by submit time."""
    q = rings.num_sqs
    if tenant is None:
        tenant = torch.zeros_like(sq_id)
    sq_key = torch.where(valid, sq_id, q)
    offset = segment_rank(sq_key)
    row = torch.clamp(sq_key, 0, q - 1)
    pos = torch.remainder(rings.tail[row.long()] + offset, rings.depth)
    # Invalid rows scatter out of bounds and are dropped.
    pos = torch.where(valid, pos, rings.depth)
    new = (submit_time, opcode, lba, nblocks, buf_id, req_id, tenant)
    fields = {
        name: scatter_drop(getattr(rings, name), row, pos, val)
        for name, val in zip(_RING_FIELDS, new)
    }
    counts = segment_sum(valid.to(I32), sq_key, q + 1)[:q]
    return dataclasses.replace(rings, **fields, tail=rings.tail + counts)


def submit_grouped(
    rings: SQRings,
    submit_time: torch.Tensor,  # (Q, F) — row q targets SQ q
    opcode: torch.Tensor,
    lba: torch.Tensor,
    nblocks: torch.Tensor,
    buf_id: torch.Tensor,
    req_id: torch.Tensor,
    valid: torch.Tensor,        # (Q, F) bool
    tenant: "torch.Tensor | None" = None,
    fused: bool = False,
) -> SQRings:
    """Append row q's valid entries to SQ q in array order (rows must be
    pre-sorted by submit time).

    ``fused`` moves the seven fields in one stacked (Q, F, 7) scatter, the
    six i32 fields riding as raw float32 bits (``Tensor.view``) — bits are
    moved, never converted, so the rings land bit-identical.
    """
    q, f = submit_time.shape
    dev = submit_time.device
    if tenant is None:
        tenant = torch.zeros_like(opcode)
    offset = torch.cumsum(valid.to(I32), 1, dtype=I32) - 1
    pos = torch.remainder(rings.tail[:, None] + offset, rings.depth)
    pos = torch.where(valid, pos, rings.depth)  # dropped
    rows = torch.arange(q, dtype=I32, device=dev)[:, None].expand(q, f)
    tail = rings.tail + torch.sum(valid.to(I32), dim=1, dtype=I32)
    new = (submit_time, opcode, lba, nblocks, buf_id, req_id, tenant)

    if fused:
        page = torch.stack(
            [new[0]] + [x.view(F32) for x in new[1:]], dim=-1
        )
        old = [getattr(rings, name) for name in _RING_FIELDS]
        stacked = torch.stack([old[0]] + [x.view(F32) for x in old[1:]],
                              dim=-1)
        stacked = scatter_drop(stacked, rows, pos, page)
        fields = [stacked[..., 0].contiguous()] + [
            stacked[..., i].contiguous().view(I32) for i in range(1, 7)
        ]
    else:
        fields = [
            scatter_drop(getattr(rings, name), rows, pos, val)
            for name, val in zip(_RING_FIELDS, new)
        ]
    return dataclasses.replace(
        rings, **dict(zip(_RING_FIELDS, fields)), tail=tail
    )


def _gather_entries(
    rings: SQRings, nfetch: torch.Tensor, fetch_width: int
) -> Tuple[RequestBatch, torch.Tensor]:
    """Gather up to ``nfetch[q]`` entries from each SQ head (SQ-major
    order). Returns a RequestBatch of capacity Q*fetch_width plus the
    (Q, F) validity."""
    q, d = rings.num_sqs, rings.depth
    dev = nfetch.device
    j = torch.arange(fetch_width, dtype=I32, device=dev)[None, :]
    pos = torch.remainder(rings.head[:, None] + j, d)          # (Q, F)
    valid = j < nfetch[:, None]                                # (Q, F)
    rows = torch.arange(q, dtype=I32, device=dev)[:, None]
    r, p = rows.long(), pos.long()

    def take(field):
        return field[r, p].reshape(-1)

    batch = RequestBatch(
        arrival=take(rings.submit_time),   # provisional: submit time
        sq_id=rows.expand(q, fetch_width).reshape(-1),
        slot=pos.reshape(-1),
        opcode=take(rings.opcode),
        lba=take(rings.lba),
        nblocks=take(rings.nblocks),
        buf_id=take(rings.buf_id),
        req_id=take(rings.req_id),
        valid=valid.reshape(-1),
        tenant=take(rings.tenant),
    )
    return batch, valid


def fetch_distributed(
    rings: SQRings,
    clock: torch.Tensor,         # () f32 — entries visible iff submit <= clock
    disp_time: torch.Tensor,     # (U,) f32 dispatcher busy-until cursors
    cfg: EngineConfig,
    plat: PlatformModel,
) -> Tuple[SQRings, torch.Tensor, RequestBatch, torch.Tensor]:
    """SwarmIO frontend: all units fetch their SQs in parallel, coalesced.
    Returns (rings', disp_time', batch, fetch_done_per_row)."""
    qs, f = cfg.num_sqs, cfg.fetch_width
    u = cfg.num_units
    per_unit = qs // u

    avail = rings.tail - rings.head
    visible = _visible_count(rings, clock, f)
    nfetch = torch.clamp(torch.minimum(avail, visible), max=f)
    # Self-pacing: a dispatcher still busy with its previous pass skips
    # this round; pending entries coalesce into its next fetch.
    active_u = disp_time <= clock                                   # (U,)
    active = torch.repeat_interleave(active_u, per_unit)            # (Q,)
    nfetch = torch.where(active, nfetch, 0)
    cost = fetch_cost(nfetch, cfg, plat)
    cost = torch.where(active, cost, 0.0)

    cum = seq_cumsum(cost.reshape(u, per_unit), 1)
    start = torch.maximum(disp_time, clock)                         # (U,)
    fetch_done_sq = (start[:, None] + cum).reshape(qs)              # (Q,)
    disp_time = start + cum[:, -1]

    batch, _ = _gather_entries(rings, nfetch, f)
    fetch_done = torch.repeat_interleave(fetch_done_sq, f)
    rings = dataclasses.replace(rings, head=rings.head + nfetch)
    return rings, disp_time, batch, fetch_done


def fetch_centralized(
    rings: SQRings,
    clock: torch.Tensor,         # () f32
    disp_time: torch.Tensor,     # (1,) f32
    cfg: EngineConfig,
    plat: PlatformModel,
) -> Tuple[SQRings, torch.Tensor, RequestBatch, torch.Tensor]:
    """NVMeVirt baseline: ONE dispatcher serializes over all SQs, one
    entry a transaction (no coalescing), draining each SQ before the
    next. Every multiply and add rounds on its own (the reference's CPU
    compile may fuse ``nf * per_entry + poll`` and ``sq_base + (j + 1) *
    per_entry`` into FMAs)."""
    f = cfg.fetch_width

    avail = rings.tail - rings.head
    visible = _visible_count(rings, clock, f)
    nfetch = torch.clamp(torch.minimum(avail, visible), max=f)
    nfetch = torch.where(disp_time[0] <= clock, nfetch, 0)  # self-pacing

    per_entry = _per_entry_cost(cfg, plat)
    cost = nfetch.to(F32) * per_entry + plat.doorbell_poll_us
    cum = seq_cumsum(cost, 0)
    start = torch.maximum(disp_time[0], clock)
    sq_base = start + cum - cost                                    # (Q,)
    disp_time = (start + cum[-1])[None]

    batch, _ = _gather_entries(rings, nfetch, f)
    # Entry j of SQ q completes fetching at base_q + (j+1)*per_entry.
    j1 = torch.arange(1, f + 1, dtype=F32, device=nfetch.device)[None, :]
    fetch_done = (sq_base[:, None] + j1 * per_entry).reshape(-1)
    rings = dataclasses.replace(rings, head=rings.head + nfetch)
    return rings, disp_time, batch, fetch_done


def fetch(
    rings: SQRings,
    clock: torch.Tensor,
    disp_time: torch.Tensor,
    cfg: EngineConfig,
    plat: PlatformModel,
) -> Tuple[SQRings, torch.Tensor, RequestBatch, torch.Tensor]:
    """The single fetch entry point of ``engine_round`` and
    ``StorageClient``."""
    if cfg.frontend == "distributed":
        return fetch_distributed(rings, clock, disp_time, cfg, plat)
    return fetch_centralized(rings, clock, disp_time, cfg, plat)


def deal_sqs(n: int, cfg: EngineConfig, device) -> torch.Tensor:
    """SQ of request i of a flat application batch, (N,) i32: requests
    interleave across service units first, then round-robin over each
    unit's SQs, keeping ascending batch order within an SQ."""
    u = cfg.num_units if cfg.frontend == "distributed" else 1
    per_unit = cfg.num_sqs // u
    i = torch.arange(n, dtype=I32, device=device)
    return (i % u) * per_unit + torch.div(i, u, rounding_mode="floor") % per_unit


def fetch_row_units(cfg: EngineConfig, device) -> torch.Tensor:
    """(Q*F,) i32 service-unit id per fetch-batch row (SQ-major layout)."""
    u = cfg.num_units if cfg.frontend == "distributed" else 1
    rows = cfg.num_sqs * cfg.fetch_width
    return torch.div(
        torch.arange(rows, dtype=I32, device=device), rows // u,
        rounding_mode="floor",
    )


def _per_entry_cost(cfg: EngineConfig, plat: PlatformModel) -> float:
    """Non-coalesced per-SQE fetch cost by transport/engine (as float32)."""
    if cfg.transport == "host":
        return float(np.float32(
            plat.host_txn_base_us + plat.sqe_bytes / plat.host_bytes_per_us
        ))
    if cfg.dsa_fetch:
        return float(np.float32(plat.dsa_sqe_fetch_us))
    return float(np.float32(plat.cpu_sqe_fetch_us))


def fetch_cost(
    nfetch: torch.Tensor, cfg: EngineConfig, plat: PlatformModel
) -> torch.Tensor:
    """Virtual-time cost to fetch ``nfetch[q]`` entries from each SQ."""
    nf = nfetch.to(F32)
    bytes_per_sq = nf * plat.sqe_bytes
    per_entry = nf * _per_entry_cost(cfg, plat)
    if not cfg.coalesced:
        return per_entry + plat.doorbell_poll_us
    if cfg.transport == "host":
        cost = plat.host_txn_base_us + true_div(
            bytes_per_sq, plat.host_bytes_per_us
        )
    elif cfg.dsa_fetch:
        cost = plat.dsa_coal_base_us + true_div(
            bytes_per_sq, plat.dsa_bytes_per_us
        )
    else:
        cost = plat.cpu_coal_base_us + bytes_per_sq * plat.cpu_coal_byte_us
    # An adaptive dispatcher falls back to per-entry fetches when only a
    # few entries are pending (bulk-txn setup would dominate).
    cost = torch.minimum(cost, per_entry)
    return torch.where(nfetch > 0, cost, plat.doorbell_poll_us)


def _visible_count(
    rings: SQRings, clock: torch.Tensor, f: int
) -> torch.Tensor:
    """How many contiguous head entries of each SQ were posted by
    ``clock`` (in-order consumption stops at the first invisible one)."""
    d = rings.depth
    dev = rings.head.device
    j = torch.arange(f, dtype=I32, device=dev)[None, :]
    pos = torch.remainder(rings.head[:, None] + j, d)
    rows = torch.arange(rings.num_sqs, dtype=torch.int64, device=dev)[:, None]
    t = rings.submit_time[rows, pos.long()]
    in_ring = j < (rings.tail - rings.head)[:, None]
    vis = (t <= clock) & in_ring
    lead = torch.cumprod(vis.to(I32), dim=1, dtype=I32)
    return torch.sum(lead, dim=1, dtype=I32)
