"""Frontend: submission-queue rings, doorbells and request fetching
(port of ``repro/core/frontend.py``).

SQ entries live in contiguous ring buffers, so a coalesced fetch of n
entries is one bulk transfer costing ``txn_base + n*sqe_bytes/bw``. The
*distributed* frontend partitions the SQs across service units and
fetches all units' SQs in parallel; the *centralized* NVMeVirt baseline
has one dispatcher that serializes over all SQs, one entry a transaction.
``submit`` and ``deal_sqs`` post a flat application batch
(``core/client.py``).

Every function takes one drive's rings or an M-drive array's, whose
leaves carry a leading ``(M,)`` axis (the clock ``(M,)``, the cursors
``(M, U)``); each drive's numbers are those of a call on its own.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.segops import (
    scatter_last,
    segment_max,
    segment_rank,
    segment_sum,
    seq_cumsum,
    take,
    true_div,
)
from repro_torch.core.types import (
    F32,
    I32,
    EngineConfig,
    PlatformModel,
    RequestBatch,
)
from repro_torch.core.xla_math import _fma32


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
        return self.submit_time.shape[-2]

    @property
    def depth(self) -> int:
        return self.submit_time.shape[-1]

    @staticmethod
    def empty(num_sqs: int, depth: int, device,
              lead: Tuple[int, ...] = ()) -> "SQRings":
        """Empty rings; ``lead=(M,)`` gives an array's, one set a drive."""
        shape = tuple(lead) + (num_sqs, depth)

        def z():
            return torch.zeros(shape, dtype=I32, device=device)

        return SQRings(
            submit_time=torch.full(shape, 3e38, dtype=F32, device=device),
            opcode=z(), lba=z(),
            nblocks=torch.ones(shape, dtype=I32, device=device),
            buf_id=z(), req_id=z(), tenant=z(),
            head=torch.zeros(shape[:-1], dtype=I32, device=device),
            tail=torch.zeros(shape[:-1], dtype=I32, device=device),
        )


_RING_FIELDS = ("submit_time", "opcode", "lba", "nblocks", "buf_id",
                "req_id", "tenant")


def scatter_drop(
    field: torch.Tensor, rows: torch.Tensor, pos: torch.Tensor,
    val: torch.Tensor,
) -> torch.Tensor:
    """``field.at[rows, pos].set(val, mode="drop")`` on a (..., Q, D, ...)
    ring field, drive by drive: entries whose ``pos`` is outside
    ``[0, D)`` are dropped, and of several entries for one slot the last
    one wins. ``val`` is ``pos``'s shape plus the field's trailing axes."""
    rest = tuple(val.shape[pos.dim():])
    nlead = field.dim() - 2 - len(rest)
    lead = tuple(field.shape[:nlead])
    q, d = field.shape[nlead], field.shape[nlead + 1]
    keep = (pos >= 0) & (pos < d)
    flat = torch.where(keep, rows.long() * d + pos.long(), q * d)
    out = scatter_last(field.reshape(lead + (q * d,) + rest),
                       flat.expand(pos.shape).reshape(lead + (-1,)),
                       val.reshape(lead + (-1,) + rest))
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
    pos = torch.remainder(take(rings.tail, row) + offset, rings.depth)
    # Invalid rows scatter out of bounds and are dropped.
    pos = torch.where(valid, pos, rings.depth)
    new = (submit_time, opcode, lba, nblocks, buf_id, req_id, tenant)
    fields = {
        name: scatter_drop(getattr(rings, name), row, pos,
                           val.expand(pos.shape))
        for name, val in zip(_RING_FIELDS, new)
    }
    counts = segment_sum(valid.to(I32), sq_key, q + 1)[..., :q]
    return dataclasses.replace(rings, **fields, tail=rings.tail + counts)


def submit_grouped(
    rings: SQRings,
    submit_time: torch.Tensor,  # (..., Q, F) — row q targets SQ q
    opcode: torch.Tensor,
    lba: torch.Tensor,
    nblocks: torch.Tensor,
    buf_id: torch.Tensor,
    req_id: torch.Tensor,
    valid: torch.Tensor,        # (..., Q, F) bool
    tenant: "torch.Tensor | None" = None,
    fused: bool = False,
) -> SQRings:
    """Append row q's valid entries to SQ q in array order (rows must be
    pre-sorted by submit time).

    ``fused`` moves the seven fields in one stacked (Q, F, 7) scatter, the
    six i32 fields riding as raw float32 bits (``Tensor.view``) — bits are
    moved, never converted, so the rings land bit-identical.
    """
    q, f = submit_time.shape[-2:]
    dev = submit_time.device
    if tenant is None:
        tenant = torch.zeros_like(opcode)
    offset = torch.cumsum(valid.to(I32), -1, dtype=I32) - 1
    pos = torch.remainder(rings.tail[..., None] + offset, rings.depth)
    pos = torch.where(valid, pos, rings.depth)  # dropped
    rows = torch.arange(q, dtype=I32, device=dev)[:, None].expand(pos.shape)
    tail = rings.tail + torch.sum(valid.to(I32), dim=-1, dtype=I32)
    new = tuple(x.expand(pos.shape) for x in (
        submit_time, opcode, lba, nblocks, buf_id, req_id, tenant))

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
    pos = torch.remainder(rings.head[..., None] + j, d)        # (..., Q, F)
    valid = j < nfetch[..., None]                              # (..., Q, F)
    rows = torch.arange(q, dtype=I32, device=dev)[:, None]
    flat = tuple(pos.shape[:-2]) + (-1,)
    p = pos.long()

    def gather(field):
        return take(field, p).reshape(flat)

    batch = RequestBatch(
        arrival=gather(rings.submit_time),   # provisional: submit time
        sq_id=rows.expand(pos.shape).reshape(flat),
        slot=pos.reshape(flat),
        opcode=gather(rings.opcode),
        lba=gather(rings.lba),
        nblocks=gather(rings.nblocks),
        buf_id=gather(rings.buf_id),
        req_id=gather(rings.req_id),
        valid=valid.reshape(flat),
        tenant=gather(rings.tenant),
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
    lead = tuple(disp_time.shape[:-1])
    active_u = disp_time <= clock[..., None]                        # (U,)
    active = torch.repeat_interleave(active_u, per_unit, dim=-1)    # (Q,)
    nfetch = torch.where(active, nfetch, 0)
    cost = fetch_cost(nfetch, cfg, plat)
    cost = torch.where(active, cost, 0.0)

    cum = seq_cumsum(cost.reshape(lead + (u, per_unit)), -1)
    start = torch.maximum(disp_time, clock[..., None])              # (U,)
    fetch_done_sq = (start[..., None] + cum).reshape(lead + (qs,))  # (Q,)
    disp_time = start + cum[..., -1]

    batch, _ = _gather_entries(rings, nfetch, f)
    fetch_done = torch.repeat_interleave(fetch_done_sq, f, dim=-1)
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
    # self-pacing
    nfetch = torch.where(disp_time[..., :1] <= clock[..., None], nfetch, 0)

    per_entry = _per_entry_cost(cfg, plat)
    cost = nfetch.to(F32) * per_entry + plat.doorbell_poll_us
    cum = seq_cumsum(cost, -1)
    start = torch.maximum(disp_time[..., :1], clock[..., None])
    sq_base = start + cum - cost                                    # (Q,)
    disp_time = start + cum[..., -1:]

    batch, _ = _gather_entries(rings, nfetch, f)
    # Entry j of SQ q completes fetching at base_q + (j+1)*per_entry.
    j1 = torch.arange(1, f + 1, dtype=F32, device=nfetch.device)[None, :]
    fetch_done = (sq_base[..., None] + j1 * per_entry).reshape(
        tuple(sq_base.shape[:-1]) + (-1,))
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


def direct_fetch_times(
    disp_time: torch.Tensor,  # (U,) f32 dispatcher busy-until cursors
    t_submit: torch.Tensor,   # (N,) f32 virtual submission times
    valid: torch.Tensor,      # (N,) bool
    cfg: EngineConfig,
    plat: PlatformModel,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The ring-less frontend of a directly submitted flat batch (a test
    path: ``DevicePipeline._fetch_direct``; every consumer goes through the
    SQ rings). Requests are dealt to the U units in contiguous runs of
    ``ceil(N / U)``, and each unit's dispatcher streams its run in, one
    coalesced transaction per ``fetch_width`` entries (or one a request
    when coalescing is off).

    The compiled reference turns ``sqe_bytes / bw`` into a product with
    the float32 reciprocal of ``bw`` and fuses both products of
    ``start + n_txn*txn + (rank+1)*sqe*(1/bw)`` (and the uncoalesced
    ``start + (rank+1)*per_entry``) into its adds, one rounding each
    (pinned through ``jax.jit``); ``_fma32`` does the same. Returns
    (fetch_done (N,), disp_time' (U,), unit (N,)), ``unit``
    non-decreasing."""
    n = t_submit.shape[-1]
    u = disp_time.shape[-1]
    per_unit = -(-n // u)
    idx = torch.arange(n, dtype=I32, device=t_submit.device)
    unit = torch.div(idx, per_unit, rounding_mode="floor")
    rank = idx - unit * per_unit
    start = torch.maximum(t_submit, take(disp_time, unit))
    r1 = (rank + 1).to(F32)
    if cfg.coalesced:
        if cfg.transport == "host":
            txn, bw = plat.host_txn_base_us, plat.host_bytes_per_us
        else:
            txn, bw = plat.txn_base_us, plat.link_bytes_per_us
        n_txn = (torch.div(rank, cfg.fetch_width, rounding_mode="floor")
                 + 1).to(F32)
        at_txn = _fma32(n_txn, torch.full_like(n_txn, float(np.float32(txn))),
                        start)
        recip = float(np.float32(1.0) / np.float32(bw))
        fetch_done = _fma32(r1 * float(np.float32(plat.sqe_bytes)),
                            torch.full_like(r1, recip), at_txn)
    else:
        fetch_done = _fma32(
            r1, torch.full_like(r1, _per_entry_cost(cfg, plat)), start)
    fetch_done = torch.where(valid, fetch_done, 0.0)
    disp_time = torch.maximum(segment_max(fetch_done, unit, u), disp_time)
    return fetch_done, disp_time, unit


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
    pos = torch.remainder(rings.head[..., None] + j, d)
    t = take(rings.submit_time, pos)
    in_ring = j < (rings.tail - rings.head)[..., None]
    vis = (t <= clock[..., None, None]) & in_ring
    lead = torch.cumprod(vis.to(I32), dim=-1, dtype=I32)
    return torch.sum(lead, dim=-1, dtype=I32)
