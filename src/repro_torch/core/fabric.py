"""Fabric layer: the NIC/link hop to a remote drive (port of
``repro/core/fabric.py``).

A remote drive's fetched SQEs (plus write payloads) cross a TX link
before the timing model sees them, and its completions (plus read
payloads) cross an RX link back before they are posted to the CQ. One
``fabric_hop`` prices a whole epoch's frames in time order: frames pack
into MTU batches of ``mtu_batch`` per wire transaction (flushed early
once the oldest has waited ``mtu_timeout_us``), each transaction pays
``wire_txn_us`` plus its bytes at the link bandwidth on a serialized
cursor, and each direction adds half the RTT. A frame ready only after
its batch flushed ships as its own transaction. Cursors advance only
where a frame carries cost, so an ``inf`` wire is an exact no-op.

``switch_hop`` adds the shared switch port an array's links converge on,
at the fair per-link share ``switch_bytes_per_us / switch_fanin``. With
more than one entry in ``qos_weights`` every shared resource keeps one
cursor per tenant class and serves the tenants active in an epoch at
their weighted share (``_gps_serve``); one class gives the unweighted
path bit for bit.

Every tensor may carry leading drive axes: cursors are ``(..., T)`` and
frames ``(..., N)``, one row of cursors a drive.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.segops import (
    NEG,
    lex_sort_by_segment,
    queueing_scan,
    segment_max,
    segmented_prefix_max,
    take,
    unsort,
)
from repro_torch.core.types import (
    F32, I32, OP_WRITE, FabricConfig, RequestBatch, SSDConfig,
)


def _f32(x: float) -> float:
    """A Python float rounded to float32 (the reference's jnp.float32)."""
    return float(np.float32(x))


def _per(x: torch.Tensor, rate: float) -> torch.Tensor:
    """``x / float32(rate)`` as the reference's compiled hop computes it:
    XLA turns a division by a compiled constant into a product with its
    float32 reciprocal (``inf`` gives 0)."""
    return x * float(np.float32(1.0) / np.float32(rate))


@dataclasses.dataclass(frozen=True)
class FabricState:
    """Per-drive link state: one (..., T) cursor per tenant class per
    resource (T = ``FabricConfig.num_tenants``). ``switch_tx`` and
    ``switch_rx`` are the drive's cursors on the shared switch port."""

    tx_busy: torch.Tensor    # (T,) f32 initiator->target cursors
    rx_busy: torch.Tensor    # (T,) f32 target->initiator cursors
    switch_tx: torch.Tensor  # (T,) f32 shared-switch cursors, TX direction
    switch_rx: torch.Tensor  # (T,) f32 shared-switch cursors, RX direction

    @staticmethod
    def init(num_tenants: int, device) -> "FabricState":
        def z():
            return torch.zeros((num_tenants,), dtype=F32, device=device)

        return FabricState(tx_busy=z(), rx_busy=z(), switch_tx=z(),
                           switch_rx=z())


def tx_wire_bytes(batch: RequestBatch, sqe_bytes: int,
                  ssd: SSDConfig) -> torch.Tensor:
    """Outbound bytes per frame: the SQE plus any write payload."""
    payload = torch.where(
        batch.opcode == OP_WRITE,
        batch.nblocks.to(F32) * _f32(ssd.block_bytes), 0.0,
    )
    return _f32(sqe_bytes) + payload


def rx_wire_bytes(batch: RequestBatch, fab: FabricConfig,
                  ssd: SSDConfig) -> torch.Tensor:
    """Return bytes per frame: the CQE plus any read payload."""
    payload = torch.where(
        batch.opcode != OP_WRITE,
        batch.nblocks.to(F32) * _f32(ssd.block_bytes), 0.0,
    )
    return _f32(fab.cqe_bytes) + payload


def _frame_layout(
    t_ready: torch.Tensor,
    valid: torch.Tensor,
    tenant: "torch.Tensor | None",
    fab: FabricConfig,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The epoch layout shared by the link and switch hops: frames by
    ready time, then segmented by tenant class (invalid rows a trailing
    pseudo-segment ``T``), time order kept within a segment. Returns
    ``(order, heads, rank, key_clip)``, the last the clipped tenant id of
    each row of the layout. The reference's two forms (two stable sorts,
    or one lexicographic sort under ``fused_sort``) are one permutation,
    which ``segops.lex_sort_by_segment`` computes."""
    t = fab.num_tenants
    if tenant is None or t == 1:
        cls = torch.zeros_like(valid, dtype=I32)
    else:
        cls = torch.clamp(tenant, 0, t - 1).to(I32)
    key = torch.where(valid, cls, t).to(I32)
    order, heads, rank = lex_sort_by_segment(key, t_ready)
    return order, heads, rank, torch.clamp(take(key, order), 0, t - 1)


def _gps_serve(
    busy: torch.Tensor,      # (..., T) per-tenant cursors of this resource
    ready: torch.Tensor,     # (..., N) f32 frame-ready times (epoch layout)
    cost: torch.Tensor,      # (..., N) f32 full-bandwidth cost per frame
    s_valid: torch.Tensor,   # (..., N) bool
    heads: torch.Tensor,     # (..., N) bool tenant-segment heads
    key_clip: torch.Tensor,  # (..., N) i32 clipped tenant id per row
    fab: FabricConfig,
    use_pallas: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Serve one epoch on per-tenant cursors at weighted shares: tenant
    k's frames run the single-server recurrence on cursor k with costs
    times ``sum(active w) / w_k``. Returns ``(busy', sent)``; cursors
    advance only where a frame carried cost.

    The weights enter as Python floats (a ``where`` a tenant, no host
    copy inside a captured round). With one class the factor is exactly
    1.0, so the cost goes in as it is. The costs' cumulative sum on the
    ``seg_scan`` route adds in ``jnp.cumsum``'s order, since the
    fabric's costs are fractional."""
    t = fab.num_tenants
    if t > 1:
        w = [_f32(x) for x in fab.qos_weights]
        active = torch.clamp(
            segment_max(s_valid.to(F32), key_clip, t), min=0.0)
        act_w = w[0] * active[..., 0]
        for k in range(1, t):
            act_w = act_w + w[k] * active[..., k]
        act_w = torch.where(act_w > 0.0, act_w, 1.0)
        w_row = torch.full_like(cost, w[0])
        for k in range(1, t):
            w_row = torch.where(key_clip == k, w[k], w_row)
        eff = cost * (act_w[..., None] / w_row)
    else:
        eff = cost
    sent = queueing_scan(ready, eff, heads, take(busy, key_clip),
                         use_pallas=use_pallas, seq_sum=True)
    busy = torch.maximum(
        busy,
        segment_max(torch.where(s_valid & (cost > 0.0), sent, NEG),
                    key_clip, t),
    )
    return busy, sent


def fabric_hop(
    busy: torch.Tensor,     # (..., T) f32 this direction's link cursors
    t_ready: torch.Tensor,  # (..., N) f32 frame-ready times
    nbytes: torch.Tensor,   # (..., N) f32 wire bytes per frame
    valid: torch.Tensor,    # (..., N) bool
    fab: FabricConfig,
    bytes_per_us: float,
    tenant: "torch.Tensor | None" = None,  # (..., N) i32 QoS class
    use_pallas: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Price one epoch's frames over one link direction. Returns
    ``(busy', t_out)``: when each frame's last byte lands on the far side
    (MTU flush, serialized transmission, half-RTT propagation). Invalid
    rows pass through untouched."""
    order, heads, rank, key_clip = _frame_layout(t_ready, valid, tenant,
                                                 fab)
    o = order.long()
    s_t = take(t_ready, o)
    s_valid = take(valid, o)
    s_bytes = take(nbytes, o)

    # MTU batches: runs of mtu_batch frames within a tenant segment. A
    # batch ships when it fills (its last member's ready time) or its
    # flush timer expires (first member + mtu_timeout_us), whichever is
    # earlier; a frame ready after that flush ships at its own time.
    gheads = heads | (torch.remainder(rank, fab.mtu_batch) == 0)
    last = torch.ones_like(gheads[..., :1])
    tails = torch.cat([gheads[..., 1:], last], dim=-1)
    first = segmented_prefix_max(torch.where(gheads, s_t, NEG), gheads)
    full = segmented_prefix_max(
        torch.where(tails, s_t, NEG).flip(-1), tails.flip(-1)
    ).flip(-1)
    bell = torch.minimum(full, first + _f32(fab.mtu_timeout_us))
    ready = torch.maximum(s_t, bell)

    # Serialized transmission: NIC setup at each batch head and for each
    # post-flush straggler, bytes at the link bandwidth.
    cost = torch.where(s_valid, _per(s_bytes, bytes_per_us), 0.0)
    cost = cost + torch.where((gheads | (s_t > bell)) & s_valid,
                              _f32(fab.wire_txn_us), 0.0)
    busy, sent = _gps_serve(busy, ready, cost, s_valid, heads, key_clip,
                            fab, use_pallas=use_pallas)
    landed = sent + _f32(0.5 * fab.rtt_us)
    return busy, torch.where(valid, unsort(landed, order), t_ready)


def switch_hop(
    busy: torch.Tensor,     # (..., T) f32 this lane's shared-switch cursors
    t_ready: torch.Tensor,  # (..., N) f32 frame-ready times
    nbytes: torch.Tensor,   # (..., N) f32 wire bytes per frame
    valid: torch.Tensor,    # (..., N) bool
    fab: FabricConfig,
    tenant: "torch.Tensor | None" = None,  # (..., N) i32 QoS class
    use_pallas: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Price one epoch's frames through the shared switch port, at the
    lane's share ``switch_bytes_per_us / switch_fanin``: no MTU batching,
    NIC setup or propagation, only bytes through the port share on the
    per-tenant cursors. An ``inf`` roof never advances them."""
    order, heads, _, key_clip = _frame_layout(t_ready, valid, tenant, fab)
    o = order.long()
    s_t = take(t_ready, o)
    s_valid = take(valid, o)
    cost = torch.where(
        s_valid, _per(take(nbytes, o), fab.switch_share_bytes_per_us),
        0.0)
    busy, sent = _gps_serve(busy, s_t, cost, s_valid, heads, key_clip,
                            fab, use_pallas=use_pallas)
    return busy, torch.where(valid, unsort(sent, order), t_ready)
