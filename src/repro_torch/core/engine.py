"""Closed-loop emulation engine (port of ``repro/core/engine.py``).

One round: dispatchers fetch newly visible SQ entries (frontend), the
shared ``DevicePipeline`` prices them (lock, timing model, data path,
flash backend, CQ post and reap), the metrics and the functional block
copies are updated, and the workload resubmits each completed slot.
With ``cfg.cache`` enabled the round's completed reads fill the stage-0
page cache (``core/cache.py``) and the resubmissions pass through it
first: a read that hits completes at ``hit_us`` and its slot proposes its
next request at once, up to ``chase`` times a round (``_chase``, a static
loop), so ``req_counter`` advances by ``n * (chase + 1)``.

``run`` is the eager body, a Python loop over rounds, as the reference's
``run`` is the body that its ``make_runner`` compiles. On a card,
``make_runner`` captures one ``engine_round`` into a CUDA graph
(``repro_torch/cuda_graph.py``) at its first call and replays it once a
round on static state buffers; on the CPU it runs the eager loop. No
round reads a value back to the host. Entry points run on ``cuda`` unless
the caller names a device, and raise when no card is present and none was
named.

An M-drive array (``init_array_state``, ``make_array_runner``,
``simulate(num_devices=M)``) is the same round on a state whose every
leaf has a leading ``(M,)`` drive axis, where the reference vmaps: each
stage reduces, scans, gathers and scatters per drive, so drive d's leaves
are bit for bit those of a single drive of salt d, and one array round is
one CUDA graph whose engine kernels launch once each for all M drives.

``make_runner(sanitize=True)`` (or ``cfg.sanitize``) runs the pipeline's
invariant checks in every round (``device._sanitize_checks``): they write
a flag tensor on the run's device, which is one more static buffer of the
captured round, and the runner reads it once after the run and raises
``device.SanitizeError``. The checks only observe, so the final state is
the unsanitized run's bit for bit; with sanitize off a round runs none of
them.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import cuda_graph
from repro_torch.core import cache as cache_mod
from repro_torch.core import datapath, frontend, segops
from repro_torch.core import device as device_mod
from repro_torch.core.cache import CacheState
from repro_torch.core.device import DevicePipeline, DeviceState
from repro_torch.core.device import init_array_state as init_array_state_of
from repro_torch.core.frontend import SQRings
from repro_torch.core.qp import CQRings
from repro_torch.core.segops import segment_sum
from repro_torch.core.types import (
    F32,
    I32,
    OP_READ,
    EngineConfig,
    PlatformModel,
    SSDConfig,
    WorkloadConfig,
    resolve_device,
)
from repro_torch.core.xla_math import lane_sum
from repro_torch.workloads import Workload, as_workload

FAR = 3e38

HIST_BUCKETS = 64


# Lower edge of buckets 1..63 as float32 bit patterns: the smallest
# latency that the reference's compiled float32 formula
# ``clip(log10(max(lat, 1e-6)) * 64/5, 0, 63)`` puts in each bucket. Its
# float32 ``log10`` rounds its own way within an ULP or two of each edge,
# so the port compares against the edges it produces instead of taking a
# logarithm: every device then buckets a latency exactly as the reference
# does (tests/test_torch_engine.py checks every edge and its neighbours).
_EDGE_BITS = (
    0x3f993a15, 0x3fb76cf5, 0x3fdb9378, 0x40036cf4, 0x401d53df, 0x403c55a4,
    0x406173d4, 0x4086f160, 0x40a189c0, 0x40c15ff5, 0x40e77c71, 0x410a8de6,
    0x4125dc7b, 0x41468cce, 0x416dae66, 0x418e4328, 0x41aa4cd3, 0x41cbdd1c,
    0x41f40acc, 0x421211d3, 0x422edb95, 0x425151d1, 0x427a92c4, 0x4295fa94,
    0x42b3898f, 0x42d6ebe8, 0x4300a3c3, 0x4319fe1c, 0x433857a0, 0x435cac60,
    0x43841519, 0x439e1d24, 0x43bd4691, 0x43e2943f, 0x44079e00, 0x44225868,
    0x44425754, 0x4468a495, 0x448b3f28, 0x44a6b0aa, 0x44c78ad2, 0x44eede76,
    0x450ef929, 0x452b26b0, 0x454ce1ee, 0x457542fb, 0x4592ccb0, 0x45afbb49,
    0x45d25d9f, 0x45fbd350, 0x4616ba70, 0x46346f41, 0x4657fedf, 0x46814857,
    0x469ac31b, 0x46b94372, 0x46ddc6b3, 0x4704be14, 0x471ee768, 0x473e38b8,
    0x4763b620, 0x47884b85, 0x47a32816,
)


@functools.lru_cache(maxsize=8)
def _edges_on(device: torch.device) -> torch.Tensor:
    bits = torch.tensor(_EDGE_BITS, dtype=torch.int64).to(I32)
    return bits.view(F32).to(device)


def latency_bucket(lat_us: torch.Tensor) -> torch.Tensor:
    """Histogram bucket index for an E2E latency (elementwise, i32)."""
    edges = _edges_on(lat_us.device)
    return torch.searchsorted(edges, lat_us, right=True).to(I32)


def _bucket_of(lat_us: float) -> int:
    """``latency_bucket`` of one float32 latency, on the host."""
    bits = np.array(_EDGE_BITS, dtype=np.uint32).view(np.float32)
    return int(np.searchsorted(bits, np.float32(lat_us), side="right"))


# The percentile each bucket reports, as float32 bit patterns: the
# reference's ``1.0 * 10 ** ((idx + 0.5) * 5/64)`` in float32, whose power
# is XLA's ``powf``. ``torch.pow`` on the card rounds some of them an ULP
# apart (buckets 36 and 40 among them: 710.4973754882812 for
# 710.4974365234375), so the port looks the value up
# (tests/test_torch_engine.py checks all 64 against the reference).
_PCT_BITS = (
    0x3f8c0bec, 0x3fa7a5cc, 0x3fc8b041, 0x3ff03dbf, 0x400fcb69, 0x402c2263,
    0x404e0f36, 0x4076abb0, 0x4093a493, 0x40b0bdb7, 0x40d392f7, 0x40fd45ad,
    0x4117981b, 0x4135789a, 0x41593c81, 0x41820673, 0x419ba6b5, 0x41ba53e6,
    0x41df0cd6, 0x42058147, 0x421fd11b, 0x423f5078, 0x426504ff, 0x428913f2,
    0x42a4180b, 0x42c46f33, 0x42eb260e, 0x430cbf18, 0x43287c49, 0x4349b103,
    0x4371711b, 0x43908361, 0x43acfe9d, 0x43cf16d7, 0x43f7e746, 0x44146178,
    0x44319fd6, 0x4454a1a7, 0x447e89b6, 0x44985a0e, 0x44b660c6, 0x44da526f,
    0x4502accd, 0x451c6dd9, 0x453b4249, 0x45602a34, 0x45862c15, 0x45a09d93,
    0x45c0453c, 0x45e62a00, 0x4609c353, 0x4624e9fc, 0x46456a84, 0x466c52e7,
    0x468d732a, 0x46a953d8, 0x46cab30e, 0x46f2a601, 0x47113c44, 0x472ddbf1,
    0x47501fca, 0x47792470, 0x47951f4e, 0x47b28316,
)


@functools.lru_cache(maxsize=8)
def _percentiles_on(device: torch.device) -> torch.Tensor:
    bits = torch.tensor(_PCT_BITS, dtype=torch.int64).to(I32)
    return bits.view(F32).to(device)


def _row_percentile(h: torch.Tensor, q: float) -> torch.Tensor:
    """``hist_percentile`` of each row of a (..., HIST_BUCKETS) table."""
    c = torch.cumsum(h, -1, dtype=F32)
    idx = torch.argmax((c >= q * c[..., -1:]).to(I32), dim=-1)
    return _percentiles_on(h.device)[idx]


def hist_percentile(hist: torch.Tensor, q: float) -> torch.Tensor:
    """Approximate latency percentile: the geometric midpoint of the first
    bucket where the CDF reaches ``q``."""
    return _row_percentile(hist.reshape(-1, HIST_BUCKETS).sum(dim=0), q)


def _sum(vals: torch.Tensor) -> torch.Tensor:
    """A round's float32 latency sum per drive (over the last axis),
    accumulated in double and rounded once. The n terms are latencies
    (not negative), so any order of double additions lands within
    n * 2^-53 of the exact sum, relative (2^-40 at ``local_1drive``'s 8192
    rows); the card (a tree) and the CPU (another order) then round to the
    same float32 unless the exact sum lies that close to a float32
    rounding midpoint."""
    return torch.sum(vals, dim=-1, dtype=torch.float64).to(F32)


def _group_sum(vals: torch.Tensor, seg: torch.Tensor, k: int) -> torch.Tensor:
    """Per-group float sum as ``_sum``, (..., k) (a masked row sum — no
    atomics, whose order varies on the card)."""
    groups = torch.arange(k, dtype=seg.dtype, device=seg.device)
    return torch.where(seg[..., None, :] == groups[:, None],
                       vals[..., None, :], 0.0).sum(
        dim=-1, dtype=torch.float64).to(F32)


@dataclasses.dataclass(frozen=True)
class Metrics:
    completed: torch.Tensor        # f32 count
    fetched: torch.Tensor          # f32 count
    sum_e2e: torch.Tensor          # f32 us (reap - submit)
    sum_target: torch.Tensor       # f32 us (timing-model latency)
    sum_proc: torch.Tensor         # f32 us (copy-ready - dispatch)
    last_completion: torch.Tensor  # f32 us max completion time seen
    first_submit: torch.Tensor     # f32 us min submit time seen
    lat_hist: torch.Tensor         # (HIST_BUCKETS,) f32 E2E histogram
    cache_hits: torch.Tensor       # f32 count of stage-0 cache hits
    tenant_completed: torch.Tensor  # (T,) f32
    tenant_sum_e2e: torch.Tensor    # (T,) f32 us
    tenant_lat_hist: torch.Tensor   # (T, HIST_BUCKETS) f32

    @staticmethod
    def zero(num_tenants: int, device) -> "Metrics":
        def z(*shape, v=0.0):
            return torch.full(shape, v, dtype=F32, device=device)

        return Metrics(
            z(), z(), z(), z(), z(), z(), z(v=FAR),
            z(HIST_BUCKETS), z(),
            z(num_tenants), z(num_tenants), z(num_tenants, HIST_BUCKETS),
        )

    def iops(self) -> torch.Tensor:
        """Virtual-time sustained IOPS (requests per emulated second)."""
        span = torch.clamp(self.last_completion - self.first_submit, min=1e-6)
        return self.completed / span * 1e6

    def avg_e2e_us(self) -> torch.Tensor:
        return self.sum_e2e / torch.clamp(self.completed, min=1.0)

    def avg_target_us(self) -> torch.Tensor:
        return self.sum_target / torch.clamp(self.completed, min=1.0)

    def avg_proc_us(self) -> torch.Tensor:
        return self.sum_proc / torch.clamp(self.completed, min=1.0)

    def hit_rate(self) -> torch.Tensor:
        """Fraction of completed requests served by the stage-0 cache."""
        return self.cache_hits / torch.clamp(self.completed, min=1.0)

    def _pooled(self, x: torch.Tensor) -> torch.Tensor:
        """(T,) per-tenant counts with any leading drive axes summed
        away (integer-valued, exact in any order)."""
        return x.reshape(-1, x.shape[-1]).sum(dim=0)

    def tenant_share(self) -> torch.Tensor:
        """(T,) fraction of device completions per tenant; an array's
        drives are summed first."""
        c = self._pooled(self.tenant_completed)
        return c / torch.clamp(torch.sum(c), min=1.0)

    def tenant_avg_e2e_us(self) -> torch.Tensor:
        """(T,) mean consumer-observed latency per tenant. An array's
        per-drive sums add in the reference's compiled order
        (``xla_math.lane_sum`` over the drive axis)."""
        t = self.tenant_sum_e2e.shape[-1]
        s = lane_sum(self.tenant_sum_e2e.reshape(-1, t).T)
        return s / torch.clamp(self._pooled(self.tenant_completed), min=1.0)

    def _pooled_tenant_hist(self) -> torch.Tensor:
        """(T, HIST_BUCKETS) with any leading drive axes summed away."""
        t = self.tenant_completed.shape[-1]
        return self.tenant_lat_hist.reshape(-1, t, HIST_BUCKETS).sum(dim=0)

    def tenant_p99_us(self) -> torch.Tensor:
        """(T,) per-tenant p99 E2E latency (device completions only)."""
        return _row_percentile(self._pooled_tenant_hist(), 0.99)

    def tenant_p50_us(self) -> torch.Tensor:
        """(T,) per-tenant median E2E latency (device completions only)."""
        return _row_percentile(self._pooled_tenant_hist(), 0.50)

    def slo_attainment(self, slo_us: float) -> torch.Tensor:
        """(T,) fraction of each tenant's device completions whose bucket's
        lower edge is at or under ``slo_us`` (an empty tenant reports
        1.0). The bucket of ``slo_us`` is the compiled reference's
        (``latency_bucket``'s edges)."""
        h = self._pooled_tenant_hist()
        ok = torch.arange(HIST_BUCKETS, device=h.device) <= _bucket_of(slo_us)
        met = torch.sum(torch.where(ok, h, 0.0), dim=-1)
        tot = torch.sum(h, dim=-1)
        return torch.where(tot > 0, met / torch.clamp(tot, min=1.0), 1.0)

    def p50_us(self) -> torch.Tensor:
        return hist_percentile(self.lat_hist, 0.50)

    def p95_us(self) -> torch.Tensor:
        return hist_percentile(self.lat_hist, 0.95)

    def p99_us(self) -> torch.Tensor:
        return hist_percentile(self.lat_hist, 0.99)


@dataclasses.dataclass(frozen=True)
class EngineState:
    """One drive's state, or an M-drive array's with a leading ``(M,)``
    axis on every leaf (``init_array_state``)."""

    rings: SQRings              # submission half of the queue pairs
    cq: CQRings                 # completion half (SQ q pairs with CQ q)
    device: DeviceState         # the pipeline's virtual-time state
    cache: Optional[CacheState]  # stage-0 page cache (None when off)
    clock: torch.Tensor         # () f32 virtual now
    flash: torch.Tensor         # (num_blocks, block_words) emulated flash
    bufs: torch.Tensor          # (num_bufs, block_words) I/O buffers
    req_counter: torch.Tensor   # () i32 next request id
    salt: torch.Tensor          # () i32 per-device workload salt
    last_submit: torch.Tensor   # (Q,) f32 newest submit time per SQ
    metrics: Metrics


def init_state(
    cfg: EngineConfig,
    ssd: SSDConfig,
    wl: "Workload | WorkloadConfig",
    block_words: int = 16,
    salt: int = 0,
    device: "torch.device | str | None" = None,
) -> EngineState:
    """Rings pre-filled from the workload generator at t~0, on ``device``
    (``cuda`` unless named)."""
    device = resolve_device(device)
    wl = as_workload(wl)
    if wl.precondition_drive:
        ssd = ssd.replace(preconditioned=True)
    pipe = DevicePipeline(cfg, ssd, PlatformModel())
    q, dep = cfg.num_sqs, cfg.sq_depth
    rings = SQRings.empty(q, dep, device)

    pre = wl.prefill(cfg, ssd, salt, device)
    n_pre = pre.req_id.shape[0] * pre.req_id.shape[1]
    buf_id = torch.remainder(pre.req_id, cfg.num_bufs).to(I32)
    rings = frontend.submit_grouped(
        rings, pre.submit, pre.opcode, pre.lba, pre.nblocks, buf_id,
        pre.req_id, pre.valid, tenant=pre.tenant,
        fused=cfg.use_compaction,
    )

    nb = ssd.num_blocks if cfg.emulate_data else 1
    nbuf = cfg.num_bufs if cfg.emulate_data else 1
    flash = (
        torch.arange(nb, dtype=F32, device=device)[:, None]
        + segops.true_div(
            torch.arange(block_words, dtype=F32, device=device)[None, :],
            block_words,
        )
    )
    bufs = torch.zeros((nbuf, block_words), dtype=F32, device=device)
    last_submit = torch.amax(torch.where(pre.valid, pre.submit, 0.0), dim=1)
    return EngineState(
        rings=rings,
        cq=pipe.init_cq(device),
        device=pipe.init_state(device),
        cache=(CacheState.init(cfg.cache, device) if cfg.cache.enabled
               else None),
        clock=torch.zeros((), dtype=F32, device=device),
        flash=flash,
        bufs=bufs,
        req_counter=torch.tensor(n_pre, dtype=I32, device=device),
        salt=torch.tensor(salt, dtype=I32, device=device),
        last_submit=last_submit,
        metrics=Metrics.zero(
            max(cfg.fabric.num_tenants, getattr(wl, "num_tenants", 1)),
            device,
        ),
    )


@dataclasses.dataclass(frozen=True)
class _Proposals:
    """Each slot's next request: id, LBA, opcode, submit time, validity."""

    req: torch.Tensor
    lba: torch.Tensor
    op: torch.Tensor
    t: torch.Tensor
    valid: torch.Tensor


def _chase(cstate, prop: _Proposals, m: Metrics, req_counter, tenant_rows,
           anchor, cfg, ssd, wl, salt) -> "tuple[_Proposals, Metrics]":
    """The stage-0 hit chase of one round. A proposed read that hits
    completes at GPU-local latency without posting an SQE, and its slot
    proposes its next request at once (ids ``req_counter + n*(k+1) +
    slot``), up to ``chase`` hits a slot a round; what survives (the first
    miss, or the last proposal) enters the rings. The hits add to the
    metrics as the reference adds them, after the device completions: a
    static loop with no read back to the host."""
    ccfg = cfg.cache
    n = prop.req.shape[-1]
    lead = tuple(prop.req.shape[:-1])
    device = prop.req.device
    hit_us = float(np.float32(ccfg.hit_us))
    zero = torch.zeros(lead, dtype=F32, device=device)
    hits, hit_e2e, hit_last = zero, zero, zero
    hit_first = torch.full(lead, FAR, dtype=F32, device=device)
    for k in range(ccfg.chase):
        hit, done_h = cache_mod.serve(
            cstate, prop.lba, prop.valid & (prop.op == OP_READ), prop.t,
            ccfg)
        nh = torch.sum(hit.to(F32), dim=-1)
        hits = hits + nh
        hit_e2e = hit_e2e + nh * hit_us
        hit_last = torch.maximum(
            hit_last, torch.amax(torch.where(hit, done_h, 0.0), dim=-1))
        hit_first = torch.minimum(
            hit_first, torch.amin(torch.where(hit, prop.t, FAR), dim=-1))
        ids = (req_counter[..., None] + n * (k + 1)
               + torch.arange(n, dtype=I32, device=device))
        s_t, s_valid = wl.next_submit(ids, done_h, hit, anchor, cfg, ssd,
                                      salt)
        prop = _Proposals(
            req=torch.where(hit, ids, prop.req),
            lba=torch.where(hit, wl.address(ids, ssd, salt), prop.lba),
            op=torch.where(hit, wl.opcode(ids, salt, tenant=tenant_rows),
                           prop.op),
            t=torch.where(hit, s_t, prop.t),
            valid=torch.where(hit, s_valid, prop.valid),
        )
    # Every hit of the round lands in the bucket of hit_us (one bucket).
    bucket = torch.zeros_like(m.lat_hist)
    bucket[..., _bucket_of(ccfg.hit_us)] = hits
    return prop, dataclasses.replace(
        m,
        completed=m.completed + hits,
        sum_e2e=m.sum_e2e + hit_e2e,
        last_completion=torch.maximum(m.last_completion, hit_last),
        first_submit=torch.minimum(m.first_submit, hit_first),
        lat_hist=m.lat_hist + bucket,
        cache_hits=m.cache_hits + hits,
    )


def engine_round(
    state: EngineState,
    cfg: EngineConfig,
    ssd: SSDConfig,
    wl: "Workload | WorkloadConfig",
    plat: PlatformModel,
    flags: Optional[torch.Tensor] = None,
) -> EngineState:
    """One round of one drive, or of every drive of an array (a leading
    ``(M,)`` axis on every leaf): each drive's leaves come out as a round
    of that drive alone would leave them, and each engine kernel launches
    once for all the drives. A sanitized round ORs its checks into
    ``flags``."""
    wl = as_workload(wl)
    pipe = DevicePipeline(cfg, ssd, plat)
    q, f = cfg.num_sqs, cfg.fetch_width
    device = state.clock.device
    lead = tuple(state.clock.shape)

    # -- 1. frontend fetch ---------------------------------------------------
    rings, disp_time, batch, fetch_done = frontend.fetch(
        state.rings, state.clock, state.device.disp_time, cfg, plat
    )
    submit_t = batch.arrival                       # provisional = submit time
    n = batch.valid.shape[-1]
    unit = frontend.fetch_row_units(cfg, device)

    # -- 2-5. the device pipeline (timing + data path + flash + QP) ----------
    dev = dataclasses.replace(state.device, disp_time=disp_time)
    dev, cqr, res = pipe.process(
        dev, batch, fetch_done, unit, state.cq, ring_layout=True,
        flags=flags,
    )

    # -- completion metrics: the consumer observes ``reaped`` ----------------
    valid = batch.valid
    valid_f = valid.to(F32)
    done = res.reaped
    e2e = torch.where(valid, done - submit_t, 0.0)
    tgt_lat = torch.where(valid, res.target - res.arrival, 0.0)
    proc = torch.where(valid, res.ready - res.arrival, 0.0)
    nvalid = torch.sum(valid_f, dim=-1)
    bucket = latency_bucket(e2e)
    lat_hist = segment_sum(valid_f, bucket, HIST_BUCKETS)
    n_ten = state.metrics.tenant_completed.shape[-1]
    t_bucket = torch.clamp(batch.tenants, 0, n_ten - 1)
    tenant_completed = segment_sum(valid_f, t_bucket, n_ten)
    tenant_sum_e2e = _group_sum(e2e, t_bucket, n_ten)
    tenant_lat_hist = segment_sum(
        valid_f, t_bucket * HIST_BUCKETS + bucket, n_ten * HIST_BUCKETS
    ).reshape(lead + (n_ten, HIST_BUCKETS))

    # -- functional data movement --------------------------------------------
    flash, bufs = state.flash, state.bufs
    if cfg.emulate_data:
        bufs = datapath.apply_reads(flash, bufs, batch, cfg.use_pallas)
        flash = datapath.apply_writes(flash, bufs, batch)

    # -- workload-driven resubmission ----------------------------------------
    salt = state.salt[..., None]
    sqs = torch.arange(q, dtype=I32, device=device)
    tenant_rows = torch.repeat_interleave(
        wl.tenant_of_sq(sqs, cfg, salt), f
    ).expand(lead + (n,))
    new_req = state.req_counter[..., None] + torch.arange(
        n, dtype=I32, device=device)
    new_lba = wl.address(new_req, ssd, salt)
    new_op = wl.opcode(new_req, salt, tenant=tenant_rows)
    anchor = torch.repeat_interleave(state.last_submit, f, dim=-1)
    resub_t, resub_valid = wl.next_submit(
        new_req, done, valid, anchor, cfg, ssd, salt
    )

    m = state.metrics
    metrics = Metrics(
        completed=m.completed + nvalid,
        fetched=m.fetched + nvalid,
        sum_e2e=m.sum_e2e + _sum(e2e),
        sum_target=m.sum_target + _sum(tgt_lat),
        sum_proc=m.sum_proc + _sum(proc),
        last_completion=torch.maximum(
            m.last_completion,
            torch.amax(torch.where(valid, done, 0.0), dim=-1),
        ),
        first_submit=torch.minimum(
            m.first_submit,
            torch.amin(torch.where(valid, submit_t, FAR), dim=-1),
        ),
        lat_hist=m.lat_hist + lat_hist,
        cache_hits=m.cache_hits,
        tenant_completed=m.tenant_completed + tenant_completed,
        tenant_sum_e2e=m.tenant_sum_e2e + tenant_sum_e2e,
        tenant_lat_hist=m.tenant_lat_hist + tenant_lat_hist,
    )

    # -- stage 0: the page cache filters the resubmissions -------------------
    cstate, ccfg = state.cache, cfg.cache
    ids_per_round = n
    if ccfg.enabled:
        # Fills: this round's completed device reads are now resident.
        cstate = cache_mod.insert(
            cstate, batch.lba, valid & (batch.opcode == OP_READ), ccfg)
        prop = _Proposals(new_req, new_lba, new_op, resub_t, resub_valid)
        prop, metrics = _chase(cstate, prop, metrics, state.req_counter,
                               tenant_rows, anchor, cfg, ssd, wl, salt)
        new_req, new_lba, new_op = prop.req, prop.lba, prop.op
        resub_t, resub_valid = prop.t, prop.valid
        ids_per_round = n * (ccfg.chase + 1)

    resub_t = torch.where(resub_valid, resub_t, FAR)
    last_submit = torch.maximum(
        state.last_submit,
        torch.amax(
            torch.where(resub_valid, resub_t, 0.0).reshape(lead + (q, f)),
            dim=-1,
        ),
    )
    # Rows are SQ-major (q, f); sort each SQ's resubmissions by time.
    rt = resub_t.reshape(lead + (q, f))
    order = segops.stable_argsort(rt, dim=-1).long()

    def pick(x):
        return torch.gather(x.expand(lead + (n,)).reshape(lead + (q, f)), -1,
                            order)

    rings = frontend.submit_grouped(
        rings,
        pick(resub_t),
        pick(new_op),
        pick(new_lba),
        torch.ones(lead + (q, f), dtype=I32, device=device),
        pick(batch.buf_id),
        pick(new_req),
        pick(resub_valid),
        tenant=pick(tenant_rows),
        fused=cfg.use_compaction,
    )

    # -- clock advance: one poll quantum, or a jump over an idle gap to the
    # earliest pending submission (each drive its own).
    dpos = torch.remainder(rings.head, rings.depth)
    head_t = segops.take(rings.submit_time, dpos[..., None])[..., 0]
    head_t = torch.where(rings.tail > rings.head, head_t, FAR)
    nxt = torch.amin(head_t, dim=-1)
    stepped = state.clock + float(np.float32(cfg.poll_quantum_us))
    clock = torch.where(nxt < FAR, torch.maximum(stepped, nxt), stepped)

    return EngineState(
        rings=rings, cq=cqr, device=dev, cache=cstate, clock=clock,
        flash=flash, bufs=bufs,
        req_counter=state.req_counter + ids_per_round,
        salt=state.salt, last_submit=last_submit, metrics=metrics,
    )


def run(
    state: EngineState,
    cfg: EngineConfig,
    ssd: SSDConfig,
    wl: "Workload | WorkloadConfig",
    plat: PlatformModel,
    rounds: int,
) -> EngineState:
    """Run ``rounds`` engine rounds. A sanitized run raises
    ``device.SanitizeError`` after the last round if a check failed."""
    wl = as_workload(wl)
    flags = (device_mod.new_flags(state.clock.device) if cfg.sanitize
             else None)
    for _ in range(rounds):
        state = engine_round(state, cfg, ssd, wl, plat, flags)
    if flags is not None:
        device_mod.raise_if_flagged(flags)
    return state


def unalias(state: EngineState) -> EngineState:
    """Deep-copy every leaf, so that no two leaves share storage and none
    shares it with ``state``: the copy may be handed to a donating runner
    while ``state`` stays the caller's."""
    return cuda_graph.map_leaves(torch.clone, state)


class _GraphRunner:
    """``rounds`` replays of one captured ``engine_round`` on static state
    buffers (see ``make_runner``)."""

    def __init__(self, cfg, ssd, wl, plat, rounds: int, donate: bool,
                 device: torch.device):
        self.rounds, self.donate = rounds, donate
        self.device = cuda_graph.cuda_index(device)
        # A sanitized round writes its checks into one more static buffer.
        self.flags = (device_mod.new_flags(self.device) if cfg.sanitize
                      else None)
        self.args = (cfg, ssd, wl, plat, self.flags)
        self.static: "EngineState | None" = None
        self.graph: "cuda_graph.Captured | None" = None

    def _round(self) -> EngineState:
        new = engine_round(self.static, *self.args)
        cuda_graph.check_writeback(self.static, new)
        cuda_graph.copy_into(self.static, new)
        return new

    def __call__(self, state: EngineState) -> EngineState:
        if state.clock.device != self.device:
            raise ValueError(
                f"state is on {state.clock.device}, runner on {self.device}")
        if self.graph is None:
            self.static = unalias(state)
            self.graph = cuda_graph.Captured(
                self._round, self.device,
                warm=lambda: engine_round(self.static, *self.args))
        elif state is not self.static:
            cuda_graph.copy_into(self.static, state)
        if self.flags is not None:
            self.flags.zero_()
        self.graph.replay(self.rounds)
        if self.flags is not None:
            device_mod.raise_if_flagged(self.flags)
        return self.static if self.donate else unalias(self.static)


def make_runner(
    cfg: EngineConfig, ssd: SSDConfig, wl, plat: PlatformModel,
    rounds: int, donate: bool = False,
    device: "torch.device | str | None" = None,
    sanitize: bool = False,
) -> Callable[[EngineState], EngineState]:
    """The engine runner with static configs bound, for states on
    ``device`` (``cuda`` unless named).

    On a card the runner captures one ``engine_round`` into a CUDA graph
    at its first call (after one eager warm round on the capture stream)
    and replays it ``rounds`` times on static state buffers; a replay ends
    by writing the new state into those buffers. A capture that fails
    raises. ``donate=False`` copies the caller's state into the buffers,
    leaves it unchanged and returns a copy of the result.
    ``donate=True`` returns the buffers themselves; passing that result
    back skips the copy in, and as in the reference the caller must not
    reuse a donated input. Unlike the reference, a donated *result* is
    valid only until the runner's next call, whatever state that call is
    given: every call rewrites the same buffers, so ``x = r(a)`` followed
    by ``r(b)`` turns ``x`` into ``r(b)``'s result (``unalias(x)`` keeps a
    copy). On the CPU the runner is the eager loop, and ``donate`` only
    permits that reuse.

    ``sanitize=True`` (or ``cfg.sanitize``) runs the invariant checks in
    every round and raises ``device.SanitizeError`` from the runner, after
    the run, on the first violated one; the final state is the
    unsanitized runner's bit for bit.
    """
    device = resolve_device(device)
    if sanitize:
        cfg = cfg.replace(sanitize=True)
    wl = as_workload(wl)
    if device.type == "cuda":
        return _GraphRunner(cfg, ssd, wl, plat, rounds, donate, device)

    def runner(state: EngineState) -> EngineState:
        if state.clock.device.type != device.type:
            raise ValueError(
                f"state is on {state.clock.device}, runner on {device}"
            )
        return run(state, cfg, ssd, wl, plat, rounds)

    return runner


def make_array_runner(
    cfg: EngineConfig, ssd: SSDConfig, wl, plat: PlatformModel,
    rounds: int, donate: bool = False,
    device: "torch.device | str | None" = None,
    sanitize: bool = False,
) -> Callable[[EngineState], EngineState]:
    """The M-drive array runner: ``make_runner``'s contract for a stacked
    state (``init_array_state``: a leading ``(M,)`` axis on every leaf).

    The reference vmaps ``run`` over the drives; here every stage works on
    the drive axis itself, so one ``engine_round`` prices all M drives,
    each as it would be priced alone, and each engine kernel launches once
    a round for the whole array. On a card one array round is one captured
    CUDA graph, replayed ``rounds`` times; ``donate`` and ``sanitize`` as
    in ``make_runner`` (a check fails if it fails on any drive)."""
    runner = make_runner(cfg, ssd, wl, plat, rounds, donate, device,
                         sanitize)

    def array_runner(states: EngineState) -> EngineState:
        if states.clock.dim() != 1:
            raise ValueError(
                "make_array_runner takes a stacked state with a leading "
                f"(M,) axis; its clock is {tuple(states.clock.shape)}")
        return runner(states)

    array_runner.runner = runner
    return array_runner


def make_sharded_array_runner(
    cfg: EngineConfig, ssd: SSDConfig, wl, plat: PlatformModel,
    rounds: int, mesh=None, axis_name: str = "dev",
    device: "torch.device | str | None" = None,
) -> Callable[[EngineState], EngineState]:
    """M-drive array runner sharded over the ranks of a 1-D mesh (the
    reference's ``shard_map`` over a ``(axis_name,)`` mesh).

    Where ``make_array_runner`` prices the whole array on one device, this
    gives each rank M/n of the stacked ``EngineState``'s drives (its block
    of the leading axis) and runs them through ``make_array_runner`` on the
    rank's own device: on a card one captured CUDA graph a round, so no
    collective runs inside a round. The ranks' final states are assembled
    once after the run (one all-gather a dtype, ``_assemble``) into the
    stacked global state every rank returns. M must be divisible by the
    mesh size. Each rank passes the whole global state (every rank holds
    it).

    ``mesh`` defaults to the whole world on a ``(axis_name,)`` mesh of
    ``device``'s type (``cuda`` unless named)."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_axis_mesh, rank_device

    wl = as_workload(wl)
    if mesh is None:
        mesh = make_axis_mesh(axis_name, device)
    n = shd.axis_size(axis_name, mesh)
    i = shd.axis_index(axis_name, mesh)
    group = mesh.get_group(axis_name)
    local_device = rank_device(mesh.device_type)
    runners: dict = {}

    def _run(states: EngineState) -> EngineState:
        m = states.clock.shape[0]
        if m % n != 0:
            raise ValueError(
                f"array of M={m} drives cannot shard over a mesh of "
                f"{n} devices — M must be divisible by the mesh size "
                "(pass a smaller mesh or resize the array)"
            )
        step = m // n
        local = cuda_graph.map_leaves(
            lambda x: x.narrow(0, i * step, step).to(local_device).clone(),
            states)
        if step not in runners:
            runners[step] = make_array_runner(cfg, ssd, wl, plat, rounds,
                                              device=local_device)
        out = runners[step](local)
        return _assemble(out, group, n) if n > 1 else out

    return _run


def _assemble(local: EngineState, group, n: int) -> EngineState:
    """The ranks' blocks of a stacked state, all-gathered into the global
    state: the leaves of each dtype flattened into one buffer, one
    all-gather a dtype, the dtypes in one order on every rank (a set's
    order differs between processes); the gathered buffer is
    rank-major."""
    from repro_torch.distributed import sharding as shd

    leaves = cuda_graph.leaves(local)
    gathered = {}
    for dt in sorted({x.dtype for x in leaves}, key=str):
        mine = [x for x in leaves if x.dtype == dt]
        flat = torch.cat([x.reshape(-1) for x in mine])
        g = shd._gather(flat, group, 0).reshape(n, -1)
        parts = g.split([x.numel() for x in mine], dim=1)
        gathered.update({id(x): p.reshape(n * x.shape[0], *x.shape[1:])
                         for x, p in zip(mine, parts)})
    return cuda_graph.map_leaves(lambda x: gathered[id(x)], local)


def init_array_state(
    cfg: EngineConfig,
    ssd: SSDConfig,
    wl: "Workload | WorkloadConfig",
    num_devices: int,
    block_words: int = 16,
    device: "torch.device | str | None" = None,
) -> EngineState:
    """Stacked ``EngineState`` of an M-drive array on ``device`` (``cuda``
    unless named): a leading ``(M,)`` axis on every leaf, drive d built by
    ``init_state`` with salt d, so salt-aware generators (closed loop,
    Poisson, Zipf) serve M independent request streams. A fixed-trace
    replay is striped through ``Workload.sharded``: drive d replays the
    time-sorted rows i with ``i % M == d``."""
    device = resolve_device(device)
    wl = as_workload(wl).sharded(num_devices)
    return init_array_state_of(
        lambda salt: init_state(cfg, ssd, wl, block_words, salt=salt,
                                device=device),
        num_devices,
    )


def aggregate_iops(state: EngineState) -> torch.Tensor:
    """Virtual IOPS of the drive, or of the array: the sum of the drives'
    sustained rates, accumulated in double and rounded once (as ``_sum``),
    so that the card and the CPU give one float32 whatever their order."""
    return torch.sum(state.metrics.iops(), dtype=torch.float64).to(F32)


def simulate(
    cfg: EngineConfig,
    ssd: SSDConfig,
    wl: "Workload | WorkloadConfig",
    plat: Optional[PlatformModel] = None,
    rounds: int = 64,
    block_words: int = 16,
    num_devices: int = 1,
    device: "torch.device | str | None" = None,
) -> EngineState:
    """Convenience: init + run on ``device``. Returns the final state.

    With ``num_devices=M > 1`` the state has a leading (M,) axis on every
    leaf (an emulated M-drive array in one program); the array's
    throughput is ``aggregate_iops(state)``, and the histogram
    percentiles already pool the drives."""
    plat = plat or PlatformModel()
    device = resolve_device(device)
    if num_devices == 1:
        state = init_state(cfg, ssd, wl, block_words, device=device)
        return make_runner(cfg, ssd, wl, plat, rounds, device=device)(state)
    states = init_array_state(cfg, ssd, wl, num_devices, block_words,
                              device=device)
    return make_array_runner(cfg, ssd, wl, plat, rounds,
                             device=device)(states)
