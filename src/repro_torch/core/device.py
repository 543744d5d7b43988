"""The layered device pipeline (port of ``repro/core/device.py``).

``DevicePipeline.process`` composes, for one fetched ``RequestBatch``:

    stage 2a  the global timing lock over the admission ``Epoch``
    stage 2b  target completion times (``timing.update``)
    stage 3   the backend data path (DSA offload or baseline workers)
    stage 4   the flash backend (writes, GC, mapping misses)
    stage 5   posting to the CQ paired with each SQ and reaping (``qp``),
              neutral or coalescing

(Stage 0, the page cache, sits in front of the rings: ``core/cache.py``,
driven by the engine and the client.) A remote drive
(``EngineConfig.fabric.remote``) wraps the target-side stages in two
fabric hops (``core/fabric.py``): stage 1.5 sends the fetched SQEs and
write payloads through the shared switch port (when it has a finite
roof) and the drive's TX link, and stage 4.5 returns completions and
read payloads over the RX link and back through the switch, before the
CQ. ``EngineConfig.lock_order`` picks how service units take the global
timing lock: in unit index order (``"program"``) or in the order their
batches became ready (``"ready_time"``), whole unit blocks then entering
the timing model in that order. ``EngineConfig.timing_scope="local"``
gives each service unit its own 1/U slice of the timing state and no
shared lock (the paper's rejected design, §IV-D).

``EngineConfig.sanitize`` adds the reference's fifteen invariant checks
to every pass (``_sanitize_checks``: ring indices in bounds, completion
times monotone and non-negative, the valid mask conserved through the
admission and compaction permutations, flash pages and fabric cursors).
They only observe: each ORs its bit into a small int32 flag tensor on the
run's device (``new_flags``), nothing is read back inside a round, and
the runner reads the flags once after the run and raises
``SanitizeError`` with the reference's message for the first check that
failed (``raise_if_flagged``). No check is a device-side assert, which
would leave the CUDA context unusable.

The ring-less direct path (``_fetch_direct``, ``_submit_direct``,
``make_direct_batch``) lets tests probe stages 2-4 on a flat batch with
no SQ machinery; every consumer goes through the rings.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.cuda_graph import map_leaves
from repro_torch.core import datapath, frontend, qp, segops, timing
from repro_torch.core import fabric as fabric_mod
from repro_torch.core.epoch import (
    Epoch, admission_row_order, unit_ready_order,
)
from repro_torch.core.fabric import FabricState
from repro_torch.core.flash import FlashState, flash_stage
from repro_torch.core.qp import CQRings
from repro_torch.core.types import (
    F32,
    I32,
    EngineConfig,
    PlatformModel,
    RequestBatch,
    SSDConfig,
    TimingState,
)


@dataclasses.dataclass(frozen=True)
class DeviceState:
    """All virtual-time emulator-side state for one emulated device."""

    tstate: TimingState       # shared timing model (busy_until + rr cursor)
    disp_time: torch.Tensor   # (U,) dispatcher busy-until cursors
    work_time: torch.Tensor   # (U, W) baseline worker lanes busy-until
    dsa_time: torch.Tensor    # (U,) DSA engine busy-until cursors
    lock_time: torch.Tensor   # ()  global timing-lock busy-until
    map_time: torch.Tensor    # ()  global map/unmap-lock busy-until
    flash: FlashState         # stage-4 flash-array state
    fabric: FabricState       # NIC/link cursors (remote drives only)

    @staticmethod
    def init(ssd: SSDConfig, num_units: int, workers_per_unit: int,
             num_tenants: int, device) -> "DeviceState":
        def zeros(*shape):
            return torch.zeros(shape, dtype=F32, device=device)

        return DeviceState(
            tstate=TimingState.init(ssd.n_instances, device),
            disp_time=zeros(num_units),
            work_time=zeros(num_units, workers_per_unit),
            dsa_time=zeros(num_units),
            lock_time=zeros(),
            map_time=zeros(),
            flash=FlashState.init(ssd, device),
            fabric=FabricState.init(num_tenants, device),
        )

    @property
    def num_units(self) -> int:
        return self.disp_time.shape[-1]


@dataclasses.dataclass(frozen=True)
class PipelineResult:
    """Per-request virtual-time outcome of one pipeline pass (all (N,))."""

    arrival: torch.Tensor     # post-lock dispatch time (timing-model input)
    target: torch.Tensor      # timing-model completion (device fidelity)
    ready: torch.Tensor       # data-path completion (copy landed)
    flash_done: torch.Tensor  # flash-backend completion
    done: torch.Tensor        # max(target, ready, flash_done), 0 if invalid
    reaped: torch.Tensor      # when the consumer observed the completion


def acquire_lock(
    lock_time: torch.Tensor,
    epoch: Epoch,
    num_units: int,
    cfg: EngineConfig,
    plat: PlatformModel,
) -> Tuple[torch.Tensor, torch.Tensor, "torch.Tensor | None"]:
    """Serialize service units on the global timing-model lock:
    ``done_u = max(t, ready_u) + cost_u``, folded unit by unit exactly as
    the reference's sequential scan. The cost is per request (the
    per-request baseline: every request takes the lock) or per batch
    (aggregated mode); an array's drives each hold their own lock
    (``lock_time`` (M,)). Returns ``(lock_time', lock_done (U,),
    unit_order)``.

    ``lock_order="program"`` folds the units in index order
    (``unit_order`` is None). ``"ready_time"`` folds them in order of
    their batch ready time (ties by index), each drive its own order:
    ready times and costs are gathered through the (..., U) permutation,
    the grants scatter back to unit order, and the permutation is
    returned so that the timing model dispatches in the same order.

    The local timing scope has no shared lock: each unit's grant is its
    own batch ready time, and ``unit_order`` is None."""
    if cfg.timing_scope == "local":
        return lock_time, epoch.unit_ready(num_units), None
    n_valid_u = epoch.unit_counts(num_units)
    batch_ready = epoch.unit_ready(num_units)
    if cfg.mode == "per_request":
        cost = n_valid_u.to(F32) * float(np.float32(plat.lock_per_req_us))
    else:
        cost = torch.where(
            n_valid_u > 0, float(np.float32(plat.lock_per_batch_us)), 0.0
        )
    unit_order = None
    if cfg.lock_order == "ready_time":
        unit_order = unit_ready_order(batch_ready)
        o = unit_order.long()
        batch_ready, cost = segops.take(batch_ready, o), segops.take(cost, o)
    t = lock_time
    grants = []
    for u in range(num_units):
        t = torch.maximum(t, batch_ready[..., u]) + cost[..., u]
        grants.append(t)
    granted = torch.stack(grants, dim=-1)
    if unit_order is not None:
        granted = segops.unsort(granted, unit_order)
    return t, granted, unit_order


def init_array_state(init_fn: Callable[[int], object], num_devices: int):
    """Stacked per-drive state with a leading ``(M,)`` axis on every leaf.

    ``init_fn(salt)`` builds one drive's state tree (frozen dataclasses of
    tensors) for drive index ``salt``; the M trees, built with salts
    0..M-1, are stacked leaf by leaf. Salt-aware initializers (the
    engine's workload prefill) give distinct per-drive streams,
    salt-oblivious ones identical drives. ``engine.init_array_state`` and
    ``StorageClient.init_array_state`` are thin adapters over it.
    """
    if num_devices < 1:
        raise ValueError(f"num_devices={num_devices} must be >= 1")
    trees = [init_fn(d) for d in range(num_devices)]
    return map_leaves(lambda *xs: torch.stack(xs), *trees)


# The reference's messages, one a check, in its order; check i sets bit i.
SANITIZE_MESSAGES = (
    "sanitize: valid row carries an SQ id outside [0, num_sqs) — "
    "the CQ scatter would silently drop its completion",
    "sanitize: valid row carries a ring slot outside [0, sq_depth)",
    "sanitize: negative post-lock arrival time on a valid row",
    "sanitize: timing-model completion precedes its arrival",
    "sanitize: data-path completion precedes its arrival",
    "sanitize: negative flash-backend completion time",
    "sanitize: CQ reap time precedes the wire completion it reaps",
    "sanitize: a dispatcher/lock busy-until cursor moved backwards",
    "sanitize: admission dispatch_order is not a permutation — "
    "some rows would be double-priced and others dropped",
    "sanitize: valid-mask not conserved through the admission "
    "permutation",
    "sanitize: epoch compaction does not conserve the valid "
    "mask (pos is not a permutation or n_valid drifted)",
    "sanitize: per-CQ valid counts do not sum to the epoch's "
    "valid count",
    "sanitize: flash page accounting went negative (free or live "
    "page underflow — GC cannot keep up or double-counted)",
    "sanitize: a flash die busy-until cursor moved backwards",
    "sanitize: a fabric serialization cursor moved backwards",
)


class SanitizeError(RuntimeError):
    """A sanitized run broke a pipeline invariant. The message is the
    reference's for the first check (in the reference's order) that
    failed; ``bits`` holds every failed check's bit."""

    def __init__(self, bits: int):
        self.bits = bits
        first = (bits & -bits).bit_length() - 1
        super().__init__(SANITIZE_MESSAGES[first])


def new_flags(device) -> torch.Tensor:
    """A cleared flag tensor for a sanitized run: () int32 on ``device``."""
    return torch.zeros((), dtype=I32, device=device)


def raise_if_flagged(flags: torch.Tensor) -> None:
    """Read the flags once (one sync) and raise ``SanitizeError`` if any
    check failed."""
    bits = int(flags.item())
    if bits:
        raise SanitizeError(bits)


def _wrap(idx: torch.Tensor, n: int) -> torch.Tensor:
    """A negative index counted from the end, as JAX indexing reads it."""
    return torch.where(idx < 0, idx + n, idx)


def _hits(idx: torch.Tensor, n: int) -> torch.Tensor:
    """How often each row 0..n-1 of each drive occurs in ``idx``, as the
    reference's dropped scatter counts it: a negative index from the end,
    one still outside [0, n) nowhere."""
    idx = _wrap(idx, n)
    key = torch.where((idx >= 0) & (idx < n), idx, n)
    return segops.segment_sum(torch.ones_like(key), key, n + 1)[..., :n]


def _sanitize_checks(
    cfg: EngineConfig,
    prev: DeviceState,
    new: DeviceState,
    batch: RequestBatch,
    res: PipelineResult,
    dispatch_order: "torch.Tensor | None",
    cq_counts: "torch.Tensor | None",
    flags: torch.Tensor,
) -> None:
    """The reference's ``EngineConfig.sanitize`` checks, ORed into
    ``flags`` (bit i for ``SANITIZE_MESSAGES[i]``) on its device. Pure
    observation: no value of the pass changes, so a sanitized run's state
    is bit for bit the unsanitized one's. A check over an array fails if
    it fails on any drive. Indices are clamped where they are read, so a
    corrupt index sets its bit instead of faulting."""
    valid = batch.valid
    dev = valid.device
    false = torch.zeros((), dtype=torch.bool, device=dev)

    def rows_bad(pred: torch.Tensor) -> torch.Tensor:
        return torch.any(valid & ~pred)

    def bad(pred: torch.Tensor) -> torch.Tensor:
        return ~torch.all(pred)

    n = valid.shape[-1]
    nv = torch.sum(valid.to(I32), dim=-1, dtype=I32)
    perm_bad = perm_valid_bad = compact_bad = counts_bad = false
    if dispatch_order is not None:
        perm_bad = bad(_hits(dispatch_order, n) == 1)
        # The reference's gather wraps a negative index and clamps.
        moved = segops.take(
            valid, torch.clamp(_wrap(dispatch_order, n), 0, n - 1))
        perm_valid_bad = bad(
            torch.sum(moved.to(I32), dim=-1, dtype=I32) == nv)
    if cfg.use_compaction:
        plan = segops.compact_epoch(valid)
        compact_bad = bad(_hits(plan.pos, n) == 1) | bad(plan.n_valid == nv)
    if cq_counts is not None:
        counts_bad = bad(
            torch.sum(cq_counts.to(I32), dim=-1, dtype=I32) == nv)
    fp, ff, fn_ = prev.fabric, new.fabric, new.flash
    violated = torch.stack([
        rows_bad((batch.sq_id >= 0) & (batch.sq_id < cfg.num_sqs)),
        rows_bad((batch.slot >= 0) & (batch.slot < cfg.sq_depth)),
        rows_bad(res.arrival >= 0.0),
        rows_bad(res.target >= res.arrival),
        rows_bad(res.ready >= res.arrival),
        rows_bad(res.flash_done >= 0.0),
        rows_bad(res.reaped >= res.done),
        bad(new.disp_time >= prev.disp_time)
        | bad(new.lock_time >= prev.lock_time),
        perm_bad,
        perm_valid_bad,
        compact_bad,
        counts_bad,
        bad((fn_.free_pages >= 0.0) & (fn_.valid_pages >= 0.0)),
        bad(fn_.chip_busy >= prev.flash.chip_busy),
        bad(ff.tx_busy >= fp.tx_busy) | bad(ff.rx_busy >= fp.rx_busy)
        | bad(ff.switch_tx >= fp.switch_tx)
        | bad(ff.switch_rx >= fp.switch_rx),
    ])
    bit = torch.arange(len(SANITIZE_MESSAGES), dtype=I32, device=dev)
    flags.bitwise_or_(torch.sum(violated.to(I32) << bit, dtype=I32))


@dataclasses.dataclass(frozen=True)
class DevicePipeline:
    """Static composition of the stages for one device model."""

    cfg: EngineConfig
    ssd: SSDConfig
    plat: PlatformModel

    @property
    def num_units(self) -> int:
        return self.cfg.num_units if self.cfg.frontend == "distributed" else 1

    def init_state(self, device) -> DeviceState:
        return DeviceState.init(
            self.ssd, self.num_units, self.cfg.workers_per_unit,
            self.cfg.fabric.num_tenants, device,
        )

    def _fetch_direct(
        self,
        state: DeviceState,
        t_submit: torch.Tensor,  # (N,) f32
        valid: torch.Tensor,     # (N,) bool
    ) -> Tuple[DeviceState, torch.Tensor, torch.Tensor]:
        """Fetch a directly submitted flat batch (no SQ rings; a test path
        to stages 2-4, ``frontend.direct_fetch_times``). Returns (state',
        fetch_done (N,), unit (N,))."""
        fetch_done, disp_time, unit = frontend.direct_fetch_times(
            state.disp_time, t_submit, valid, self.cfg, self.plat
        )
        return (
            dataclasses.replace(state, disp_time=disp_time), fetch_done, unit
        )

    def init_cq(self, device) -> CQRings:
        """Fresh CQ rings shaped to mirror the configured SQ rings."""
        return CQRings.empty(self.cfg.num_sqs, self.cfg.sq_depth, device)

    def process(
        self,
        state: DeviceState,
        batch: RequestBatch,
        fetch_done: torch.Tensor,  # (N,) per-row fetch completion times
        unit: torch.Tensor,        # (N,) i32 non-decreasing service-unit ids
        cq: "CQRings | None" = None,
        ring_layout: bool = False,
        flags: Optional[torch.Tensor] = None,
    ) -> Tuple[DeviceState, "CQRings | None", PipelineResult]:
        """Timing model under the global lock, then the data path, the
        flash backend and the CQ completion path. ``ring_layout=True``
        promises the SQ-major fixed-width layout of the ring gather (so
        the compaction path may use block reductions); ``cq=None`` skips
        stage 5. An array's state and batch carry a leading ``(M,)`` drive
        axis on every leaf (``unit`` may stay (N,), shared by the drives);
        each drive is priced as a call on its own would price it.

        With ``cfg.sanitize`` the pass ORs its checks into ``flags``
        (``new_flags``) in place; a sanitized pass without them raises, so
        the setting is never silently inert."""
        cfg, ssd, plat = self.cfg, self.ssd, self.plat
        if cfg.sanitize and flags is None:
            raise ValueError(
                "cfg.sanitize needs a flag tensor (device.new_flags)")
        fab = cfg.fabric
        u = state.num_units
        valid = batch.valid
        unit = unit.expand(valid.shape)
        tenant = batch.tenants if fab.num_tenants > 1 else None

        compact = cfg.use_compaction
        blocky = compact and ring_layout
        pallas = cfg.resolve_pallas_segscan(ssd, plat)
        unit_rank = (
            segops.presorted_plan(unit).rank if cfg.use_sort_plan else None
        )
        if blocky:
            cq_rank = segops.block_masked_rank(valid, cfg.fetch_width)
            cq_counts = segops.block_counts(valid, cfg.fetch_width)
        else:
            cq_rank = (
                segops.masked_presorted_rank(batch.sq_id, valid)
                if cfg.use_sort_plan else None
            )
            cq_counts = None

        # -- stage 1.5: fabric TX hop (remote drives only): the shared
        # switch port first (fan-out), then this drive's own link.
        links = state.fabric
        fab_tx, fab_rx = links.tx_busy, links.rx_busy
        sw_tx, sw_rx = links.switch_tx, links.switch_rx
        if fab.remote:
            tx_bytes = fabric_mod.tx_wire_bytes(batch, plat.sqe_bytes, ssd)
            if fab.switched:
                sw_tx, fetch_done = fabric_mod.switch_hop(
                    sw_tx, fetch_done, tx_bytes, valid, fab, tenant,
                    use_pallas=pallas,
                )
            fab_tx, fetch_done = fabric_mod.fabric_hop(
                fab_tx, fetch_done, tx_bytes, valid, fab,
                fab.tx_bytes_per_us, tenant, use_pallas=pallas,
            )

        # -- stage 2a: global timing-model lock over the admission epoch;
        # the post-TX fetch times are its ready times.
        epoch = Epoch.from_batch(
            batch, fetch_done, unit, "ring" if ring_layout else "direct"
        )
        n_valid_u = epoch.unit_counts(u)
        lock_time, lock_done, unit_order = acquire_lock(
            state.lock_time, epoch, u, cfg, plat
        )
        disp_time = torch.maximum(state.disp_time, lock_done)
        epoch = epoch.admit(lock_done)
        arrival = epoch.arrival

        # -- stage 2b: target completion times, dispatched in lock
        # acquisition order under the ready-time lock (a row permutation:
        # data movement only).
        tbatch = dataclasses.replace(batch, arrival=arrival)
        dispatch_order = (
            admission_row_order(unit_order, epoch, u)
            if unit_order is not None else None
        )
        if cfg.timing_scope == "local":
            tstate, target = timing.local_scope_update(
                state.tstate, arrival, valid, ssd, u, use_compaction=compact,
            )
        else:
            tstate, target = timing.update(
                state.tstate, tbatch, ssd, cfg.mode, use_compaction=compact,
                dispatch_order=dispatch_order,
            )

        # -- stage 3: backend data transfer.
        if cfg.batched_datapath:
            # The DSA engine also carried the fetch transfer: bump its
            # cursors by the fetched bytes (integer-valued f32 sums are
            # exact in any order).
            sqe = float(np.float32(plat.sqe_bytes))
            if blocky:
                fetch_bytes_u = n_valid_u.to(F32) * sqe
            else:
                fetch_bytes_u = segops.segment_sum(
                    torch.where(valid, sqe, 0.0), unit, u
                )
            dsa_time0 = state.dsa_time + segops.true_div(
                fetch_bytes_u, plat.dsa_bytes_per_us
            )
            dsa_time, ready = datapath.dsa_worker_times(
                dsa_time0, arrival, batch, cfg, plat, ssd, unit=unit
            )
            work_time, map_time = state.work_time, state.map_time
        else:
            work_time, map_time, ready = datapath.baseline_worker_times(
                state.work_time, state.map_time, arrival, batch, cfg, plat,
                ssd, unit=unit, unit_rank=unit_rank,
                use_counting_sort=compact,
            )
            dsa_time = state.dsa_time

        # -- stage 4: flash-level backend (writes, GC, mapping misses).
        if ssd.flash_backend:
            fstate, flash_done = flash_stage(
                state.flash, batch, arrival, target, ssd, use_pallas=pallas,
                use_counting_sort=compact,
                use_pallas_flash=cfg.use_pallas_flash,
            )
        else:
            fstate, flash_done = state.flash, torch.where(valid, arrival, 0.0)

        done = torch.where(
            valid, torch.maximum(torch.maximum(target, ready), flash_done),
            0.0,
        )

        # -- stage 4.5: fabric RX hop: this drive's link, then the shared
        # switch port all return streams converge on (incast).
        if fab.remote:
            rx_bytes = fabric_mod.rx_wire_bytes(batch, fab, ssd)
            fab_rx, wire_done = fabric_mod.fabric_hop(
                fab_rx, done, rx_bytes, valid, fab, fab.rx_bytes_per_us,
                tenant, use_pallas=pallas,
            )
            if fab.switched:
                sw_rx, wire_done = fabric_mod.switch_hop(
                    sw_rx, wire_done, rx_bytes, valid, fab, tenant,
                    use_pallas=pallas,
                )
            wire_done = torch.where(valid, wire_done, 0.0)
        else:
            wire_done = done

        new_state = DeviceState(
            tstate=tstate, disp_time=disp_time, work_time=work_time,
            dsa_time=dsa_time, lock_time=lock_time, map_time=map_time,
            flash=fstate,
            fabric=FabricState(tx_busy=fab_tx, rx_busy=fab_rx,
                               switch_tx=sw_tx, switch_rx=sw_rx),
        )

        # -- stage 5: post to the CQ and reap (queue-pair layer).
        if cq is None:
            reaped = wire_done
        else:
            cq, reaped = qp.post_and_reap(
                cq, batch.sq_id, wire_done, batch.req_id, valid, cfg.qp,
                posted_rank=cq_rank, use_pallas=pallas, posted_counts=cq_counts,
                fused_scatter=compact, use_pallas_reap=cfg.use_pallas_reap,
            )
        res = PipelineResult(
            arrival=arrival, target=target, ready=ready,
            flash_done=flash_done, done=done, reaped=reaped,
        )
        if cfg.sanitize:
            _sanitize_checks(cfg, state, new_state, batch, res,
                             dispatch_order, cq_counts, flags)
        return new_state, cq, res

    def _submit_direct(
        self,
        state: DeviceState,
        batch: RequestBatch,
    ) -> Tuple[DeviceState, PipelineResult]:
        """``_fetch_direct`` then ``process`` with no rings on either side
        (a test path). The batch's ``opcode`` decides read or write
        pricing. A sanitized call raises ``SanitizeError`` if a check
        failed."""
        state, fetch_done, unit = self._fetch_direct(
            state, batch.arrival, batch.valid
        )
        flags = new_flags(batch.valid.device) if self.cfg.sanitize else None
        state, _, res = self.process(state, batch, fetch_done, unit,
                                     flags=flags)
        if flags is not None:
            raise_if_flagged(flags)
        return state, res


def make_direct_batch(
    lba: torch.Tensor,
    t_submit,
    valid: Optional[torch.Tensor] = None,
    opcode: Optional[torch.Tensor] = None,
    nblocks: Optional[torch.Tensor] = None,
    tenant: Optional[torch.Tensor] = None,
) -> RequestBatch:
    """A ``RequestBatch`` for ring-less direct submission (a test path):
    SQ, slot and buffer 0, request ids 0..N-1, all rows valid and single
    blocks unless given, ``t_submit`` broadcast to (N,) float32."""
    n = lba.shape[0]
    dev = lba.device
    z = torch.zeros((n,), dtype=I32, device=dev)
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=dev)
    t_submit = torch.as_tensor(t_submit, dtype=F32, device=dev).expand(n)
    return RequestBatch(
        arrival=t_submit.clone(),
        sq_id=z, slot=z,
        opcode=z if opcode is None else opcode,
        lba=lba.to(I32),
        nblocks=(torch.ones((n,), dtype=I32, device=dev) if nblocks is None
                 else nblocks),
        buf_id=z,
        req_id=torch.arange(n, dtype=I32, device=dev),
        valid=valid,
        tenant=z if tenant is None else tenant,
    )
