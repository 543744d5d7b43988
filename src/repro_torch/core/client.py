"""Accelerator-initiated storage client in virtual time (port of
``repro/core/client.py``).

``StorageClient.submit(state, flash, ops)`` is the single entry point: a
``StorageOps`` batch (opcode, LBA, tenant and submission clock per slot)
is posted as SQEs into real ``SQRings`` (dealt round-robin across the
service units' SQs), fetched by the engine's own frontend, priced by the
shared ``DevicePipeline.process`` and reaped from the paired CQs, in as
many fetch passes as the batch needs. The functional block store is
updated and gathered beside it. ``submit_array`` prices an (M, N)
batch over an M-drive array (every leaf of the state with a leading
``(M,)`` axis, one shared block store) in one pass of the same path, and
``submit_striped`` deals a flat batch round-robin over the drives.
Everything else is a thin wrapper:

    read / write                  homogeneous single-drive batches
    read_array / write_array      per-drive (M, N) batches
    read_striped                  flat batch striped over W <= M drives
    read_replicated               least-loaded replica routing
    write_replicated              replica fan-out, durable at the slowest

With ``cfg.cache.enabled`` the state carries the stage-0 page cache
(``core/cache.py``; an array's stacked, one a drive): read hits complete
at ``hit_us`` and never post an SQE, and every valid op fills the cache
(write-allocate). With ``cfg.fabric.remote`` every drive sits behind
its own TX/RX link (and the shared switch port, if it has a finite roof),
priced inside ``DevicePipeline.process``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

import numpy as np

from repro_torch.core import cache as cache_mod
from repro_torch.core import frontend
from repro_torch.core.cache import CacheState
from repro_torch.core.device import DevicePipeline, DeviceState
from repro_torch.core.device import init_array_state as _stack_states
from repro_torch.core.frontend import SQRings, scatter_drop
from repro_torch.core.qp import CQRings
from repro_torch.core.segops import (
    scatter_last,
    segment_rank,
    stable_argsort,
    take,
)
from repro_torch.core.xla_math import lane_mean
from repro_torch.core.types import (
    F32,
    I32,
    OP_WRITE,
    EngineConfig,
    PlatformModel,
    SSDConfig,
    StorageOps,
    resolve_device,
)


@dataclasses.dataclass(frozen=True)
class ClientState:
    """Virtual-time device state carried across application steps."""

    dev: DeviceState
    cache: Optional[CacheState] = None   # stage-0 GPU page cache


@dataclasses.dataclass(frozen=True)
class StorageClient:
    ssd: SSDConfig
    cfg: EngineConfig
    plat: PlatformModel = PlatformModel()

    @property
    def pipeline(self) -> DevicePipeline:
        return DevicePipeline(self.cfg, self.ssd, self.plat)

    def init_state(self, device: "torch.device | str | None" = None
                   ) -> ClientState:
        """Fresh state on ``device`` (``cuda`` unless named), shaped from
        ``cfg`` exactly as ``engine_round`` prices with; with the page cache
        on, an empty cache."""
        device = resolve_device(device)
        return ClientState(
            dev=self.pipeline.init_state(device),
            cache=(CacheState.init(self.cfg.cache, device)
                   if self.cfg.cache.enabled else None),
        )

    def init_array_state(self, num_devices: int,
                         device: "torch.device | str | None" = None
                         ) -> ClientState:
        """Fresh stacked state of an M-drive array on ``device``: every
        leaf with a leading ``(M,)`` axis."""
        device = resolve_device(device)
        return _stack_states(lambda _: self.init_state(device), num_devices)

    # -- the shared SQ -> pipeline -> CQ ring path --------------------------
    def _submit_through_rings(
        self,
        dev: DeviceState,
        lba: torch.Tensor,       # (N,) i32
        t_submit: torch.Tensor,  # (N,) f32
        valid: torch.Tensor,     # (N,) bool
        opcode: torch.Tensor,    # (N,) i32
        tenant: "torch.Tensor | None" = None,  # (N,) i32 QoS class
    ) -> Tuple[DeviceState, torch.Tensor]:
        """Post a flat batch as SQEs, fetch + process + reap via the CQs.
        Returns (dev', done (N,) in the original request order). An
        array's state and (M, N) batch price each drive's row as that
        drive alone; the ring capacity holds per drive."""
        cfg, plat, pipe = self.cfg, self.plat, self.pipeline
        n = lba.shape[-1]
        lead = tuple(lba.shape[:-1])
        device = lba.device
        q, f = cfg.num_sqs, cfg.fetch_width
        if n > q * cfg.sq_depth:
            raise ValueError(
                f"batch of {n} requests exceeds ring capacity "
                f"num_sqs*sq_depth={q * cfg.sq_depth}"
            )

        # Deal time-sorted requests across SQs; req_id carries the
        # original index so completions scatter back to request order.
        order = stable_argsort(t_submit)
        o = order.long()
        sq_id = frontend.deal_sqs(n, cfg, device).expand(lead + (n,))
        zeros = torch.zeros(lead + (n,), dtype=I32, device=device)
        if tenant is None:
            tenant = zeros
        rings = SQRings.empty(q, cfg.sq_depth, device, lead)
        rings = frontend.submit(
            rings, sq_id, take(t_submit, o), take(opcode, o), take(lba, o),
            torch.ones(lead + (n,), dtype=I32, device=device), zeros,
            order.to(I32), take(valid, o), tenant=take(tenant, o),
        )

        cq = CQRings.empty(q, cfg.sq_depth, device, lead)
        row_unit = frontend.fetch_row_units(cfg, device)
        clock = torch.amax(torch.where(valid, t_submit, 0.0), dim=-1)
        done = torch.zeros(lead + (n,), dtype=F32, device=device)
        for _ in range(-(-n // (q * f))):  # ceil: fetch window per pass
            # Dispatchers poll again as soon as they are free (all
            # entries are already posted and visible).
            clock = torch.maximum(clock, torch.amax(dev.disp_time, dim=-1))
            rings, disp_time, batch, fetch_done = frontend.fetch(
                rings, clock, dev.disp_time, cfg, plat
            )
            dev = dataclasses.replace(dev, disp_time=disp_time)
            dev, cq, res = pipe.process(
                dev, batch, fetch_done, row_unit, cq, ring_layout=True
            )
            idx = torch.where(batch.valid, batch.req_id, n)
            done = scatter_last(done, idx, res.reaped)
        return dev, done

    def _priced(
        self,
        state: ClientState,
        lba: torch.Tensor,       # (..., N) i32
        ops: StorageOps,
    ) -> Tuple[ClientState, torch.Tensor]:
        """Stage 0, then the ring path: read hits complete at ``hit_us``
        and stay off the rings; every valid op fills the cache afterwards
        (write-allocate). One drive's batch or an array's (M, N), each
        drive with its own cache. Returns (state', done)."""
        ccfg = self.cfg.cache
        valid = ops.valid
        submit_valid = valid
        if ccfg.enabled:
            hit, hit_done = cache_mod.serve(
                state.cache, lba, valid, ops.t_submit, ccfg)
            hit = hit & (ops.opcode != OP_WRITE)  # only reads hit
            submit_valid = valid & ~hit
        dev, done = self._submit_through_rings(
            state.dev, lba, ops.t_submit, submit_valid, ops.opcode,
            ops.tenant,
        )
        cstate = state.cache
        if ccfg.enabled:
            done = torch.where(hit, hit_done, done)
            cstate = cache_mod.insert(cstate, lba, valid, ccfg)
        return ClientState(dev=dev, cache=cstate), done

    # -- the unified op API --------------------------------------------------
    def submit(
        self,
        state: ClientState,
        flash: torch.Tensor,     # (num_blocks, block_words)
        ops: StorageOps,         # flat (N,) op batch (possibly mixed r/w)
        data: "torch.Tensor | None" = None,  # (N, block_words) payloads
        with_data: bool = False,
    ) -> Tuple[ClientState, torch.Tensor, "torch.Tensor | None",
               torch.Tensor]:
        """One batched op submission. Returns ``(state', flash', data_out,
        done)``: ``flash`` with the valid write slots' ``data`` rows
        scattered in (a new tensor; of several writes to one LBA in a
        batch the last lands), the gathered rows of every valid slot when
        ``with_data`` (reads see this batch's writes), and the per-slot
        consumer-observed completion times. With the page cache on, read
        hits complete at ``hit_us`` without posting an SQE and every valid
        op fills the cache."""
        lba = ops.lba.to(I32)
        valid = ops.valid
        state, done = self._priced(state, lba, ops)
        if data is not None:
            dst = torch.where(valid & (ops.opcode == OP_WRITE), lba,
                              flash.shape[0])
            flash = scatter_last(flash, dst, data)
        out = flash[torch.where(valid, lba, 0).long()] if with_data else None
        return state, flash, out, done

    def submit_array(
        self,
        state: ClientState,      # stacked: every leaf has a leading (M,) axis
        flash: torch.Tensor,     # (num_blocks, block_words) — shared store
        ops: StorageOps,         # (M, N) per-drive op batches
        data: "torch.Tensor | None" = None,  # (M, N, block_words) payloads
        with_data: bool = False,
    ) -> Tuple[ClientState, torch.Tensor, "torch.Tensor | None",
               torch.Tensor]:
        """``submit`` over an M-drive array in one pass of the ring path:
        each drive prices its own row of ``ops``; the functional scatter
        and gather against the shared block store happen once for the
        array (of several writes to one LBA the last in drive-major order
        lands). Returns ``(state', flash', data_out, done)`` with ``done``
        shaped (M, N). Each drive's page cache serves and fills from its own
        row."""
        m, n = ops.lba.shape
        lba = ops.lba.to(I32)
        state, done = self._priced(state, lba, ops)
        if data is not None:
            dst = torch.where(ops.valid & (ops.opcode == OP_WRITE), lba,
                              flash.shape[0]).reshape(-1)
            flash = scatter_last(
                flash, dst, data.reshape((m * n,) + tuple(data.shape[2:])))
        out = (flash[torch.where(ops.valid, lba, 0).long()] if with_data
               else None)
        return state, flash, out, done

    def submit_striped(
        self,
        state: ClientState,      # stacked array state (M drives)
        flash: torch.Tensor,
        ops: StorageOps,         # flat (N,) op batch — any N
        data: "torch.Tensor | None" = None,  # (N, block_words) payloads
        stripe_width: "int | None" = None,
        with_data: bool = False,
    ) -> Tuple[ClientState, torch.Tensor, "torch.Tensor | None",
               torch.Tensor]:
        """Stripe a flat op batch round-robin over the array's drives: op
        i goes to drive ``i % W`` with ``W = stripe_width`` (default all M
        drives); the other drives see an empty batch. A ragged tail is
        padded with invalid slots, which never touch the rings or the
        device; ``done`` and ``data_out`` come back in op order."""
        m = _num_drives(state)
        w = m if stripe_width is None else stripe_width
        if not 1 <= w <= m:
            raise ValueError(
                f"stripe_width={w} must be in [1, M={m}] — a stripe "
                "cannot span more drives than the array holds"
            )
        n = ops.lba.shape[0]
        cols = -(-n // w)          # ceil: ring slots per striped drive
        pad = cols * w - n

        # (N, ...) -> (M, cols, ...): op i = stripe (i % W, i // W); the
        # pad tail and the M - W unstriped drives are invalid slots.
        def to_dev(x, fill):
            rest = tuple(x.shape[1:])
            x = torch.cat([x, x.new_full((pad,) + rest, fill)])
            x = x.reshape((cols, w) + rest).transpose(0, 1)
            if w < m:
                x = torch.cat([x, x.new_full((m - w, cols) + rest, fill)])
            return x.contiguous()

        ops2d = StorageOps(
            opcode=to_dev(ops.opcode, 0),
            lba=to_dev(ops.lba.to(I32), 0),
            t_submit=to_dev(ops.t_submit, 0.0),
            tenant=to_dev(ops.tenant, 0),
            valid=to_dev(ops.valid, False),
        )
        data2d = None if data is None else to_dev(data, 0)
        state, flash, _, done2d = self.submit_array(
            state, flash, ops2d, data=data2d
        )
        done = done2d[:w].transpose(0, 1).reshape(cols * w)[:n]
        out = (flash[torch.where(ops.valid, ops.lba, 0).long()] if with_data
               else None)
        return state, flash, out, done

    # -- thin wrappers over submit -------------------------------------------
    def read(
        self,
        state: ClientState,
        flash: torch.Tensor,     # (num_blocks, block_words)
        lba: torch.Tensor,       # (N,) i32 block addresses
        t_submit: "torch.Tensor | float" = 0.0,   # () or (N,) f32
        valid: "torch.Tensor | None" = None,
        with_data: bool = True,
        tenant: "torch.Tensor | int" = 0,   # () or (N,) i32 QoS class
    ) -> Tuple[ClientState, "torch.Tensor | None", torch.Tensor]:
        """N block reads at ``t_submit`` through the SQ/CQ rings: ``submit``
        with an all-read batch. Returns (state', data (N, block_words) or
        ``None`` when ``with_data=False``, completion times (N,))."""
        ops = StorageOps.make(lba, t_submit, tenant=tenant, valid=valid)
        state, _, data, done = self.submit(
            state, flash, ops, with_data=with_data
        )
        return state, data, done

    def write(
        self,
        state: ClientState,
        flash: torch.Tensor,     # (num_blocks, block_words)
        data: torch.Tensor,      # (N, block_words) blocks to persist
        lba: torch.Tensor,       # (N,) i32 destination block addresses
        t_submit: "torch.Tensor | float" = 0.0,   # () or (N,) f32
        valid: "torch.Tensor | None" = None,
        tenant: "torch.Tensor | int" = 0,   # () or (N,) i32 QoS class
    ) -> Tuple[ClientState, torch.Tensor, torch.Tensor]:
        """N block writes at ``t_submit`` through the SQ/CQ rings: ``submit``
        with an all-write batch, so stage 4 prices flash programs (and GC).
        Returns (state', flash' with the blocks scattered in, completion
        times (N,)). Of several writes to one LBA in a batch the last lands
        (the reference leaves that unspecified)."""
        ops = StorageOps.make(
            lba, t_submit, opcode=OP_WRITE, tenant=tenant, valid=valid
        )
        state, flash, _, done = self.submit(state, flash, ops, data=data)
        return state, flash, done

    def read_array(
        self,
        state: ClientState,      # stacked: every leaf has a leading (M,) axis
        flash: torch.Tensor,     # (num_blocks, block_words) — shared store
        lba: torch.Tensor,       # (M, N) i32 per-drive block addresses
        t_submit: "torch.Tensor | float" = 0.0,   # (), (M,) or (M, N) f32
        valid: "torch.Tensor | None" = None,      # (M, N) bool
        with_data: bool = True,
        tenant: "torch.Tensor | int" = 0,   # scalar or (M, N) i32
    ) -> Tuple[ClientState, "torch.Tensor | None", torch.Tensor]:
        """Per-drive batched reads over an M-drive array: ``submit_array``
        with an all-read batch."""
        ops = StorageOps.make(lba, _per_drive(t_submit, lba), tenant=tenant,
                              valid=valid)
        state, _, data, done = self.submit_array(
            state, flash, ops, with_data=with_data
        )
        return state, data, done

    def write_array(
        self,
        state: ClientState,      # stacked: every leaf has a leading (M,) axis
        flash: torch.Tensor,     # (num_blocks, block_words) — shared store
        data: torch.Tensor,      # (M, N, block_words) per-drive payloads
        lba: torch.Tensor,       # (M, N) i32 per-drive block addresses
        t_submit: "torch.Tensor | float" = 0.0,   # (), (M,) or (M, N) f32
        valid: "torch.Tensor | None" = None,      # (M, N) bool
        tenant: "torch.Tensor | int" = 0,   # scalar or (M, N) i32
    ) -> Tuple[ClientState, torch.Tensor, torch.Tensor]:
        """Per-drive batched writes over an M-drive array: ``submit_array``
        with an all-write batch. Each drive prices its share on its own
        dies and GC state; the blocks land once in the shared store."""
        ops = StorageOps.make(lba, _per_drive(t_submit, lba),
                              opcode=OP_WRITE, tenant=tenant, valid=valid)
        state, flash, _, done = self.submit_array(
            state, flash, ops, data=data
        )
        return state, flash, done

    def read_striped(
        self,
        state: ClientState,      # stacked array state (M drives)
        flash: torch.Tensor,
        lba: torch.Tensor,       # (N,) i32 — any N
        t_submit: "torch.Tensor | float" = 0.0,   # () or (N,) f32
        valid: "torch.Tensor | None" = None,
        stripe_width: "int | None" = None,
        tenant: "torch.Tensor | int" = 0,   # () or (N,) i32
    ) -> Tuple[ClientState, torch.Tensor, torch.Tensor]:
        """A flat read batch striped round-robin over the array's drives:
        ``submit_striped`` with an all-read batch."""
        ops = StorageOps.make(lba, t_submit, tenant=tenant, valid=valid)
        state, _, data, done = self.submit_striped(
            state, flash, ops, stripe_width=stripe_width, with_data=True
        )
        return state, data, done

    def _replica_grid(self, m: int, n: int, drive: torch.Tensor,
                      valid: torch.Tensor, width: int):
        """Each request's (drive, slot) cell in an (M, n) per-drive grid:
        a drive's requests fill its slots in request order; invalid ones
        get slot ``width`` (dropped)."""
        rank = segment_rank(drive)
        row = torch.clamp(drive, 0, m - 1)
        col = torch.where(valid, rank, width)

        def scat(x, fill):
            base = torch.full((m, n), fill, dtype=x.dtype, device=x.device)
            return scatter_drop(base, row, col, x)

        def back(grid):
            return grid[row.long(), torch.clamp(col, 0, n - 1).long()]

        return scat, back

    def read_replicated(
        self,
        state: ClientState,      # stacked array state (M drives)
        flash: torch.Tensor,
        lba: torch.Tensor,       # (N,) i32 — any N
        t_submit: "torch.Tensor | float" = 0.0,   # () or (N,) f32
        valid: "torch.Tensor | None" = None,
        replicas: int = 2,
        tenant: "torch.Tensor | int" = 0,   # () or (N,) i32
    ) -> Tuple[ClientState, torch.Tensor, torch.Tensor]:
        """Replica reads over an M-drive array, least-loaded routing.
        Block b's R replicas live on drives ``(b + r) % M`` (chained
        declustering); each read goes, in request order, to the candidate
        with the least load: the drive's mean instance backlog, plus on a
        remote array its RX link cursor (and its shared-switch RX cursor
        when the switch has a finite roof), plus the estimated time of
        the reads already routed to it in this batch (the first such
        candidate on a tie). A read's estimate is one service slot
        (``1e6 / t_max_iops`` us), plus on a remote array the amortized
        wire transaction and the frame's bytes at the RX link and switch
        share. Returns (state', data, done) in request order."""
        m = _num_drives(state)
        if not 1 <= replicas <= m:
            raise ValueError(
                f"replicas={replicas} must be in [1, M={m}] — a block "
                "cannot have more replicas than the array has drives"
            )
        n = lba.shape[0]
        device = lba.device
        lba = lba.to(I32)
        if valid is None:
            valid = torch.ones((n,), dtype=torch.bool, device=device)
        t_submit = _fan(t_submit, (n,), F32, device)

        fab = self.cfg.fabric
        load = lane_mean(state.dev.tstate.busy_until)
        est = 1e6 / self.ssd.t_max_iops
        if fab.remote:
            # The link frontier is the latest per-tenant cursor.
            load = load + torch.amax(state.dev.fabric.rx_busy, dim=-1)
            est += fab.wire_txn_us / fab.mtu_batch
            frame = fab.cqe_bytes + self.ssd.block_bytes
            if math.isfinite(fab.rx_bytes_per_us):
                est += frame / fab.rx_bytes_per_us
            if fab.switched:
                load = load + torch.amax(state.dev.fabric.switch_rx, dim=-1)
                est += frame / fab.switch_share_bytes_per_us
        est = torch.full((1,), float(np.float32(est)), dtype=F32,
                         device=device)
        cand = torch.remainder(
            lba[:, None] + torch.arange(replicas, dtype=I32, device=device),
            m)                                               # (N, R)
        # The routing is a sequential scan (each pick sees the load of
        # the earlier picks), one small step a request.
        drive = torch.full((n,), m, dtype=I32, device=device)
        for i in range(n):
            ci = cand[i].long()
            d = ci[torch.argmin(load[ci])]
            load = torch.where(valid[i], load.index_add(0, d[None], est),
                               load)
            drive[i] = torch.where(valid[i], d.to(I32), m)

        scat, back = self._replica_grid(m, n, drive, valid, n)
        tenant = _fan(tenant, (n,), I32, device)
        state, _, done2d = self.read_array(
            state, flash, scat(lba, 0), scat(t_submit, 0.0),
            scat(valid, False), with_data=False, tenant=scat(tenant, 0),
        )
        done = torch.where(valid, back(done2d), 0.0)
        data = flash[torch.where(valid, lba, 0).long()]
        return state, data, done

    def write_replicated(
        self,
        state: ClientState,      # stacked array state (M drives)
        flash: torch.Tensor,
        data: torch.Tensor,      # (N, block_words) blocks to persist
        lba: torch.Tensor,       # (N,) i32 — any N
        t_submit: "torch.Tensor | float" = 0.0,   # () or (N,) f32
        valid: "torch.Tensor | None" = None,
        replicas: int = 2,
        tenant: "torch.Tensor | int" = 0,   # () or (N,) i32
    ) -> Tuple[ClientState, torch.Tensor, torch.Tensor]:
        """Replica-write fan-out over an M-drive array: block b's R
        replicas live on drives ``(b + r) % M``, every write goes to all
        of them, and it completes when the slowest replica has (the max
        over its R completions). Each drive prices its share; the block
        lands once in the shared store. Returns (state', flash', done)
        in request order."""
        m = _num_drives(state)
        if not 1 <= replicas <= m:
            raise ValueError(
                f"replicas={replicas} must be in [1, M={m}] — a block "
                "cannot have more replicas than the array has drives"
            )
        n, r = lba.shape[0], replicas
        device = lba.device
        lba = lba.to(I32)
        if valid is None:
            valid = torch.ones((n,), dtype=torch.bool, device=device)
        t_submit = _fan(t_submit, (n,), F32, device)
        tenant = _fan(tenant, (n,), I32, device)

        # (N, R) candidate drives, request-major, so each drive's slots
        # fill in request order; a request's R candidates are distinct
        # (R <= M), so an (M, N) grid holds the whole fan-out.
        cand = torch.remainder(
            lba[:, None] + torch.arange(r, dtype=I32, device=device), m)
        valid_rep = valid.repeat_interleave(r)
        drive = torch.where(valid_rep, cand.reshape(-1), m).to(I32)
        scat, back = self._replica_grid(m, n, drive, valid_rep, n * r)

        def rep(x):
            return x.repeat_interleave(r)

        ops2d = StorageOps(
            opcode=torch.full((m, n), OP_WRITE, dtype=I32, device=device),
            lba=scat(rep(lba), 0), t_submit=scat(rep(t_submit), 0.0),
            tenant=scat(rep(tenant), 0), valid=scat(valid_rep, False),
        )
        state, _, _, done2d = self.submit_array(state, flash, ops2d)
        done_rep = back(done2d).reshape(n, r)
        done = torch.where(valid, torch.amax(done_rep, dim=1), 0.0)
        # One copy per request in the shared store: the fan-out is a
        # device-time matter.
        dst = torch.where(valid, lba, flash.shape[0])
        flash = scatter_last(flash, dst, data)
        return state, flash, done


def _num_drives(state: ClientState) -> int:
    """M of a stacked array state."""
    if state.dev.lock_time.dim() != 1:
        raise ValueError("an array entry point takes a stacked state with a "
                         "leading (M,) axis (StorageClient.init_array_state)")
    return state.dev.lock_time.shape[0]


def _fan(x: "torch.Tensor | float | int", shape, dtype, device
         ) -> torch.Tensor:
    """A scalar or tensor broadcast to ``shape`` on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device, dtype).expand(shape)
    return torch.full(shape, x, dtype=dtype, device=device)


def _per_drive(t_submit: "torch.Tensor | float", lba: torch.Tensor
               ) -> "torch.Tensor | float":
    """An (M,) submission clock as one column a drive; anything else as
    it is (``StorageOps.make`` broadcasts it)."""
    if isinstance(t_submit, torch.Tensor) and t_submit.dim() == 1:
        return t_submit.to(lba.device, F32)[:, None]
    return t_submit
