"""Accelerator-initiated storage client in virtual time (port of
``repro/core/client.py``).

``StorageClient.submit(state, flash, ops)`` is the single entry point: a
``StorageOps`` batch (opcode, LBA, tenant and submission clock per slot)
is posted as SQEs into real ``SQRings`` (dealt round-robin across the
service units' SQs), fetched by the engine's own frontend, priced by the
shared ``DevicePipeline.process`` and reaped from the paired CQs, in as
many fetch passes as the batch needs. The functional block store is
updated and gathered beside it. ``read`` and ``write`` are thin wrappers
over ``submit`` with an all-read or all-write batch.

The array, striped and replicated entry points wait for ROADMAP A11; the
stage-0 page cache for A13 (the pipeline rejects ``cache.enabled`` when
it is built).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.core import frontend
from repro_torch.core.device import DevicePipeline, DeviceState
from repro_torch.core.frontend import SQRings
from repro_torch.core.segops import scatter_last, stable_argsort
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
    """Virtual-time device state carried across application steps (the
    reference's stage-0 ``cache`` field comes with ROADMAP A13)."""

    dev: DeviceState


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
        ``cfg`` exactly as ``engine_round`` prices with."""
        return ClientState(dev=self.pipeline.init_state(resolve_device(device)))

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
        Returns (dev', done (N,) in the original request order)."""
        cfg, plat, pipe = self.cfg, self.plat, self.pipeline
        n = lba.shape[0]
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
        sq_id = frontend.deal_sqs(n, cfg, device)
        zeros = torch.zeros((n,), dtype=I32, device=device)
        if tenant is None:
            tenant = zeros
        rings = SQRings.empty(q, cfg.sq_depth, device)
        rings = frontend.submit(
            rings, sq_id, t_submit[order], opcode[order], lba[order],
            torch.ones((n,), dtype=I32, device=device), zeros,
            order.to(I32), valid[order], tenant=tenant[order],
        )

        cq = pipe.init_cq(device)
        row_unit = frontend.fetch_row_units(cfg, device)
        clock = torch.amax(torch.where(valid, t_submit, 0.0))
        done = torch.zeros((n,), dtype=F32, device=device)
        for _ in range(-(-n // (q * f))):  # ceil: fetch window per pass
            # Dispatchers poll again as soon as they are free (all
            # entries are already posted and visible).
            clock = torch.maximum(clock, torch.amax(dev.disp_time))
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
        consumer-observed completion times."""
        lba = ops.lba.to(I32)
        valid = ops.valid
        dev, done = self._submit_through_rings(
            state.dev, lba, ops.t_submit, valid, ops.opcode, ops.tenant
        )
        if data is not None:
            dst = torch.where(valid & (ops.opcode == OP_WRITE), lba,
                              flash.shape[0])
            flash = scatter_last(flash, dst, data)
        out = flash[torch.where(valid, lba, 0).long()] if with_data else None
        return ClientState(dev=dev), flash, out, done

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
