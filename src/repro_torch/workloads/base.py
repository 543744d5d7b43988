"""Workload abstraction for the emulation engine (port of
``repro/workloads/base.py``).

A ``Workload`` is a static generator object with three decisions:

  * ``prefill``     — what sits in the SQ rings at t=0
  * ``address`` / ``opcode`` — the request stream's content
  * ``next_submit`` — when a completed slot produces its next submission

All randomness is counter-based (xorshift hash of the request id, the
workload seed and a per-device ``salt``), so the port draws the same
stream as the reference from the same ids. On an M-drive array the
request hooks take (M, N) ids and an (M, 1) salt column (drive d's salt
is d), and each drive draws the stream a drive of that salt draws alone.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core.segops import hash_u32
from repro_torch.core.types import (
    F32,
    I32,
    EngineConfig,
    SSDConfig,
    WorkloadConfig,
)

FAR = 3e38

_U32 = 0xFFFFFFFF


class Prefill(NamedTuple):
    """Entries pre-posted into the SQ rings at t=0; all tensors (Q, L)."""

    submit: torch.Tensor   # f32 virtual submission times (row-sorted)
    opcode: torch.Tensor   # i32
    lba: torch.Tensor      # i32
    nblocks: torch.Tensor  # i32
    req_id: torch.Tensor   # i32
    valid: torch.Tensor    # bool
    tenant: "torch.Tensor | None" = None  # i32 QoS class (None = all 0)


def _u32(x: "torch.Tensor | int") -> "torch.Tensor | int":
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _U32
    return int(x) & _U32


@dataclasses.dataclass(frozen=True)
class Workload:
    """Base closed-loop-shaped workload; subclasses override the hooks."""

    io_depth: int = 64
    read_frac: float = 1.0
    seed: int = 0
    precondition_drive: bool = False

    # -- counter-based randomness -------------------------------------------
    def _key(self, req_id: torch.Tensor, salt: "torch.Tensor | int",
             stream: int = 0) -> torch.Tensor:
        base = (
            _u32(req_id)
            + ((self.seed * 0x9E3779B9) & _U32)
            + ((_u32(salt) * 0x632BE5AB) & _U32)
            + ((stream * 7919) & _U32)
        ) & _U32
        return hash_u32(base)

    # -- request-content hooks ----------------------------------------------
    def address(self, req_id: torch.Tensor, ssd: SSDConfig,
                salt: "torch.Tensor | int" = 0) -> torch.Tensor:
        """Uniform-random LBAs."""
        h = self._key(req_id, salt)
        return (h % ssd.num_blocks).to(I32)

    def opcode(self, req_id: torch.Tensor, salt: "torch.Tensor | int" = 0,
               tenant: "torch.Tensor | None" = None) -> torch.Tensor:
        """Read/write decision (1 = write)."""
        del tenant
        h = self._key(req_id, salt, stream=1)
        threshold = float(np.float32(self.read_frac * 1000))
        return ((h % 1000).to(F32) >= threshold).to(I32)

    def tenant_of_sq(self, sq_id: torch.Tensor, cfg: EngineConfig,
                     salt: "torch.Tensor | int" = 0) -> torch.Tensor:
        """QoS/tenant class served by each SQ (single class by default)."""
        del cfg, salt
        return torch.zeros_like(sq_id)

    # -- lifecycle hooks -----------------------------------------------------
    def prefill(self, cfg: EngineConfig, ssd: SSDConfig,
                salt: "torch.Tensor | int", device) -> Prefill:
        """``io_depth`` entries per SQ at t~0 (staggered for a total order)."""
        q, d = cfg.num_sqs, self.io_depth
        if d > cfg.sq_depth:
            raise ValueError(
                f"io_depth={d} exceeds sq_depth={cfg.sq_depth}"
            )
        req_id = (
            torch.arange(q, dtype=I32, device=device)[:, None] * d
            + torch.arange(d, dtype=I32, device=device)[None, :]
        )
        submit = (
            torch.arange(d, dtype=F32, device=device)[None, :] * 1e-3
            + torch.arange(q, dtype=F32, device=device)[:, None] * 1e-5
        )
        tenant = self.tenant_of_sq(
            torch.arange(q, dtype=I32, device=device), cfg, salt
        )[:, None].expand(q, d)
        return Prefill(
            submit=submit,
            opcode=self.opcode(req_id, salt, tenant=tenant),
            lba=self.address(req_id, ssd, salt),
            nblocks=torch.ones((q, d), dtype=I32, device=device),
            req_id=req_id,
            valid=torch.ones((q, d), dtype=torch.bool, device=device),
            tenant=tenant,
        )

    def sharded(self, num_shards: int) -> "Workload":
        """This generator on one drive of an M-drive array. Salt-aware
        generators give M independent streams from the salt alone and
        return ``self``; ``TraceReplay`` stripes its trace."""
        del num_shards
        return self

    def next_submit(
        self,
        new_req: torch.Tensor,   # (N,) i32 ids of the would-be new requests
        done: torch.Tensor,      # (N,) f32 completion time of the old request
        valid: torch.Tensor,     # (N,) bool old request was real
        anchor: torch.Tensor,    # (N,) f32 last submit time posted per SQ
        cfg: EngineConfig,
        ssd: SSDConfig,
        salt: "torch.Tensor | int" = 0,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """When the slot's next submission occurs. Returns (time, valid)."""
        raise NotImplementedError


def as_workload(wl: "Workload | WorkloadConfig") -> "Workload":
    """Adapt a legacy ``WorkloadConfig`` to the closed-loop generator."""
    if isinstance(wl, Workload):
        return wl
    from repro_torch.workloads.generators import ClosedLoop

    return ClosedLoop(
        io_depth=wl.io_depth, read_frac=wl.read_frac, seed=wl.seed,
        resubmit_delay_us=wl.resubmit_delay_us,
    )
