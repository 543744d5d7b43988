"""Workload generators (port of ``repro/workloads/generators.py``).

``ClosedLoop``        fio/BaM analogue: each slot resubmits after completion
                      plus think time.
``PoissonOpenLoop``   open-loop Poisson arrivals at a configured aggregate
                      rate, chained per SQ off the engine-tracked anchor.
``ZipfClosedLoop``    read-only closed loop with power-law (Zipf-like) LBA
                      skew, for ``routing="lba_hash"`` channel studies.
``MixedReadWrite``    closed loop with a read/write mix (default 70/30) and
                      optional Zipf skew.
``SteadyStateMixed``  the same mix on a preconditioned (fully written)
                      drive.
``MultiTenant``       closed loop with the SQs partitioned across tenant
                      (QoS) classes, each with its own read/write mix.
``TraceReplay``       fixed-trace replay, dealt round-robin across SQs at
                      t=0, never resubmitting.

The Zipf address's power and the Poisson gap's logarithm go through
``core.xla_math``, which rounds as the reference's compiled ``jnp.power``
and ``jnp.log`` do on every device; the per-SQ cumulative sums go through
``segops.seq_cumsum``, which adds in ``jnp.cumsum``'s order.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.segops import seq_cumsum, uniform01
from repro_torch.core.types import F32, I32, EngineConfig
from repro_torch.core.xla_math import log_f32, pow_f32
from repro_torch.workloads.base import FAR, Prefill, Workload


@dataclasses.dataclass(frozen=True)
class ClosedLoop(Workload):
    """Closed-loop synthetic workload (fio / BaM analogue)."""

    resubmit_delay_us: float = 1.0

    def next_submit(self, new_req, done, valid, anchor, cfg, ssd,
                    salt=0) -> Tuple[torch.Tensor, torch.Tensor]:
        return done + float(np.float32(self.resubmit_delay_us)), valid


@dataclasses.dataclass(frozen=True)
class MixedReadWrite(ClosedLoop):
    """Closed loop mixing reads and writes, optionally Zipf-skewed.

    Addresses follow P(lba <= x) = (x/N)^(1-theta), inverse-CDF sampled
    from the request hash. At ``theta=0`` the exponent is 1 and the power
    is skipped: ``u**1 == u`` exactly.
    """

    read_frac: float = 0.7
    theta: float = 0.0

    def address(self, req_id, ssd, salt=0):
        if not 0.0 <= self.theta < 1.0:
            raise ValueError(f"theta={self.theta} must be in [0, 1)")
        u = uniform01(self._key(req_id, salt))
        alpha = 1.0 / (1.0 - self.theta)
        if alpha != 1.0:
            u = pow_f32(u, alpha)
        x = u * ssd.num_blocks
        return torch.clamp(x.to(I32), 0, ssd.num_blocks - 1)


@dataclasses.dataclass(frozen=True)
class ZipfClosedLoop(MixedReadWrite):
    """Read-only closed loop with power-law address skew (Zipf hot spot)."""

    read_frac: float = 1.0
    theta: float = 0.9


@dataclasses.dataclass(frozen=True)
class SteadyStateMixed(MixedReadWrite):
    """Mixed read/write load on a steady-state (fully written) drive:
    ``engine.init_state`` builds the flash array preconditioned."""

    precondition_drive: bool = True


@dataclasses.dataclass(frozen=True)
class MultiTenant(ClosedLoop):
    """Closed loop with the SQs partitioned across tenant (QoS) classes.

    SQ q serves tenant ``q * T // num_sqs`` (contiguous blocks), or
    ``q % T`` with ``interleave=True``; each class draws its own
    read/write mix from ``tenant_read_frac``.
    """

    tenant_read_frac: tuple = (1.0, 0.0)
    interleave: bool = False

    def __post_init__(self) -> None:
        if len(self.tenant_read_frac) < 1:
            raise ValueError("tenant_read_frac must name >= 1 tenant")
        if any(not 0.0 <= rf <= 1.0 for rf in self.tenant_read_frac):
            raise ValueError(
                f"tenant_read_frac={self.tenant_read_frac} entries "
                "must be in [0, 1]"
            )

    @property
    def num_tenants(self) -> int:
        return len(self.tenant_read_frac)

    def tenant_of_sq(self, sq_id, cfg, salt=0):
        del salt
        t = self.num_tenants
        if cfg.num_sqs < t:
            raise ValueError(
                f"num_sqs={cfg.num_sqs} cannot host {t} tenant classes"
            )
        if self.interleave:
            return torch.remainder(sq_id, t).to(I32)
        return torch.div(sq_id * t, cfg.num_sqs,
                         rounding_mode="floor").to(I32)

    def opcode(self, req_id, salt=0, tenant=None):
        if tenant is None:
            return super().opcode(req_id, salt)
        # The reference compares against ``rf * 1000`` with ``rf`` a
        # float32 array: a float32 product, made here on the host. The
        # per-tenant pick is a chain of selects (no host copy).
        thr = np.asarray(self.tenant_read_frac, np.float32) * np.float32(1000)
        tc = torch.clamp(tenant, 0, self.num_tenants - 1)
        h = self._key(req_id, salt, stream=1)
        draw = (h % 1000).to(F32)
        limit = torch.full(draw.shape, float(thr[0]), dtype=F32,
                           device=draw.device)
        for t in range(1, self.num_tenants):
            limit = torch.where(tc == t, float(thr[t]), limit)
        return (draw >= limit).to(I32)


@dataclasses.dataclass(frozen=True)
class PoissonOpenLoop(Workload):
    """Open-loop Poisson arrivals at ``rate_iops`` aggregate requests/s.

    Each SQ carries an independent Poisson process of rate
    ``rate_iops / num_sqs``, chained off the engine-tracked per-SQ
    ``anchor``, so arrivals never react to completions.
    """

    rate_iops: float = 1e6

    def mean_gap_us(self, cfg: EngineConfig) -> float:
        """Mean inter-arrival time within one SQ, in virtual us."""
        return cfg.num_sqs / self.rate_iops * 1e6

    def gap_us(self, req_id: torch.Tensor, cfg: EngineConfig,
               salt: "torch.Tensor | int" = 0) -> torch.Tensor:
        """Exponential inter-arrival sample for this request id."""
        u = uniform01(self._key(req_id, salt, stream=2))
        return -log_f32(u) * float(np.float32(self.mean_gap_us(cfg)))

    def prefill(self, cfg, ssd, salt, device) -> Prefill:
        base = super().prefill(cfg, ssd, salt, device)
        submit = seq_cumsum(self.gap_us(base.req_id, cfg, salt), 1)
        return base._replace(submit=submit)

    def next_submit(self, new_req, done, valid, anchor, cfg, ssd,
                    salt=0) -> Tuple[torch.Tensor, torch.Tensor]:
        # Rows are SQ-major (num_sqs, fetch_width): each SQ's m completed
        # slots materialize its next m arrivals, chained off the anchor.
        gaps = torch.where(valid, self.gap_us(new_req, cfg, salt), 0.0)
        lead = tuple(gaps.shape[:-1])
        chained = seq_cumsum(gaps.reshape(lead + (cfg.num_sqs, -1)), -1)
        return anchor + chained.reshape(gaps.shape), valid


@dataclasses.dataclass(frozen=True)
class TraceReplay(Workload):
    """Replay a fixed (time, lba, opcode) trace; no resubmission.

    The trace is time-sorted and dealt round-robin across SQs (entry i
    goes to SQ ``i % num_sqs``). With ``num_shards = M`` drive ``salt``
    replays only the entries whose time-sorted index i has
    ``i % M == salt``.
    """

    submit: tuple = ()   # static nested tuples, one row per SQ
    lba: tuple = ()
    ops: tuple = ()
    mask: tuple = ()
    num_shards: int = 1

    @staticmethod
    def from_trace(times_us, lbas, opcodes,
                   cfg: EngineConfig) -> "TraceReplay":
        times_us = np.asarray(times_us, np.float32)
        lbas = np.asarray(lbas, np.int32)
        opcodes = np.asarray(opcodes, np.int32)
        if not (times_us.shape == lbas.shape == opcodes.shape):
            raise ValueError("trace arrays must have identical shapes")
        t = len(times_us)
        q = cfg.num_sqs
        length = max(-(-t // q), 1)
        if length > cfg.sq_depth:
            raise ValueError(
                f"trace of {t} entries needs {length} slots/SQ but "
                f"sq_depth={cfg.sq_depth}"
            )
        order = np.argsort(times_us, kind="stable")
        sub = np.full((q, length), FAR, np.float32)
        lb = np.zeros((q, length), np.int32)
        op = np.zeros((q, length), np.int32)
        va = np.zeros((q, length), bool)
        j = np.arange(t)
        rows, cols = j % q, j // q
        sub[rows, cols] = times_us[order]
        lb[rows, cols] = lbas[order]
        op[rows, cols] = opcodes[order]
        va[rows, cols] = True

        def tup(a):
            return tuple(tuple(r) for r in a.tolist())

        return TraceReplay(
            io_depth=length, submit=tup(sub), lba=tup(lb), ops=tup(op),
            mask=tup(va),
        )

    @property
    def num_requests(self) -> int:
        return int(np.sum(np.asarray(self.mask)))

    def sharded(self, num_shards: int) -> "TraceReplay":
        """Stripe the trace across ``num_shards`` array drives."""
        if num_shards < 1:
            raise ValueError(f"num_shards={num_shards} must be >= 1")
        return dataclasses.replace(self, num_shards=num_shards)

    def prefill(self, cfg, ssd, salt, device) -> Prefill:
        sub = torch.tensor(self.submit, dtype=F32, device=device)
        q, length = sub.shape
        if q != cfg.num_sqs:
            raise ValueError(
                f"trace was built for {q} SQs, engine has {cfg.num_sqs}"
            )
        cols = torch.arange(length, dtype=I32, device=device)[None, :]
        rows = torch.arange(q, dtype=I32, device=device)[:, None]
        valid = torch.tensor(self.mask, dtype=torch.bool, device=device)
        if self.num_shards > 1:
            # ``from_trace`` dealt time-sorted entry i to cell
            # (i % q, i // q); keep this drive's stripe, i % M == salt.
            mine = torch.remainder(cols * q + rows, self.num_shards) == salt
            valid = valid & mine
        tenant = self.tenant_of_sq(rows[:, 0], cfg, salt)
        return Prefill(
            submit=sub,
            opcode=torch.tensor(self.ops, dtype=I32, device=device),
            lba=torch.tensor(self.lba, dtype=I32, device=device),
            nblocks=torch.ones((q, length), dtype=I32, device=device),
            req_id=rows * length + cols,
            valid=valid,
            tenant=tenant[:, None].expand(q, length),
        )

    def next_submit(self, new_req, done, valid, anchor, cfg, ssd,
                    salt=0) -> Tuple[torch.Tensor, torch.Tensor]:
        return torch.full_like(done, FAR), torch.zeros_like(valid)
