"""Workload generators (port of ``repro/workloads/generators.py``).

``ClosedLoop``      fio/BaM analogue: each slot resubmits after completion
                    plus think time.
``MixedReadWrite``  closed loop with a read/write mix (default 70/30) and
                    optional power-law (Zipf-like) address skew.

The other reference generators (Zipf, steady-state, multi-tenant,
Poisson, trace replay) are ROADMAP A10.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.segops import uniform01
from repro_torch.core.types import I32
from repro_torch.workloads.base import Workload


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
    is skipped: ``u**1 == u`` exactly, and no device's ``pow`` rounding
    can then move an address.
    """

    read_frac: float = 0.7
    theta: float = 0.0

    def address(self, req_id, ssd, salt=0):
        if not 0.0 <= self.theta < 1.0:
            raise ValueError(f"theta={self.theta} must be in [0, 1)")
        u = uniform01(self._key(req_id, salt))
        alpha = 1.0 / (1.0 - self.theta)
        if alpha != 1.0:
            u = torch.pow(u, float(np.float32(alpha)))
        x = u * ssd.num_blocks
        return torch.clamp(x.to(I32), 0, ssd.num_blocks - 1)
