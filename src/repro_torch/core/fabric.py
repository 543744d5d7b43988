"""Fabric layer state (port of ``repro/core/fabric.py``, state only).

``DeviceState`` carries a ``FabricState`` for the NIC/link cursors of a
remote drive. This slice runs local drives only, where the fabric hop is
skipped and the cursors never move; the hop itself (``fabric_hop``,
``switch_hop``) is ROADMAP A12, and ``DevicePipeline`` rejects
``fabric.remote`` when built.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.types import F32


@dataclasses.dataclass(frozen=True)
class FabricState:
    """Per-drive link state: one (T,) cursor per tenant class per
    resource (T = ``FabricConfig.num_tenants``)."""

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
