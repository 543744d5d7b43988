"""The admission epoch: one fetched batch's view of the timing core
(port of ``repro/core/epoch.py``).

An ``Epoch`` packages ``(arrival, ready, tenant, valid, unit, layout)``
for the global timing lock (``device.acquire_lock``) and the timing
model. ``layout == "ring"`` promises the SQ-major fixed-width row blocks
of ``frontend._gather_entries`` (units are contiguous ``N // U`` slabs),
which turns per-unit reductions into reshapes; ``"direct"`` uses
segmented forms on the non-decreasing ``unit`` key. Every tensor may
carry a leading ``(M,)`` drive axis (an array's epochs, one a drive).

``unit_ready_order`` and ``admission_row_order`` build the ready-time
lock's acquisition permutation from ``(ready, unit)`` keys with a stable
sort, so ties keep program order. The permutation moves whole unit
blocks and no float arithmetic: gathering rows through it cannot
perturb a float.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.segops import (
    segment_max, segment_sum, stable_argsort, take, unsort,
)
from repro_torch.core.types import I32, RequestBatch


@dataclasses.dataclass(frozen=True)
class Epoch:
    """One fetched batch's admission state (struct of (N,) tensors)."""

    arrival: torch.Tensor  # (N,) f32 evolving per-row time cursor
    ready: torch.Tensor    # (N,) f32 post-fabric-TX device arrival times
    tenant: torch.Tensor   # (N,) i32 QoS class per row
    valid: torch.Tensor    # (N,) bool
    unit: torch.Tensor     # (N,) i32 non-decreasing service-unit ids
    layout: str = "direct"  # "ring" | "direct"

    @staticmethod
    def from_batch(
        batch: RequestBatch,
        ready: torch.Tensor,
        unit: torch.Tensor,
        layout: str,
    ) -> "Epoch":
        """Admission view of a fetched batch; ``ready`` is the post-TX
        fetch-done vector (== raw fetch times on a local drive)."""
        return Epoch(
            arrival=ready, ready=ready, tenant=batch.tenants,
            valid=batch.valid, unit=unit, layout=layout,
        )

    @property
    def capacity(self) -> int:
        return self.ready.shape[-1]

    @property
    def is_ring(self) -> bool:
        return self.layout == "ring"

    def rows_per_unit(self, num_units: int) -> int:
        """Fixed block width of the ring layout's unit slabs."""
        return self.capacity // num_units

    def unit_counts(self, num_units: int) -> torch.Tensor:
        """(U,) valid-request count per unit (exact integer reduction)."""
        v = self.valid.to(I32)
        if self.is_ring:
            return torch.sum(v.reshape(self._per_unit(num_units)), dim=-1,
                             dtype=I32)
        return segment_sum(v, self.unit, num_units)

    def _per_unit(self, num_units: int):
        return tuple(self.valid.shape[:-1]) + (num_units, -1)

    def unit_ready(self, num_units: int) -> torch.Tensor:
        """(U,) batch ready time per unit: the max over its valid rows
        (empty units reduce to 0)."""
        masked = torch.where(self.valid, self.ready, 0.0)
        if self.is_ring:
            return torch.amax(masked.reshape(self._per_unit(num_units)),
                              dim=-1)
        return segment_max(masked, self.unit, num_units)

    def admit(self, lock_done: torch.Tensor) -> "Epoch":
        """``arrival = max(ready, lock_done[unit])``: a row dispatches once
        its unit holds the lock and its own frame has landed."""
        return dataclasses.replace(
            self,
            arrival=torch.maximum(self.ready, take(lock_done, self.unit)),
        )


def unit_ready_order(batch_ready: torch.Tensor) -> torch.Tensor:
    """(..., U) lock-acquisition permutation: units by ``(ready, index)``,
    per drive. Stable, so equal ready times keep program order: with
    monotone ready times it is the identity."""
    return stable_argsort(batch_ready)


def admission_row_order(
    unit_order: torch.Tensor,  # (..., U) i32 acquisition order
    epoch: Epoch,
    num_units: int,
) -> torch.Tensor:
    """(..., N) row permutation dispatching unit blocks in lock order:
    position j holds the j-th row dispatched, rows inside a block in
    program order. Index arithmetic on the ring layout's fixed-width
    slabs; a stable argsort of each row's acquisition position
    otherwise."""
    if epoch.is_ring:
        w = epoch.rows_per_unit(num_units)
        rows = torch.arange(w, dtype=I32, device=unit_order.device)
        perm = unit_order[..., :, None] * w + rows
        return perm.reshape(tuple(unit_order.shape[:-1]) + (-1,)).to(I32)
    pos = torch.arange(num_units, dtype=I32, device=unit_order.device)
    lock_pos = unsort(pos.expand(unit_order.shape).contiguous(), unit_order)
    unit = epoch.unit.expand(epoch.valid.shape)
    return stable_argsort(take(lock_pos, unit))
