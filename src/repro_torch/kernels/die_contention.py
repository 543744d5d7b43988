"""Per-die flash contention on the card (port of
``repro/kernels/die_contention.py``).

``die_contention`` launches ``csrc/die_contention.cu`` once (rows staged
in shared memory tile by tile, each die's event rows found through a
bitmap, one warp per die folding them in row order) on CUDA tensors. Its
plain version is ``kernels/ref.py::die_contention_ref``; ``kernels/ops.py``
chooses between them by the tensor's device.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build

_P = ctypes.c_void_p


def die_contention(
    ready: torch.Tensor,      # (N,) f32 post-lock dispatch times
    cost: torch.Tensor,       # (N,) f32 die occupancy per event row
    chip: torch.Tensor,       # (N,) i32 die per row, in [0, K)
    event: torch.Tensor,      # (N,) bool rows that occupy their die
    chip_busy: torch.Tensor,  # (K,) f32 epoch-start die cursors
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (busy (N,), new_cursors (K,)); busy is 0 on non-event rows."""
    dev = ready.device
    build.require(ready, "ready", torch.float32, 1)
    build.require(cost, "cost", torch.float32, 1, dev)
    build.require(chip, "chip", torch.int32, 1, dev)
    build.require(event, "event", torch.bool, 1, dev)
    build.require(chip_busy, "chip_busy", torch.float32, 1, dev)
    n = ready.shape[0]
    if not (cost.shape[0] == chip.shape[0] == event.shape[0] == n):
        raise ValueError("ready, cost, chip and event must have equal length")
    k = chip_busy.shape[0]
    busy = torch.empty((n,), dtype=torch.float32, device=dev)
    cur = torch.empty((k,), dtype=torch.float32, device=dev)
    fn = build.bind("die_contention", [_P] * 7 + [ctypes.c_int] * 3 + [_P])
    d, stream = build.launch_args(dev)
    rc = fn(build.ptr(ready), build.ptr(cost), build.ptr(chip),
            build.ptr(event), build.ptr(chip_busy), build.ptr(busy),
            build.ptr(cur), n, k, d, stream)
    build.check("die_contention", rc)
    build.LAUNCHES["die_contention"] += 1
    return busy, cur
