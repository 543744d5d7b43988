"""Segmented prefix max on the card (port of ``repro/kernels/seg_scan.py``).

``seg_scan`` launches ``csrc/seg_scan.cu`` (three passes: tile scans,
carry scan over the tile aggregates, carry fix-up) on CUDA tensors. Its
plain version is ``kernels/ref.py::seg_scan_ref``; ``kernels/ops.py``
chooses between them by the tensor's device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

TILE = 256

_P = ctypes.c_void_p


def seg_scan(values: torch.Tensor, heads: torch.Tensor) -> torch.Tensor:
    """(n,) f32 values, (n,) bool heads on one CUDA device -> (n,) f32."""
    build.require(values, "values", torch.float32, 1)
    build.require(heads, "heads", torch.bool, 1, values.device)
    n = values.shape[0]
    if heads.shape[0] != n:
        raise ValueError(f"heads has {heads.shape[0]} rows, values {n}")
    nb = max(-(-n // TILE), 1)
    out = torch.empty_like(values)
    fscratch = torch.empty((2 * nb + 1,), dtype=torch.float32,
                           device=values.device)
    iscratch = torch.empty((2 * nb,), dtype=torch.int32, device=values.device)
    fn = build.bind("seg_scan", [_P] * 5 + [ctypes.c_int] * 2 + [_P])
    dev, stream = build.launch_args(values.device)
    rc = fn(build.ptr(values), build.ptr(heads), build.ptr(out),
            build.ptr(fscratch), build.ptr(iscratch), n, dev, stream)
    build.check("seg_scan", rc)
    build.LAUNCHES["seg_scan"] += 1
    return out
