"""Segmented prefix max on the card (port of ``repro/kernels/seg_scan.py``).

``seg_scan`` launches ``csrc/seg_scan.cu`` once on CUDA tensors: one
thread block cluster of 8 CTAs scans a tile of 8192 elements, and past one
tile the tiles run in a single pass with a decoupled look-back over a
zeroed scratch of one word a tile.
Its plain version is ``kernels/ref.py::seg_scan_ref``; ``kernels/ops.py``
chooses between them by the tensor's device.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

_P = ctypes.c_void_p
_ARGTYPES = [_P] * 4 + [ctypes.c_longlong, ctypes.c_int, _P]


@functools.lru_cache(maxsize=None)
def _tile() -> int:
    """The elements one CTA scans (a compile-time constant of the
    library)."""
    return build.library("seg_scan").seg_scan_tile()


def seg_scan(values: torch.Tensor, heads: torch.Tensor) -> torch.Tensor:
    """(n,) f32 values, (n,) bool heads on one CUDA device -> (n,) f32."""
    build.require(values, "values", torch.float32, 1)
    dev = values.get_device()
    build.require(heads, "heads", torch.bool, 1, dev)
    n = values.shape[0]
    if heads.shape[0] != n:
        raise ValueError(f"heads has {heads.shape[0]} rows, values {n}")
    out = torch.empty_like(values)
    tile = _tile()
    # The look-back's ticket counter and one status word a tile; the launch
    # function zeroes them. A call of one tile needs none.
    scratch = (torch.empty((-(-n // tile) + 1,), dtype=torch.int64,
                           device=values.device)
               if n > tile else None)
    fn = build.bind("seg_scan", _ARGTYPES)
    _, stream = build.launch_args(dev)
    rc = fn(values.data_ptr(), heads.data_ptr(), out.data_ptr(),
            scratch.data_ptr() if scratch is not None else None, n, dev,
            stream)
    build.check("seg_scan", rc)
    build.LAUNCHES["seg_scan"] += 1
    return out
