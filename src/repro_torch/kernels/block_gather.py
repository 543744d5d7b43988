"""Batched block copy on the card (port of
``repro/kernels/block_gather.py::block_gather``).

``block_gather`` launches ``csrc/block_gather.cu`` once on CUDA tensors of
any dtype: a warp takes 32 copy descriptors, loads their indices once and
copies the rows in 16-byte vectors where the row width and alignment
allow, bytes otherwise. Its plain version is
``kernels/ref.py::block_gather_ref``; ``kernels/ops.py`` chooses between
them by the tensor's device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_ARGTYPES = [_P] * 3 + [_LL] * 3 + [ctypes.c_int] * 2 + [_P]


def block_gather(flash: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[i] = flash[idx[i]]`` for (num_blocks, width) ``flash`` and
    (n,) i32 ``idx``, with JAX's index rule (negative counts from the end,
    then clamp into range)."""
    build.require(flash, "flash", None, 2)
    dev = flash.get_device()
    build.require(idx, "idx", torch.int32, 1, dev)
    num_blocks, width = flash.shape
    n = idx.shape[0]
    out = torch.empty((n, width), dtype=flash.dtype, device=flash.device)
    row_bytes = width * flash.element_size()
    src, dst = flash.data_ptr(), out.data_ptr()
    vec16 = row_bytes % 16 == 0 and (src | dst) % 16 == 0
    fn = build.bind("block_gather", _ARGTYPES)
    _, stream = build.launch_args(dev)
    rc = fn(src, idx.data_ptr(), dst, num_blocks, row_bytes, n, int(vec16),
            dev, stream)
    build.check("block_gather", rc)
    build.LAUNCHES["block_gather"] += 1
    return out
