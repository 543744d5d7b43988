"""Batched block copy on the card (port of
``repro/kernels/block_gather.py::block_gather``).

``block_gather`` launches ``csrc/block_gather.cu`` (16-byte vector copies
where the row width allows, bytes otherwise) on CUDA tensors of any
dtype. Its plain version is ``kernels/ref.py::block_gather_ref``;
``kernels/ops.py`` chooses between them by the tensor's device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_P = ctypes.c_void_p
_LL = ctypes.c_longlong


def block_gather(flash: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[i] = flash[idx[i]]`` for (num_blocks, width) ``flash`` and
    (n,) i32 ``idx``, with JAX's index rule (negative counts from the end,
    then clamp into range)."""
    build.require(flash, "flash", None, 2)
    build.require(idx, "idx", torch.int32, 1, flash.device)
    num_blocks, width = flash.shape
    n = idx.shape[0]
    out = torch.empty((n, width), dtype=flash.dtype, device=flash.device)
    row_bytes = width * flash.element_size()
    vec16 = (
        row_bytes % 16 == 0
        and flash.data_ptr() % 16 == 0
        and out.data_ptr() % 16 == 0
    )
    fn = build.bind(
        "block_gather", [_P] * 3 + [_LL] * 3 + [ctypes.c_int] * 2 + [_P]
    )
    dev, stream = build.launch_args(flash.device)
    rc = fn(build.ptr(flash), build.ptr(idx), build.ptr(out), num_blocks,
            row_bytes, n, int(vec16), dev, stream)
    build.check("block_gather", rc)
    build.LAUNCHES["block_gather"] += 1
    return out
