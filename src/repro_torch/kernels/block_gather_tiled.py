"""Tiled batched block copy on the card (port of
``repro/kernels/block_gather.py::block_gather_tiled``).

``block_gather_tiled`` launches ``csrc/block_gather_tiled.cu`` once on CUDA
tensors of any dtype: ``block_gather``'s lanes-a-row layout (16-byte
vector copies where the row width allows, bytes otherwise), each CTA
owning a whole number of tiles of ``tile`` copy descriptors. Nothing on
the port's paths calls it, as nothing in the reference calls its
original. Its plain version is ``kernels/ref.py::block_gather_tiled_ref``;
``kernels/ops.py`` chooses between them by the tensor's device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int


def block_gather_tiled(flash: torch.Tensor, idx: torch.Tensor, *,
                       tile: int = 8) -> torch.Tensor:
    """``out[i] = flash[idx[i]]`` for (num_blocks, width) ``flash`` and
    (n,) i32 ``idx`` with ``n % tile == 0``, under the reference's index
    rule (negative counts from the end, then clamp into range)."""
    build.require(flash, "flash", None, 2)
    build.require(idx, "idx", torch.int32, 1, flash.device)
    num_blocks, width = flash.shape
    n = idx.shape[0]
    if tile < 1 or n % tile:
        raise ValueError(f"descriptor count {n} is not a multiple of "
                         f"tile={tile}")
    out = torch.empty((n, width), dtype=flash.dtype, device=flash.device)
    row_bytes = width * flash.element_size()
    vec16 = (
        row_bytes % 16 == 0
        and flash.data_ptr() % 16 == 0
        and out.data_ptr() % 16 == 0
    )
    fn = build.bind("block_gather_tiled",
                    [_P] * 3 + [_LL] * 3 + [_I] * 3 + [_P])
    dev, stream = build.launch_args(flash.device)
    rc = fn(build.ptr(flash), build.ptr(idx), build.ptr(out), num_blocks,
            row_bytes, n, tile, int(vec16), dev, stream)
    build.check("block_gather_tiled", rc)
    build.LAUNCHES["block_gather_tiled"] += 1
    return out
