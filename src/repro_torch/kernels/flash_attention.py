"""Blockwise attention forward on the card (port of
``repro/kernels/flash_attention.py::flash_attention``).

``flash_attention`` launches ``csrc/flash_attention.cu`` on CUDA tensors
(head dim 64, 128 or 256, any sequence length): bf16 goes through the
tensor-core body (TMA loads, ``wgmma``, P·V with p split into bf16 hi and
lo halves), float32 through the SIMT body. Its plain version is
``kernels/ref.py::attention_ref``; ``kernels/ops.py`` chooses between them
by the tensor's device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128, 256)


def check_options(window, logit_softcap) -> None:
    if window is not None and window < 1:
        raise ValueError(f"window={window} must be None or >= 1")
    if logit_softcap is not None and not logit_softcap > 0:
        raise ValueError(f"logit_softcap={logit_softcap} must be None or > 0")


def flash_attention(
    q: torch.Tensor,   # (B, Hq, S, D)
    k: torch.Tensor,   # (B, Hkv, S, D)
    v: torch.Tensor,   # (B, Hkv, S, D)
    *,
    causal: bool = True,
    window: "int | None" = None,
    logit_softcap: "float | None" = None,
    scale: "float | None" = None,
) -> torch.Tensor:
    """Attention of every q head ``h`` over KV head ``h // group``, with
    the causal mask, a local window (a row sees the last ``window``
    columns) and logit softcap ``cap * tanh(s / cap)``; out in q's type."""
    build.require(q, "q", None, 4)
    if q.dtype not in DTYPES:
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    build.require(k, "k", q.dtype, 4, q.device)
    build.require(v, "v", q.dtype, 4, q.device)
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    if k.shape != (b, hkv, s, d) or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must be "
                         f"({b}, Hkv, {s}, {d})")
    if hkv < 1 or hq % hkv:
        raise ValueError(f"Hq={hq} must be a multiple of Hkv={hkv}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} is not one of {HEAD_DIMS}")
    check_options(window, logit_softcap)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    # The TMA tensor maps need 16-byte aligned bases (a view may be offset).
    q, k, v = (x if x.data_ptr() % 16 == 0 else x.clone() for x in (q, k, v))
    fn = build.bind("flash_attention", [_P] * 4 + [_I] * 8 + [_F] * 2
                    + [_I, _P])
    dev, stream = build.launch_args(q.device)
    rc = fn(build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(out),
            b, hq, hkv, s, d, DTYPES[q.dtype], int(causal), window or 0,
            logit_softcap or 0.0,
            scale if scale is not None else d ** -0.5, dev, stream)
    build.check("flash_attention", rc)
    build.LAUNCHES["flash_attention"] += 1
    return out
