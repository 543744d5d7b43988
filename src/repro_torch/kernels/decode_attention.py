"""Flash-decoding on the card (port of
``repro/kernels/decode_attention.py::decode_attention``).

``decode_attention`` launches ``csrc/decode_attention.cu`` on CUDA tensors
(bf16 or f32, any cache length), one CTA per (sequence, KV head) serving
the KV head's whole group of q heads. The lengths stay on the card: the
wrapper never reads them. Its plain version is
``kernels/ref.py::decode_attention_ref``; ``kernels/ops.py`` chooses
between them by the tensor's device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import DTYPES, check_options

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

SMEM_LIMIT = 232448  # bytes of shared memory a block may use on Hopper


def decode_attention(
    q: torch.Tensor,        # (B, Hq, D)
    k_cache: torch.Tensor,  # (B, Hkv, S, D)
    v_cache: torch.Tensor,  # (B, Hkv, S, D)
    lengths: torch.Tensor,  # (B,) i32
    *,
    window: "int | None" = None,
    logit_softcap: "float | None" = None,
    scale: "float | None" = None,
) -> torch.Tensor:
    """One query row per (b, q head) against cache positions
    ``[0, lengths[b])`` (the last ``window`` of them with a window), GQA
    head ``h`` reading KV head ``h // group``; out in q's type."""
    build.require(q, "q", None, 3)
    if q.dtype not in DTYPES:
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    build.require(k_cache, "k_cache", q.dtype, 4, q.device)
    build.require(v_cache, "v_cache", q.dtype, 4, q.device)
    build.require(lengths, "lengths", torch.int32, 1, q.device)
    b, hq, d = q.shape
    hkv, s = k_cache.shape[1], k_cache.shape[2]
    if k_cache.shape != (b, hkv, s, d) or v_cache.shape != k_cache.shape:
        raise ValueError(f"caches {tuple(k_cache.shape)} and "
                         f"{tuple(v_cache.shape)} must be ({b}, Hkv, S, {d})")
    if lengths.shape != (b,):
        raise ValueError(f"lengths must be ({b},), got {tuple(lengths.shape)}")
    if hkv < 1 or hq % hkv:
        raise ValueError(f"Hq={hq} must be a multiple of Hkv={hkv}")
    vec = 16 // q.element_size()
    if d % vec or k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError(f"the caches must be 16-byte aligned with a head dim "
                         f"that is a multiple of {vec}")
    check_options(window, logit_softcap)
    smem_bytes = build.library("decode_attention").decode_attention_smem_bytes
    smem_bytes.argtypes = [_I, _I]
    smem_bytes.restype = _I
    smem = smem_bytes(hq // hkv, d)
    if smem > SMEM_LIMIT:
        raise ValueError(f"group {hq // hkv} x head dim {d} needs {smem} bytes "
                         f"of shared memory, above {SMEM_LIMIT}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    fn = build.bind("decode_attention", [_P] * 5 + [_I] * 7 + [_F] * 2
                    + [_I, _P])
    dev, stream = build.launch_args(q.device)
    rc = fn(build.ptr(q), build.ptr(k_cache), build.ptr(v_cache),
            build.ptr(lengths), build.ptr(out), b, hq, hkv, s, d,
            DTYPES[q.dtype], window or 0, logit_softcap or 0.0,
            scale if scale is not None else d ** -0.5, dev, stream)
    build.check("decode_attention", rc)
    build.LAUNCHES["decode_attention"] += 1
    return out
