"""Flash-decoding on the card (port of
``repro/kernels/decode_attention.py::decode_attention``).

``decode_attention`` launches ``csrc/decode_attention.cu`` on CUDA tensors
(bf16 or f32, any cache length). bf16 with head dim 64, 128 or 256 runs the
split-KV body: the cache is cut into ``splits`` chunks chosen from the
cache length ``S`` alone (about three CTAs per SM), each CTA writes a
float32 partial (m, l, acc) to a scratch this wrapper allocates, and a
combine kernel of the same launch merges them. float32, or another head
dim, runs the SIMT body, one CTA per (sequence, KV head). Either way the
lengths stay on the card: the wrapper never reads them. Its plain version
is ``kernels/ref.py::decode_attention_ref``; ``kernels/ops.py`` chooses
between them by the tensor's device.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import DTYPES, check_options

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

SMEM_LIMIT = 232448  # bytes of shared memory a block may use on Hopper
SPLIT_HEAD_DIMS = (64, 128, 256)
TILE = 64          # cache rows a ring stage of the split body
HEADS = 16         # q heads a CTA of the split body (the mma's M)
CTAS_PER_SM = 3    # the split count aims at this many CTAs an SM


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_plan(b: int, hkv: int, group: int, s: int, sms: int):
    """(splits, chunk) for the split body: ``chunk`` cache rows a split, a
    multiple of ``TILE``, so that ``b * hkv * ceil(group / HEADS) *
    splits`` CTAs come near ``CTAS_PER_SM * sms``. Depends on the cache
    length ``s`` and the shapes only, never on the lengths."""
    tiles = -(-s // TILE)
    ctas = b * hkv * -(-group // HEADS)
    want = max(1, min(tiles, -(-CTAS_PER_SM * sms // ctas)))
    per = -(-tiles // want)
    return -(-tiles // per), per * TILE


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
    split = q.dtype == torch.bfloat16 and d in SPLIT_HEAD_DIMS and s > 0
    if not split:
        smem_bytes = build.library(
            "decode_attention").decode_attention_smem_bytes
        smem_bytes.argtypes = [_I, _I]
        smem_bytes.restype = _I
        smem = smem_bytes(hq // hkv, d)
        if smem > SMEM_LIMIT:
            raise ValueError(f"group {hq // hkv} x head dim {d} needs {smem} "
                             f"bytes of shared memory, above {SMEM_LIMIT}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    splits, chunk, part = 0, 0, None
    if split:
        if q.data_ptr() % 16:  # q is read in 16-byte pieces
            q = q.clone()
        splits, chunk = split_plan(b, hkv, hq // hkv, s,
                                   _sm_count(q.device.index))
        part = torch.empty(b * hq * splits * (d + 2), dtype=torch.float32,
                           device=q.device)
    part_o = build.ptr(part) if part is not None else _P(0)
    part_ml = (_P(part.data_ptr() + b * hq * splits * d * 4)
               if part is not None else _P(0))
    fn = build.bind("decode_attention", [_P] * 7 + [_I] * 7 + [_F] * 2
                    + [_I] * 3 + [_P])
    dev, stream = build.launch_args(q.device)
    rc = fn(build.ptr(q), build.ptr(k_cache), build.ptr(v_cache),
            build.ptr(lengths), build.ptr(out), part_o, part_ml, b, hq, hkv,
            s, d, DTYPES[q.dtype], window or 0, logit_softcap or 0.0,
            scale if scale is not None else d ** -0.5, splits, chunk, dev,
            stream)
    build.check("decode_attention", rc)
    build.LAUNCHES["decode_attention"] += 1
    return out
