"""Dispatch layer for the port's kernels (port of ``repro/kernels/ops.py``).

Each entry point dispatches on the device of the tensor it is given: a
CUDA tensor goes to the hand-written kernel (which raises if it cannot
launch — there is no fallback), a CPU tensor goes to the kernel's plain
PyTorch version in ``kernels/ref.py``, and any other device raises.
``LAUNCHES`` counts kernel launches per kernel (the CUDA wrappers add to
it; the plain versions never do).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import block_gather as _bg
from repro_torch.kernels import block_gather_tiled as _bgt
from repro_torch.kernels import build
from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import die_contention as _dc
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import fused_reap as _fr
from repro_torch.kernels import ref
from repro_torch.kernels import seg_scan as _ss

LAUNCHES = build.LAUNCHES
reset_launches = build.reset_launches


def _on_cuda(t: torch.Tensor, what: str) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{what}: no kernel or plain version for {t.device}")


def block_gather(flash: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    if _on_cuda(flash, "block_gather"):
        return _bg.block_gather(flash, idx)
    return ref.block_gather_ref(flash, idx)


def block_gather_tiled(flash: torch.Tensor, idx: torch.Tensor, *,
                       tile: int = 8) -> torch.Tensor:
    if _on_cuda(flash, "block_gather_tiled"):
        return _bgt.block_gather_tiled(flash, idx, tile=tile)
    return ref.block_gather_tiled_ref(flash, idx, tile=tile)


def seg_scan(values: torch.Tensor, heads: torch.Tensor) -> torch.Tensor:
    if _on_cuda(values, "seg_scan"):
        return _ss.seg_scan(values, heads)
    return ref.seg_scan_ref(values, heads)


def fused_reap(done_time, visible_time, req_id_ring, tail, key, done,
               req_id, valid):
    if _on_cuda(done_time, "fused_reap"):
        return _fr.fused_reap(
            done_time, visible_time, req_id_ring, tail, key, done, req_id,
            valid,
        )
    return ref.fused_reap_ref(
        done_time, visible_time, req_id_ring, tail, key, done, req_id, valid
    )


def die_contention(ready, cost, chip, event, chip_busy):
    if _on_cuda(ready, "die_contention"):
        return _dc.die_contention(ready, cost, chip, event, chip_busy)
    return ref.die_contention_ref(ready, cost, chip, event, chip_busy)


def flash_attention(q, k, v, **kw):
    """``kw``: ``causal``, ``window``, ``logit_softcap``, ``scale``."""
    if _on_cuda(q, "flash_attention"):
        return _fa.flash_attention(q.contiguous(), k.contiguous(),
                                   v.contiguous(), **kw)
    return ref.attention_ref(q, k, v, **kw)


def decode_attention(q, k_cache, v_cache, lengths, **kw):
    """``kw``: ``window``, ``logit_softcap``, ``scale``."""
    if _on_cuda(q, "decode_attention"):
        return _da.decode_attention(q.contiguous(), k_cache.contiguous(),
                                    v_cache.contiguous(), lengths, **kw)
    return ref.decode_attention_ref(q, k_cache, v_cache, lengths, **kw)
