"""Dispatch layer for the port's kernels (port of ``repro/kernels/ops.py``).

Each entry point dispatches on the device of the tensor it is given: a
CUDA tensor goes to the hand-written kernel (which raises if it cannot
launch — there is no fallback), a CPU tensor goes to the kernel's plain
PyTorch version in ``kernels/ref.py``, and any other device raises.
``LAUNCHES`` counts kernel launches per kernel (the CUDA wrappers add to
it; the plain versions never do).

The four engine kernels also take an M-drive array, every operand with a
leading ``(M,)`` axis, in ONE launch: the drives are laid end to end
(rows concatenated, each drive's tables offset by its index) so that the
``.cu`` sources see one bigger problem whose per-drive pieces never
meet, and the result is split back. Both routes flatten alike, so the
plain versions check the flattening on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.core.segops import drive_offsets
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


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1).contiguous()


def block_gather(flash: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[..., i, :] = flash[..., idx[..., i], :]``; (nb, W) and (n,), or
    (M, nb, W) and (M, n) in one launch. Each drive's index is wrapped
    (negative counts from its end) and clamped into its own ``[0, nb)``
    BEFORE its offset ``d * nb`` is added: the kernel's own wrap and clamp
    are against the flattened ``M * nb`` rows and would carry a bad index
    into the next drive's blocks."""
    if flash.dim() == 3:
        m, nb = flash.shape[0], flash.shape[1]
        safe = torch.where(idx < 0, idx + nb, idx).clamp(0, nb - 1)
        flat = (safe + drive_offsets((m,), nb, idx.device)).to(torch.int32)
        out = block_gather(
            flash.reshape((m * nb,) + flash.shape[2:]).contiguous(),
            _flat(flat))
        return out.reshape(idx.shape + out.shape[1:])
    if _on_cuda(flash, "block_gather"):
        return _bg.block_gather(flash, idx)
    return ref.block_gather_ref(flash, idx)


def block_gather_tiled(flash: torch.Tensor, idx: torch.Tensor, *,
                       tile: int = 8) -> torch.Tensor:
    if _on_cuda(flash, "block_gather_tiled"):
        return _bgt.block_gather_tiled(flash, idx, tile=tile)
    return ref.block_gather_tiled_ref(flash, idx, tile=tile)


def seg_scan(values: torch.Tensor, heads: torch.Tensor) -> torch.Tensor:
    """Segmented inclusive prefix max of (n,) rows, or of (M, n) drives in
    one launch: the drives are concatenated with a head at each drive's
    first row."""
    if values.dim() == 2:
        heads = heads.clone()
        heads[:, 0] = True
        return seg_scan(_flat(values), _flat(heads)).reshape(values.shape)
    if _on_cuda(values, "seg_scan"):
        return _ss.seg_scan(values, heads)
    return ref.seg_scan_ref(values, heads)


def fused_reap(done_time, visible_time, req_id_ring, tail, key, done,
               req_id, valid):
    """The neutral CQ post on (Q, D) rings and (N,) rows, or on (M, Q, D)
    rings and (M, N) rows in one launch: the rings flatten to (M*Q, D),
    a valid row of drive d posts to CQ ``clip(key, 0, Q-1) + d*Q`` and an
    invalid one carries ``M*Q``. Each CQ keeps its own tail, so the int32
    wrap of ``tail + rank`` is that of a drive's own call."""
    if done_time.dim() == 3:
        m, q, d = done_time.shape
        flat_key = torch.where(
            valid, key.clamp(0, q - 1) + drive_offsets((m,), q, key.device),
            m * q).to(torch.int32)
        dt, vt, rid, counts = fused_reap(
            *(r.reshape(m * q, d).contiguous()
              for r in (done_time, visible_time, req_id_ring)),
            *(_flat(x) for x in (tail, flat_key, done, req_id, valid)))
        return (dt.reshape(m, q, d), vt.reshape(m, q, d),
                rid.reshape(m, q, d), counts.reshape(m, q))
    if _on_cuda(done_time, "fused_reap"):
        return _fr.fused_reap(
            done_time, visible_time, req_id_ring, tail, key, done, req_id,
            valid,
        )
    return ref.fused_reap_ref(
        done_time, visible_time, req_id_ring, tail, key, done, req_id, valid
    )


def die_contention(ready, cost, chip, event, chip_busy):
    """The in-order per-die fold of (N,) rows over (K,) dies, or of (M, N)
    rows over (M, K) dies in one launch: drive d's die c becomes die
    ``c + d*K`` of M*K, and a die's rows keep their order."""
    if chip_busy.dim() == 2:
        m, k = chip_busy.shape
        flat_chip = (chip + drive_offsets((m,), k, chip.device)).to(
            torch.int32)
        end, busy = die_contention(
            *(_flat(x) for x in (ready, cost, flat_chip, event, chip_busy)))
        return end.reshape(ready.shape), busy.reshape(m, k)
    if _on_cuda(ready, "die_contention"):
        return _dc.die_contention(ready, cost, chip, event, chip_busy)
    return ref.die_contention_ref(ready, cost, chip, event, chip_busy)


def _refuse_autograd(what: str, *tensors) -> None:
    """The attention kernels are forward only, as the reference's Pallas
    kernels are (its kernel path cannot be differentiated): a kernel's
    output carries no gradient, so an input that asks for one raises here
    rather than losing it. On either device, so that the kernel route
    behaves alike on both."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what}: the attention kernels have no backward; train with "
            "ModelConfig.use_pallas=False (the chunked flash_vjp path)")


def flash_attention(q, k, v, **kw):
    """``kw``: ``causal``, ``window``, ``logit_softcap``, ``scale``."""
    _refuse_autograd("flash_attention", q, k, v)
    if _on_cuda(q, "flash_attention"):
        return _fa.flash_attention(q.contiguous(), k.contiguous(),
                                   v.contiguous(), **kw)
    return ref.attention_ref(q, k, v, **kw)


def decode_attention(q, k_cache, v_cache, lengths, **kw):
    """``kw``: ``window``, ``logit_softcap``, ``scale``."""
    _refuse_autograd("decode_attention", q, k_cache, v_cache)
    if _on_cuda(q, "decode_attention"):
        return _da.decode_attention(q.contiguous(), k_cache.contiguous(),
                                    v_cache.contiguous(), lengths, **kw)
    return ref.decode_attention_ref(q, k_cache, v_cache, lengths, **kw)
