"""Chunked flash attention in plain PyTorch, forward only (port of
``repro/models/flash_vjp.py::flash_attention_jnp``).

The ``use_pallas=False`` path of ``attention._flash_core``: a loop over q
chunks and, inside, over kv chunks with an online-softmax carry in
float32, so live memory is O(B·H·q_chunk·kv_chunk) rather than O(S²).
Like the reference it visits every kv chunk and masks; it skips none.
The custom backward comes with training (ROADMAP A18).
"""
from __future__ import annotations

import torch

NEG = -3e38


def _mask(rows, cols, causal, window):
    m = torch.ones((rows.shape[0], cols.shape[0]), dtype=torch.bool,
                   device=rows.device)
    if causal:
        m &= cols[None, :] <= rows[:, None]
    if window is not None:
        m &= cols[None, :] > rows[:, None] - window
    return m


def flash_attention_jnp(
    q, k, v, causal, window, cap, scale, q_chunk, kv_chunk
) -> torch.Tensor:
    """q (B, Hq, S, D), k/v (B, Hkv, S, D) -> (B, Hq, S, D) in q's type."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    if s % q_chunk or s % kv_chunk:
        raise ValueError(f"S={s} must be a multiple of q_chunk={q_chunk} "
                         f"and kv_chunk={kv_chunk}")
    nq, nk = s // q_chunk, s // kv_chunk
    kf = k.float().reshape(b, hkv, nk, kv_chunk, d)
    vf = v.float().reshape(b, hkv, nk, kv_chunk, d)
    dev = q.device
    outs = []
    for iq in range(nq):
        qc = q[:, :, iq * q_chunk:(iq + 1) * q_chunk]
        qc = qc.reshape(b, hkv, g, q_chunk, d).float() * scale
        rows = iq * q_chunk + torch.arange(q_chunk, device=dev)
        m = torch.full((b, hkv, g, q_chunk, 1), NEG, device=dev)
        l = torch.zeros((b, hkv, g, q_chunk, 1), device=dev)
        acc = torch.zeros((b, hkv, g, q_chunk, d), device=dev)
        for ik in range(nk):
            kc = kf[:, :, ik, None]   # (B, Hkv, 1, Ck, D)
            vc = vf[:, :, ik, None]
            sc = torch.matmul(qc, kc.transpose(-1, -2))
            if cap is not None:
                sc = cap * torch.tanh(sc / cap)
            cols = ik * kv_chunk + torch.arange(kv_chunk, device=dev)
            msk = _mask(rows, cols, causal, window)
            sc = torch.where(msk, sc, NEG)
            m_new = torch.maximum(m, torch.amax(sc, dim=-1, keepdim=True))
            p = torch.where(msk, torch.exp(sc - m_new), 0.0)
            alpha = torch.exp(m - m_new)
            l = alpha * l + torch.sum(p, dim=-1, keepdim=True)
            acc = acc * alpha + torch.matmul(p, vc)
            m = m_new
        o = acc / torch.where(l > 0, l, 1.0)
        outs.append(o.reshape(b, hq, q_chunk, d))
    return torch.cat(outs, dim=2).to(q.dtype)
