"""Chunked flash attention in plain PyTorch with the flash backward (port
of ``repro/models/flash_vjp.py``).

The ``use_pallas=False`` path of ``attention._flash_core``, and the one
that trains: a loop over q chunks and, inside, over kv chunks with an
online-softmax carry in float32, so live memory is O(B·H·q_chunk·kv_chunk)
rather than O(S²). Like the reference it visits every kv chunk and masks;
it skips none.

Plain autograd through that loop would store every chunk's carry. The
reference's custom VJP, here a ``torch.autograd.Function``, stores only
(q, k, v, o, L), L = m + log(l) per row, and recomputes the attention
probabilities chunk by chunk in the backward:

    D_i  = Σ_d dO_i · O_i
    P_ij = exp(S_ij − L_i)
    dV_j = Σ_i P_ij dO_i
    dS   = P ⊙ (dO Vᵀ − D)
    dQ_i = Σ_j dS_ij K_j · scale ;  dK_j = Σ_i dS_ij Q_i · scale

with GQA groups summed into dK/dV, the causal and window masks, and the
softcap's factor (dS_raw = dS_cap · (1 − (S_cap/cap)²)). Arithmetic is
float32 throughout; dq, dk and dv come out in the inputs' dtypes.
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


def _scores(qs, kc, cap):
    """Capped scores of the scaled q chunk, and tanh(s/cap) for the
    backward (None without a cap). qs: (B, Hkv, G, Cq, D) float32; kc:
    (B, Hkv, Ck, D) float32."""
    s = torch.matmul(qs, kc[:, :, None].transpose(-1, -2))
    if cap is None:
        return s, None
    t = torch.tanh(s / cap)
    return cap * t, t


def _fwd_impl(q, k, v, causal, window, cap, scale, q_chunk, kv_chunk):
    """(o in q's dtype, lse (B, Hq, S) float32)."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    nq, nk = s // q_chunk, s // kv_chunk
    kf = k.float().reshape(b, hkv, nk, kv_chunk, d)
    vf = v.float().reshape(b, hkv, nk, kv_chunk, d)
    dev = q.device
    outs, lses = [], []
    for iq in range(nq):
        qc = q[:, :, iq * q_chunk:(iq + 1) * q_chunk]
        qs = qc.reshape(b, hkv, g, q_chunk, d).float() * scale
        rows = iq * q_chunk + torch.arange(q_chunk, device=dev)
        m = torch.full((b, hkv, g, q_chunk, 1), NEG, device=dev)
        l = torch.zeros((b, hkv, g, q_chunk, 1), device=dev)
        acc = torch.zeros((b, hkv, g, q_chunk, d), device=dev)
        for ik in range(nk):
            sc, _ = _scores(qs, kf[:, :, ik], cap)
            cols = ik * kv_chunk + torch.arange(kv_chunk, device=dev)
            msk = _mask(rows, cols, causal, window)
            sc = torch.where(msk, sc, NEG)
            m_new = torch.maximum(m, torch.amax(sc, dim=-1, keepdim=True))
            p = torch.where(msk, torch.exp(sc - m_new), 0.0)
            alpha = torch.exp(m - m_new)
            l = alpha * l + torch.sum(p, dim=-1, keepdim=True)
            acc = acc * alpha + torch.matmul(p, vf[:, :, ik, None])
            m = m_new
        o = acc / torch.where(l > 0, l, 1.0)
        lse = m[..., 0] + torch.log(torch.clamp(l[..., 0], min=1e-30))
        outs.append(o.reshape(b, hq, q_chunk, d))
        lses.append(lse.reshape(b, hq, q_chunk))
    return torch.cat(outs, dim=2).to(q.dtype), torch.cat(lses, dim=2)


def _bwd_impl(q, k, v, o, lse, do, causal, window, cap, scale, q_chunk,
              kv_chunk):
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    nq, nk = s // q_chunk, s // kv_chunk
    dof = do.float()
    dd = torch.sum(dof * o.float(), dim=-1)                     # (B, Hq, S)
    kf = k.float().reshape(b, hkv, nk, kv_chunk, d)
    vf = v.float().reshape(b, hkv, nk, kv_chunk, d)
    dev = q.device
    dk = torch.zeros((b, hkv, nk, kv_chunk, d), device=dev)
    dv = torch.zeros((b, hkv, nk, kv_chunk, d), device=dev)
    dqs = []
    for iq in range(nq):
        rs = slice(iq * q_chunk, (iq + 1) * q_chunk)
        qc = q[:, :, rs].reshape(b, hkv, g, q_chunk, d).float()
        qs = qc * scale
        doc = dof[:, :, rs].reshape(b, hkv, g, q_chunk, d)
        lsec = lse[:, :, rs].reshape(b, hkv, g, q_chunk, 1)
        ddc = dd[:, :, rs].reshape(b, hkv, g, q_chunk, 1)
        rows = iq * q_chunk + torch.arange(q_chunk, device=dev)
        dq_c = torch.zeros((b, hkv, g, q_chunk, d), device=dev)
        for ik in range(nk):
            kc, vc = kf[:, :, ik], vf[:, :, ik]
            sc, t = _scores(qs, kc, cap)
            cols = ik * kv_chunk + torch.arange(kv_chunk, device=dev)
            msk = _mask(rows, cols, causal, window)
            p = torch.where(msk, torch.exp(sc - lsec), 0.0)
            # The group axis G is summed into the shared kv head.
            dv[:, :, ik] += torch.einsum("bhgqk,bhgqd->bhkd", p, doc)
            dp = torch.matmul(doc, vc[:, :, None].transpose(-1, -2))
            ds = p * (dp - ddc)
            if cap is not None:
                ds = ds * (1.0 - t * t)
            dq_c = dq_c + torch.matmul(ds, kc[:, :, None]) * scale
            dk[:, :, ik] += torch.einsum("bhgqk,bhgqd->bhkd", ds, qc) * scale
        dqs.append(dq_c.reshape(b, hq, q_chunk, d))
    dq = torch.cat(dqs, dim=2)
    return (dq.to(q.dtype), dk.reshape(b, hkv, s, d).to(k.dtype),
            dv.reshape(b, hkv, s, d).to(v.dtype))


class FlashAttention(torch.autograd.Function):
    """The reference's ``custom_vjp``: saves (q, k, v, o, lse) only."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, cap, scale, q_chunk, kv_chunk):
        o, lse = _fwd_impl(q, k, v, causal, window, cap, scale, q_chunk,
                           kv_chunk)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, window, cap, scale, q_chunk, kv_chunk)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _bwd_impl(q, k, v, o, lse, do, *ctx.args)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention_jnp(
    q, k, v, causal, window, cap, scale, q_chunk, kv_chunk
) -> torch.Tensor:
    """q (B, Hq, S, D), k/v (B, Hkv, S, D) -> (B, Hq, S, D) in q's type,
    differentiable in q, k and v through the flash backward."""
    s = q.shape[2]
    if s % q_chunk or s % kv_chunk:
        raise ValueError(f"S={s} must be a multiple of q_chunk={q_chunk} "
                         f"and kv_chunk={kv_chunk}")
    return FlashAttention.apply(q, k, v, causal, window, cap, scale, q_chunk,
                                kv_chunk)
