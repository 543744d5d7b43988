"""Recurrent sequence-mixing blocks: Griffin RG-LRU, xLSTM mLSTM / sLSTM
(port of ``repro/models/recurrent.py``).

All three expose (init, apply over a sequence, state init) and plug into
the same block assembly as attention:

* RG-LRU — diagonal gated linear recurrence, combined over time with
  ``segops.associative_scan`` (JAX's odd/even tree).
* mLSTM  — matrix memory; chunkwise-parallel form, a loop over chunks
  carrying the stabilized (C, n, m) state, quadratic attention-style
  work inside a chunk.
* sLSTM  — scalar memory with recurrent h-dependence, a loop over time
  (stabilized exponential gating).

The reference's ``checkpointed_scan`` rematerializes segments for the
backward pass; with the forward alone it is a plain loop, which is what
runs here. ``softplus`` and ``log_sigmoid`` are written as the
reference's ``jnp.logaddexp`` computes them (``F.softplus`` switches to
the identity above 20 and ``F.logsigmoid`` takes another formula).

Given a state, ``rglru_apply``, ``mlstm_apply`` and ``slstm_apply``
write the new state into its tensors as well as returning it, so a
captured decode step, which keeps its caches in place, carries them.

Inside a ``shard_map`` body on a mesh (``transformer.forward`` under
``sharding.use_rules``) each block takes the whole sequence of its rank's
batch rows (``sharding.seq_whole`` gathers a seq-sharded residual) and
returns its rows of the residual's layout (``sharding.seq_block``), next
to the reference's ``constrain`` hook.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import segops, xla_math
from repro_torch.distributed import sharding as shd
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig

NEG = -3e38


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jnp.logaddexp(x, 0)``: max(x, 0) + log1p(exp(-|x|)), and x + 0
    where that difference is a NaN."""
    big = torch.clamp(x, min=0.0)
    out = big + torch.log1p(torch.exp(-torch.abs(x)))
    return torch.where(torch.isnan(x), x + 0.0, out)


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: -softplus(-x)."""
    return -softplus(-x)


def _write_back(state, new):
    """Copy every leaf of ``new`` into the matching tensor of ``state``
    (``None`` leaves on either side are skipped). Returns ``state``."""
    if state is None:
        return new
    if isinstance(state, tuple):
        return tuple(_write_back(s, n) for s, n in zip(state, new))
    state.copy_(new)
    return state


# ---------------------------------------------------------------------------
# Griffin RG-LRU recurrent block.
# ---------------------------------------------------------------------------

def rglru_init(gen: torch.Generator, cfg: ModelConfig, dtype,
               stack: tuple = ()) -> dict:
    d = cfg.d_model
    lru = d  # lru_width == d_model (recurrentgemma)
    s = d ** -0.5
    lo, hi = -4.3, -1.0
    lam = torch.rand((*stack, lru), generator=gen, dtype=torch.float32,
                     device=gen.device) * (hi - lo) + lo
    return {
        "w_x": layers.normal(gen, (*stack, d, lru), s, dtype),
        "w_gate": layers.normal(gen, (*stack, d, lru), s, dtype),
        "conv_w": layers.normal(gen, (*stack, cfg.conv_width, lru), 0.1,
                                dtype),
        "conv_b": torch.zeros((*stack, lru), dtype=dtype, device=gen.device),
        "w_input_gate": layers.normal(gen, (*stack, lru, lru), s * 0.1,
                                      dtype),
        "w_rec_gate": layers.normal(gen, (*stack, lru, lru), s * 0.1, dtype),
        # Λ so that a = exp(-c·softplus(Λ)) spreads over (0.9, 0.999).
        "lambda_": lam,
        "w_out": layers.normal(gen, (*stack, lru, d), lru ** -0.5, dtype),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: "torch.Tensor | None" = None):
    """Depthwise causal conv along time. x: (B, S, C), w: (W, C).

    Returns (y, new_state) where state is the trailing (W-1) inputs."""
    width = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, width - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    s = x.shape[1]
    y = sum(xp[:, i:i + s] * w[i] for i in range(width)) + b
    new_state = xp[:, -(width - 1):] if width > 1 else None
    return y, new_state


def _lru_combine(lhs, rhs):
    """(a1, b1) then (a2, b2): (a1·a2, a2·b1 + b2), the second product
    fused into its add as the compiled reference does."""
    a1, b1 = lhs
    a2, b2 = rhs
    return [a1 * a2, xla_math._fma32(a2, b1, b2)]


def _rglru_core(xc: torch.Tensor, params: dict, cfg: ModelConfig,
                h0: "torch.Tensor | None"):
    """RG-LRU recurrence over (B, S, lru). Returns (h in xc's dtype,
    float32 h_last)."""
    xf = xc.float()
    gate_in = torch.sigmoid(xf @ params["w_input_gate"].float())
    gate_r = torch.sigmoid(xf @ params["w_rec_gate"].float())
    log_a = -cfg.rglru_c * softplus(params["lambda_"]) * gate_r
    a = torch.exp(log_a)                                   # (B, S, lru)
    # multiplier sqrt(1 - a^2), computed stably.
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    b_t = mult * gate_in * xf
    if h0 is not None:
        # Fold the carried state into the first step: b_0 += a_0 * h0.
        first = xla_math._fma32(a[:, 0], h0.float(), b_t[:, 0])
        b_t = torch.cat([first[:, None], b_t[:, 1:]], dim=1)
    _, h = segops.associative_scan(
        _lru_combine, [a.transpose(1, 2), b_t.transpose(1, 2)])
    h = h.transpose(1, 2)
    return h.to(xc.dtype), h[:, -1]


def rglru_apply(params: dict, x: torch.Tensor, cfg: ModelConfig,
                state: "tuple | None" = None):
    """Griffin recurrent block over a sequence. ``state`` = (conv_state
    (B, W-1, lru), h (B, lru) float32), written in place when given.
    Returns (y (B, S, D), new_state)."""
    conv_state, h0 = state if state is not None else (None, None)
    x = shd.seq_whole(x)
    gate = layers._act("gelu", x @ params["w_gate"])
    xr = x @ params["w_x"]
    xc, new_conv = _causal_conv(xr, params["conv_w"], params["conv_b"],
                                conv_state)
    h, h_last = _rglru_core(xc, params, cfg, h0)
    y = (h * gate) @ params["w_out"]
    y = shd.seq_block(shd.constrain(y, ("batch", "seq", "embed")))
    return y, _write_back(state, (new_conv, h_last))


def rglru_init_state(cfg: ModelConfig, batch: int, dtype, device,
                     stack: tuple = ()):
    lru = cfg.d_model
    return (
        torch.zeros((*stack, batch, cfg.conv_width - 1, lru), dtype=dtype,
                    device=device),
        torch.zeros((*stack, batch, lru), dtype=torch.float32, device=device),
    )


# ---------------------------------------------------------------------------
# xLSTM mLSTM block (matrix memory, chunkwise-parallel).
# ---------------------------------------------------------------------------

def mlstm_init(gen: torch.Generator, cfg: ModelConfig, dtype,
               stack: tuple = ()) -> dict:
    d = cfg.d_model
    dh = cfg.n_heads * cfg.d_head
    s = d ** -0.5
    sh = dh ** -0.5
    z = dict(device=gen.device)
    return {
        "w_up": layers.normal(gen, (*stack, d, dh), s, dtype),     # mlstm path
        "w_z": layers.normal(gen, (*stack, d, dh), s, dtype),      # output gate
        "conv_w": layers.normal(gen, (*stack, cfg.conv_width, dh), 0.1,
                                dtype),
        "conv_b": torch.zeros((*stack, dh), dtype=dtype, **z),
        "w_q": layers.normal(gen, (*stack, dh, dh), sh, dtype),
        "w_k": layers.normal(gen, (*stack, dh, dh), sh, dtype),
        "w_v": layers.normal(gen, (*stack, dh, dh), sh, dtype),
        "w_if": layers.normal(gen, (*stack, dh, 2 * cfg.n_heads), sh, dtype),
        "b_if": torch.zeros((*stack, 2 * cfg.n_heads), dtype=torch.float32,
                            **z),
        "w_down": layers.normal(gen, (*stack, dh, d), dh ** -0.5, dtype),
        "skip_scale": torch.ones((*stack, dh), dtype=dtype, **z),
    }


def _mlstm_chunk_scan(q, k, v, logi, logf, chunk: int, carry0=None):
    """Stabilized chunkwise-parallel mLSTM over q, k, v (B, H, S, dh) and
    float32 gates (B, H, S). Returns (h, carry)."""
    b, hh, s, dk = q.shape
    dv = v.shape[-1]
    g = min(chunk, s)
    if s % g:
        raise ValueError(f"sequence {s} is not a multiple of chunk {g}")
    ng = s // g
    dev = q.device

    qs = q.reshape(b, hh, ng, g, dk).float() * dk ** -0.5
    ks_ = k.reshape(b, hh, ng, g, dk).float()
    vs = v.reshape(b, hh, ng, g, dv).float()
    li = logi.reshape(b, hh, ng, g)
    lf = logf.reshape(b, hh, ng, g)

    if carry0 is None:
        carry0 = (torch.zeros((b, hh, dk, dv), dtype=torch.float32,
                              device=dev),
                  torch.zeros((b, hh, dk), dtype=torch.float32, device=dev),
                  torch.full((b, hh), NEG, dtype=torch.float32, device=dev))

    idx = torch.arange(g, device=dev)
    causal = idx[:, None] >= idx[None, :]                    # (g, g)

    c_prev, n_prev, m_prev = carry0
    hs = []
    for j in range(ng):
        qc, kc, vc = qs[:, :, j], ks_[:, :, j], vs[:, :, j]
        lic, lfc = li[:, :, j], lf[:, :, j]
        bcum = torch.cumsum(lfc, dim=-1)                     # (B,H,g) incl.
        btot = bcum[..., -1]
        # Intra-chunk exponents: D[t,s] = b_t - b_s + i_s (s<=t).
        expo = bcum[..., :, None] - bcum[..., None, :] + lic[..., None, :]
        expo = torch.where(causal, expo, NEG)
        m_intra = torch.amax(expo, dim=-1)                   # (B,H,g)
        m_inter = m_prev[..., None] + bcum                   # (B,H,g)
        m_t = torch.maximum(m_inter, m_intra)

        inter_scale = torch.exp(m_inter - m_t)               # (B,H,g)
        num_inter = torch.matmul(qc, c_prev) * inter_scale[..., None]
        den_inter = torch.matmul(qc, n_prev[..., None])[..., 0] * inter_scale

        w_intra = torch.exp(expo - m_t[..., None])           # (B,H,g,g)
        scores = torch.matmul(qc, kc.transpose(-1, -2)) * w_intra
        num = num_inter + torch.matmul(scores, vc)
        den = den_inter + torch.sum(scores, dim=-1)
        hs.append(num / torch.maximum(torch.abs(den),
                                      torch.exp(-m_t))[..., None])

        # Carry update (stabilized).
        m_new = torch.maximum(
            m_prev + btot,
            torch.amax(btot[..., None] - bcum + lic, dim=-1),
        )
        decay = torch.exp(m_prev + btot - m_new)             # (B,H)
        kw = torch.exp(btot[..., None] - bcum + lic - m_new[..., None])
        kwk = kc * kw[..., None]
        c_prev = (c_prev * decay[..., None, None]
                  + torch.matmul(kwk.transpose(-1, -2), vc))
        n_prev = n_prev * decay[..., None] + torch.sum(kwk, dim=2)
        m_prev = m_new
    h = torch.stack(hs, dim=2).reshape(b, hh, s, dv)
    return h, (c_prev, n_prev, m_prev)


def mlstm_apply(params: dict, x: torch.Tensor, cfg: ModelConfig,
                state: "tuple | None" = None, chunk: int = 256):
    """xLSTM mLSTM block. ``state`` = (conv_state, (C, n, m)), written in
    place when given."""
    x = shd.seq_whole(x)
    b, s, d = x.shape
    hh, dh = cfg.n_heads, cfg.d_head
    conv_state, cell = state if state is not None else (None, None)

    xin = x @ params["w_up"]
    z = x @ params["w_z"]
    xc, new_conv = _causal_conv(xin, params["conv_w"], params["conv_b"],
                                conv_state)
    xc = F.silu(xc)

    def heads(t):
        return t.reshape(b, s, hh, dh).transpose(1, 2)

    q = heads(xc @ params["w_q"])
    k = heads(xc @ params["w_k"])
    v = heads(xin @ params["w_v"])
    gates = xc.float() @ params["w_if"].float() + params["b_if"]
    gates = gates.reshape(b, s, 2, hh).permute(0, 3, 1, 2)   # (B,H,S,2)
    logi = gates[..., 0]
    logf = log_sigmoid(gates[..., 1])

    h, new_cell = _mlstm_chunk_scan(q, k, v, logi, logf, chunk, cell)
    h = h.transpose(1, 2).reshape(b, s, hh * dh).to(x.dtype)
    h = h + params["skip_scale"] * xc                     # learnable skip
    y = (h * F.silu(z)) @ params["w_down"]
    y = shd.seq_block(shd.constrain(y, ("batch", "seq", "embed")))
    return y, _write_back(state, (new_conv, new_cell))


def mlstm_init_state(cfg: ModelConfig, batch: int, dtype, device,
                     stack: tuple = ()):
    hh, dh = cfg.n_heads, cfg.d_head
    f32 = dict(dtype=torch.float32, device=device)
    return (
        torch.zeros((*stack, batch, cfg.conv_width - 1, hh * dh),
                    dtype=dtype, device=device),
        (
            torch.zeros((*stack, batch, hh, dh, dh), **f32),
            torch.zeros((*stack, batch, hh, dh), **f32),
            torch.full((*stack, batch, hh), NEG, **f32),
        ),
    )


# ---------------------------------------------------------------------------
# xLSTM sLSTM block (scalar memory, sequential).
# ---------------------------------------------------------------------------

def slstm_init(gen: torch.Generator, cfg: ModelConfig, dtype,
               stack: tuple = ()) -> dict:
    d = cfg.d_model
    dh = cfg.n_heads * cfg.d_head
    z = dict(device=gen.device)
    return {
        # Input projections for z, i, f, o (fused).
        "w_in": layers.normal(gen, (*stack, d, 4 * dh), d ** -0.5, dtype),
        "b_in": torch.zeros((*stack, 4 * dh), dtype=torch.float32, **z),
        # Recurrent (block-diagonal per head) h -> gates.
        "w_rec": layers.normal(gen, (*stack, cfg.n_heads, cfg.d_head,
                                     4 * cfg.d_head),
                               cfg.d_head ** -0.5, torch.float32),
        "norm": torch.zeros((*stack, dh), dtype=dtype, **z),
        "w_out": layers.normal(gen, (*stack, dh, d), dh ** -0.5, dtype),
    }


def slstm_apply(params: dict, x: torch.Tensor, cfg: ModelConfig,
                state: "tuple | None" = None):
    """Sequential sLSTM over time (stabilized exponential gating).
    ``state`` = (h, c, n, m), each (B, H, dh) float32, written in place
    when given."""
    x = shd.seq_whole(x)
    b, s, d = x.shape
    hh, dh = cfg.n_heads, cfg.d_head
    xin = (x @ params["w_in"]).float() + params["b_in"]
    xin = xin.reshape(b, s, 4, hh, dh)

    if state is None:
        h, c, n, m = slstm_init_state(cfg, b, x.dtype, x.device)
    else:
        h, c, n, m = state
    w_rec = params["w_rec"]                                  # (H, dh, 4dh)

    hs = []
    for i in range(s):
        xt = xin[:, i]
        rec = torch.matmul(h.transpose(0, 1), w_rec).transpose(0, 1)
        rec = rec.reshape(b, hh, 4, dh)
        zt = torch.tanh(xt[:, 0] + rec[:, :, 0])
        it = xt[:, 1] + rec[:, :, 1]
        ft = xt[:, 2] + rec[:, :, 2]
        ot = torch.sigmoid(xt[:, 3] + rec[:, :, 3])
        logf = log_sigmoid(ft)
        m_new = torch.maximum(logf + m, it)
        i_s = torch.exp(it - m_new)
        f_s = torch.exp(logf + m - m_new)
        c = f_s * c + i_s * zt
        n = f_s * n + i_s
        h = ot * c / torch.clamp(n, min=1e-6)
        m = m_new
        hs.append(h)

    out = torch.stack(hs, dim=1).reshape(b, s, hh * dh)      # (B,S,dh*H)
    out = layers.rms_norm(out.to(x.dtype), params["norm"])
    y = out @ params["w_out"]
    y = shd.seq_block(shd.constrain(y, ("batch", "seq", "embed")))
    return y, _write_back(state, (h, c, n, m))


def slstm_init_state(cfg: ModelConfig, batch: int, dtype, device,
                     stack: tuple = ()):
    """(h, c, n, m): zeros, but ``n`` at ones (``dtype`` is unused: the
    state is float32, as the reference's)."""
    shape = (*stack, batch, cfg.n_heads, cfg.d_head)
    z = dict(dtype=torch.float32, device=device)
    return (torch.zeros(shape, **z), torch.zeros(shape, **z),
            torch.ones(shape, **z), torch.zeros(shape, **z))


RGLRU_AXES = {
    "w_x": ("embed", "lru"), "w_gate": ("embed", "lru"),
    "conv_w": ("conv", "lru"), "conv_b": ("lru",),
    "w_input_gate": ("lru", "lru"), "w_rec_gate": ("lru", "lru"),
    "lambda_": ("lru",), "w_out": ("lru", "embed"),
}
MLSTM_AXES = {
    "w_up": ("embed", "heads"), "w_z": ("embed", "heads"),
    "conv_w": ("conv", "heads"), "conv_b": ("heads",),
    "w_q": ("heads", "heads"), "w_k": ("heads", "heads"),
    "w_v": ("heads", "heads"),
    "w_if": ("heads", None), "b_if": (None,),
    "w_down": ("heads", "embed"), "skip_scale": ("heads",),
}
SLSTM_AXES = {
    "w_in": ("embed", "heads"), "b_in": ("heads",),
    "w_rec": (None, "head_dim", "head_dim"),
    "norm": ("heads",), "w_out": ("heads", "embed"),
}
