"""The float32 ``pow`` and ``log`` of the workload stream, as XLA on the CPU
computes them, written as plain torch element ops so that the CPU and the
card round alike and both equal the reference bit for bit.

XLA's CPU backend lowers ``jnp.power(x, y)`` on float32 to a call of the C
library's ``powf`` (glibc's, the FMA build: a 16-entry log2 table and a
degree-5 polynomial in double, times ``y``, then a 32-entry exp2 table and
a degree-3 polynomial in double, rounded once to float32), run with
subnormal results flushed to zero. ``jnp.log`` on float32 is inlined as a
Cephes-style float32 polynomial whose multiply-adds LLVM contracts into
fused multiply-adds. ``torch.pow``/``torch.log`` and CUDA's ``powf``/
``logf`` each round differently from both, and a Zipf address or a Poisson
gap is a float32 that must match. The constants below are glibc's and
XLA's own; each fused multiply-add is emulated exactly (``_fma64`` in
double, ``_fma32`` through double), so the result does not depend on the
device's libm or on its compiler's contraction.

XLA's algebraic simplifier rewrites a power whose exponent is a compiled
constant of 2 or 3 into products (``x*x``, ``x*x*x``), so the reference's
compiled engine takes those, while its eager ``jnp.power`` (the exponent
then an argument) calls ``powf``; ``pow_f32`` follows the compiled engine.

Domain: ``pow_f32`` takes positive normal float32 bases and an exponent of
at least 1 for which the result is not above float32's range; ``log_f32``
takes positive finite float32. That is every draw of
``segops.uniform01``.

``lane_sum`` and ``lane_mean`` add a float32 axis in the order of XLA's
compiled CPU reduction, for the few places where a float sum's rounding
decides an outcome (a vector search's distances, a replica router's
loads).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core.types import F32

F64 = torch.float64

# glibc's powf_log2_data: (invc, logc) per subinterval, then the
# polynomial for log2(1 + r) (POWF_LOG2_POLY_ORDER = 5, POWF_SCALE = 1).
_LOG2_INVC = (
    "0x1.661ec79f8f3bep+0", "0x1.571ed4aaf883dp+0", "0x1.49539f0f010bp+0",
    "0x1.3c995b0b80385p+0", "0x1.30d190c8864a5p+0", "0x1.25e227b0b8eap+0",
    "0x1.1bb4a4a1a343fp+0", "0x1.12358f08ae5bap+0", "0x1.0953f419900a7p+0",
    "0x1p+0", "0x1.e608cfd9a47acp-1", "0x1.ca4b31f026aap-1",
    "0x1.b2036576afce6p-1", "0x1.9c2d163a1aa2dp-1", "0x1.886e6037841edp-1",
    "0x1.767dcf5534862p-1",
)
_LOG2_LOGC = (
    "-0x1.efec65b963019p-2", "-0x1.b0b6832d4fca4p-2", "-0x1.7418b0a1fb77bp-2",
    "-0x1.39de91a6dcf7bp-2", "-0x1.01d9bf3f2b631p-2", "-0x1.97c1d1b3b7afp-3",
    "-0x1.2f9e393af3c9fp-3", "-0x1.960cbbf788d5cp-4", "-0x1.a6f9db6475fcep-5",
    "0x0p+0", "0x1.338ca9f24f53dp-4", "0x1.476a9543891bap-3",
    "0x1.e840b4ac4e4d2p-3", "0x1.40645f0c6651cp-2", "0x1.88e9c2c1b9ff8p-2",
    "0x1.ce0a44eb17bccp-2",
)
_LOG2_POLY = (
    "0x1.27616c9496e0bp-2", "-0x1.71969a075c67ap-2", "0x1.ec70a6ca7baddp-2",
    "-0x1.7154748bef6c8p-1", "0x1.71547652ab82bp+0",
)
# glibc's exp2f_data: tab[i] = bits(2^(i/32)) - (i << 47), the shift that
# rounds to a multiple of 1/32, and the polynomial for 2^r (order 3).
_EXP2_TAB = (
    0x3ff0000000000000, 0x3fefd9b0d3158574, 0x3fefb5586cf9890f,
    0x3fef9301d0125b51, 0x3fef72b83c7d517b, 0x3fef54873168b9aa,
    0x3fef387a6e756238, 0x3fef1e9df51fdee1, 0x3fef06fe0a31b715,
    0x3feef1a7373aa9cb, 0x3feedea64c123422, 0x3feece086061892d,
    0x3feebfdad5362a27, 0x3feeb42b569d4f82, 0x3feeab07dd485429,
    0x3feea47eb03a5585, 0x3feea09e667f3bcd, 0x3fee9f75e8ec5f74,
    0x3feea11473eb0187, 0x3feea589994cce13, 0x3feeace5422aa0db,
    0x3feeb737b0cdc5e5, 0x3feec49182a3f090, 0x3feed503b23e255d,
    0x3feee89f995ad3ad, 0x3feeff76f2fb5e47, 0x3fef199bdd85529c,
    0x3fef3720dcef9069, 0x3fef5818dcfba487, 0x3fef7c97337b9b5f,
    0x3fefa4afa2a490da, 0x3fefd0765b6e4540,
)
_EXP2_SHIFT = float.fromhex("0x1.8p+47")
_EXP2_SHIFT_BITS = int(np.float64(_EXP2_SHIFT).view(np.int64))
_EXP2_POLY = ("0x1.c6af84b912394p-5", "0x1.ebfce50fac4f3p-3",
              "0x1.62e42ff0c52d6p-1")
_POWF_OFF = 0x3F330000
_FLT_MIN = float.fromhex("0x1p-126")

# XLA's float32 log (its constants as float32 bit patterns): the mantissa
# is folded into [sqrt(1/2), sqrt(2)), p(x) is evaluated as three
# interleaved Horner chains, and
# log(m 2^e) = x - x^2/2 + x^3 p(x) + e (ln2_lo + ln2_hi).
def _f32(bits: int) -> float:
    return float(np.array(bits, np.uint32).view(np.float32))


def _h(s: str) -> float:
    return float.fromhex(s)


_LOG_P = tuple(_f32(b) for b in (
    0x3D9021BB, 0xBDEBD1B8, 0x3DEF251A, 0xBDFE5D4F, 0x3E11E9BF, 0xBE2AAE50,
    0x3E4CCEAC, 0xBE7FFFFC, 0x3EAAAAAA,
))
_LOG_SQRTHF = _f32(0x3F3504F3)
_LN2_LO = _f32(0xB95E8083)
_LN2_HI = _f32(0x3F318000)


@functools.lru_cache(maxsize=8)
def _tables(device: torch.device):
    """The three tables on ``device`` (made on the host once a device)."""
    invc = torch.tensor([_h(s) for s in _LOG2_INVC], dtype=F64)
    logc = torch.tensor([_h(s) for s in _LOG2_LOGC], dtype=F64)
    exp2 = torch.tensor(_EXP2_TAB, dtype=torch.int64)
    return invc.to(device), logc.to(device), exp2.to(device)


# -- exact fused multiply-add --------------------------------------------------

def _two_sum(a: torch.Tensor, b: torch.Tensor):
    """s + e == a + b exactly, s = RN(a + b) (Knuth)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _split(a: torch.Tensor):
    """Veltkamp: a == hi + lo, each half 26 bits wide."""
    t = a * 134217729.0
    hi = t - (t - a)
    return hi, a - hi


def _two_prod(a: torch.Tensor, b: torch.Tensor):
    """p + e == a * b exactly, p = RN(a * b) (Dekker)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def _add_odd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a + b rounded to odd: the truncated sum, with its last bit set
    whenever the sum is inexact."""
    s, e = _two_sum(a, b)
    bits = s.view(torch.int64)
    step = torch.where((e > 0) == (s > 0), 1, -1)
    bump = (e != 0) & ((bits & 1) == 0)
    return torch.where(bump, bits + step, bits).view(F64)


def _fma64(a: torch.Tensor, b: "torch.Tensor | float",
           c: "torch.Tensor | float") -> torch.Tensor:
    """a * b + c rounded once, in double (Boldo and Melquiond's emulation
    through rounding to odd). Scalars become fills on ``a``'s device.
    Only ``pow_f32`` calls it, on doubles it builds from a base's and a
    table's bits, so no gradient ever reaches it (``_fma32`` is the one
    that training differentiates)."""
    b = b if isinstance(b, torch.Tensor) else torch.full_like(a, b)
    c = c if isinstance(c, torch.Tensor) else torch.full_like(a, c)
    uh, ul = _two_prod(a, b)
    th, tl = _two_sum(c, uh)
    return th + _add_odd(tl, ul)


class _Fma32(torch.autograd.Function):
    """float32 a * b + c rounded once: the product is exact in double, and
    a double sum rounded to odd then to float32 rounds as one step. The
    rounding goes through integer views, which autograd cannot follow, so
    the gradient is written out: that of ``a * b + c``, (g·b, g·a, g) in
    float32, as JAX differentiates the fused product."""

    @staticmethod
    def forward(ctx, a, b, c):
        ctx.save_for_backward(a, b)
        return _add_odd(a.to(F64) * b.to(F64), c.to(F64)).to(F32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(F32)
        return g * b.to(F32), g * a.to(F32), g


def _fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a * b + c rounded once (``_Fma32``), differentiable where
    the three operands share one shape (every differentiated call)."""
    return _Fma32.apply(a, b, c)


def const_div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` for a constant ``c`` as the reference's compiled code
    computes it: XLA's simplifier rewrites a division by a constant into a
    product with the float32 reciprocal ``1 / float32(c)``."""
    return x * float(np.float32(1) / np.float32(c))


# -- powf ----------------------------------------------------------------------

def _flushed(x: torch.Tensor) -> torch.Tensor:
    """Results below 2^-126 as zero: XLA runs with subnormals flushed."""
    return torch.where(x < _FLT_MIN, torch.zeros_like(x), x)


def pow_f32(x: torch.Tensor, y: "float | torch.Tensor") -> torch.Tensor:
    """``x ** float32(y)`` on float32 ``x`` as the reference's compiled
    ``jnp.power`` with a constant exponent gives it on the CPU: products
    for 2 and 3, else glibc's ``powf``; subnormal results flushed. A
    float32 tensor ``y`` (an exponent the reference computes, as AdamW's
    ``b1 ** step``) always takes ``powf``."""
    if isinstance(y, torch.Tensor):
        y = y.to(F64)
    else:
        y = float(np.float32(y))
        if y == 2.0:
            return _flushed(x * x)
        if y == 3.0:
            return _flushed(x * x * x)
    invc_t, logc_t, exp2_t = _tables(x.device)
    # log2_inline: x = 2^k z, z in [OFF, 2 OFF), c the centre of z's
    # subinterval; log2(x) = log1p(z/c - 1)/ln2 + log2(c) + k.
    ix = x.view(torch.int32).to(torch.int64)
    tmp = ix - _POWF_OFF
    i = ((tmp >> 19) & 15).long()
    top = tmp & ~0x7FFFFF
    z = (ix - top).to(torch.int32).view(F32).to(F64)
    k = (top >> 23).to(F64)
    # ``take``, not ``t[i]``: a 0-d index tensor would be read back to
    # the host as a Python integer.
    invc, logc = torch.take(invc_t, i), torch.take(logc_t, i)
    a0, a1, a2, a3, a4 = (_h(s) for s in _LOG2_POLY)
    r = _fma64(z, invc, -1.0)
    y0 = k + logc
    r2 = r * r
    yy = _fma64(r, a0, a1)
    p = _fma64(r, a2, a3)
    r4 = r2 * r2
    q = _fma64(r, a4, y0)
    q = _fma64(r2, p, q)
    logx = _fma64(r4, yy, q)
    ylogx = logx * y
    # exp2_inline: ylogx = n/32 + r, 2^ylogx = 2^(n/32) 2^r.
    xd = torch.clamp(ylogx, min=-1000.0)
    kd = xd + _EXP2_SHIFT
    n = kd.view(torch.int64) - _EXP2_SHIFT_BITS
    kd = kd - _EXP2_SHIFT
    r = xd - kd
    s = (torch.take(exp2_t, (n & 31).long()) + n * (1 << 47)).view(F64)
    c0, c1, c2 = (_h(s_) for s_ in _EXP2_POLY)
    zz = _fma64(r, c0, c1)
    r2 = r * r
    yy = _fma64(r, c2, 1.0)
    yy = _fma64(r2, zz, yy)
    return _flushed((yy * s).to(F32))


# -- logf ----------------------------------------------------------------------

def log_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``log`` on the CPU, fused multiply-adds included."""
    x = torch.clamp(x, min=_FLT_MIN)
    bits = x.view(torch.int32)
    e = ((bits >> 23) - 127).to(F32) + 1.0
    m = ((bits & -2139095041) | 0x3F000000).view(F32)   # in [0.5, 1)
    low = m < _LOG_SQRTHF
    xm = (m - 1.0) + torch.where(low, m, torch.zeros_like(m))
    e = e - low.to(F32)
    x2 = xm * xm
    x3 = x2 * xm
    p0, p1, p2, p3, p4, p5, p6, p7, p8 = (
        torch.full_like(xm, c) for c in _LOG_P)
    ya = _fma32(xm, p0, p1)
    yb = _fma32(xm, p3, p4)
    yc = _fma32(xm, p6, p7)
    ya = _fma32(xm, ya, p2)
    yb = _fma32(xm, yb, p5)
    yc = _fma32(xm, yc, p8)
    yy = _fma32(x3, ya, yb)
    yy = _fma32(x3, yy, yc)
    tail = _fma32(x3, yy, e * _LN2_LO)
    out = (xm - x2 * 0.5) + tail
    return out + e * _LN2_HI


# XLA's CPU backend rewrites a sum over more than this many elements into
# windows of this size (each summed in order), then sums the windows.
XLA_REDUCE_WINDOW = 32


def lane_sum(x: torch.Tensor) -> torch.Tensor:
    """Float32 sum over the last axis in the order of the reference's
    compiled ``jnp.sum``: up to 32 elements left to right from 0; more in
    windows of 32 (the axis padded with zeros to a whole number of
    windows, half the padding in front), each summed that way, and then
    the window sums, recursively."""
    n = x.shape[-1]
    if n > XLA_REDUCE_WINDOW:
        m = -(-n // XLA_REDUCE_WINDOW)
        pad = m * XLA_REDUCE_WINDOW - n
        if pad:
            shape = x.shape[:-1]
            x = torch.cat([x.new_zeros(shape + (pad // 2,)), x,
                           x.new_zeros(shape + (pad - pad // 2,))], dim=-1)
        x = lane_sum(x.reshape(x.shape[:-1] + (m, XLA_REDUCE_WINDOW)))
        return lane_sum(x)
    acc = x[..., 0] + 0.0
    for j in range(1, n):
        acc = acc + x[..., j]
    return acc


def lane_mean(x: torch.Tensor) -> torch.Tensor:
    """float32 mean over the last axis as the reference's compiled
    ``jnp.mean`` takes it: ``lane_sum``, times float32(1/n) (XLA turns the
    division by a constant into that product)."""
    return lane_sum(x) * float(np.float32(1.0 / x.shape[-1]))
