"""The port's attention kernels: plain versions against the reference's
oracles and its Pallas kernels (interpret mode), dispatch by device, the
chunked plain prefill path, and the CUDA kernels against their plain
versions on a card.

The plain versions run the kernels' float32 arithmetic; against the
reference's float32 oracles and Pallas kernels they agree to
``rtol=atol=1e-5`` (sums in another order). The Pallas shapes are ones its
wrappers accept: S a multiple of the q/kv block, the cache length a
multiple of the decode block. The CUDA kernels run only on a card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import close_enough
from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.models.flash_vjp import flash_attention_jnp as jflash_jnp
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels.decode_attention import TILE, split_plan
from repro_torch.models.flash_vjp import flash_attention_jnp
from port_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)


def qkv(b, hq, hkv, s, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, s, d)).astype(np.float32),
            rng.standard_normal((b, hkv, s, d)).astype(np.float32),
            rng.standard_normal((b, hkv, s, d)).astype(np.float32))


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# (b, hq, hkv, s, d, causal, window, softcap)
FLASH_CASES = [
    (1, 2, 2, 128, 16, True, None, None),      # group 1
    (2, 4, 2, 128, 32, True, None, None),      # group 2
    (1, 4, 1, 256, 16, True, 48, None),        # group 4, window
    (1, 2, 1, 128, 16, True, None, 5.0),       # softcap
    (1, 4, 2, 256, 16, True, 64, 3.0),         # window + softcap
    (1, 2, 2, 128, 16, False, None, None),     # not causal
]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_attention_plain_matches_reference(case):
    b, hq, hkv, s, d, causal, window, cap = case
    q, k, v = qkv(b, hq, hkv, s, d, s + hq)
    scale = d ** -0.5
    got = ref.attention_ref(t(q), t(k), t(v), causal=causal, window=window,
                            logit_softcap=cap, scale=scale).numpy()
    want = jref.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal, window=window,
                              logit_softcap=cap, scale=scale)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    pallas = pallas_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=causal, window=window, logit_softcap=cap,
                          scale=scale, block_q=128, block_k=128,
                          interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)


# (b, hq, hkv, s, d, lengths, window, softcap)
DECODE_CASES = [
    (2, 2, 2, 256, 16, [256, 100], None, None),   # group 1, short length
    (2, 4, 2, 256, 32, [1, 200], None, None),     # group 2
    (1, 4, 1, 512, 16, [300], 64, None),          # group 4, window
    (2, 4, 2, 256, 16, [256, 37], 32, 4.0),       # window + softcap
    (1, 2, 1, 256, 16, [129], None, 2.0),         # softcap
]


@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_attention_plain_matches_reference(case):
    b, hq, hkv, s, d, lengths, window, cap = case
    rng = np.random.default_rng(s + hq)
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    _, k, v = qkv(b, hq, hkv, s, d, s)
    lens = np.asarray(lengths, np.int32)
    scale = d ** -0.5
    got = ref.decode_attention_ref(t(q), t(k), t(v), t(lens), window=window,
                                   logit_softcap=cap, scale=scale).numpy()
    args = [jnp.asarray(x) for x in (q, k, v, lens)]
    want = jref.decode_attention_ref(*args, window=window, logit_softcap=cap,
                                     scale=scale)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    pallas = pallas_decode(*args, window=window, logit_softcap=cap,
                           scale=scale, block_k=256, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)


@pytest.mark.parametrize("causal,window,cap,chunk", [
    (True, None, None, 32), (True, 24, None, 16), (True, None, 4.0, 64),
    (False, None, None, 32),
])
def test_chunked_plain_prefill_matches_reference(causal, window, cap, chunk):
    """The ``use_pallas=False`` prefill core against the reference's."""
    q, k, v = qkv(2, 4, 2, 64, 16, chunk)
    got = flash_attention_jnp(t(q), t(k), t(v), causal, window, cap, 0.25,
                              chunk, chunk).numpy()
    want = jflash_jnp(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal,
                      window, cap, 0.25, chunk, chunk)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_plain_versions_keep_bf16_storage_and_float32_math():
    """bf16 in, bf16 out; the arithmetic is the float32 one on the same
    (bf16-rounded) values."""
    q, k, v = (torch.from_numpy(x).bfloat16() for x in qkv(1, 4, 2, 40, 16, 5))
    out = ref.attention_ref(q, k, v, window=16)
    assert out.dtype == torch.bfloat16
    f32 = ref.attention_ref(q.float(), k.float(), v.float(), window=16)
    assert torch.equal(out, f32.bfloat16())
    lens = torch.tensor([40], dtype=torch.int32)
    dec = ref.decode_attention_ref(q[:, :, -1], k, v, lens, logit_softcap=3.0)
    assert dec.dtype == torch.bfloat16
    assert torch.equal(dec, ref.decode_attention_ref(
        q[:, :, -1].float(), k.float(), v.float(), lens,
        logit_softcap=3.0).bfloat16())


def test_plain_versions_handle_any_length():
    """Ragged S and lengths past S: the kernels' contract, not the Pallas
    wrappers' (which need multiples of their blocks)."""
    q, k, v = (t(x) for x in qkv(1, 2, 1, 37, 16, 9))
    full = ref.attention_ref(q, k, v)
    # Row 36 of causal attention is the decode of token 36 over 37 rows.
    dec = ref.decode_attention_ref(q[:, :, 36], k, v,
                                   torch.tensor([37], dtype=torch.int32))
    torch.testing.assert_close(dec, full[:, :, 36], **TOL)
    past = ref.decode_attention_ref(q[:, :, 36], k, v,
                                    torch.tensor([99], dtype=torch.int32))
    torch.testing.assert_close(past, dec, **TOL)


def test_ops_dispatch_cpu_tensors_to_plain_versions():
    build.reset_launches()
    q, k, v = (t(x) for x in qkv(1, 4, 2, 33, 16, 3))
    kw = dict(window=8, logit_softcap=2.0, scale=0.3)
    assert torch.equal(ops.flash_attention(q, k, v, **kw),
                       ref.attention_ref(q, k, v, **kw))
    lens = torch.tensor([20], dtype=torch.int32)
    assert torch.equal(ops.decode_attention(q[:, :, 0], k, v, lens, **kw),
                       ref.decode_attention_ref(q[:, :, 0], k, v, lens, **kw))
    assert all(c == 0 for c in ops.LAUNCHES.values())


def test_attention_wrappers_refuse_cpu_tensors():
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention

    q, k, v = (t(x) for x in qkv(1, 2, 1, 64, 64, 1))
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        flash_attention(q, k, v)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        decode_attention(q[:, :, 0], k, v, torch.ones(1, dtype=torch.int32))
    meta = torch.empty((1, 2, 4, 64), device="meta")
    with pytest.raises(ValueError, match="no kernel or plain version"):
        ops.flash_attention(meta, meta, meta)


# -- the card kernels' arithmetic, emulated in plain torch -------------------
#
# The CUDA kernels run only on a card; these emulations repeat their
# arithmetic on the CPU so that the designs are checked before any card
# time: split-KV decode (per-split partials, then the combine) and the
# tensor-core flash numerics (bf16 operands, float32 accumulation, scale
# and softcap on the float32 scores, P·V with p split into bf16 hi and lo).

NEG = torch.tensor(ref.NEG)


def pv(p, v, split):
    """p @ v as the kernels take it: p split into bf16 hi and lo halves
    (``split``), or rounded once to bf16 (what the split avoids)."""
    hi = p.bfloat16().float()
    out = torch.matmul(hi, v)
    if split:
        out = out + torch.matmul((p - hi).bfloat16().float(), v)
    return out


def emulate_split_decode(q, k, v, lengths, *, window=None, cap=None,
                         scale=None, splits, chunk, split_p=False):
    """Split-KV decode: split ``i`` covers cache rows ``[i*chunk,
    (i+1)*chunk)`` and writes (m, l, acc) over its live rows, or (NEG, 0)
    when none is live; the combine rescales by ``exp(m_i - m)`` over the
    splits with ``l_i > 0`` and divides by ``l`` (0 -> 1)."""
    b, hq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    qf = q.float().reshape(b, hkv, g, d)
    out = torch.zeros((b, hkv, g, d))
    for bi in range(b):
        length = int(lengths[bi])
        end = min(length, s)
        lo = max(0, length - window) if window is not None else 0
        parts = []
        for i in range(splits):
            beg, stop = max(i * chunk, lo), min((i + 1) * chunk, end)
            if beg >= stop:
                parts.append((NEG.expand(hkv, g), torch.zeros(hkv, g), None))
                continue
            kk = k[bi, :, beg:stop].float()
            sc = torch.einsum("hgd,hnd->hgn", qf[bi], kk) * scale
            if cap is not None:
                sc = cap * torch.tanh(sc / cap)
            m = sc.amax(-1)
            p = torch.exp(sc - m[..., None])
            vv = v[bi, :, beg:stop].float()
            acc = pv(p, vv, True) if split_p else torch.matmul(p, vv)
            parts.append((m, p.sum(-1), acc))
        live = [pt for pt in parts if bool((pt[1] > 0).all())]
        assert len(live) == sum(pt[2] is not None for pt in parts)
        if not live:
            continue
        m = torch.stack([pt[0] for pt in live]).amax(0)
        w = [torch.exp(pt[0] - m) for pt in live]
        l = sum(pt[1] * wi for pt, wi in zip(live, w))
        acc = sum(pt[2] * wi[..., None] for pt, wi in zip(live, w))
        out[bi] = acc / torch.where(l > 0, l, 1.0)[..., None]
    return out.reshape(b, hq, d).to(q.dtype)


# (b, hq, hkv, s, lengths, window, softcap, chunk): chunk None = the
# wrapper's own plan on a 132-SM card.
SPLIT_CASES = [
    (2, 2, 2, 256, [1, 256], None, None, 64),            # group 1, S
    (3, 4, 2, 256, [63, 64, 65], None, None, 64),        # split edge -1/0/+1
    (2, 24, 2, 512, [128, 129], None, None, 128),        # group 12, edge +1
    (2, 4, 2, 512, [512, 300], 40, None, 64),            # windows empty splits
    (1, 24, 2, 1024, [1000], 70, 3.0, 128),              # window + softcap
    (2, 4, 1, 256, [200, 17], None, 2.0, None),          # softcap, own plan
    (8, 24, 2, 1024, [1024, 960, 961, 959, 1, 2, 512, 700], None, None, None),
]


@pytest.mark.parametrize("case", SPLIT_CASES)
def test_split_kv_decode_emulation_matches_reference(case):
    b, hq, hkv, s, lengths, window, cap, chunk = case
    d = 16
    if chunk is None:
        splits, chunk = split_plan(b, hkv, hq // hkv, s, 132)
    else:
        splits = -(-s // chunk)
    assert chunk % TILE == 0 and (splits - 1) * chunk < s <= splits * chunk
    rng = np.random.default_rng(s + hq + b)
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    _, k, v = qkv(b, hq, hkv, s, d, s + 1)
    lens = np.asarray(lengths, np.int32)
    scale = d ** -0.5
    got = emulate_split_decode(t(q), t(k), t(v), t(lens), window=window,
                               cap=cap, scale=scale, splits=splits,
                               chunk=chunk).numpy()
    want = ref.decode_attention_ref(t(q), t(k), t(v), t(lens), window=window,
                                    logit_softcap=cap, scale=scale).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    args = [jnp.asarray(x) for x in (q, k, v, lens)]
    pallas = pallas_decode(*args, window=window, logit_softcap=cap,
                           scale=scale, block_k=256, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)


def test_split_plan_fills_the_card_from_the_cache_length_alone():
    """At serve_long's decode (8 sequences, 2 KV heads, group 12, 4224-row
    caches) the plan gives 22 splits of 192 rows: 352 CTAs on 132 SMs."""
    assert split_plan(8, 2, 12, 4224, 132) == (22, 192)
    for b, hkv, g, s in [(1, 1, 1, 1), (4, 2, 12, 48), (2, 16, 2, 4224),
                         (1, 8, 40, 131072)]:
        splits, chunk = split_plan(b, hkv, g, s, 132)
        assert chunk % TILE == 0 and (splits - 1) * chunk < s <= splits * chunk


def test_split_kv_decode_bf16_keeps_the_tolerance():
    """bf16 caches through the split with p split into hi/lo for P·V stay
    inside the card tolerance against the plain version."""
    q, k, v = (t(x).bfloat16() for x in qkv(4, 24, 2, 512, 64, 11))
    lens = torch.tensor([512, 129, 1, 300], dtype=torch.int32)
    got = emulate_split_decode(q[:, :, 0], k, v, lens, splits=4, chunk=128,
                               split_p=True)
    assert close_enough(got, ref.decode_attention_ref(q[:, :, 0], k, v, lens))


def emulate_flash(q, k, v, *, causal=True, window=None, cap=None,
                  scale=None, bk=128, split=True):
    """The tensor-core flash body's numerics over kv tiles of ``bk`` rows:
    bf16 q·kᵀ accumulated in float32 (exact products), scale and softcap
    on the float32 scores, the online softmax in float32, P·V with p in
    bf16 hi/lo halves (``split``) or rounded once, O / l rounded once."""
    b, hq, s, d = q.shape
    g = hq // k.shape[1]
    scale = scale if scale is not None else d ** -0.5
    qf = q.float()
    kf = k.float().repeat_interleave(g, 1)
    vf = v.float().repeat_interleave(g, 1)
    rows = torch.arange(s)[:, None]
    m = torch.full((b, hq, s), ref.NEG)
    l = torch.zeros((b, hq, s))
    o = torch.zeros((b, hq, s, d))
    for k0 in range(0, s, bk):
        cols = torch.arange(k0, min(k0 + bk, s))[None, :]
        sc = torch.matmul(qf, kf[:, :, k0:k0 + bk].transpose(-1, -2)) * scale
        if cap is not None:
            sc = cap * torch.tanh(sc / cap)
        keep = torch.ones((s, cols.shape[1]), dtype=torch.bool)
        if causal:
            keep &= cols <= rows
        if window is not None:
            keep &= cols > rows - window
        sc = torch.where(keep, sc, NEG)
        mx = torch.maximum(m, sc.amax(-1))
        a = torch.exp(m - mx)
        p = torch.where(sc == NEG, 0.0, torch.exp(sc - mx[..., None]))
        l = l * a + p.sum(-1)
        o = o * a[..., None] + pv(p, vf[:, :, k0:k0 + bk], split)
        m = mx
    return (o / torch.where(l > 0, l, 1.0)[..., None]).to(q.dtype)


# (b, hq, hkv, s, d, causal, window, softcap, bk)
FLASH_NUMERICS_CASES = [
    (1, 4, 2, 256, 64, True, None, None, 128),    # causal, group 2
    (1, 4, 2, 200, 64, True, 48, None, 128),      # window, ragged S
    (1, 2, 1, 300, 128, True, None, 5.0, 128),    # softcap, ragged S
    (2, 4, 4, 77, 32, True, None, None, 64),      # one ragged tile
    (1, 24, 2, 130, 32, False, None, None, 64),   # group 12, not causal
]


@pytest.mark.parametrize("case", FLASH_NUMERICS_CASES)
def test_flash_tensor_core_numerics_keep_the_tolerance(case):
    b, hq, hkv, s, d, causal, window, cap, bk = case
    q, k, v = (t(x).bfloat16() for x in qkv(b, hq, hkv, s, d, s + d))
    want = ref.attention_ref(q, k, v, causal=causal, window=window,
                             logit_softcap=cap)
    got = emulate_flash(q, k, v, causal=causal, window=window, cap=cap,
                        bk=bk)
    assert close_enough(got, want)


@pytest.mark.parametrize("case", FLASH_NUMERICS_CASES)
def test_flash_with_p_rounded_once_to_bf16_misses_the_tolerance(case):
    """Why P·V splits p: rounded once to bf16, as a stock flash kernel
    does, p misses the plain version beyond the bf16 bound (on the output
    elements near zero)."""
    b, hq, hkv, s, d, causal, window, cap, bk = case
    q, k, v = (t(x).bfloat16() for x in qkv(b, hq, hkv, s, d, s + d))
    want = ref.attention_ref(q, k, v, causal=causal, window=window,
                             logit_softcap=cap)
    got = emulate_flash(q, k, v, causal=causal, window=window, cap=cap,
                        bk=bk, split=False)
    assert not close_enough(got, want)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_attention_kernels_match_plain_versions(card):
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention

    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        q, k, v = (t(x).to(card, dtype) for x in qkv(2, 4, 2, 200, 128, 4))
        for kw in ({}, dict(window=64, logit_softcap=50.0)):
            torch.testing.assert_close(
                flash_attention(q, k, v, **kw).float(),
                ref.attention_ref(q, k, v, **kw).float(), rtol=tol, atol=tol)
            lens = torch.tensor([200, 77], dtype=torch.int32, device=card)
            torch.testing.assert_close(
                decode_attention(q[:, :, 0].contiguous(), k, v, lens,
                                 **kw).float(),
                ref.decode_attention_ref(q[:, :, 0], k, v, lens, **kw).float(),
                rtol=tol, atol=tol)
