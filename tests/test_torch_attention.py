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

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.models.flash_vjp import flash_attention_jnp as jflash_jnp
from repro_torch.kernels import build, ops, ref
from repro_torch.models.flash_vjp import flash_attention_jnp

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
