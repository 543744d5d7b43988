"""The port's kernels: plain versions against the reference's Pallas
kernels, dispatch by device, and the CUDA kernels against their plain
versions on a card.

On the CPU the reference kernels run through ``repro.kernels.ops`` (Pallas
interpret mode) and must agree exactly with the port's plain versions —
all four are max/add folds, integer bookkeeping or data movement, exact
for any input. The CUDA kernels cannot run here; ``test_cuda_kernels_*``
builds and checks them on a machine with a card and skips otherwise.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.block_gather import block_gather_tiled as pallas_tiled
from repro_torch.kernels import build, ops, ref


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def same(a, b):
    a = np.ascontiguousarray(a)
    b = np.ascontiguousarray(b.cpu().numpy())
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a.reshape(-1).view(np.uint8),
                                  b.reshape(-1).view(np.uint8))


def seg_case(n, seed, p_head=0.15, first_head=True):
    rng = np.random.default_rng(seed)
    v = rng.uniform(-1e3, 1e3, n).astype(np.float32)
    h = rng.random(n) < p_head
    if first_head:
        h[0] = True
    return v, h


@pytest.mark.parametrize("n,first_head", [
    (1, True), (5, False), (33, True), (256, False), (300, True),
])
def test_seg_scan_plain_matches_pallas(n, first_head):
    v, h = seg_case(n, n, first_head=first_head)
    same(jops.seg_scan(jnp.asarray(v), jnp.asarray(h)),
         ref.seg_scan_ref(t(v), t(h)))
    same(jref.seg_scan_ref(jnp.asarray(v), jnp.asarray(h)),
         ref.seg_scan_ref(t(v), t(h)))


def die_case(n, k, seed, p_event=0.5):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 1000, n).astype(np.float32),
            rng.integers(1, 50, n).astype(np.float32),
            rng.integers(0, k, n).astype(np.int32),
            rng.random(n) < p_event,
            rng.integers(0, 1000, k).astype(np.float32))


@pytest.mark.parametrize("n,k,p", [(1, 1, 1.0), (48, 6, 0.5), (120, 4, 0.0),
                                   (200, 32, 0.8)])
def test_die_contention_plain_matches_pallas(n, k, p):
    args = die_case(n, k, n + k, p)
    rb, rc = jops.die_contention(*map(jnp.asarray, args))
    pb, pc = ref.die_contention_ref(*map(t, args))
    same(rb, pb)
    same(rc, pc)


def test_die_contention_plain_is_the_sequential_fold_on_fractions():
    """Fractional times: the plain version is still the row-order fold,
    one rounded max-then-add per event row."""
    rng = np.random.default_rng(7)
    n, k = 300, 5
    ready = rng.uniform(0, 100, n).astype(np.float32)
    cost = rng.uniform(0.1, 3, n).astype(np.float32)
    chip = rng.integers(0, k, n).astype(np.int32)
    event = rng.random(n) < 0.6
    cur = rng.uniform(0, 50, k).astype(np.float32)
    want_cur = cur.copy()
    want = np.zeros(n, np.float32)
    for i in range(n):
        if event[i]:
            b = np.float32(max(want_cur[chip[i]], ready[i]) + cost[i])
            want[i] = b
            want_cur[chip[i]] = b
    busy, new_cur = ref.die_contention_ref(
        t(ready), t(cost), t(chip), t(event), t(cur)
    )
    same(want, busy)
    same(want_cur, new_cur)


def reap_case(q, d, n, seed, tail_lo=0, tail_hi=50):
    rng = np.random.default_rng(seed)
    key = rng.integers(0, q, n).astype(np.int32)
    valid = rng.random(n) < 0.7
    key = np.where(valid, key, q).astype(np.int32)
    return (rng.uniform(0, 9, (q, d)).astype(np.float32),
            rng.uniform(0, 9, (q, d)).astype(np.float32),
            rng.integers(0, 99, (q, d)).astype(np.int32),
            rng.integers(tail_lo, tail_hi, q).astype(np.int32),
            key, rng.uniform(0, 1e4, n).astype(np.float32),
            rng.integers(0, 1 << 20, n).astype(np.int32), valid)


@pytest.mark.parametrize("q,d,n,lo,hi", [
    (1, 4, 30, 0, 3), (4, 8, 64, 0, 50), (8, 16, 100, 2**31 - 60, 2**31 - 1),
    (3, 2, 40, 0, 5),
])
def test_fused_reap_plain_matches_pallas(q, d, n, lo, hi):
    """Including tails that wrap the ring, int32 tail overflow, and more
    posts than slots (the last post to a slot wins)."""
    args = reap_case(q, d, n, q * d + n, lo, hi)
    for a, b in zip(jops.fused_reap(*map(jnp.asarray, args)),
                    ref.fused_reap_ref(*map(t, args))):
        same(a, b)


@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.float64])
def test_block_gather_plain_matches_pallas(dtype):
    rng = np.random.default_rng(1)
    flash = (rng.standard_normal((64, 16)) * 100).astype(dtype)
    idx = rng.integers(0, 64, 40).astype(np.int32)
    if dtype == np.float64:
        # The JAX reference runs with x64 off; hold f64 against numpy.
        np.testing.assert_array_equal(
            ref.block_gather_ref(t(flash), t(idx)).numpy(), flash[idx])
        return
    same(jops.block_gather(jnp.asarray(flash), jnp.asarray(idx)),
         ref.block_gather_ref(t(flash), t(idx)))


def test_block_gather_index_rule_is_jax_gather():
    flash = np.arange(40, dtype=np.float32).reshape(10, 4)
    idx = np.array([-30, -3, 0, 9, 10, 99], np.int32)
    same(jref.block_gather_ref(jnp.asarray(flash), jnp.asarray(idx)),
         ref.block_gather_ref(t(flash), t(idx)))


@pytest.mark.parametrize("tile", [1, 4, 8, 16])
@pytest.mark.parametrize("dtype", ["float32", "int32", "bfloat16"])
def test_block_gather_tiled_plain_matches_pallas(tile, dtype):
    """The tiled gather against the reference's kernel in interpret mode,
    with indices in range, negative and past the end."""
    rng = np.random.default_rng(tile)
    flash = (rng.standard_normal((48, 16)) * 100).astype(np.float32)
    idx = rng.integers(-60, 60, 6 * tile).astype(np.int32)
    if dtype == "bfloat16":
        want = pallas_tiled(jnp.asarray(flash).astype(jnp.bfloat16),
                            jnp.asarray(idx), tile=tile, interpret=True)
        got = ref.block_gather_tiled_ref(t(flash).bfloat16(), t(idx),
                                         tile=tile)
        same(np.asarray(want.astype(jnp.float32)), got.float())
        return
    flash = flash.astype(dtype)
    want = pallas_tiled(jnp.asarray(flash), jnp.asarray(idx), tile=tile,
                        interpret=True)
    same(want, ref.block_gather_tiled_ref(t(flash), t(idx), tile=tile))


def test_block_gather_tiled_index_rule_is_the_references():
    """Pinned against the reference's interpret mode: a negative index
    counts from the end, then indices clamp into range (as block_gather)."""
    flash = np.arange(40, dtype=np.float32).reshape(10, 4)
    idx = np.array([-30, -3, -1, 0, 9, 10, 99, 5], np.int32)
    want = pallas_tiled(jnp.asarray(flash), jnp.asarray(idx), tile=4,
                        interpret=True)
    np.testing.assert_array_equal(np.asarray(want)[:, 0],
                                  [0, 28, 36, 0, 36, 36, 36, 20])
    same(want, ref.block_gather_tiled_ref(t(flash), t(idx), tile=4))


def test_block_gather_tiled_refuses_ragged_descriptor_counts():
    """The reference asserts ``n % tile == 0``; the port raises."""
    flash = np.ones((8, 4), np.float32)
    idx = np.zeros(6, np.int32)
    with pytest.raises(AssertionError):
        pallas_tiled(jnp.asarray(flash), jnp.asarray(idx), tile=4,
                     interpret=True)
    with pytest.raises(ValueError, match="not a multiple of tile=4"):
        ops.block_gather_tiled(t(flash), t(idx), tile=4)
    with pytest.raises(ValueError, match="not a multiple of tile=0"):
        ops.block_gather_tiled(t(flash), t(idx), tile=0)


def test_ops_dispatch_cpu_tensors_to_plain_versions():
    build.reset_launches()
    v, h = seg_case(50, 3)
    same(np.asarray(ref.seg_scan_ref(t(v), t(h))), ops.seg_scan(t(v), t(h)))
    args = die_case(40, 3, 5)
    for a, b in zip(ref.die_contention_ref(*map(t, args)),
                    ops.die_contention(*map(t, args))):
        same(a.numpy(), b)
    args = reap_case(4, 8, 30, 9)
    for a, b in zip(ref.fused_reap_ref(*map(t, args)),
                    ops.fused_reap(*map(t, args))):
        same(a.numpy(), b)
    flash = np.ones((8, 4), np.float32)
    idx = np.array([1, 2], np.int32)
    same(flash[idx], ops.block_gather(t(flash), t(idx)))
    same(flash[idx], ops.block_gather_tiled(t(flash), t(idx), tile=2))
    assert all(c == 0 for c in ops.LAUNCHES.values())


def test_ops_refuse_other_devices():
    x = torch.empty(4, device="meta")
    with pytest.raises(ValueError, match="no kernel or plain version"):
        ops.seg_scan(x, x.bool())


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernel wrappers never take a CPU tensor (no quiet fallback)."""
    from repro_torch.kernels.seg_scan import seg_scan

    from repro_torch.kernels.block_gather_tiled import block_gather_tiled

    v, h = seg_case(8, 1)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        seg_scan(t(v), t(h))
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        block_gather_tiled(t(np.ones((4, 4), np.float32)),
                           t(np.zeros(4, np.int32)), tile=2)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions(card):
    from repro_torch.kernels.block_gather import block_gather
    from repro_torch.kernels.die_contention import die_contention
    from repro_torch.kernels.fused_reap import fused_reap
    from repro_torch.kernels.seg_scan import seg_scan

    def on(*xs):
        return [t(x).to(card) for x in xs]

    for n, fh in [(1, False), (8229, True), (300007, False)]:
        args = on(*seg_case(n, n, first_head=fh))
        same(ref.seg_scan_ref(*args).cpu().numpy(), seg_scan(*args))
    args = on(*die_case(8192, 32, 1, 0.3))
    for a, b in zip(ref.die_contention_ref(*args), die_contention(*args)):
        same(a.cpu().numpy(), b)
    args = on(*reap_case(32, 1024, 8192, 2, 900, 1024))
    for a, b in zip(ref.fused_reap_ref(*args), fused_reap(*args)):
        same(a.cpu().numpy(), b)
    flash = torch.randn(16384, 16, device=card)
    idx = t(np.random.default_rng(0).integers(0, 16384, 8192)
            .astype(np.int32)).to(card)
    same(ref.block_gather_ref(flash, idx).cpu().numpy(),
         block_gather(flash, idx))
    from repro_torch.kernels.block_gather_tiled import block_gather_tiled

    for tile in (1, 8, 16):
        same(ref.block_gather_tiled_ref(flash, idx, tile=tile).cpu().numpy(),
             block_gather_tiled(flash, idx, tile=tile))
