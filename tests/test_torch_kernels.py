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
from port_threads import one_torch_thread  # noqa: F401


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


def seg_special_case(n, kind, seed):
    """``signed-zeros``: values of +0 and -0. ``nan``: finite values with
    NaNs of two payloads and both signs on 5% of the elements. Random
    heads, the first element not a head."""
    rng = np.random.default_rng(seed)
    if kind == "signed-zeros":
        v = rng.choice(np.array([0.0, -0.0], np.float32), n)
    else:
        v = rng.uniform(-1e3, 1e3, n).astype(np.float32)
        v[rng.random(n) < 0.05] = rng.choice(
            np.array([0x7FC00001, 0xFFA00042], np.uint32).view(np.float32))
    h = rng.random(n) < 0.1
    h[0] = False
    return v, h


@pytest.mark.parametrize("kind", ["signed-zeros", "nan"])
@pytest.mark.parametrize("n", [8, 300, 4096])
def test_seg_scan_plain_matches_pallas_on_special_values(n, kind):
    """Of two zeros the max takes +0, and -0 stays where every value so
    far in the segment is -0 (the Pallas kernel adds nothing). A NaN runs
    to the segment's end: positions equal, and the plain version pins the
    card's canonical NaN 0x7FFFFFFF (the CUDA kernel's ``max.NaN.f32``
    returns no other), while the reference passes an input's payload
    through, so the payload is not compared with the reference."""
    v, h = seg_special_case(n, kind, n)
    want = np.asarray(jops.seg_scan(jnp.asarray(v), jnp.asarray(h)))
    got = ref.seg_scan_ref(t(v), t(h)).numpy()
    nan = np.isnan(want)
    np.testing.assert_array_equal(nan, np.isnan(got))
    np.testing.assert_array_equal(want[~nan].view(np.uint32),
                                  got[~nan].view(np.uint32))
    assert (got[nan].view(np.uint32) == 0x7FFFFFFF).all()


def test_jax_max_lives_in_segops():
    from repro_torch.core import segops

    assert ref.jax_max is segops.jax_max


def test_every_source_is_a_kernel_or_the_launch_floor():
    """``build_all`` compiles every ``csrc/*.cu``; only the seven kernels
    have launch counts."""
    names = sorted(p.stem for p in build.CSRC.glob("*.cu"))
    assert names == sorted(build.SOURCES)
    assert "launch_floor" not in build.KERNELS
    assert "launch_floor" not in build.LAUNCHES


def test_bind_caches_one_signature_a_function(monkeypatch):
    """``bind`` sets a launch function's signature once; a later call with
    the same signature gets the cached function, one with another raises
    instead of launching with the first signature's conversions."""
    import ctypes
    import types

    lib = types.SimpleNamespace(probe_launch=ctypes.CDLL(None).abs)
    monkeypatch.setattr(build, "library", lambda name: lib)
    monkeypatch.setattr(build, "_FNS", {})
    fn = build.bind("probe", [ctypes.c_int])
    assert fn.restype is ctypes.c_int and fn(-3) == 3
    assert build.bind("probe", [ctypes.c_int]) is fn
    with pytest.raises(ValueError, match="probe_launch"):
        build.bind("probe", [ctypes.c_void_p])


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


def signed_zero_case(n, k, seed):
    """Readies and costs of +0 and -0, cursors of -0. Costs mostly -0 keep
    -0 cursors alive, so that a -0 cursor meets a +0 ready again and
    again."""
    rng = np.random.default_rng(seed)
    zeros = np.array([0.0, -0.0], np.float32)
    return (rng.choice(zeros, n), rng.choice(zeros, n, p=[0.1, 0.9]),
            rng.integers(0, k, n).astype(np.int32), rng.random(n) < 0.7,
            np.full(k, -0.0, np.float32))


def test_die_contention_plain_matches_pallas_on_signed_zeros():
    """Of two zeros the reference's max takes +0, and a cost of -0 keeps
    the max's sign in the output."""
    args = signed_zero_case(256, 4, 11)
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


def reap_case(q, d, n, seed, tail_lo=0, tail_hi=50, p_valid=0.7):
    rng = np.random.default_rng(seed)
    key = rng.integers(0, q, n).astype(np.int32)
    valid = rng.random(n) < p_valid
    key = np.where(valid, key, q).astype(np.int32)
    return (rng.uniform(0, 9, (q, d)).astype(np.float32),
            rng.uniform(0, 9, (q, d)).astype(np.float32),
            rng.integers(0, 99, (q, d)).astype(np.int32),
            rng.integers(tail_lo, tail_hi, q).astype(np.int32),
            key, rng.uniform(0, 1e4, n).astype(np.float32),
            rng.integers(0, 1 << 20, n).astype(np.int32), valid)


@pytest.mark.parametrize("q,d,n,lo,hi,p_valid", [
    pytest.param(1, 4, 30, 0, 3, 0.7, id="1-4-30-0-3"),
    pytest.param(4, 8, 64, 0, 50, 0.7, id="4-8-64-0-50"),
    pytest.param(8, 16, 100, 2**31 - 60, 2**31 - 1, 0.7,
                 id="8-16-100-2147483588-2147483647"),
    pytest.param(3, 2, 40, 0, 5, 0.7, id="3-2-40-0-5"),
    # The int32 tail wraps inside a CQ's last D posts and D does not
    # divide 2^32: the slots of consecutive ranks jump at the wrap.
    pytest.param(1, 6, 10, 2**31 - 7, 2**31 - 6, 1.0, id="wrap-1-6-10"),
    pytest.param(3, 1000, 5000, 2**31 - 1100, 2**31 - 900, 0.7,
                 id="wrap-3-1000-5000"),
])
def test_fused_reap_plain_matches_pallas(q, d, n, lo, hi, p_valid):
    """Including tails that wrap the ring, int32 tail overflow, more
    posts than slots (the last post to a slot wins), and a tail that
    wraps past 2^31 inside the last D posts."""
    args = reap_case(q, d, n, q * d + n, lo, hi, p_valid)
    for a, b in zip(jops.fused_reap(*map(jnp.asarray, args)),
                    ref.fused_reap_ref(*map(t, args))):
        same(a, b)


def wrap_reproduction():
    """One CQ of depth 6, ten valid posts from tail 2^31 - 7, req_id =
    row, ring pre-filled with -1: the tail wraps at the eighth post."""
    n = 10
    return (np.zeros((1, 6), np.float32), np.zeros((1, 6), np.float32),
            np.full((1, 6), -1, np.int32), np.array([2**31 - 7], np.int32),
            np.zeros(n, np.int32), np.arange(n, dtype=np.float32),
            np.arange(n, dtype=np.int32), np.ones(n, bool))


def test_fused_reap_wrapped_tail_last_writer():
    """Posts 0..6 fill slots 1, 2, 3, 4, 5, 0, 1 of the depth-6 ring; at
    the wrap (tail + 7 = -2^31, floor modulo 6 = 4) posts 7, 8, 9 land on
    slots 4, 5, 0. So slots 2 and 3 keep posts 1 and 2, which are not
    among the last six ranks."""
    args = wrap_reproduction()
    want = np.array([[9, 6, 1, 2, 7, 8]], np.int32)
    np.testing.assert_array_equal(
        np.asarray(jops.fused_reap(*map(jnp.asarray, args))[2]), want)
    dt, vt, rid, counts = ref.fused_reap_ref(*map(t, args))
    np.testing.assert_array_equal(rid.numpy(), want)
    np.testing.assert_array_equal(dt.numpy(), want.astype(np.float32))
    np.testing.assert_array_equal(counts.numpy(), [10])


def test_fused_reap_plain_leaves_the_rings_untouched():
    """The post is functional: the caller's rings are not written."""
    args = [t(x) for x in reap_case(4, 8, 64, 3, 0, 50)]
    before = [x.clone() for x in args]
    ref.fused_reap_ref(*args)
    for a, b in zip(before, args):
        same(a.numpy(), b)


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

    # A tile is one cluster of 8192 elements: one tile, one element into
    # the second, three tiles with no head (the look-back runs to tile 0),
    # 129 tiles; signed zeros and NaNs (bit-identical: both sides give the
    # canonical NaN); inputs one element past an aligned address.
    for n, fh in [(1, False), (8229, True), (300007, False), (8192, False),
                  (8193, True), (16385, False), (2**20 + 3, False)]:
        args = on(*seg_case(n, n, first_head=fh))
        same(ref.seg_scan_ref(*args).cpu().numpy(), seg_scan(*args))
    args = on(*seg_case(20000, 5, p_head=0.0, first_head=False))
    same(ref.seg_scan_ref(*args).cpu().numpy(), seg_scan(*args))
    for n, kind in [(8192, "signed-zeros"), (300007, "signed-zeros"),
                    (8192, "nan"), (300007, "nan")]:
        args = on(*seg_special_case(n, kind, n))
        same(ref.seg_scan_ref(*args).cpu().numpy(), seg_scan(*args))
    args = [x[1:] for x in on(*seg_case(8194, 6))]
    same(ref.seg_scan_ref(*args).cpu().numpy(), seg_scan(*args))
    args = on(*die_case(8192, 32, 1, 0.3))
    for a, b in zip(ref.die_contention_ref(*args), die_contention(*args)):
        same(a.cpu().numpy(), b)
    # Many tiles, several die groups, K = 1000, a long chain on one die,
    # fractional times (re-association would show), no rows.
    rng = np.random.default_rng(14)
    one_die = list(die_case(65536, 32, 3, 0.5))
    one_die[2] = np.zeros(65536, np.int32)
    frac = (rng.uniform(0, 5000, 8192).astype(np.float32),
            rng.uniform(0.1, 300, 8192).astype(np.float32),
            rng.integers(0, 32, 8192).astype(np.int32),
            rng.random(8192) < 0.3, rng.uniform(0, 3000, 32).astype(np.float32))
    # +inf readies and -0 costs; signed zeros (of two zeros the max takes
    # +0); NaN readies and cursors with payloads (a NaN propagates).
    special = die_case(8192, 32, 7, 0.3)
    special[0][rng.random(8192) < 0.01] = np.inf
    special[1][rng.random(8192) < 0.01] = -0.0
    nans = die_case(8192, 32, 12, 0.5)
    nans[0][rng.random(8192) < 0.002] = np.uint32(0x7FC00001).view(np.float32)
    nans[4][::7] = np.uint32(0xFFA00042).view(np.float32)
    for case in (die_case(300007, 32, 4, 0.3), die_case(8192, 512, 5, 0.3),
                 die_case(20000, 1000, 6, 0.5), one_die, frac, special,
                 signed_zero_case(8192, 32, 13), nans,
                 die_case(0, 32, 8, 0.3)):
        args = on(*case)
        for a, b in zip(ref.die_contention_ref(*args), die_contention(*args)):
            same(a.cpu().numpy(), b)
    args = on(*reap_case(32, 1024, 8192, 2, 900, 1024))
    for a, b in zip(ref.fused_reap_ref(*args), fused_reap(*args)):
        same(a.cpu().numpy(), b)
    # Tails that wrap past 2^31 inside the last D posts (D = 6 and 1000),
    # a depth past the shared-memory slot table, no rows; the caller's
    # rings stay as they were.
    for case in (wrap_reproduction(),
                 reap_case(4, 1000, 8192, 9, 2**31 - 1500, 2**31 - 1000, 0.9),
                 reap_case(2, 60000, 150000, 10, 2**31 - 60000,
                           2**31 - 10000, 0.9),
                 reap_case(32, 1024, 0, 11)):
        args = on(*case)
        before = [x.clone() for x in args]
        got = fused_reap(*args)
        for a, b in zip(ref.fused_reap_ref(*args), got):
            same(a.cpu().numpy(), b)
        for a, b in zip(before, args):
            same(a.cpu().numpy(), b)
    flash = torch.randn(16384, 16, device=card)
    idx = t(np.random.default_rng(0).integers(0, 16384, 8192)
            .astype(np.int32)).to(card)
    same(ref.block_gather_ref(flash, idx).cpu().numpy(),
         block_gather(flash, idx))
    # Descriptor counts that are not a multiple of 32, rows of 1, 4, 50
    # and 600-byte units, a flash table one element past alignment (the
    # byte path), and one past 2 GiB with indices near its end.
    rng = np.random.default_rng(15)
    for shape, n, dtype in [((16384, 16), 8191, torch.float32),
                            ((100, 3), 33, torch.float32),
                            ((512, 4), 1000, torch.float32),
                            ((1000, 200), 999, torch.float32),
                            ((300, 300), 77, torch.bfloat16)]:
        f = torch.randn(*shape, device=card).to(dtype)
        i = t(rng.integers(-10, shape[0] + 10, n).astype(np.int32)).to(card)
        same(ref.block_gather_ref(f, i).cpu().numpy(), block_gather(f, i))
    f = torch.randn(4096 * 16 + 1, device=card)[1:].view(4096, 16)
    i = t(rng.integers(0, 4096, 2000).astype(np.int32)).to(card)
    same(ref.block_gather_ref(f, i).cpu().numpy(), block_gather(f, i))
    big = 2**25 + 4096
    f = torch.randn(big, 16, device=card)
    i = t(rng.integers(big - 5000, big + 10, 8192).astype(np.int32)).to(card)
    same(ref.block_gather_ref(f, i).cpu().numpy(), block_gather(f, i))
    del f
    from repro_torch.kernels.block_gather_tiled import block_gather_tiled

    for tile in (1, 8, 16):
        same(ref.block_gather_tiled_ref(flash, idx, tile=tile).cpu().numpy(),
             block_gather_tiled(flash, idx, tile=tile))
