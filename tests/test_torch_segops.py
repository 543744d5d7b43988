"""Port of ``core/segops.py`` against the reference, function by function.

Inputs are made with numpy from a seed and handed to both packages.
Integer results (ranks, orders, positions, counts, hashes) must be equal.
Float results must be bit-identical: the segmented max is exact in any
order, and the port's ``associative_scan`` combines the same pairs in
the same tree as ``lax.associative_scan``, so even the fractional-cost
queueing scan matches bit for bit. The kernel route
(``queueing_scan(use_pallas=True)``) re-associates the cost cumsum and is
exact on integer-valued costs, as in the reference.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import segops as js
from repro_torch.core import segops as ts
from port_threads import one_torch_thread  # noqa: F401

SIZES = [1, 2, 3, 7, 64, 255, 1000]


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def j(x):
    return jnp.asarray(x)


def same(a, b):
    a, b = np.asarray(a), b.numpy() if isinstance(b, torch.Tensor) else b
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    assert a.shape == b.shape
    np.testing.assert_array_equal(
        np.ascontiguousarray(a).reshape(-1).view(np.uint8),
        np.ascontiguousarray(b).reshape(-1).view(np.uint8),
    )


def keys(n, k, seed, sorted_=False):
    x = np.random.default_rng(seed).integers(0, k, n).astype(np.int32)
    return np.sort(x) if sorted_ else x


def test_hash_and_uniform01():
    x = np.random.default_rng(0).integers(0, 2**31 - 1, 5000, dtype=np.int64)
    x = x.astype(np.int32)
    ref = np.asarray(js.hash_u32(j(x)))
    out = ts.hash_u32(t(x)).numpy()
    np.testing.assert_array_equal(ref.astype(np.int64), out)
    same(js.uniform01(j(ref)), ts.uniform01(t(out)))


@pytest.mark.parametrize("n", SIZES)
def test_segmented_prefix_max(n):
    rng = np.random.default_rng(n)
    v = rng.uniform(-1e3, 1e3, n).astype(np.float32)
    h = rng.random(n) < 0.2
    same(jax.jit(js.segmented_prefix_max)(j(v), j(h)),
         ts.segmented_prefix_max(t(v), t(h)))


SPECIAL = [8, 300, 4096]
ZEROS = np.array([0.0, -0.0], np.float32)
NANS = np.array([0x7FC00001, 0xFFA00042], np.uint32).view(np.float32)


def same_nan(a, b):
    """Bit-identical where the reference is not NaN; NaN at the same
    positions, payload and sign not compared: the card's max returns its
    canonical NaN and XLA passes an operand's through, so no payload rule
    holds on both."""
    a, b = np.asarray(a), b.numpy()
    assert a.dtype == b.dtype and a.shape == b.shape
    nan = np.isnan(a)
    np.testing.assert_array_equal(nan, np.isnan(b))
    np.testing.assert_array_equal(a[~nan].view(np.uint32),
                                  b[~nan].view(np.uint32))


def special_values(n, kind, rng):
    """``signed-zeros``: +0 and -0 only. ``nan``: finite values with NaNs
    of two payloads and both signs on 5% of the elements."""
    if kind == "signed-zeros":
        return rng.choice(ZEROS, n)
    v = rng.uniform(-100, 100, n).astype(np.float32)
    v[rng.random(n) < 0.05] = rng.choice(NANS)
    return v


def test_jax_max_is_jnp_maximum():
    """Every pair of zeros, infinities, NaNs and normal numbers: bits equal
    to ``jnp.maximum``'s where it is not NaN, NaN where it is. (XLA on the
    CPU flushes a subnormal result to zero; the port does not, so
    subnormals stay out.)"""
    vals = np.array([0.0, -0.0, np.inf, -np.inf, 1.5, -1.5, 3e38, -3e38,
                     1.2e-38, -1.2e-38], np.float32)
    vals = np.concatenate([vals, NANS])
    a, b = np.meshgrid(vals, vals)
    a, b = a.reshape(-1), b.reshape(-1)
    same_nan(jnp.maximum(j(a), j(b)), ts.jax_max(t(a), t(b)))


@pytest.mark.parametrize("kind", ["signed-zeros", "nan"])
@pytest.mark.parametrize("n", SPECIAL)
def test_segmented_prefix_max_special_values(n, kind):
    """The reference's scan adds +0.0 in every interleave, so no output
    of two or more elements is -0, and a NaN runs to the segment's end."""
    rng = np.random.default_rng(n)
    v = special_values(n, kind, rng)
    h = rng.random(n) < 0.1
    same_nan(jax.jit(js.segmented_prefix_max)(j(v), j(h)),
             ts.segmented_prefix_max(t(v), t(h)))


@pytest.mark.parametrize("n", SPECIAL)
def test_key_space_scan_keeps_todays_bits(n):
    """On floats with no zero tie and no NaN, the key-space scan gives the
    bits of the reference's scan and of the port's float scan."""
    rng = np.random.default_rng(n + 7)
    v = rng.uniform(-1e3, 1e3, n).astype(np.float32)
    h = rng.random(n) < 0.1
    keys = ts.segmented_prefix_jax_max(t(v), t(h))
    same(jax.jit(js.segmented_prefix_max)(j(v), j(h)), keys)
    same(ts.segmented_prefix_max(t(v), t(h)).numpy(), keys)


@pytest.mark.parametrize("n", SPECIAL)
def test_key_space_scan_is_the_sequential_jnp_fold(n):
    """``segmented_prefix_jax_max`` on zeros of both signs: the sequential
    fold of ``jnp.maximum`` keeps -0 where every value so far in the
    segment is -0 (no interleave adds +0.0 there)."""
    rng = np.random.default_rng(n + 11)
    v = rng.choice(ZEROS, n)
    h = rng.random(n) < 0.1

    def step(run, x):
        r = jnp.where(x[1], x[0], jnp.maximum(run, x[0]))
        return r, r

    _, want = jax.lax.scan(step, j(v[0]), (j(v), j(h)))
    same(want, ts.segmented_prefix_jax_max(t(v), t(h)))


@pytest.mark.parametrize("n", SIZES)
def test_associative_scan_uses_the_reference_tree(n):
    """A float sum is order-sensitive: equal bits mean equal trees."""
    v = np.random.default_rng(n).uniform(0, 1, n).astype(np.float32)
    ref = jax.lax.associative_scan(jnp.add, j(v))
    out = ts.associative_scan(lambda a, b: [a[0] + b[0]], [t(v)])[0]
    same(ref, out)


@jax.jit
def _ref_plans(k, g, v):
    return (js.stable_argsort(k), js.make_sort_plan(k), js.presorted_plan(g),
            js.sort_by_segment(k), js.segment_rank(k),
            js.masked_presorted_rank(g, v))


@pytest.mark.parametrize("n", SIZES)
def test_sort_plans_and_ranks(n):
    k = keys(n, 5, n)
    g = np.sort(k)
    v = np.random.default_rng(n + 1).random(n) < 0.6
    ref = _ref_plans(j(k), j(g), j(v))
    out = (ts.stable_argsort(t(k)), ts.make_sort_plan(t(k)),
           ts.presorted_plan(t(g)), ts.sort_by_segment(t(k)),
           ts.segment_rank(t(k)), ts.masked_presorted_rank(t(g), t(v)))
    same(ref[0], out[0])
    for rp, tp in [(ref[1], out[1]), (ref[2], out[2])]:
        same(rp.order, tp.order)
        same(rp.heads, tp.heads)
        same(rp.rank, tp.rank)
    for a, b in zip(ref[3], out[3]):
        same(a, b)
    same(ref[4], out[4])
    same(ref[5], out[5])


@pytest.mark.parametrize("p_valid", [0.0, 0.4, 1.0])
def test_compact_epoch(p_valid):
    v = np.random.default_rng(3).random(300) < p_valid
    rp, tp = js.compact_epoch(j(v)), ts.compact_epoch(t(v))
    same(rp.pos, tp.pos)
    same(rp.n_valid, tp.n_valid)


@pytest.mark.parametrize("n", SIZES)
def test_counting_sort(n):
    k = keys(n, 7, n + 5)
    ref = jax.jit(js.counting_positions, static_argnums=1)(j(k), 7)
    for a, b in zip(ref, ts.counting_positions(t(k), 7)):
        same(a, b)
    rp = jax.jit(js.counting_sort_plan, static_argnums=1)(j(k), 7)
    tp = ts.counting_sort_plan(t(k), 7)
    same(rp.order, tp.order)
    same(rp.heads, tp.heads)
    same(rp.rank, tp.rank)


@pytest.mark.parametrize("width", [1, 4, 16])
def test_block_rank_and_counts(width):
    v = np.random.default_rng(width).random(64) < 0.5
    same(js.block_masked_rank(j(v), width), ts.block_masked_rank(t(v), width))
    same(js.block_counts(j(v), width), ts.block_counts(t(v), width))


def _scan_case(n, seed, integer):
    rng = np.random.default_rng(seed)
    if integer:
        ready = rng.integers(0, 500, n).astype(np.float32)
        cost = rng.integers(0, 20, n).astype(np.float32)
        seed_v = rng.integers(0, 300, n).astype(np.float32)
    else:
        ready = rng.uniform(0, 500, n).astype(np.float32)
        cost = (rng.uniform(0, 2, n) + 0.01).astype(np.float32)
        seed_v = rng.uniform(0, 300, n).astype(np.float32)
    heads = rng.random(n) < 0.1
    heads[0] = True
    return ready, cost, heads, seed_v


@pytest.mark.parametrize("n", SIZES)
def test_queueing_scan_fractional_costs_bit_exact(n):
    args = _scan_case(n, n, integer=False)
    same(jax.jit(js.queueing_scan)(*map(j, args)),
         ts.queueing_scan(*map(t, args)))


@pytest.mark.parametrize("n", SIZES)
def test_queueing_scan_kernel_route_integer_costs(n):
    """The seg_scan route against the reference's Pallas route (run in
    interpret mode) and against the plain scan: exact on integer costs."""
    args = _scan_case(n, n + 100, integer=True)
    ref = js.queueing_scan(*map(j, args), use_pallas=True)
    out = ts.queueing_scan(*map(t, args), use_pallas=True)
    same(ref, out)
    same(ref, ts.queueing_scan(*map(t, args)))


def _special_scan_case(n, kind, seed):
    """Readies, costs and seeds of +0 and -0 (``signed-zeros``), or
    integer times with NaN readies (``nan``)."""
    rng = np.random.default_rng(seed)
    heads = rng.random(n) < 0.1
    if kind == "signed-zeros":
        return (rng.choice(ZEROS, n), rng.choice(ZEROS, n), heads,
                rng.choice(ZEROS, n))
    ready = rng.integers(0, 500, n).astype(np.float32)
    ready[rng.random(n) < 0.05] = rng.choice(NANS)
    return (ready, rng.integers(0, 20, n).astype(np.float32), heads,
            rng.integers(0, 300, n).astype(np.float32))


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["associative", "kernel-route"])
@pytest.mark.parametrize("kind", ["signed-zeros", "nan"])
@pytest.mark.parametrize("n", SPECIAL)
def test_queueing_scan_special_values(n, kind, use_pallas):
    """Both routes against the reference's (its Pallas kernel in interpret
    mode on the kernel route): of two zeros the seeding max takes +0, and
    the associative route's interleave turns -0 into +0."""
    args = _special_scan_case(n, kind, n + 3)
    ref = js.queueing_scan(*map(j, args), use_pallas=use_pallas)
    same_nan(ref, ts.queueing_scan(*map(t, args), use_pallas=use_pallas))


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["associative", "kernel-route"])
def test_queueing_scan_one_element_seed_takes_plus_zero(use_pallas):
    """One element, a head: ready + cost = -0 against seed + cost = +0.
    ``jnp.maximum`` takes +0, and with one element no interleave runs."""
    args = (np.array([-0.0], np.float32), np.array([-0.0], np.float32),
            np.array([True]), np.array([0.0], np.float32))
    ref = js.queueing_scan(*map(j, args), use_pallas=use_pallas)
    assert np.asarray(ref).view(np.uint32)[0] == 0
    same(ref, ts.queueing_scan(*map(t, args), use_pallas=use_pallas))


def test_true_div_and_seq_cumsum():
    x = np.random.default_rng(9).uniform(0, 1e5, (5, 9)).astype(np.float32)
    same(j(x) / 30000.0, ts.true_div(t(x), 30000.0))
    same(jnp.cumsum(j(x), axis=1), ts.seq_cumsum(t(x), 1))


@pytest.mark.parametrize("n", [1, 2, 16, 17, 32, 100, 257, 300, 4100])
def test_seq_cumsum_takes_jnp_cumsum_order_on_long_axes(n):
    """Past 16 elements XLA sums an axis in chunks of 16 (each left to
    right, then the chunks' exclusive totals, recursively), which a left
    to right sum misses by several ULP at 32 elements: bit-exact on a
    1-D axis (the centralized fetch's 32 SQs) and on a middle axis."""
    rng = np.random.default_rng(n)
    x = rng.uniform(0, 20, n).astype(np.float32)
    same(jnp.cumsum(j(x)), ts.seq_cumsum(t(x), 0))
    y = rng.uniform(-5, 20, (3, n, 2)).astype(np.float32)
    same(jnp.cumsum(j(y), axis=1), ts.seq_cumsum(t(y), 1))
