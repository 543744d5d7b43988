"""Segmented scan primitives (port of ``repro/core/segops.py``).

The timing model, the frontend and the pipeline stages build on these:
a segmented inclusive prefix max, within-segment ranks from a stable
sort, the reusable ``SortPlan``, the epoch-compaction plan, counting-sort
positions for small key alphabets, fixed-width block ranks, and the exact
(max,+) queueing scan.

Two porting rules hold throughout. Every tensor this module creates is
int32/float32/bool, as in the reference. And where the reference's float
result depends on the order of a reduction, the port keeps that order:
``associative_scan`` is JAX's odd/even recursion written out, so
``queueing_scan``'s reference path combines the same pairs in the same
tree as ``lax.associative_scan``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Sequence, Tuple

import torch

from repro_torch.core.types import F32, I32

NEG = -3e38

_U32 = 0xFFFFFFFF


def hash_u32(x: torch.Tensor) -> torch.Tensor:
    """xorshift-style integer hash (deterministic per-request randomness).

    The reference hashes uint32 values; torch cannot shift uint32 on every
    backend, so the port carries the 32-bit value in an int64 tensor and
    masks after each multiply. Returns int64 holding values in [0, 2^32).
    """
    x = x.to(torch.int64) & _U32
    x = ((x ^ (x >> 16)) * 0x7FEB352D) & _U32
    x = ((x ^ (x >> 15)) * 0x846CA68B) & _U32
    return x ^ (x >> 16)


def uniform01(h: torch.Tensor) -> torch.Tensor:
    """Map a u32 hash (int64 carrier) to (0, 1) — open at both ends."""
    return (h.to(F32) + 0.5) / 4294967296.0


def stable_argsort(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """THE argsort of the port: always stable, int32 like ``jnp.argsort``."""
    return torch.argsort(x, dim=dim, stable=True).to(I32)


def true_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / float32(d)`` as a correctly rounded division on every device.

    PyTorch's CUDA backend divides by a Python scalar as a multiply by its
    reciprocal, which rounds differently; dividing by a 0-dim tensor on
    the same device keeps the true division the reference performs.
    """
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


_CUMSUM_CHUNK = 16  # XLA's chunk for a long cumulative sum


def seq_cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Float cumsum in ``jnp.cumsum``'s order on the CPU, in the tensor's
    own dtype, on both devices.

    XLA rewrites the cumulative sum of an axis longer than 16 into chunks
    of 16: each chunk is summed left to right, the chunks' totals are
    cumsummed the same way (recursively), and each chunk's elements then
    add the exclusive sum of the chunks before it. An axis of up to 16
    elements is summed left to right. (``torch.cumsum`` accumulates
    float32 in double on the CPU and in a parallel tree on the card.)
    """
    x = x.movedim(dim, 0)
    n = x.shape[0]
    if n <= _CUMSUM_CHUNK:
        out = torch.empty_like(x)
        out[0] = x[0]
        for j in range(1, n):
            out[j] = out[j - 1] + x[j]
        return out.movedim(0, dim)
    m = -(-n // _CUMSUM_CHUNK)
    rest = tuple(x.shape[1:])
    pad = x.new_zeros((m * _CUMSUM_CHUNK - n,) + rest)
    chunks = torch.cat([x, pad]).reshape((m, _CUMSUM_CHUNK) + rest)
    within = seq_cumsum(chunks, 1)
    totals = seq_cumsum(within[:, -1], 0)
    before = torch.cat([x.new_zeros((1,) + rest), totals[:-1]])
    out = (within + before[:, None]).reshape((m * _CUMSUM_CHUNK,) + rest)
    return out[:n].movedim(0, dim)


def _interleave(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``lax``'s interleave: it pads both halves with zeros and adds them,
    so a float element comes out as ``x + 0.0`` (-0 becomes +0, every
    other value keeps its bits). The port writes that sum straight into
    each half's slots, one kernel a half as a copy would be."""
    out = torch.empty(
        (a.shape[0] + b.shape[0],) + tuple(a.shape[1:]),
        dtype=a.dtype, device=a.device,
    )
    if out.dtype.is_floating_point:
        torch.add(a, 0.0, out=out[0::2])
        torch.add(b, 0.0, out=out[1::2])
    else:
        out[0::2] = a
        out[1::2] = b
    return out


def associative_scan(
    fn: Callable[[List[torch.Tensor], List[torch.Tensor]], List[torch.Tensor]],
    elems: Sequence[torch.Tensor],
) -> List[torch.Tensor]:
    """Inclusive scan along dim 0 with JAX's ``lax.associative_scan`` tree.

    Combine adjacent pairs, scan the half-size result recursively (the
    odd outputs), then combine each odd output with the next even input
    (the even outputs), and interleave. ``fn(left, right)`` takes and
    returns lists of tensors.
    """

    def _scan(es: List[torch.Tensor]) -> List[torch.Tensor]:
        n = es[0].shape[0]
        if n < 2:
            return es
        reduced = fn([e[0:-1:2] for e in es], [e[1::2] for e in es])
        odd = _scan(reduced)
        if n % 2 == 0:
            even = fn([e[:-1] for e in odd], [e[2::2] for e in es])
        else:
            even = fn(odd, [e[2::2] for e in es])
        even = [torch.cat([e[:1], r]) for e, r in zip(es, even)]
        return [_interleave(a, b) for a, b in zip(even, odd)]

    return _scan(list(elems))


def jax_max(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.maximum``'s rule on every device: a NaN propagates, and of two
    zeros +0 is the larger. (``torch.maximum`` keeps an operand of such a
    tie, which one depending on the device and the length.) The max is
    negative exactly when both operands are, so ``torch.maximum``'s
    magnitude takes the AND of the operands' sign bits: a tie of zeros
    gives -0 only where both are -0. A NaN result may carry either sign."""
    signs = (a.view(I32) & b.view(I32)).view(F32)
    return torch.copysign(torch.maximum(a, b), signs)


def segmented_prefix_max(
    values: torch.Tensor, heads: torch.Tensor
) -> torch.Tensor:
    """Inclusive prefix max restarting at each ``heads[i]==True``.

    As in the reference, the interleave of ``associative_scan`` adds
    +0.0, so no output of two or more elements is -0; the combine's
    choice between zeros of two signs therefore never shows, and it
    keeps one ``torch.maximum``."""

    def combine(a, b):
        fa, va = a
        fb, vb = b
        return [fa | fb, torch.where(fb, vb, torch.maximum(va, vb))]

    return associative_scan(combine, [heads, values])[1]


_INF_BITS = 0x7F800000
_MAG = 0x7FFFFFFF


def segmented_prefix_jax_max(
    values: torch.Tensor, heads: torch.Tensor
) -> torch.Tensor:
    """The segmented inclusive prefix max under ``jax_max``'s rule with
    no +0.0 added anywhere: what a sequential fold of ``jnp.maximum``
    gives, and so what the reference's ``seg_scan`` kernel gives.

    The float32 bits map once to int32 keys that order as the floats do
    with -0 below +0 (-0 -> -1, +0 -> 0), every NaN pinned to the key
    0x7FFFFFFF above +inf; the scan takes one integer max a combine
    (integers pass the interleave unchanged), and the keys map back once.
    A NaN comes out as 0x7FFFFFFF, the card's canonical NaN, whatever
    payload went in."""
    b = values.view(I32)
    mag = b & _MAG
    key = torch.where(mag > _INF_BITS, _MAG, mag ^ (b >> 31))
    out = segmented_prefix_max(key, heads)
    return (out ^ ((out >> 31) & _MAG)).view(F32)


@dataclasses.dataclass(frozen=True)
class SortPlan:
    """Reusable segment-major layout of one epoch batch for one sort key."""

    order: torch.Tensor  # (N,) i32 permutation into segment-major layout
    heads: torch.Tensor  # (N,) bool segment starts in sorted layout
    rank: torch.Tensor   # (N,) i32 within-segment position in sorted layout


def _heads(s_key: torch.Tensor) -> torch.Tensor:
    first = torch.ones((1,), dtype=torch.bool, device=s_key.device)
    return torch.cat([first, s_key[1:] != s_key[:-1]])


def _heads_rank(s_key: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(heads, rank) of an already segment-major key array.

    The segment start is the running max of the head indices (indices
    increase, so the newest head always wins): the integer result the
    reference derives with a float segmented prefix max.
    """
    n = s_key.shape[0]
    idx = torch.arange(n, dtype=I32, device=s_key.device)
    heads = _heads(s_key)
    seg_start = torch.cummax(torch.where(heads, idx, 0), dim=0).values
    return heads, idx - seg_start


def make_sort_plan(key: torch.Tensor) -> SortPlan:
    """Stable sort by integer segment key, packaged as a reusable plan."""
    order = stable_argsort(key)
    heads, rank = _heads_rank(key[order])
    return SortPlan(order=order, heads=heads, rank=rank)


def presorted_plan(key: torch.Tensor) -> SortPlan:
    """SortPlan for a key the caller knows is already non-decreasing."""
    n = key.shape[0]
    heads, rank = _heads_rank(key)
    return SortPlan(
        order=torch.arange(n, dtype=I32, device=key.device),
        heads=heads, rank=rank,
    )


def sort_by_segment(
    key: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stable sort by integer segment key: (order, heads, rank)."""
    plan = make_sort_plan(key)
    return plan.order, plan.heads, plan.rank


def unsort(values: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """``zeros.at[order].set(values)`` for a permutation ``order``."""
    out = torch.empty_like(values)
    out[order.long()] = values
    return out


def segment_sum(vals: torch.Tensor, seg: torch.Tensor, k: int) -> torch.Tensor:
    """``jax.ops.segment_sum`` for keys in ``[0, k)``. On the card the
    additions run in no fixed order, so callers sum counts or other
    integer-valued floats, which are exact in any order."""
    out = torch.zeros((k,), dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, seg.long(), vals)


def segment_max(vals: torch.Tensor, seg: torch.Tensor, k: int) -> torch.Tensor:
    """``jax.ops.segment_max``: an empty segment reduces to -inf."""
    out = torch.full((k,), float("-inf"), dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce_(0, seg.long(), vals, "amax", include_self=True)


def scatter_last(
    table: torch.Tensor, dst: torch.Tensor, rows: torch.Tensor
) -> torch.Tensor:
    """``table.at[dst].set(rows, mode="drop")`` with the last row winning.

    Destinations outside ``[0, R)`` are dropped. For every destination the
    winner is the highest row index that targets it (an ``amax`` over the
    row indices); only winners are scattered, so no two writes collide.
    """
    r = table.shape[0]
    n = dst.shape[0]
    keep = (dst >= 0) & (dst < r)
    d = torch.where(keep, dst, r).long()
    idx = torch.arange(n, dtype=torch.int64, device=dst.device)
    last = torch.full((r + 1,), -1, dtype=torch.int64, device=dst.device)
    last.scatter_reduce_(0, d, idx, "amax", include_self=True)
    win = keep & (last[d] == idx)
    out = torch.cat([table, table.new_zeros((1,) + tuple(table.shape[1:]))])
    out[torch.where(win, d, r)] = rows
    return out[:r]


def segment_rank(key: torch.Tensor) -> torch.Tensor:
    """Within-segment rank in original order (count of earlier equal keys)."""
    order, _, rank = sort_by_segment(key)
    return unsort(rank, order)


def masked_presorted_rank(
    group: torch.Tensor,   # (N,) i32 non-decreasing group ids
    valid: torch.Tensor,   # (N,) bool
) -> torch.Tensor:
    """``segment_rank(where(valid, group, G))`` for valid rows, sort-free;
    invalid rows return 0."""
    vi = valid.to(I32)
    exc = torch.cumsum(vi, 0, dtype=I32) - vi
    heads = _heads(group)
    base = torch.cummax(torch.where(heads, exc, 0), dim=0).values
    return torch.where(valid, exc - base, 0)


@dataclasses.dataclass(frozen=True)
class CompactPlan:
    """Dense-prefix layout of one epoch's valid rows: valid rows land at
    ``0 .. n_valid-1`` in original order, invalid rows pack after."""

    pos: torch.Tensor      # (N,) i32 permutation into the dense layout
    n_valid: torch.Tensor  # () i32 number of valid rows


def compact_epoch(valid: torch.Tensor) -> CompactPlan:
    """Build the dense-prefix compaction plan for one epoch's validity."""
    cs = torch.cumsum(valid.to(I32), 0, dtype=I32)
    n_valid = cs[-1]
    idx = torch.arange(valid.shape[0], dtype=I32, device=valid.device)
    pos = torch.where(valid, cs - 1, n_valid + (idx - cs))
    return CompactPlan(pos=pos, n_valid=n_valid)


def counting_positions(
    key: torch.Tensor, num_keys: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stable counting-sort positions for keys in ``[0, num_keys)``.

    Returns ``(position, rank_in_key, counts, offsets)`` — the stable-sort
    permutation as destinations, from one (num_keys, N) one-hot cumsum.
    """
    n = key.shape[0]
    idx = torch.arange(n, dtype=I32, device=key.device)
    keys = torch.arange(num_keys, dtype=key.dtype, device=key.device)
    oh = key[None, :] == keys[:, None]
    csum = torch.cumsum(oh.to(I32), 1, dtype=I32)  # (S, N)
    counts = csum[:, -1]
    offsets = torch.cumsum(counts, 0, dtype=I32) - counts
    k = key.long()
    rank_in_key = csum[k, idx.long()] - 1
    return offsets[k] + rank_in_key, rank_in_key, counts, offsets


def counting_sort_plan(key: torch.Tensor, num_keys: int) -> SortPlan:
    """``make_sort_plan`` via counting sort (bit-identical for keys in
    ``[0, num_keys)``: stable counting sort IS the stable sort)."""
    n = key.shape[0]
    position, rank_in_key, _, _ = counting_positions(key, num_keys)
    idx = torch.arange(n, dtype=I32, device=key.device)
    page = torch.stack(
        [idx, rank_in_key, (rank_in_key == 0).to(I32)], dim=-1
    )
    s = unsort(page, position)
    return SortPlan(order=s[:, 0], rank=s[:, 1], heads=s[:, 2].bool())


def block_masked_rank(valid: torch.Tensor, block: int) -> torch.Tensor:
    """``masked_presorted_rank`` for fixed-width segment blocks."""
    v = valid.reshape(-1, block).to(I32)
    rank = (torch.cumsum(v, 1, dtype=I32) - v).reshape(-1)
    return torch.where(valid, rank, 0)


def block_counts(valid: torch.Tensor, block: int) -> torch.Tensor:
    """Per-segment valid counts for fixed-width segment blocks."""
    return torch.sum(valid.reshape(-1, block).to(I32), dim=1, dtype=I32)


def _seeded(ready, cost, heads, seed):
    """``a = ready + cost``, and at each head ``max(a, seed + cost)``: the
    server's state entering the segment, for both routes below. Of two
    zeros ``jnp.maximum`` takes +0, but that choice shows only in a scan
    of one element: with two or more, the associative route's interleave
    adds +0.0 to every output, and on the kernel route a zero of either
    sign there meets ``s`` in ``a - s`` and ``s + ...`` so that no output
    is -0 either way (``tests/test_torch_segops.py`` holds both routes
    against the reference on zeros of both signs). So only a one-element
    scan seeds with ``jax_max``; otherwise one ``torch.maximum`` adds no
    device event."""
    a = ready + cost
    mx = jax_max if a.shape[0] < 2 else torch.maximum
    return torch.where(heads, mx(a, seed + cost), a)


def queueing_scan_via_segmax(
    ready: torch.Tensor,
    cost: torch.Tensor,
    heads: torch.Tensor,
    seed: torch.Tensor,
    segmax_fn=segmented_prefix_max,
) -> torch.Tensor:
    """``queueing_scan`` reduced to one segmented prefix max:
    ``busy_j = S_j + max_{i <= j, same segment} (a_i - S_i)`` with
    ``S = cumsum(cost)``. Exact against the reference scan when costs are
    integer-valued (the cumsum's association is then irrelevant). ``S`` is
    accumulated in double and rounded once a row: for the engine's costs
    every double partial sum is exact, so the card (whose float32 cumsum
    is a tree) gives the CPU's numbers (whose float32 cumsum accumulates
    in double)."""
    a = _seeded(ready, cost, heads, seed)
    s = torch.cumsum(cost.to(torch.float64), 0).to(F32)
    return s + segmax_fn(a - s, heads)


def _kernel_segmax(values: torch.Tensor, heads: torch.Tensor) -> torch.Tensor:
    from repro_torch.kernels import ops as kops

    return kops.seg_scan(values.to(F32).contiguous(), heads.contiguous())


def queueing_scan(
    ready: torch.Tensor,
    cost: torch.Tensor,
    heads: torch.Tensor,
    seed: torch.Tensor,
    use_pallas: bool = False,
) -> torch.Tensor:
    """Exact single-server queueing recurrence, vectorized per segment:
    ``busy_j = max(ready_j, busy_{j-1}) + cost_j`` with ``busy_{-1} = seed``
    at each head, as a (max,+) function-composition scan.

    ``use_pallas=True`` (``EngineConfig.use_pallas_segscan``) routes the
    core through the ``seg_scan`` kernel via ``queueing_scan_via_segmax``;
    otherwise the scan runs on JAX's combine tree (``associative_scan``).
    The combine keeps one ``torch.maximum``: a zero's sign never changes
    a magnitude downstream (``x + ±0`` and ``max(x, ±0)`` differ only when
    the result is zero), and the interleave turns every -0 of the output
    into +0, as the reference's does, so no output shows the combine's
    choice between zeros of two signs.
    """
    if use_pallas:
        return queueing_scan_via_segmax(
            ready, cost, heads, seed, segmax_fn=_kernel_segmax
        )
    a = _seeded(ready, cost, heads, seed)

    def combine(left, right):
        fl, al, cl = left
        fr, ar, cr = right
        a_ = torch.where(fr, ar, torch.maximum(ar, al + cr))
        c_ = torch.where(fr, cr, cl + cr)
        return [fl | fr, a_, c_]

    return associative_scan(combine, [heads, a, cost])[1]
