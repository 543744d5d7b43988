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

Every op works along the last axis (the rows of one drive's epoch) and
treats any leading axes as independent drives of an array: a leading
``(M,)`` axis gives each drive exactly the numbers a call on its own rows
gives, which is how the engine runs an M-drive array in one program (the
reference's ``vmap``). Scatters and segment reductions flatten the drives
with a per-drive offset; gathers go through ``take`` and ``take_rows``.
"""
from __future__ import annotations

import dataclasses
import math
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


def _same_ndim(x: torch.Tensor, idx: torch.Tensor, trailing: int):
    """``x`` and ``idx`` with ones prepended to the one with fewer leading
    axes (``x`` has ``trailing`` more axes than ``idx`` past the leading
    ones), so that ``take_along_dim`` broadcasts them."""
    lead = idx.dim() - (x.dim() - trailing)
    if lead > 0:
        x = x.reshape((1,) * lead + tuple(x.shape))
    elif lead < 0:
        idx = idx.reshape((1,) * -lead + tuple(idx.shape))
    return x, idx.long()


def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., idx]`` drive by drive: each drive's row of ``idx`` indexes
    that drive's row of ``x`` (a missing leading axis on either
    broadcasts). An index used more than once is best made int64 once by
    the caller (``take_along_dim`` wants int64)."""
    x, idx = _same_ndim(x, idx, 0)
    return torch.take_along_dim(x, idx, dim=-1)


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` drive by drive for a (..., R, W) table of rows and
    (..., N) row indices: (..., N, W)."""
    table, idx = _same_ndim(table, idx, 1)
    return torch.take_along_dim(table, idx[..., None], dim=-2)


def drive_offsets(lead: Tuple[int, ...], size: int, device) -> torch.Tensor:
    """``d * size`` for each drive d of leading shape ``lead``, shaped
    ``lead + (1,)`` (int64): the offset of drive d's block when the
    drives' tables are laid end to end."""
    return (torch.arange(math.prod(lead), dtype=torch.int64, device=device)
            * size).reshape(tuple(lead) + (1,))


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
    """``lax``'s interleave along the last axis: it pads both halves with
    zeros and adds them, so a float element comes out as ``x + 0.0`` (-0
    becomes +0, every other value keeps its bits). The port writes that
    sum straight into each half's slots, one kernel a half as a copy
    would be; where autograd records (a half requires grad, which the
    ``out=`` writes would refuse), the two sums are laid side by side
    with a stack instead, the same bits."""
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        n = a.shape[-1] + b.shape[-1]
        pad = a.shape[-1] - b.shape[-1]            # 0, or 1 for an odd n
        both = torch.stack([a, torch.nn.functional.pad(b, (0, pad))], -1)
        return (both.flatten(-2)[..., :n]) + 0.0
    out = torch.empty(
        tuple(a.shape[:-1]) + (a.shape[-1] + b.shape[-1],),
        dtype=a.dtype, device=a.device,
    )
    if out.dtype.is_floating_point:
        torch.add(a, 0.0, out=out[..., 0::2])
        torch.add(b, 0.0, out=out[..., 1::2])
    else:
        out[..., 0::2] = a
        out[..., 1::2] = b
    return out


def associative_scan(
    fn: Callable[[List[torch.Tensor], List[torch.Tensor]], List[torch.Tensor]],
    elems: Sequence[torch.Tensor],
) -> List[torch.Tensor]:
    """Inclusive scan along the last axis with JAX's
    ``lax.associative_scan`` tree (the elements share one shape).

    Combine adjacent pairs, scan the half-size result recursively (the
    odd outputs), then combine each odd output with the next even input
    (the even outputs), and interleave. ``fn(left, right)`` takes and
    returns lists of tensors.
    """

    def _scan(es: List[torch.Tensor]) -> List[torch.Tensor]:
        n = es[0].shape[-1]
        if n < 2:
            return es
        reduced = fn([e[..., 0:-1:2] for e in es], [e[..., 1::2] for e in es])
        odd = _scan(reduced)
        if n % 2 == 0:
            even = fn([e[..., :-1] for e in odd], [e[..., 2::2] for e in es])
        else:
            even = fn(odd, [e[..., 2::2] for e in es])
        even = [torch.cat([e[..., :1], r], dim=-1) for e, r in zip(es, even)]
        return [_interleave(a, b) for a, b in zip(even, odd)]

    return _scan(list(torch.broadcast_tensors(*elems)))


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


def segment_heads(s_key: torch.Tensor) -> torch.Tensor:
    """Where each run of equal keys starts, along the last axis."""
    first = torch.ones(tuple(s_key.shape[:-1]) + (1,), dtype=torch.bool,
                       device=s_key.device)
    return torch.cat([first, s_key[..., 1:] != s_key[..., :-1]], dim=-1)


def _heads_rank(s_key: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(heads, rank) of an already segment-major key array.

    The segment start is the running max of the head indices (indices
    increase, so the newest head always wins): the integer result the
    reference derives with a float segmented prefix max.
    """
    n = s_key.shape[-1]
    idx = torch.arange(n, dtype=I32, device=s_key.device)
    heads = segment_heads(s_key)
    seg_start = torch.cummax(torch.where(heads, idx, 0), dim=-1).values
    return heads, idx - seg_start


def make_sort_plan(key: torch.Tensor) -> SortPlan:
    """Stable sort by integer segment key, packaged as a reusable plan."""
    order = stable_argsort(key)
    heads, rank = _heads_rank(take(key, order))
    return SortPlan(order=order, heads=heads, rank=rank)


def presorted_plan(key: torch.Tensor) -> SortPlan:
    """SortPlan for a key the caller knows is already non-decreasing."""
    n = key.shape[-1]
    heads, rank = _heads_rank(key)
    return SortPlan(
        order=torch.arange(n, dtype=I32, device=key.device).expand(
            key.shape),
        heads=heads, rank=rank,
    )


def sort_by_segment(
    key: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stable sort by integer segment key: (order, heads, rank)."""
    plan = make_sort_plan(key)
    return plan.order, plan.heads, plan.rank


def lex_sort_by_segment(
    key: torch.Tensor,
    t: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stable lexicographic sort by (key, t) along the last axis: (order,
    heads, rank) as ``sort_by_segment`` gives them.

    The reference sorts once with ``lax.sort`` on two keys; a stable sort
    by ``t`` followed by a stable segment sort by ``key`` is the same
    permutation, which is how the port computes it. Both sorts hold -0.0
    and +0.0 equal (ties keep their row order), as ``lax.sort`` does
    (``tests/test_torch_qp.py`` checks a segment holding both); the CQ's
    done times are positive, or +0.0 on invalid rows under the key ``Q``.
    """
    ord1 = stable_argsort(t)
    ord2 = stable_argsort(take(key, ord1))
    order = take(ord1, ord2)
    heads, rank = _heads_rank(take(key, order))
    return order, heads, rank


def unsort(values: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """``zeros.at[order].set(values)`` for a permutation ``order`` of each
    drive's rows: ``order`` is (..., N) and ``values`` (..., N, ...) with
    the same leading axes."""
    rest = tuple(values.shape[order.dim():])
    idx = order.long().reshape(tuple(order.shape) + (1,) * len(rest))
    return torch.empty_like(values).scatter_(
        order.dim() - 1, idx.expand(values.shape), values)


def segment_sum(vals: torch.Tensor, seg: torch.Tensor, k: int) -> torch.Tensor:
    """``jax.ops.segment_sum`` for keys in ``[0, k)``, per drive: (..., k).
    On the card the additions run in no fixed order, so callers sum counts
    or other integer-valued floats, which are exact in any order."""
    vals, seg = torch.broadcast_tensors(vals, seg)
    out = torch.zeros(tuple(vals.shape[:-1]) + (k,), dtype=vals.dtype,
                      device=vals.device)
    return out.scatter_add_(-1, seg.long(), vals)


def segment_max(vals: torch.Tensor, seg: torch.Tensor, k: int) -> torch.Tensor:
    """``jax.ops.segment_max`` per drive: an empty segment reduces to
    -inf."""
    vals, seg = torch.broadcast_tensors(vals, seg)
    out = torch.full(tuple(vals.shape[:-1]) + (k,), float("-inf"),
                     dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce_(-1, seg.long(), vals, "amax",
                               include_self=True)


def scatter_last(
    table: torch.Tensor, dst: torch.Tensor, rows: torch.Tensor
) -> torch.Tensor:
    """``table.at[dst].set(rows, mode="drop")`` with the last row winning,
    per drive: ``dst`` is (..., N), ``table`` (..., R, ...) and ``rows``
    (..., N, ...) with the same leading axes.

    Destinations outside ``[0, R)`` are dropped. For every destination the
    winner is the highest row index that targets it (an ``amax`` over the
    row indices); only winners are scattered, so no two writes collide.
    The drives' tables are laid end to end (``drive_offsets``), so one
    scatter serves them all.
    """
    lead = tuple(dst.shape[:-1])
    r = table.shape[len(lead)]
    rest = tuple(table.shape[len(lead) + 1:])
    total = math.prod(lead) * r
    keep = (dst >= 0) & (dst < r)
    if lead:
        d = torch.where(keep, dst.long() + drive_offsets(lead, r, dst.device),
                        total).reshape(-1)
        keep = keep.reshape(-1)
    else:
        d = torch.where(keep, dst, r).long()
    n = d.shape[0]
    idx = torch.arange(n, dtype=torch.int64, device=dst.device)
    last = torch.full((total + 1,), -1, dtype=torch.int64, device=dst.device)
    last.scatter_reduce_(0, d, idx, "amax", include_self=True)
    win = keep & (last[d] == idx)
    out = torch.cat([table.reshape((total,) + rest),
                     table.new_zeros((1,) + rest)])
    out[torch.where(win, d, total)] = rows.reshape((n,) + rest)
    return out[:total].reshape(table.shape)


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
    group, valid = torch.broadcast_tensors(group, valid)
    vi = valid.to(I32)
    exc = torch.cumsum(vi, -1, dtype=I32) - vi
    heads = segment_heads(group)
    base = torch.cummax(torch.where(heads, exc, 0), dim=-1).values
    return torch.where(valid, exc - base, 0)


@dataclasses.dataclass(frozen=True)
class CompactPlan:
    """Dense-prefix layout of one epoch's valid rows: valid rows land at
    ``0 .. n_valid-1`` in original order, invalid rows pack after."""

    pos: torch.Tensor      # (..., N) i32 permutation into the dense layout
    n_valid: torch.Tensor  # (...) i32 number of valid rows


def compact_epoch(valid: torch.Tensor) -> CompactPlan:
    """Build the dense-prefix compaction plan for one epoch's validity."""
    cs = torch.cumsum(valid.to(I32), -1, dtype=I32)
    n_valid = cs[..., -1]
    idx = torch.arange(valid.shape[-1], dtype=I32, device=valid.device)
    pos = torch.where(valid, cs - 1, n_valid[..., None] + (idx - cs))
    return CompactPlan(pos=pos, n_valid=n_valid)


def counting_positions(
    key: torch.Tensor, num_keys: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stable counting-sort positions for keys in ``[0, num_keys)``.

    Returns ``(position, rank_in_key, counts, offsets)`` — the stable-sort
    permutation as destinations, from one (..., num_keys, N) one-hot
    cumsum.
    """
    keys = torch.arange(num_keys, dtype=key.dtype, device=key.device)
    oh = key[..., None, :] == keys[:, None]
    csum = torch.cumsum(oh.to(I32), -1, dtype=I32)  # (..., S, N)
    counts = csum[..., -1]
    offsets = torch.cumsum(counts, -1, dtype=I32) - counts
    k = key.long()
    rank_in_key = torch.take_along_dim(csum, k[..., None, :],
                                       dim=-2)[..., 0, :] - 1
    return take(offsets, k) + rank_in_key, rank_in_key, counts, offsets


def counting_sort_plan(key: torch.Tensor, num_keys: int) -> SortPlan:
    """``make_sort_plan`` via counting sort (bit-identical for keys in
    ``[0, num_keys)``: stable counting sort IS the stable sort)."""
    n = key.shape[-1]
    position, rank_in_key, _, _ = counting_positions(key, num_keys)
    idx = torch.arange(n, dtype=I32, device=key.device).expand(key.shape)
    page = torch.stack(
        [idx, rank_in_key, (rank_in_key == 0).to(I32)], dim=-1
    )
    s = unsort(page, position)
    return SortPlan(order=s[..., 0], rank=s[..., 1], heads=s[..., 2].bool())


def block_masked_rank(valid: torch.Tensor, block: int) -> torch.Tensor:
    """``masked_presorted_rank`` for fixed-width segment blocks."""
    v = valid.reshape(tuple(valid.shape[:-1]) + (-1, block)).to(I32)
    rank = (torch.cumsum(v, -1, dtype=I32) - v).reshape(valid.shape)
    return torch.where(valid, rank, 0)


def block_counts(valid: torch.Tensor, block: int) -> torch.Tensor:
    """Per-segment valid counts for fixed-width segment blocks."""
    v = valid.reshape(tuple(valid.shape[:-1]) + (-1, block)).to(I32)
    return torch.sum(v, dim=-1, dtype=I32)


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
    mx = jax_max if a.shape[-1] < 2 else torch.maximum
    return torch.where(heads, mx(a, seed + cost), a)


def queueing_scan_via_segmax(
    ready: torch.Tensor,
    cost: torch.Tensor,
    heads: torch.Tensor,
    seed: torch.Tensor,
    segmax_fn=segmented_prefix_max,
    seq_sum: bool = False,
) -> torch.Tensor:
    """``queueing_scan`` reduced to one segmented prefix max:
    ``busy_j = S_j + max_{i <= j, same segment} (a_i - S_i)`` with
    ``S = cumsum(cost)``. Exact against the reference scan when costs are
    integer-valued (the cumsum's association is then irrelevant). ``S`` is
    accumulated in double and rounded once a row: for the engine's costs
    every double partial sum is exact, so the card (whose float32 cumsum
    is a tree) gives the CPU's numbers (whose float32 cumsum accumulates
    in double). ``seq_sum=True`` adds fractional costs in float32 in
    ``jnp.cumsum``'s order instead (``seq_cumsum``), as the reference's
    compiled route does."""
    a = _seeded(ready, cost, heads, seed)
    if seq_sum:
        s = seq_cumsum(cost, -1)
    else:
        s = torch.cumsum(cost.to(torch.float64), -1).to(F32)
    return s + segmax_fn(a - s, heads)


def _kernel_segmax(values: torch.Tensor, heads: torch.Tensor) -> torch.Tensor:
    from repro_torch.kernels import ops as kops

    values, heads = torch.broadcast_tensors(values.to(F32), heads)
    return kops.seg_scan(values.contiguous(), heads.contiguous())


def _queueing_combine(left, right):
    fl, al, cl = left
    fr, ar, cr = right
    a_ = torch.where(fr, ar, torch.maximum(ar, al + cr))
    c_ = torch.where(fr, cr, cl + cr)
    return [fl | fr, a_, c_]


def queueing_scan(
    ready: torch.Tensor,
    cost: torch.Tensor,
    heads: torch.Tensor,
    seed: torch.Tensor,
    use_pallas: bool = False,
    seq_sum: bool = False,
) -> torch.Tensor:
    """Exact single-server queueing recurrence, vectorized per segment:
    ``busy_j = max(ready_j, busy_{j-1}) + cost_j`` with ``busy_{-1} = seed``
    at each head, as a (max,+) function-composition scan.

    ``use_pallas=True`` (``EngineConfig.use_pallas_segscan``) routes the
    core through the ``seg_scan`` kernel via ``queueing_scan_via_segmax``
    (``seq_sum`` picks its cumulative sum there); otherwise the scan runs
    on JAX's combine tree (``associative_scan``).
    The combine keeps one ``torch.maximum``: a zero's sign never changes
    a magnitude downstream (``x + ±0`` and ``max(x, ±0)`` differ only when
    the result is zero), and the interleave turns every -0 of the output
    into +0, as the reference's does, so no output shows the combine's
    choice between zeros of two signs.
    """
    if use_pallas:
        return queueing_scan_via_segmax(
            ready, cost, heads, seed, segmax_fn=_kernel_segmax,
            seq_sum=seq_sum,
        )
    a = _seeded(ready, cost, heads, seed)
    return associative_scan(_queueing_combine, [heads, a, cost])[1]
