"""Logical-axis sharding on ``torch.distributed`` (port of
``repro/distributed/sharding.py``): MaxText-style rules mapping model-space
axis names to mesh axes, the ``constrain`` hooks that are the identity
outside a rules context, and ``shard_map`` with the lax collectives its
bodies use.

The reference's pieces and their counterparts here:

- A ``jax.sharding.Mesh`` is a ``DeviceMesh`` (``launch/mesh.py``) with the
  reference's axis names; ``spec_for`` reads only its axis names and sizes,
  so it also takes any object with ``axis_names`` and a ``devices`` array.
- A ``PartitionSpec`` is ``P``, a tuple of per-dimension entries (None, an
  axis name, or a tuple of axis names); ``placements`` turns it into one
  ``Shard``/``Replicate`` per mesh dimension, and ``NamedSharding`` pairs
  it with its mesh.
- A global array is a ``DTensor``. ``constrain`` redistributes a DTensor
  to its rule's placements and leaves a plain (local) tensor as it is: a
  ``shard_map`` body holds local tensors, already in the layout its specs
  give.
- ``shard_map`` runs on ``torch.distributed.tensor.experimental.local_map``:
  every DTensor argument is first redistributed to its in-spec (a plain
  tensor is a global value every rank holds, and each rank takes its
  block), the body runs on local tensors, and its outputs are DTensors
  with the out-specs' placements. Inside the body ``axis_index``,
  ``all_gather``, ``psum_scatter``, ``psum`` and ``pmean`` name mesh axes
  as the reference's ``jax.lax`` collectives do.

Collectives are autograd functions. A rank's gradient of a replicated
value is its own part of the total (the true gradient is the sum over the
ranks), so ``all_gather`` takes a reduce-scatter backward, ``psum_scatter``
an all-gather, ``psum`` an all-reduce; ``reduce_gradients`` sums a
replicated parameter's gradient over the ranks once the backward is done.
Every collective goes through ``_collective``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import warnings
from typing import Any, Sequence

import torch
import torch.distributed as dist

# Default production rules. None ⇒ replicated. An axis only binds when the
# dimension is divisible by the mesh extent (spec_for checks shapes), so
# e.g. MQA kv_heads=1 falls through and the kv_seq dim picks up "model".
DEFAULT_RULES: tuple[tuple[str, Any], ...] = (
    ("batch", ("pod", "data")),   # falls back to ("data",) on single-pod
    ("seq", "model"),             # sequence parallelism on the residual
    ("embed", "data"),            # FSDP dim of weight matrices
    ("heads", "model"),
    ("kv_heads", "model"),
    ("kv_seq", "model"),          # long KV caches when kv_heads can't shard
    ("head_dim", None),
    ("mlp", "model"),
    ("vocab", "model"),
    ("experts", "model"),
    ("expert_mlp", None),
    ("expert_cap", "data"),       # MoE dispatch buffer rows follow tokens
    ("tokens", ("pod", "data", "model")),  # flattened (B*S) token dim
    ("lru", "model"),
    ("conv", None),
    ("layers", None),
)

# Sentinel axes for scalar/replicated leaves (a bare () would be
# indistinguishable from an empty *structural* tuple in a tree).
REPLICATED = ("__replicated__",)

_ctx = threading.local()


class P(tuple):
    """A partition spec: one entry per tensor dimension, None (replicated),
    a mesh axis name, or a tuple of axis names (``PartitionSpec``)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


def axis_sizes(mesh) -> dict:
    """{axis name: extent} of a ``DeviceMesh`` or of any object carrying
    ``axis_names`` and a ``devices`` array (the reference's ``Mesh``)."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, tuple(mesh.mesh.shape)))
    return dict(zip(mesh.axis_names, tuple(mesh.devices.shape)))


def _resolve(logical: str, rules: dict, names: set):
    """Logical axis -> mesh axis (or tuple), dropping absent mesh axes."""
    target = rules.get(logical)
    if target is None:
        return None
    if isinstance(target, (tuple, list)):
        kept = tuple(t for t in target if t in names)
        return kept if kept else None
    return target if target in names else None


def spec_for(
    logical_axes: Sequence[str | None],
    rules,
    mesh,
    shape: Sequence[int] | None = None,
) -> P:
    if tuple(logical_axes) == REPLICATED:
        return P()
    rd = dict(rules)
    sizes = axis_sizes(mesh)
    parts = []
    used: set = set()

    def extent(r) -> int:
        if isinstance(r, tuple):
            out = 1
            for x in r:
                out *= sizes[x]
            return out
        return sizes[r]

    def fit(r, dim: int | None):
        """Drop already-used axes; drop bindings the dim can't divide."""
        if r is None:
            return None
        if isinstance(r, tuple):
            kept = tuple(x for x in r if x not in used)
            if not kept:
                return None
            if dim is not None and dim % extent(kept) != 0:
                # Try each member axis alone (largest first).
                for x in sorted(kept, key=lambda x: -sizes[x]):
                    if dim % sizes[x] == 0:
                        used.add(x)
                        return x
                return None
            used.update(kept)
            return kept
        if r in used:
            return None
        if dim is not None and dim % extent(r) != 0:
            return None
        used.add(r)
        return r

    for i, ax in enumerate(logical_axes):
        r = None if ax is None else _resolve(ax, rd, set(sizes))
        dim = None if shape is None else shape[i]
        parts.append(fit(r, dim))
    return P(*parts)


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def placements(spec: Sequence, mesh) -> tuple:
    """One ``Shard(dim)``/``Replicate()`` per mesh axis, in the mesh's
    order. A dimension split over several mesh axes is split in mesh
    order (the first axis outermost), which is the reference's order for
    a tuple entry written in mesh order, as every rule is."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(axis_sizes(mesh))
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        axes = _entry_axes(entry)
        if list(axes) != sorted(axes, key=names.index):
            raise ValueError(f"spec entry {entry!r} is not in mesh order "
                             f"{tuple(names)}")
        for a in axes:
            out[names.index(a)] = Shard(dim)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``)."""
    mesh: Any
    spec: P


def _is_axes(x) -> bool:
    return (
        isinstance(x, tuple)
        and len(x) > 0
        and all(isinstance(e, (str, type(None))) for e in x)
    )


def _map_axes(fn, axes_tree, shapes_tree):
    if _is_axes(axes_tree):
        return fn(axes_tree, shapes_tree)
    if isinstance(axes_tree, dict):
        return {k: _map_axes(fn, v, None if shapes_tree is None
                             else shapes_tree[k])
                for k, v in axes_tree.items()}
    return tuple(_map_axes(fn, v, None if shapes_tree is None
                           else shapes_tree[i])
                 for i, v in enumerate(axes_tree))


def sharding_tree(axes_tree, rules, mesh, shapes_tree=None):
    """Map a tree of logical-axis tuples (nested dicts and tuples, as the
    port's parameter trees) to ``NamedSharding``s. ``shapes_tree`` (same
    structure; leaves with ``.shape``) enables divisibility-aware
    binding."""
    return _map_axes(
        lambda ax, leaf: NamedSharding(mesh, spec_for(
            ax, rules, mesh, None if leaf is None else tuple(leaf.shape))),
        axes_tree, shapes_tree)


def current_context():
    """(mesh, rules) if inside ``use_rules``, else None."""
    return getattr(_ctx, "state", None)


@contextlib.contextmanager
def use_rules(mesh, rules=DEFAULT_RULES):
    """Activate logical constraints inside model code."""
    prev = getattr(_ctx, "state", None)
    _ctx.state = (mesh, rules)
    try:
        yield
    finally:
        _ctx.state = prev


def is_global(x) -> bool:
    """Whether ``x`` is a global array (a ``DTensor``), not a local one."""
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def constrain(x: torch.Tensor, logical: Sequence[str | None]) -> torch.Tensor:
    """Apply a logical sharding constraint if a rules context is active: a
    global array is redistributed to the rule's placements; a local one
    (inside a ``shard_map`` body) is left as it is."""
    state = getattr(_ctx, "state", None)
    if state is None or not is_global(x):
        return x
    mesh, rules = state
    spec = spec_for(logical, rules, mesh, tuple(x.shape))
    return redistribute(x, placements(spec, mesh))


# ---------------------------------------------------------------------------
# Collectives.
# ---------------------------------------------------------------------------

def _collective(kind: str, out: torch.Tensor, x: torch.Tensor,
                group) -> torch.Tensor:
    """Run one collective of ``x`` into ``out`` over ``group``. Every
    backend the port runs takes each kind on the tensors' own device:
    NCCL, and gloo on CPU and on CUDA tensors (float32, bfloat16, int32
    and bool, checked by ``chip_smoke.py``'s ``mesh`` phase), so nothing
    is composed here."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        if kind == "all_gather":
            dist.all_gather_into_tensor(out, x, group=group)
        elif kind == "reduce_scatter":
            dist.reduce_scatter_tensor(out, x, op=dist.ReduceOp.SUM,
                                       group=group)
        elif kind == "all_reduce":
            if out is not x:
                out.copy_(x)
            dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        else:
            raise ValueError(kind)
    return out


def _gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((n * xt.shape[0], *xt.shape[1:]))
    return _collective("all_gather", out, xt, group).movedim(0, dim)


def _reduce_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    xt = x.movedim(dim, 0).contiguous()
    if xt.shape[0] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {n} ranks")
    out = xt.new_empty((xt.shape[0] // n, *xt.shape[1:]))
    return _collective("reduce_scatter", out, xt, group).movedim(0, dim)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    return _collective("all_reduce", torch.empty_like(x), x, group)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group, ctx.dim), None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


# ---------------------------------------------------------------------------
# shard_map and the collectives of its bodies.
# ---------------------------------------------------------------------------

def _region_mesh():
    mesh = getattr(_ctx, "region", None)
    if mesh is None:
        raise RuntimeError("a named-axis collective outside shard_map")
    return mesh


def in_region() -> bool:
    """Whether the caller runs inside a ``shard_map`` body."""
    return getattr(_ctx, "region", None) is not None


@contextlib.contextmanager
def region_dims(batch: int, seq: int):
    """Record the global batch and sequence length for the model code of a
    ``shard_map`` body, whose residual (B, S, D) blocks hold B / batch-axes
    rows and, where the sequence is sharded, S / model positions."""
    prev = getattr(_ctx, "dims", None)
    _ctx.dims = (batch, seq)
    try:
        yield
    finally:
        _ctx.dims = prev


def global_batch() -> "int | None":
    """The global batch ``region_dims`` recorded (None outside a body)."""
    dims = getattr(_ctx, "dims", None)
    return dims[0] if dims is not None and in_region() else None


def global_seq() -> "int | None":
    """The global sequence length ``region_dims`` recorded, or None."""
    dims = getattr(_ctx, "dims", None)
    return dims[1] if dims is not None and in_region() else None


def local_constrain(x: torch.Tensor, logical, global_shape) -> torch.Tensor:
    """Inside a ``shard_map`` body: the reference's constraint of a value
    of ``global_shape`` applied to a local one that holds some dimensions
    whole, by keeping this rank's block of each dimension the rule shards
    and ``x`` still holds whole (no communication). The batch dimension
    (the first) is always local already."""
    state = current_context()
    if state is None or not in_region():
        return x
    mesh, rules = state
    spec = spec_for(logical, rules, mesh, tuple(global_shape))
    whole = P(None, *(e if x.shape[d] == global_shape[d] else None
                      for d, e in enumerate(spec) if d > 0))
    return local_block(x, whole, mesh)


def recompute_context():
    """A ``context_fn`` for ``torch.utils.checkpoint``: the rules, the
    ``shard_map`` body and the global dims in force at the forward, put
    back around the backward's recomputation (which runs after the body
    has returned)."""
    snap = (getattr(_ctx, "state", None), getattr(_ctx, "region", None),
            getattr(_ctx, "dims", None))

    @contextlib.contextmanager
    def restored():
        prev = (getattr(_ctx, "state", None), getattr(_ctx, "region", None),
                getattr(_ctx, "dims", None))
        _ctx.state, _ctx.region, _ctx.dims = snap
        try:
            yield
        finally:
            _ctx.state, _ctx.region, _ctx.dims = prev

    return contextlib.nullcontext(), restored()


def seq_whole(x: torch.Tensor) -> torch.Tensor:
    """Inside a ``shard_map`` body, a seq-sharded residual block (B_loc,
    S / model, D) all-gathered to the whole sequence (what GSPMD does for
    a sequence-mixing block); anything else as it is."""
    s = global_seq()
    if s is None or x.shape[1] == s:
        return x
    return all_gather(x, "model", 1)


def seq_block(y: torch.Tensor) -> torch.Tensor:
    """The inverse of ``seq_whole``: a whole-sequence (B_loc, S, D) value
    cut to this rank's block of the residual's rule along the sequence
    (a body's residual holds its embed dim whole: where the batch does
    not divide, as in a one-row decode, the rule would give it the data
    axes)."""
    s = global_seq()
    if s is None:
        return y
    return local_constrain(y, ("batch", "seq", None),
                           (global_batch(), s, y.shape[2]))


@contextlib.contextmanager
def region(mesh):
    """Run the enclosed code as a ``shard_map`` body on ``mesh``: on local
    blocks, its named-axis collectives over the mesh's groups."""
    prev = getattr(_ctx, "region", None)
    _ctx.region = mesh
    try:
        yield
    finally:
        _ctx.region = prev


def _names(axes) -> tuple:
    return tuple(axes) if isinstance(axes, (tuple, list)) else (axes,)


def axis_size(axis, mesh=None) -> int:
    sizes = axis_sizes(mesh or _region_mesh())
    out = 1
    for a in _names(axis):
        out *= sizes.get(a, 1)
    return out


def axis_index(axis: str, mesh=None) -> int:
    """This rank's coordinate along ``axis`` (``lax.axis_index``)."""
    mesh = mesh or _region_mesh()
    return mesh.get_coordinate()[list(mesh.mesh_dim_names).index(axis)]


def all_gather(x: torch.Tensor, axis: str, dim: int = 0) -> torch.Tensor:
    """``lax.all_gather(x, axis, axis=dim, tiled=True)``."""
    mesh = _region_mesh()
    if axis_size(axis, mesh) == 1:
        return x
    return _AllGather.apply(x, mesh.get_group(axis), dim)


def psum_scatter(x: torch.Tensor, axis: str, dim: int = 0) -> torch.Tensor:
    """``lax.psum_scatter(x, axis, scatter_dimension=dim, tiled=True)``."""
    mesh = _region_mesh()
    if axis_size(axis, mesh) == 1:
        return x
    return _ReduceScatter.apply(x, mesh.get_group(axis), dim)


def psum(x: torch.Tensor, axes) -> torch.Tensor:
    """``lax.psum`` over one axis or a tuple of axes (one all-reduce an
    axis, in the tuple's order)."""
    mesh = _region_mesh()
    for a in _names(axes):
        if axis_size(a, mesh) > 1:
            x = _AllReduce.apply(x, mesh.get_group(a))
    return x


def pmean(x: torch.Tensor, axes) -> torch.Tensor:
    """``lax.pmean``: ``psum`` over the axes, divided by their extent."""
    n = axis_size(axes)
    return psum(x, axes) / n if n > 1 else x


def local_block(x: torch.Tensor, spec: Sequence, mesh) -> torch.Tensor:
    """This rank's block of a global value ``x`` that every rank holds
    whole, under ``spec`` (no communication)."""
    sizes = axis_sizes(mesh)
    for dim, entry in enumerate(spec):
        for a in _entry_axes(entry):
            n = sizes[a]
            if x.shape[dim] % n:
                raise ValueError(f"dim {dim} of {tuple(x.shape)} does not "
                                 f"split over {n} ranks of {a!r}")
            i = axis_index(a, mesh)
            step = x.shape[dim] // n
            x = x.narrow(dim, i * step, step)
    return x


def redistribute(x, target) -> "torch.Tensor":
    """A DTensor moved to ``target`` placements (Shard/Replicate only)
    through this module's collectives: gathers of the mesh dims that stop
    sharding a dimension (innermost first), then each rank's block of the
    ones that start."""
    from torch.distributed.tensor import DTensor, Replicate

    target = tuple(target)
    if tuple(x.placements) == target:
        return x
    mesh = x.device_mesh
    local = x.to_local()
    cur = list(x.placements)
    for md in reversed(range(len(cur))):
        if cur[md].is_shard() and cur[md] != target[md]:
            inner = [m for m in range(md + 1, len(cur)) if cur[m] == cur[md]]
            if inner:
                raise ValueError(f"cannot gather mesh dim {md} of {cur} "
                                 "while an inner one still shards its dim")
            local = _AllGather.apply(local, mesh.get_group(md), cur[md].dim)
            cur[md] = Replicate()
    for md in range(len(cur)):
        if target[md].is_shard() and not cur[md].is_shard():
            d = target[md].dim
            step = local.shape[d] // mesh.size(md)
            local = local.narrow(d, mesh.get_local_rank(md) * step, step)
            cur[md] = target[md]
    return DTensor.from_local(local, mesh, target, run_check=False,
                              shape=x.shape, stride=x.stride())


def distribute(x: torch.Tensor, mesh, spec: Sequence):
    """A global value every rank holds whole, as a DTensor under ``spec``
    (each rank keeps its block; no communication)."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local_block(x, spec, mesh), mesh,
                              placements(spec, mesh), run_check=False,
                              shape=x.shape, stride=x.contiguous().stride())


def full_tensor(x) -> torch.Tensor:
    """A DTensor's whole value on every rank (a plain tensor as it is)."""
    if not is_global(x):
        return x
    from torch.distributed.tensor import Replicate

    return redistribute(x, [Replicate()] * x.device_mesh.ndim).to_local()


def _flatten(tree, spec_tree, out_leaves: list, out_specs: list):
    """Leaves of ``tree`` with the spec of their place in ``spec_tree``,
    which may stop early (a spec for a whole subtree)."""
    if isinstance(spec_tree, P):
        if isinstance(tree, dict):
            for v in tree.values():
                _flatten(v, spec_tree, out_leaves, out_specs)
        elif isinstance(tree, (tuple, list)):
            for v in tree:
                _flatten(v, spec_tree, out_leaves, out_specs)
        else:
            out_leaves.append(tree)
            out_specs.append(spec_tree)
        return
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, spec_tree[k], out_leaves, out_specs)
    else:
        for v, s in zip(tree, spec_tree):
            _flatten(v, s, out_leaves, out_specs)


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, it) for v in tree)
    return next(it)


def _flat_specs(specs) -> list:
    if isinstance(specs, P):
        return [specs]
    return [s for sub in specs for s in _flat_specs(sub)]


def shard_map(f, mesh, in_specs, out_specs):
    """``f`` on each rank's local blocks (``jax.shard_map``): ``in_specs``
    mirrors the arguments (a spec may stand for a whole subtree),
    ``out_specs`` the outputs (one spec, or a tuple mirroring a tuple of
    outputs). A DTensor argument is redistributed to its spec; a plain
    tensor is a value every rank holds whole; a leaf that is not a tensor
    passes through. Returns DTensors."""
    from torch.distributed.tensor.experimental import local_map

    single = isinstance(out_specs, P)
    # local_map reads a tuple as one placement list per output.
    out_pl = (list(placements(out_specs, mesh)) if single else tuple(
        list(placements(s, mesh)) for s in _flat_specs(out_specs)))

    def wrapped(*args):
        leaves, specs = [], []
        _flatten(args, tuple(in_specs), leaves, specs)
        dts, in_pl = [], []
        for leaf, spec in zip(leaves, specs):
            if not isinstance(leaf, torch.Tensor):
                continue
            pl = placements(spec, mesh)
            dts.append(redistribute(leaf, pl) if is_global(leaf)
                       else distribute(leaf, mesh, spec))
            in_pl.append(pl)

        def body(*locals_):
            it = iter(locals_)
            flat = [next(it) if isinstance(leaf, torch.Tensor) else leaf
                    for leaf in leaves]
            with region(mesh):
                return f(*_rebuild(args, iter(flat)))

        return local_map(body, out_placements=out_pl,
                         in_placements=tuple(in_pl), device_mesh=mesh)(*dts)

    return wrapped


def distribute_tree(tree, mesh, shardings=None):
    """Every leaf of ``tree`` (a value every rank holds whole) as a DTensor
    on ``mesh``: under its ``NamedSharding`` in ``shardings`` (a tree of
    the same structure), else replicated."""
    from repro_torch.train.tree import tree_map

    if shardings is None:
        return tree_map(lambda t: distribute(t, mesh, P()), tree)
    return tree_map(lambda t, sh: distribute(t, mesh, sh.spec), tree,
                    shardings)


def local_tree(tree):
    """The local tensor of every DTensor leaf (a view of its storage);
    other leaves as they are."""
    from repro_torch.train.tree import tree_map

    return tree_map(lambda t: t.to_local() if is_global(t) else t, tree)


def global_norm(grads) -> torch.Tensor:
    """sqrt of the float32 sum of squares over every leaf of a gradient
    tree of DTensors, the leaves added in JAX's order: each leaf's local
    sum summed over the mesh axes that shard it."""
    from repro_torch.train import tree

    total = 0
    for _, g in tree.jax_leaves(grads):
        local = g.to_local() if is_global(g) else g
        sq = torch.sum(torch.square(local.to(torch.float32)))
        if is_global(g):
            for md, pl in enumerate(g.placements):
                if pl.is_shard() and g.device_mesh.size(md) > 1:
                    sq = _all_reduce(sq, g.device_mesh.get_group(md))
        total = total + sq
    return torch.sqrt(total)


def reduce_gradients(params, grads):
    """Sum each DTensor parameter's gradient over the mesh axes it is
    replicated on (a rank's gradient of a replicated value is its part of
    the total); the result keeps the parameter's placements. Leaves that
    are not DTensors are returned as they are."""
    from repro_torch.train.tree import tree_map
    from torch.distributed.tensor import DTensor

    def one(p, g):
        if g is None or not is_global(p):
            return g
        mesh = p.device_mesh
        local = g.to_local() if is_global(g) else g
        for md, pl in enumerate(p.placements):
            if not pl.is_shard() and mesh.size(md) > 1:
                local = _all_reduce(local, mesh.get_group(md))
        return DTensor.from_local(local, mesh, p.placements,
                                  run_check=False, shape=p.shape,
                                  stride=p.stride())

    return tree_map(one, params, grads)
