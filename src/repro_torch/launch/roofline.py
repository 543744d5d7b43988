"""Roofline terms of one step from counts on fake tensors (the port's
counterpart of ``repro/launch/roofline.py``).

Terms (per device, NVIDIA H100 SXM, dense, at its 700 W limit):
    compute    = FLOPs / 989e12              (bf16 peak)
    memory     = bytes / 3.35e12             (HBM bandwidth)
    collective = collective_bytes / 450e9    (NVLink, each way)

The reference walks the compiled HLO. The port has none: ``count_step``
runs the step once on FakeTensors (``launch/specs.py``) under two
dispatch modes and reads rank 0's counts.

- FLOPs: ``torch.utils.flop_counter``'s formulas (``FlopCounterMode``'s
  registry: matmuls, convolutions, attention) over every op on a local
  tensor. ``FlopCounterMode`` itself charges an op on DTensors at the
  DTensor's global shape (an (8, 16) @ (16, 32) product whose rows are
  split over 2 ranks counts 8 rows, not the rank's 4), so the counting
  mode lets a DTensor op run first and counts the local ops it becomes.
  The backward and the recomputation of ``torch.utils.checkpoint`` are
  ops like any other and are counted, as the compiled reference counts
  its rematerialised forward.
- Bytes: the input and output bytes of every aten op that is not a view
  (a view moves nothing) nor a bare allocation. This is what the eager
  port moves through HBM, one kernel an op. The reference charges a fused
  instruction once at its call site (``roofline.py:307-370``), so its
  elementwise chains move a tensor once where the port moves it once an
  op, and it charges slices and in-place updates by their region.
- Collective bytes: the operand bytes of every collective by kind
  (all-gather, reduce-scatter, all-reduce, all-to-all, send/recv), from
  both routes the port takes: the ``c10d`` ops of
  ``sharding._collective`` and the ``_c10d_functional`` ops a DTensor's
  redistribution issues (``roofline.py:316-324``).
- Memory (``torch.distributed._tools.mem_tracker.MemTracker`` in the
  same fake mode): argument bytes are the exact sum of the rank's local
  blocks of the arguments; temp bytes the tracker's peak of what the
  step allocates; outputs the local bytes of what it returns; peak the
  arguments plus the temps, as the reference adds them.

DTensor's sharding propagation runs each op once more at its global
shape to learn the output's shape. Neither mode counts it: it runs in a
fake mode other than the step's, its own in torch 2.11, and in torch
2.13 (which would take the step's) one that ``count_step`` enters in
place of the propagation's lock.

Three keys of the reference's record have no counterpart: the port has
no while loops of unknown trip count (``unknown_trip_loops``) and no
XLA ``cost_analysis`` (``xla_cost_analysis_flops_once``,
``xla_cost_analysis_bytes_once``).
"""
from __future__ import annotations

from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_leaves

PEAK_FLOPS = 989e12       # bf16, dense, H100 SXM
HBM_BW = 3.35e12          # bytes/s
NVLINK_BW = 450e9         # bytes/s each way

_aten = torch.ops.aten

# Collective ops of both routes: (the reference's kind, the position of
# the operand among the op's arguments).
_COLLECTIVES = {
    "c10d._allgather_base_": ("all-gather", 1),
    "c10d.allgather_into_tensor_coalesced_": ("all-gather", 1),
    "c10d._reduce_scatter_base_": ("reduce-scatter", 1),
    "c10d.reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1),
    "c10d.allreduce_": ("all-reduce", 0),
    "c10d.allreduce_coalesced_": ("all-reduce", 0),
    "c10d.alltoall_base_": ("all-to-all", 1),
    "c10d.send": ("collective-permute", 0),
    "_c10d_functional.all_gather_into_tensor": ("all-gather", 0),
    "_c10d_functional.all_gather_into_tensor_coalesced": ("all-gather", 0),
    "_c10d_functional.reduce_scatter_tensor": ("reduce-scatter", 0),
    "_c10d_functional.reduce_scatter_tensor_coalesced":
        ("reduce-scatter", 0),
    "_c10d_functional.all_reduce": ("all-reduce", 0),
    "_c10d_functional.all_reduce_": ("all-reduce", 0),
    "_c10d_functional.all_reduce_coalesced": ("all-reduce", 0),
    "_c10d_functional.all_to_all_single": ("all-to-all", 0),
}

# Ops that move no bytes: allocations without a fill, and the wait on a
# functional collective (its bytes are the collective's).
_NO_BYTES = {
    _aten.empty.memory_format, _aten.empty_strided.default,
    _aten.new_empty.default, _aten.new_empty_strided.default,
    _aten.empty_like.default,
    torch.ops._c10d_functional.wait_tensor.default,
}

# Queries of a tensor's metadata, which ``FlopCounterMode`` passes on too.
_METADATA = {
    _aten.is_contiguous.default, _aten.is_contiguous.memory_format,
    _aten.is_strides_like_format.default,
    _aten.is_non_overlapping_and_dense.default, _aten.size.default,
    _aten.sym_size.default, _aten.stride.default, _aten.sym_stride.default,
    _aten.storage_offset.default, _aten.sym_storage_offset.default,
    _aten.numel.default, _aten.sym_numel.default, _aten.dim.default,
    torch.ops.prim.layout.default, torch.ops.prim.device.default,
}


def _op_name(func) -> str:
    return f"{func.namespace}.{func._schema.name.split('::')[-1]}"


def _is_view(func) -> bool:
    """An op whose result aliases an input without writing it."""
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _tensor_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def local_bytes(tree) -> int:
    """Bytes of the rank's blocks of a tree's tensors (a DTensor's local
    tensor, a plain tensor whole)."""
    from torch.distributed.tensor import DTensor

    return sum(_tensor_bytes(t.to_local() if isinstance(t, DTensor) else t)
               for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


class _Op:
    """What ``Counts`` does with one op: pass it on (a metadata query),
    decompose it (a composite op without a FLOP formula), count its
    FLOPs by ``flops``, its collective (kind, operand position), and
    whether it moves bytes."""

    __slots__ = ("metadata", "decompose", "flops", "collective", "moves")

    def __init__(self, func, registry):
        self.metadata = func in _METADATA
        self.collective = _COLLECTIVES.get(_op_name(func))
        self.flops = registry.get(func._overloadpacket)
        self.decompose = (not self.metadata and self.flops is None
                          and self.collective is None
                          and func._can_decompose())
        self.moves = func not in _NO_BYTES and not _is_view(func)


class Counts(TorchDispatchMode):
    """FLOPs, bytes and collective bytes of the ops run on local tensors
    in ``fake_mode`` while the mode is active."""

    def __init__(self, fake_mode):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.fake_mode = fake_mode
        self.registry = flop_registry
        self.ops: dict = {}
        self.flops = 0
        self.flops_by_op: dict = defaultdict(int)
        self.bytes = 0
        self.collective_by_op: dict = defaultdict(int)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._guards import active_fake_mode
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if DTensor in types:
            return NotImplemented    # counted as the local ops it becomes
        op = self.ops.get(func)
        if op is None:
            op = self.ops[func] = _Op(func, self.registry)
        if op.metadata:
            return func(*args, **kwargs)
        if op.decompose:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        if active_fake_mode() is not self.fake_mode:
            return out               # DTensor's sharding propagation
        if op.flops is not None:
            n = int(op.flops(*args, **kwargs, out_val=out))
            self.flops += n
            self.flops_by_op[str(func._overloadpacket)] += n
        if op.collective is not None:
            kind, at = op.collective
            self.collective_by_op[kind] += _tensor_bytes(args[at])
        if op.moves:
            self.bytes += _tensor_bytes((args, kwargs, out))
        return out


def _total(snapshot: dict) -> int:
    return sum(dev.get("Total", 0) for dev in snapshot.values())


def count_step(fn, args, fake_mode) -> dict:
    """Run ``fn(*args)`` once in ``fake_mode`` (``args`` made in it: plain
    FakeTensors or DTensors of them) and return rank 0's counts: flops,
    bytes, collective bytes by kind, and argument, output, temp bytes."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    counts = Counts(fake_mode)
    mem = MemTracker()
    # The arguments' storages are known to the tracker before the step, so
    # that a view of one is not taken for a new allocation.
    mem.track_external(*tree_flatten(args)[0])
    base = _total(mem.get_tracker_snapshot())
    # torch 2.13 runs the propagation in the ambient fake mode, under this
    # lock: a fake mode of its own takes the lock's place. A version
    # without the lock makes a fake mode of its own.
    swap = hasattr(ShardingPropagator, "_fake_mode_lock")
    if swap:
        prev = ShardingPropagator._fake_mode_lock
        ShardingPropagator._fake_mode_lock = FakeTensorMode(
            allow_non_fake_inputs=True)
    try:
        with fake_mode, mem, counts:
            out = fn(*args)
    finally:
        if swap:
            ShardingPropagator._fake_mode_lock = prev
    temp = _total(mem.get_tracker_snapshot("peak")) - base
    return {
        "flops": counts.flops,
        "flops_by_op": dict(counts.flops_by_op),
        "bytes": counts.bytes,
        "collective_bytes": sum(counts.collective_by_op.values()),
        "collective_by_op": dict(counts.collective_by_op),
        "argument_bytes": local_bytes(args),
        "output_bytes": local_bytes(out),
        "temp_bytes": temp,
    }


def analyze(counts: dict, chips: int, model_flops: float | None = None
            ) -> dict:
    """Three roofline terms + bottleneck for one counted step, with the
    reference's keys."""
    flops = counts["flops"]
    bytes_accessed = counts["bytes"]
    compute_s = flops / PEAK_FLOPS
    memory_s = bytes_accessed / HBM_BW
    collective_s = counts["collective_bytes"] / NVLINK_BW
    terms = {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
    }
    bottleneck = max(terms, key=terms.get)
    out = {
        "chips": chips,
        "flops_per_device": flops,
        "bytes_per_device": bytes_accessed,
        "collective_bytes_per_device": counts["collective_bytes"],
        "collective_by_op": counts["collective_by_op"],
        **terms,
        "bottleneck": bottleneck.replace("_s", ""),
        "hbm_argument_bytes": counts["argument_bytes"],
        "hbm_output_bytes": counts["output_bytes"],
        "hbm_temp_bytes": counts["temp_bytes"],
        "hbm_peak_bytes": counts["argument_bytes"] + counts["temp_bytes"],
    }
    if model_flops:
        out["model_flops_total"] = model_flops
        out["model_flops_per_device"] = model_flops / chips
        out["useful_compute_ratio"] = (
            model_flops / chips / flops if flops else None
        )
    dom = max(terms.values())
    out["roofline_bound_s"] = dom
    out["roofline_fraction"] = compute_s / dom if dom > 0 else None
    return out
