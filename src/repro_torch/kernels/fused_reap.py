"""Fused neutral CQ post on the card (port of
``repro/kernels/fused_reap.py``).

``fused_reap`` launches ``csrc/fused_reap.cu`` once (one block per CQ: a
block-wide rank scan, each slot's last writer by ``atomicMax`` of the row
index, then a sweep that writes fresh rings). The caller's rings are only
read. Its plain version is ``kernels/ref.py::fused_reap_ref``;
``kernels/ops.py`` chooses between them by the tensor's device.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

_P = ctypes.c_void_p


@functools.lru_cache(maxsize=None)
def _smem_slots() -> int:
    """The depth up to which the kernel keeps its slot table in shared
    memory (a compile-time constant of the library)."""
    return build.library("fused_reap").fused_reap_smem_slots()


def fused_reap(
    done_time: torch.Tensor,     # (Q, D) f32 ring
    visible_time: torch.Tensor,  # (Q, D) f32 ring
    req_id_ring: torch.Tensor,   # (Q, D) i32 ring
    tail: torch.Tensor,          # (Q,) i32 free-running producer index
    key: torch.Tensor,           # (N,) i32 target CQ, == Q for invalid rows
    done: torch.Tensor,          # (N,) f32 completion times
    req_id: torch.Tensor,        # (N,) i32
    valid: torch.Tensor,         # (N,) bool
):
    """One-pass neutral post: returns (done_time', visible_time',
    req_id', counts) with ``counts`` the (Q,) per-CQ valid entries."""
    dev = done_time.device
    build.require(done_time, "done_time", torch.float32, 2)
    build.require(visible_time, "visible_time", torch.float32, 2, dev)
    build.require(req_id_ring, "req_id_ring", torch.int32, 2, dev)
    build.require(tail, "tail", torch.int32, 1, dev)
    build.require(key, "key", torch.int32, 1, dev)
    build.require(done, "done", torch.float32, 1, dev)
    build.require(req_id, "req_id", torch.int32, 1, dev)
    build.require(valid, "valid", torch.bool, 1, dev)
    q, d = done_time.shape
    n = key.shape[0]
    if visible_time.shape != (q, d) or req_id_ring.shape != (q, d):
        raise ValueError("the three rings must have one (Q, D) shape")
    if tail.shape[0] != q or d < 1:
        raise ValueError(f"tail must be ({q},) and the depth >= 1")
    if not (done.shape[0] == req_id.shape[0] == valid.shape[0] == n):
        raise ValueError("key, done, req_id and valid must have equal length")
    dt = torch.empty_like(done_time)
    vt = torch.empty_like(visible_time)
    rid = torch.empty_like(req_id_ring)
    counts = torch.empty((q,), dtype=torch.int32, device=dev)
    # A depth beyond the kernel's shared-memory slot table puts the table
    # in a (Q, D) global scratch.
    scratch = (torch.empty((q, d), dtype=torch.int32, device=dev)
               if d > _smem_slots() else None)
    fn = build.bind("fused_reap", [_P] * 13 + [ctypes.c_int] * 4 + [_P])
    dv, stream = build.launch_args(dev)
    rc = fn(build.ptr(done_time), build.ptr(visible_time),
            build.ptr(req_id_ring), build.ptr(tail), build.ptr(key),
            build.ptr(done), build.ptr(req_id), build.ptr(valid),
            build.ptr(dt), build.ptr(vt), build.ptr(rid), build.ptr(counts),
            build.ptr(scratch) if scratch is not None else None,
            q, d, n, dv, stream)
    build.check("fused_reap", rc)
    build.LAUNCHES["fused_reap"] += 1
    return dt, vt, rid, counts
