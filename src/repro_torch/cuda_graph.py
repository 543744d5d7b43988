"""CUDA graphs of the port's hot loops: the counterpart of ``jax.jit``.

The reference compiles a whole engine run (``make_runner``) and a decode
step (``serving/loop.py``) with ``jax.jit``. The port captures one engine
round, or one decode step, into a ``torch.cuda.CUDAGraph`` and replays it:
one ``cudaGraphLaunch`` a round or step instead of about a thousand kernel
launches from the host. A captured step reads and writes static buffers
that live as long as the graph; whatever changes between replays is
written into those buffers on the device.

``Captured`` also keeps ``build.LAUNCHES`` true: a replay makes no wrapper
call, so each replay adds the launches its graph recorded at capture, and
the capture itself, which launches nothing, adds none.

There is no fallback: a capture or replay that fails raises.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Callable, Dict, Iterator

import torch

from repro_torch.kernels import build


def map_leaves(fn: Callable, *trees):
    """``fn`` applied leaf by leaf to trees of frozen dataclasses whose
    leaves are tensors (``None`` fields stay ``None``); the trees must have
    one structure, the first one's."""
    first = trees[0]
    if first is None:
        return None
    if dataclasses.is_dataclass(first):
        return type(first)(**{
            f.name: map_leaves(fn, *(getattr(t, f.name) for t in trees))
            for f in dataclasses.fields(first)
        })
    return fn(*trees)


def leaves(tree) -> list:
    """The tensor leaves of a tree of dataclasses, in field order."""
    out: list = []
    map_leaves(out.append, tree)
    return out


def copy_into(dst, src) -> None:
    """Copy every leaf of ``src`` into the same leaf of ``dst`` in place;
    a leaf of another shape, dtype or device raises (``copy_`` would
    broadcast or convert it)."""
    def one(d: torch.Tensor, s: torch.Tensor) -> None:
        if d.shape != s.shape or d.dtype != s.dtype or d.device != s.device:
            raise ValueError(
                f"leaf {s.dtype}{tuple(s.shape)} on {s.device} does not fit "
                f"{d.dtype}{tuple(d.shape)} on {d.device}")
        if d is not s:
            d.copy_(s)

    map_leaves(one, dst, src)


def check_writeback(static, new) -> None:
    """Refuse a captured step whose output leaf shares memory with a static
    leaf other than the one it is copied into: copying the outputs back one
    by one would then read a buffer that an earlier copy has overwritten."""
    spans = {}
    for t in leaves(static):
        spans[t.untyped_storage().data_ptr()] = t

    def one(d: torch.Tensor, s: torch.Tensor) -> None:
        owner = spans.get(s.untyped_storage().data_ptr())
        if owner is None or owner is d:
            return
        same = (s.data_ptr() == d.data_ptr() and s.shape == d.shape
                and s.stride() == d.stride())
        if not same:
            raise RuntimeError(
                "a captured step returned a view of another static buffer")

    map_leaves(one, static, new)


@contextlib.contextmanager
def _recording() -> Iterator[Dict[str, int]]:
    """Take the launches that the wrappers count inside the block out of
    ``build.LAUNCHES`` and into the yielded dict."""
    before = dict(build.LAUNCHES)
    got: Dict[str, int] = {}
    try:
        yield got
    finally:
        for name in build.LAUNCHES:
            got[name] = build.LAUNCHES[name] - before[name]
            build.LAUNCHES[name] = before[name]


def cuda_index(device: torch.device) -> torch.device:
    """``device`` with its index filled in (``cuda`` -> ``cuda:<current>``)."""
    if device.type != "cuda":
        raise ValueError(f"a CUDA graph needs a CUDA device, not {device}")
    if device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


@functools.lru_cache(maxsize=None)
def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The one side stream that every capture on ``device`` runs on.
    cuBLAS keeps a workspace (32 MiB on an H100) per stream for the life
    of the process, so a new stream a capture would leave one behind each
    time; graphs replay on the caller's stream, one after another, so
    sharing the workspace is safe."""
    return torch.cuda.Stream(device)


class Captured:
    """One CUDA graph of ``step`` on ``device``.

    ``warm`` runs first, eagerly, on the capture stream: it builds the
    kernels and fills the cached device constants (copies from the host,
    which a capture refuses). Then ``step()`` is captured once; what it
    returns stays referenced in ``out`` (tensors in the graph's own memory
    pool, rewritten by every replay)."""

    def __init__(self, step: Callable, device: torch.device, warm: Callable):
        device = cuda_index(device)
        stream = _capture_stream(device)
        caller = torch.cuda.current_stream(device)
        stream.wait_stream(caller)
        with torch.cuda.stream(stream):
            warm()
        caller.wait_stream(stream)
        self.graph = torch.cuda.CUDAGraph()
        with _recording() as self.launches:
            with torch.cuda.graph(self.graph, stream=stream):
                self.out = step()

    def replay(self, times: int = 1) -> None:
        """Replay the graph ``times`` times on the current stream, and add
        its launches to ``build.LAUNCHES`` for each replay."""
        for _ in range(times):
            self.graph.replay()
        for name, n in self.launches.items():
            build.LAUNCHES[name] += n * times
