"""A world of ranks in spawned processes, for tests and smoke runs.

``run_world(fn, n, *args)`` spawns ``n`` processes, initialises a process
group in each (rendezvous through a ``FileStore`` file, so that several
worlds on one host never race for a TCP port), calls ``fn(rank, *args)``
in each and returns the ranks' results in rank order. A rank that raises
fails the world with its traceback; a world that does not finish within
``timeout_s`` is killed and raises ``TimeoutError``; every process is
stopped before ``run_world`` returns or raises. ``torchrun`` does the
same for the command-line entry points (``launch/train.py``).
"""
from __future__ import annotations

import os
import queue as queue_mod
import tempfile
import time
import traceback
from datetime import timedelta


def _rank_main(rank, n, backend, store_path, threads, timeout_s, fn, args,
               out):
    import torch
    import torch.distributed as dist

    try:
        torch.set_num_threads(threads)
        store = dist.FileStore(store_path, n)
        dist.init_process_group(backend, store=store, rank=rank, world_size=n,
                                timeout=timedelta(seconds=timeout_s))
        try:
            result = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        out.put((rank, True, result))
    except BaseException:  # noqa: BLE001 - reported to the parent
        out.put((rank, False, traceback.format_exc()))


def run_world(fn, n: int, *args, backend: str = "gloo", threads: int = 1,
              timeout_s: float = 300.0, store_dir: "str | None" = None):
    """``fn(rank, *args)`` on ``n`` spawned ranks; their results in rank
    order (``fn`` and its arguments and results must pickle)."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    fd, store_path = tempfile.mkstemp(prefix="world_store_", dir=store_dir)
    os.close(fd)
    os.unlink(store_path)
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, n, backend, store_path, threads, timeout_s,
                               fn, args, out))
             for r in range(n)]
    for p in procs:
        p.start()
    results: dict = {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(results) < n:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"world of {n} ranks did not finish in {timeout_s} s "
                    f"(ranks done: {sorted(results)})")
            try:
                rank, ok, val = out.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in results]
                if dead:
                    raise RuntimeError(f"rank(s) {dead} exited with "
                                       f"{[procs[r].exitcode for r in dead]}")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{val}")
            results[rank] = val
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
        return [results[r] for r in range(n)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
        if os.path.exists(store_path):
            os.unlink(store_path)
