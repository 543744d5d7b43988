"""GPU-accelerated, on-disk vector search (CAGRA-style), paper §VII (port of
``repro/apps/vector_search.py``, one drive).

The graph index lives in device memory; the dataset vectors live on the
emulated SSD. Each search iteration expands the best W unvisited
candidates per query, faults their neighbours' vectors in through the
``StorageClient`` (one 512-byte block per 128-dim float32 vector),
computes distances and merges the top-L candidate list. The storage
reads are priced by the SSD model through the SQ/CQ path; the GPU compute
is a per-iteration cost model, so QPS responds to device IOPS as in the
paper's fig 16.

On a card one iteration is captured into a CUDA graph
(``repro_torch/cuda_graph.py``) and replayed ``iterations`` times on
static buffers, the counterpart of the reference's compiled ``lax.scan``
body; on the CPU it runs eagerly. Both give the same numbers. ``search``
captures for its own call; ``make_search`` binds the configs and keeps
its capture for every call of one shape, as ``engine.make_runner`` does.

Reductions and ties follow the reference's compiled CPU program: a
squared distance over 128 lanes is summed as XLA's CPU backend splits it
(``xla_math.lane_sum``), and every top-k is a stable ascending sort,
which keeps the lower index on ties as ``jax.lax.top_k`` does.
``build_index`` and ``case_study`` draw from numpy's ``default_rng``
(the port cannot reproduce ``jax.random``), so their index is the port's
own; tests feed the reference's index in through
``convert.search_inputs_from_numpy``.

``num_devices = M > 1`` stripes each iteration's vector fetches
round-robin over an emulated M-drive array (``StorageClient.read_striped``,
the drives' state stacked on a leading axis and priced in one pass), and
the write-back goes to the array as one (M, B*K/M) batch
(``submit_array``). ``cache_sets > 0`` puts the stage-0 page cache (4
ways, ``cache_sets`` sets) in front of the vector fetches, on one drive or
one cache a drive of the array. ``remote`` puts every drive behind a
NIC/link hop each way (``REMOTE_FABRIC`` or a given ``FabricConfig``), so
the vector fetches and the write-back pay the wire.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Tuple

import numpy as np
import torch

from repro_torch import cuda_graph
from repro_torch.core.client import ClientState, StorageClient
from repro_torch.core.segops import stable_argsort
from repro_torch.core.xla_math import lane_mean, lane_sum
from repro_torch.core.types import (
    F32,
    I32,
    OP_WRITE,
    CacheConfig,
    EngineConfig,
    FabricConfig,
    PlatformModel,
    SSDConfig,
    StorageOps,
    resolve_device,
)

# Default wire for ``case_study(remote=True)``.
REMOTE_FABRIC = FabricConfig(
    remote=True, rtt_us=10.0, tx_bytes_per_us=8000.0,
    rx_bytes_per_us=8000.0, wire_txn_us=0.2, mtu_batch=8,
    mtu_timeout_us=20.0,
)

BIG = 3e38

# Rows of the kNN graph built at a time, as the reference's
# ``lax.map(batch_size=256)``: one chunk's lane differences at N = 4096
# are 256 x 4096 x 128 float32, 512 MiB.
_KNN_ROWS = 256


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    dim: int = 128
    degree: int = 16            # graph out-degree
    beam_width: int = 4         # W — candidates expanded per iteration
    list_size: int = 64         # L — internal top-list length
    iterations: int = 24
    top_k: int = 10
    gpu_flops: float = 50e12    # effective distance-compute throughput
    gpu_iter_overhead_us: float = 8.0


def _sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``sum((a - b) ** 2, axis=-1)`` as the reference computes it."""
    d = a - b
    return lane_sum(d * d)


def _check_stripes(reads_per_iter: int, num_devices: int) -> None:
    if num_devices < 1 or reads_per_iter % num_devices != 0:
        raise ValueError(
            f"batch*width*degree={reads_per_iter} must be divisible by "
            f"num_devices={num_devices} for striped array reads"
        )


def _smallest(x: torch.Tensor, k: int) -> torch.Tensor:
    """Column indices of the k smallest entries of each row, ascending, the
    lower index first on ties: ``jax.lax.top_k(-x, k)``'s indices."""
    return stable_argsort(x, dim=1)[:, :k].long()


# ---------------------------------------------------------------------------
# Index construction (exact kNN graph on synthetic data).
# ---------------------------------------------------------------------------

def _normalized(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=1, keepdim=True)


def knn_graph(vecs: torch.Tensor, degree: int) -> torch.Tensor:
    """(N, degree) i32 exact kNN graph of ``vecs`` (a row is never its own
    neighbour), ``_KNN_ROWS`` rows at a time, so no temporary holds more
    than one chunk's lane differences."""
    n = vecs.shape[0]
    rows = []
    for lo in range(0, n, _KNN_ROWS):
        hi = min(lo + _KNN_ROWS, n)
        d = _sq_dist(vecs[None, :, :], vecs[lo:hi, None, :])
        own = torch.arange(lo, hi, device=vecs.device)
        d[own - lo, own] = BIG
        rows.append(_smallest(d, degree))
    return torch.cat(rows).to(I32)


def build_index(seed: int, n: int, cfg: SearchConfig,
                device: "torch.device | str | None" = None,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (vectors (N, D), graph (N, degree) i32): unit vectors drawn
    from numpy's ``default_rng(seed)`` on the host, moved to ``device``
    (``cuda`` unless named), and their exact kNN graph."""
    draw = np.random.default_rng(seed).standard_normal((n, cfg.dim))
    vecs = _normalized(torch.from_numpy(draw.astype(np.float32))
                       .to(resolve_device(device)))
    return vecs, knn_graph(vecs, cfg.degree)


def ground_truth(vecs: torch.Tensor, queries: torch.Tensor,
                 k: int) -> torch.Tensor:
    d = _sq_dist(queries[:, None, :], vecs[None, :, :])
    return _smallest(d, k).to(I32)


# ---------------------------------------------------------------------------
# CAGRA-style batched beam search with storage-gated vector fetches.
# ---------------------------------------------------------------------------

def _merge_top(dist, idx, expanded, new_d, new_i, list_size):
    """Merge candidates; dedupe by keeping the first (sorted) occurrence."""
    all_d = torch.cat([dist, new_d], dim=1)
    all_i = torch.cat([idx, new_i], dim=1)
    all_e = torch.cat([expanded, torch.zeros_like(new_i, dtype=torch.bool)],
                      dim=1)
    order = stable_argsort(all_d, dim=1).long()
    all_d = torch.gather(all_d, 1, order)
    all_i = torch.gather(all_i, 1, order)
    all_e = torch.gather(all_e, 1, order)
    # A later duplicate of an id (an earlier occurrence exists) drops out.
    eq = all_i[:, :, None] == all_i[:, None, :]
    dup = torch.tril(eq, diagonal=-1).any(dim=2)
    all_d = torch.where(dup, BIG, all_d)
    order2 = stable_argsort(all_d, dim=1)[:, :list_size].long()
    return (torch.gather(all_d, 1, order2), torch.gather(all_i, 1, order2),
            torch.gather(all_e, 1, order2))


@dataclasses.dataclass(frozen=True)
class _Carry:
    """What one search iteration reads and writes."""

    dist: torch.Tensor      # (B, L) f32
    idx: torch.Tensor       # (B, L) i32
    expd: torch.Tensor      # (B, L) bool
    cstate: ClientState
    clock: torch.Tensor     # () f32 virtual now


@dataclasses.dataclass(frozen=True)
class _Search:
    """The static part of a search: its config and the storage client."""

    cfg: SearchConfig
    storage: StorageClient
    gpu_us: float           # modelled GPU time an iteration (float32)
    num_devices: int = 1    # > 1: reads striped over an array

    def iteration(self, c: _Carry, queries, vecs, graph
                  ) -> Tuple[_Carry, torch.Tensor]:
        cfg = self.cfg
        b, d = queries.shape
        # Pick the top-W unexpanded candidates.
        cand_d = torch.where(c.expd | (c.idx < 0), BIG, c.dist)
        sel = _smallest(cand_d, cfg.beam_width)                # (B, W)
        sel_idx = torch.gather(c.idx, 1, sel)
        valid = torch.gather(cand_d, 1, sel) < BIG
        expd = c.expd.scatter(1, sel, torch.gather(c.expd, 1, sel) | valid)

        # Neighbour ids (the graph resides in device memory).
        nbrs = graph[sel_idx.clamp(min=0).long()].reshape(b, -1)
        nvalid = valid.repeat_interleave(cfg.degree, dim=1)

        # Storage: fault in the neighbour vectors (one block each).
        lba = nbrs.reshape(-1).clamp(min=0)
        read = (self.storage.read if self.num_devices == 1
                else self.storage.read_striped)
        cstate, data, done = read(
            c.cstate, vecs, lba, c.clock, nvalid.reshape(-1)
        )
        storage_done = torch.amax(done)
        fetched = data.reshape(b, -1, d)

        nd = _sq_dist(fetched, queries[:, None, :])
        nd = torch.where(nvalid, nd, BIG)
        dist, idx, expd = _merge_top(
            c.dist, c.idx, expd, nd, nbrs, cfg.list_size
        )
        step_us = torch.clamp(storage_done - c.clock, min=self.gpu_us)
        return _Carry(dist, idx, expd, cstate, c.clock + step_us), step_us


class _GraphedSearch:
    """``iterations`` replays of one captured search iteration on static
    buffers: the inputs and the carry are copied in before the replays,
    and each replay writes its ``step_us`` into slot ``it`` of ``steps``."""

    def __init__(self, search: _Search, carry: _Carry, queries, vecs, graph):
        self.search = search
        self.device = cuda_graph.cuda_index(queries.device)
        self.inputs = tuple(t.clone() for t in (queries, vecs, graph))
        self.static = cuda_graph.map_leaves(torch.clone, carry)
        iters = search.cfg.iterations
        self.steps = torch.zeros((iters,), dtype=F32, device=self.device)
        self.it = torch.zeros((1,), dtype=torch.int64, device=self.device)
        self.graph = cuda_graph.Captured(
            self._step, self.device,
            warm=lambda: search.iteration(self.static, *self.inputs))

    def _step(self) -> _Carry:
        new, step_us = self.search.iteration(self.static, *self.inputs)
        cuda_graph.check_writeback(self.static, new)
        cuda_graph.copy_into(self.static, new)
        self.steps.index_copy_(0, self.it, step_us.reshape(1))
        self.it.add_(1)
        return new

    def __call__(self, carry: _Carry, queries, vecs, graph
                 ) -> Tuple[_Carry, torch.Tensor]:
        for dst, src in zip(self.inputs, (queries, vecs, graph)):
            cuda_graph.copy_into(dst, src)
        cuda_graph.copy_into(self.static, carry)
        self.it.zero_()
        self.graph.replay(self.search.cfg.iterations)
        return cuda_graph.map_leaves(torch.clone, self.static), \
            self.steps.clone()


class _Searcher:
    """A search with its configs bound (see ``make_search``)."""

    def __init__(self, cfg: SearchConfig, ssd: SSDConfig,
                 ecfg: EngineConfig, plat: PlatformModel, graphed: bool,
                 num_devices: int = 1):
        if num_devices < 1:
            raise ValueError(f"num_devices={num_devices} must be >= 1")
        self.cfg, self.graphed = cfg, graphed
        self.num_devices = num_devices
        self.storage = StorageClient(ssd, ecfg, plat)
        self.captured: "_GraphedSearch | None" = None

    def _iterate(self, s: _Search, carry: _Carry, queries, vecs, graph
                 ) -> Tuple[_Carry, torch.Tensor]:
        """Every iteration of one search: replays of the captured iteration
        on a card (captured at the first call), else the eager loop."""
        if queries.device.type != "cuda" or not self.graphed:
            steps = []
            for _ in range(self.cfg.iterations):
                carry, st = s.iteration(carry, queries, vecs, graph)
                steps.append(st)
            return carry, torch.stack(steps)
        if self.captured is None:
            self.captured = _GraphedSearch(s, carry, queries, vecs, graph)
        return self.captured(carry, queries, vecs, graph)

    def __call__(self, queries: torch.Tensor, vecs: torch.Tensor,
                 graph: torch.Tensor, write_back: bool = False) -> dict:
        cfg, storage, m = self.cfg, self.storage, self.num_devices
        b, d = queries.shape
        n = vecs.shape[0]
        device = queries.device
        _check_stripes(b * cfg.beam_width * cfg.degree, m)

        # Entry points: hash-spread start nodes (a uint32 product mod 2^32).
        start = (((torch.arange(b, dtype=torch.int64, device=device)
                   * 2654435761) & 0xFFFFFFFF) % n).to(I32)
        dist0 = torch.full((b, cfg.list_size), BIG, dtype=F32, device=device)
        idx0 = torch.full((b, cfg.list_size), -1, dtype=I32, device=device)
        exp0 = torch.zeros((b, cfg.list_size), dtype=torch.bool,
                           device=device)
        dist0[:, 0] = _sq_dist(queries, vecs[start.long()])
        idx0[:, 0] = start
        cstate = (storage.init_state(device) if m == 1
                  else storage.init_array_state(m, device))
        carry = _Carry(dist0, idx0, exp0, cstate,
                       torch.zeros((), dtype=F32, device=device))

        # Per-iteration modelled GPU time: distance flops + merge overhead.
        flops_per_iter = b * cfg.beam_width * cfg.degree * d * 3
        gpu_us = (flops_per_iter / cfg.gpu_flops * 1e6
                  + cfg.gpu_iter_overhead_us)
        s = _Search(cfg, storage, float(np.float32(gpu_us)), m)

        carry, step_us = self._iterate(s, carry, queries, vecs, graph)
        idx, cstate, clock = carry.idx, carry.cstate, carry.clock
        total_us = float(clock)

        writeback_us = 0.0
        if write_back:
            # The result log goes through the unified op API: one write
            # batch over the same rings as the reads (one row a drive on
            # an array).
            k = cfg.top_k
            res_i = idx[:, :k]
            res_vecs = vecs[res_i.clamp(min=0).reshape(-1).long()]
            log = torch.zeros((b * k, d), dtype=F32, device=device)
            lba = torch.arange(b * k, dtype=I32, device=device)
            wvalid = (res_i >= 0).reshape(-1)
            if m == 1:
                wops = StorageOps.make(lba, clock, opcode=OP_WRITE,
                                       valid=wvalid)
                cstate, log, _, wdone = storage.submit(cstate, log, wops,
                                                       data=res_vecs)
            else:
                if (b * k) % m != 0:
                    raise ValueError(
                        f"batch*top_k={b * k} must be divisible by "
                        f"num_devices={m} for array write-back"
                    )
                wops = StorageOps.make(
                    lba.reshape(m, -1), clock, opcode=OP_WRITE,
                    valid=wvalid.reshape(m, -1),
                )
                cstate, log, _, wdone = storage.submit_array(
                    cstate, log, wops, data=res_vecs.reshape(m, -1, d))
                wdone = wdone.reshape(-1)
            writeback_us = max(
                float(torch.amax(torch.where(wvalid, wdone, 0.0)))
                - total_us, 0.0,
            )
            total_us += writeback_us

        return {
            "indices": idx[:, : cfg.top_k],
            "distances": carry.dist[:, : cfg.top_k],
            "virtual_us": total_us,
            "qps": b / (total_us * 1e-6),
            "avg_iter_us": float(lane_mean(step_us)),
            "gpu_iter_us": float(gpu_us),
            "reads_per_iter": b * cfg.beam_width * cfg.degree,
            "writeback_us": writeback_us,
        }


def make_search(
    cfg: SearchConfig,
    ssd: SSDConfig,
    ecfg: "EngineConfig | None" = None,
    plat: "PlatformModel | None" = None,
    num_devices: int = 1,
    graphed: bool = True,
) -> Callable[..., dict]:
    """``search`` with its configs bound: a callable
    ``(queries, vecs, graph, write_back=False) -> dict``.

    On a card it captures one search iteration into a CUDA graph at its
    first call and replays it ``iterations`` times at every call; it owns
    the graph and its static buffers, which live as long as it does, and
    every later call must give inputs of the first call's shapes and
    device. A capture that fails raises. With ``graphed=False``, or on the
    CPU, the iterations run eagerly. ``num_devices > 1`` stripes the
    reads over an M-drive array."""
    return _Searcher(cfg, ssd, ecfg or EngineConfig(num_units=8,
                                                    fetch_width=64),
                     plat or PlatformModel(), graphed, num_devices)


def search(
    queries: torch.Tensor,       # (B, D)
    vecs: torch.Tensor,          # (N, D) — the "on-disk" dataset
    graph: torch.Tensor,         # (N, degree) i32
    cfg: SearchConfig,
    ssd: SSDConfig,
    ecfg: "EngineConfig | None" = None,
    plat: "PlatformModel | None" = None,
    num_devices: int = 1,
    write_back: bool = False,
    graphed: bool = True,
) -> dict:
    """Returns results + virtual-time QPS accounting, on the inputs'
    device. ``num_devices > 1`` stripes the vector fetches round-robin
    over an emulated M-drive array (batch*width*degree must divide by M).
    ``write_back=True`` persists each query's top-k result vectors
    to a result-log region through the same client after the search, so
    QPS pays for durable results. On a card the iterations replay a CUDA
    graph captured for this call unless ``graphed=False``; on the CPU they
    run eagerly. ``make_search`` keeps the capture across calls."""
    return make_search(cfg, ssd, ecfg, plat, num_devices, graphed)(
        queries, vecs, graph, write_back)


def recall_at_k(found: torch.Tensor, truth: torch.Tensor) -> float:
    """Fraction of ground-truth top-k present in results."""
    hits = (found[:, :, None] == truth[:, None, :]).any(dim=1)
    return float(torch.mean(hits.to(F32)))


@functools.lru_cache(maxsize=4)
def _cached_index(n: int, dim: int, degree: int, seed: int,
                  device: torch.device):
    cfg = SearchConfig(dim=dim, degree=degree)
    return build_index(seed, n, cfg, device)


def case_queries(batch: int, dim: int, seed: int,
                 device: "torch.device | str | None" = None) -> torch.Tensor:
    """``case_study``'s unit queries: numpy's ``default_rng(seed + 1)``,
    drawn on the host and moved to ``device``."""
    draw = np.random.default_rng(seed + 1).standard_normal((batch, dim))
    return _normalized(torch.from_numpy(draw.astype(np.float32))
                       .to(resolve_device(device)))


def case_configs(n: int, t_max_iops: float, cache_sets: int = 0,
                 fabric: FabricConfig = FabricConfig(),
                 ) -> Tuple[SSDConfig, EngineConfig]:
    """The drive and the engine of one ``case_study`` cell."""
    ssd = SSDConfig(
        t_max_iops=t_max_iops, l_min_us=50.0,
        n_instances=max(64, int(t_max_iops // 4e4)),
        num_blocks=n,
    )
    ecfg = EngineConfig(
        num_units=8, fetch_width=64,
        cache=CacheConfig(enabled=cache_sets > 0,
                          num_sets=max(cache_sets, 1)),
        fabric=fabric,
    )
    return ssd, ecfg


def case_study(
    n: int = 4096,
    batch: int = 64,
    width: int = 4,
    iterations: int = 24,
    t_max_iops: float = 2.5e6,
    seed: int = 0,
    num_devices: int = 1,
    write_back: bool = False,
    cache_sets: int = 0,
    remote: "FabricConfig | bool | None" = None,
    device: "torch.device | str | None" = None,
) -> dict:
    """One (batch, width, IOPS) cell of the paper's fig 16 study, on
    ``device`` (``cuda`` unless named), over ``num_devices`` drives.
    ``cache_sets > 0`` enables the 4-way page cache of ``cache_sets`` sets
    in front of the vector fetches (the fig 22 study); ``remote=True``
    puts every drive behind ``REMOTE_FABRIC`` (or pass a ``FabricConfig``),
    the disaggregated array whose QPS follows the link bandwidth."""
    if remote is True:
        fabric = REMOTE_FABRIC
    elif isinstance(remote, FabricConfig):
        fabric = remote
    else:
        fabric = FabricConfig()
    ssd, ecfg = case_configs(n, t_max_iops, cache_sets, fabric)
    device = resolve_device(device)
    cfg = SearchConfig(beam_width=width, iterations=iterations)
    vecs, graph = _cached_index(n, cfg.dim, cfg.degree, seed, device)
    queries = case_queries(batch, cfg.dim, seed, device)
    out = search(queries, vecs, graph, cfg, ssd, ecfg=ecfg,
                 num_devices=num_devices, write_back=write_back)
    truth = ground_truth(vecs, queries, cfg.top_k)
    out["recall"] = recall_at_k(out["indices"], truth)
    return out
