#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``, then
runs twenty phases, printing one JSON line each (with the phase's
seconds, ``phase_s``):

  env              nvidia-smi's card name and power limit, torch/CUDA
                   versions, kernel build seconds
  kernels          every kernel against its plain PyTorch version on the
                   card at the main paths' shapes and at edge shapes
                   (exact equality for the five gather/engine kernels, the
                   stated tolerances for the two attention kernels);
                   median CUDA-event times of a wrapper call, device times
                   and device events per call from torch.profiler, host
                   microseconds a call (no synchronisation), bounds and
                   library times; die_contention's one-die time and
                   its time per event row there; each attention kernel's
                   bound share and ptxas registers, shared memory and
                   spills. fused_reap must leave its input rings as they
                   were. die_contention is also timed at the baseline's
                   per-request fold (cost = sched at every row)
  main_path_read   the paper's 40-MIOPS drive (``local_1drive``: 32 SQs x
                   1024, fetch 256, 16 units, DSA datapath, closed loop at
                   io_depth 256) for 24 rounds with the block_gather,
                   seg_scan and fused_reap kernels on, from one initial
                   state through the eager ``engine.run`` and through
                   ``engine.make_runner`` (one captured round replayed a
                   round): bit-identical final states, the recorded
                   virtual numbers, wall ms and device ms a round, device
                   events a round and the device's idle share of each; a
                   ``donate=True`` chain of two calls equal to one run of
                   48 rounds; a profiler window over one graphed round
                   that holds one ``cudaGraphLaunch`` and no kernel launch
                   or copy from the host
  main_path_mixed  the same under the 70/30 read/write mix with the
                   die_contention kernel on as well
  main_path_baseline
                   the NVMeVirt baseline (``nvmevirt_cfg()``: one
                   dispatcher over 32 SQs x 1024, fetch 64, per-request
                   timing and lock, 32 CPU copy workers) on the same drive
                   at io_depth 256 for 24 rounds, kernels on, through both
                   runners as above: die_contention (the per-request
                   fold), seg_scan and fused_reap in the graph, virtual numbers those of the port run on
                   the CPU (and of the reference where the routes agree),
                   and main_path_read's graphed requests a wall-second over
                   the baseline's; then one line of fig 11 (D7_PS1010 at
                   io_depth 512, 32 rounds)
  exact            an integer-timestamp drive at full width: kernels on and
                   off, each graphed and eager, give bit-identical final
                   states
  cpu_vs_card      stock local_1drive, kernels off, on the card and on the
                   CPU: integer leaves equal, float leaves within a stated
                   ULP bound; the same for 8 rounds of the Zipf loop under
                   lba_hash and of the Poisson loop at fig 18's size; Zipf
                   addresses and Poisson gaps of 2^20 request ids and the
                   vector search at n = 1024 (its kNN graph included) bit
                   for bit
  vector_search    fig 16 at its own size (n = 4096, width 4, batches 4,
                   16, 64 and 256 at 2.5e6 and 40e6 IOPS), each search's
                   24 iterations replaying one captured iteration: QPS,
                   recall, virtual us, wall and device ms an iteration,
                   the 40e6-over-2.5e6 QPS ratio per batch; at batch 256,
                   40e6 the eager search bit-identical to the graphed one,
                   a write-back, and the kernel flags on (seg_scan,
                   fused_reap and die_contention launching) bit-identical
                   to the flags off
  workloads        figs 18-20 at full size (fig 18's four generators at
                   depth 1024 for 64 rounds on D7_PS1010, fig 19's four
                   read/write mixes and fig 20's fresh and steady-state
                   drives at depth 64 for 192 rounds) and a two-tenant
                   loop on local_1drive, each graphed through
                   make_runner: virtual MIOPS, p50/p95/p99, GC count, wall
                   and device ms a round; the final state against the CPU
                   port's, and again with the kernel flags on,
                   bit-identical
  array            the M-drive array on the one card: fig 17 (stock
                   local_1drive at depth 1024, 24 rounds, M = 1, 2, 4, 8,
                   main_path_read's kernel flags, one captured array round
                   replayed) against the reference's aggregate MIOPS,
                   fraction of target, p50 and p99, with wall and device
                   ms a round, emulated requests a wall-second, device
                   events a round (M = 4 within 1.1x of M = 1) and the
                   same kernel launches a graphed round at every M;
                   array_4drive (depth 256) and a 70/30 array with data
                   emulated and every kernel flag on, graphed equal to
                   eager, to the CPU port and drive by drive to single
                   drives of salt d; the vector search striped over 4
                   drives (n = 4096, batch 256, 40e6) against the CPU port;
                   the 4 x 40M striped KV tier (fig 27) against the
                   reference; the four engine kernels' flattened calls
                   against per-drive plain calls
  cache            the stage-0 page cache: fig 22's six rows at full size
                   (the Zipf loop at depth 256 on D7_PS1010, 48 rounds,
                   0 to 4096 sets of 4 ways), graphed, against the
                   reference's hit rate, MIOPS, p50 and p99 to the last
                   digit and against the CPU port's final state (the
                   cache's tags and cursors included), with wall and
                   device ms and device events a round; the 1024-set row
                   with every kernel flag on against the CPU port; a
                   cached 4-drive array, drive by drive against single
                   drives; ``case_study(cache_sets=256)`` on one drive and
                   striped over 4 against the same search on the CPU
  qp               the coalescing completion queue: fig 21's seven rows at
                   full size (1 to 32 completions a doorbell and the
                   neutral QP, depth 1024, 32 rounds), graphed, against
                   the reference's MIOPS, p50 and p99 to the last digit
                   and the CPU port's state; each again with
                   use_pallas_segscan on (the doorbell queue on seg_scan,
                   one more launch a graphed round than the neutral QP's)
                   against the CPU port with the same flag
  fabric           the remote fabric, the ready-time lock and the tenant
                   metrics: figs 23 and 25 (a remote 4 x 40M array, 8 link
                   bandwidths and 4 RTTs, 7 switch roofs, 24 rounds), fig
                   26 (WFQ shares, 192 rounds; bulk-write starvation, 96)
                   and fig 29 (FIFO and WFQ 2:1 x program and ready-time
                   lock, 96 rounds), graphed, against
                   ``FABRIC_REFERENCE`` (every number to the last digit
                   but a tenant's average E2E, within the bound of the
                   reference's recursive sum) and three rows' states
                   against the CPU port's; fig 24 through the remote
                   4-drive client (n = 4096); ``remote_qos`` (the speed
                   harness's remote two-tenant config) graphed against
                   eager, then with main_path_read's flags through both
                   runners, timed beside main_path_read (one more line,
                   ``{"remote_qos_vs_main_path_read": ...}``), four more
                   seg_scan launches a graphed round than the same loop
                   on a local drive, and its state against the CPU
                   port's; ``case_study(remote=True)`` on 1 and 4 drives
                   against the CPU
  figures          the paper's own evaluation at its settings: every
                   engine run of figs 03 (NVMeVirt and SwarmIO over the
                   host transport, depths 8-512, 32 rounds), 10 (D7_PS1010
                   at 256-32768 outstanding, 48 rounds), 12 (1-16 units
                   at depth 256, 8 rounds; 5-45 MIOPS targets, 64 rounds),
                   13 (base to D+A+C, 24 rounds), 14 (aggregated and
                   per-request at 2-16 units, 32 rounds) and 15 (32-1024
                   SQs; 512 B-8 KiB blocks, 24 rounds), 47 runs graphed
                   with the reference's flags, and fig 04's closed form,
                   against ``FIGURES_REFERENCE`` (every number to the last
                   digit but fig 10's average E2E, within SUM_ULP); one run
                   of each engine figure against the CPU port's state, and
                   figs 10 and 14 once more with main_path_read's flags;
                   fig 12 (a)'s graphed requests a wall-second; the paper's
                   ratios (303.9x, 537x, 3.6x) from the card's numbers
  variants         the engine's last variants: the skewed load of
                   tests/test_engine.py under the global and the local
                   timing scope (graphed equal to eager, card equal to the
                   CPU port, global over twice local); stock local_1drive
                   sanitized and unsanitized, graphed, bit-identical, with
                   the device ms and events the checks add to a round,
                   and again under the ready-time lock (the admission
                   permutation's checks), bit-identical; a
                   local-scope sanitized 2-drive array against the CPU
                   port; an out-of-range SQ id through ``process`` raising
                   ``SanitizeError`` (no device-side assert: the sanitized
                   runner still works after it); one ``_submit_direct``
                   call against the CPU port's
  serve_tier       ``python -m repro_torch.launch.serve --arch starcoder2-3b
                   --iops 40e6``'s objects at full width (batch 4, prompt
                   32, 16 tokens) with the attention kernels on: generate
                   plus the SSD-backed KV tier, whose virtual-time stats
                   must reproduce the reference's; the tier again with
                   fused_reap on, bit-identical; fig 28's hot-window x
                   cache sweep (hot window 32, 64, 128 x cache off, small,
                   large) and its tenant mix (a bulk tenant on a switched
                   remote fabric, FIFO and WFQ 4:1) against the
                   reference's tokens/s, storage us and blocks a step;
                   once the phase drops its objects, the
                   card holds no more than before it
  serve_long       generate at full width, batch 8, prompt 4096, 128
                   tokens, kernels on, its decode step a CUDA graph, timed
                   beside an eager decode loop from the same prefill (equal
                   tokens, bit-identical logits, wall and device ms a step
                   of each, one graph launch a graphed step) and its peak
                   device memory; then the
                   plain path, teacher-forced on the kernel run's tokens,
                   must agree on the prefill's and every decode step's
                   logits
  serve_archs      every other architecture the reference serves, one at a
                   time at full width: recurrentgemma-9b and
                   qwen2-moe-a2.7b (full depth) through ``launch.serve``'s
                   objects and ``serve_with_kv_tier`` (the tier's numbers
                   the reference's), xlstm-1.3b and musicgen-large (full
                   depth), qwen3-moe-30b-a3b (8 of 48 layers) and
                   qwen2-vl-72b (2 of 80, prefilled from patch embeddings
                   and M-RoPE ids) through prefill and the graphed decode
                   step; for each the kernel decode teacher-forced against
                   the plain full-sequence forward, graphed against eager
                   decode bit for bit, no NaN, the graphed step's wall and
                   device ms, and the SMOKE config's plain path on the
                   card against the CPU
  train            training on the card (``use_pallas=False``, as the
                   reference trains): flash_vjp's dq/dk/dv against autograd
                   through the plain attention at starcoder2-3b's and a
                   gemma2-27b softcap/window attention shape; one train
                   step of five SMOKE architectures on the card against the
                   CPU; starcoder2-3b at full width cut to 2 layers
                   (float32), loss and gradient norm against the CPU; then
                   starcoder2-3b FULL (30 layers, bf16, remat) at batch 4 x
                   128 through ``launch.train``'s objects on ``Prefetcher``
                   batches: a warm-up step, three timed steps and one
                   profiled (wall and device ms, events, tokens a
                   wall-second, peak memory), finite losses and norms, the
                   parameters moved, the step counted; ``train()`` on SMOKE
                   with an injected crash (one restart, the losses of an
                   uninterrupted run); and the attention kernels' refusal
                   of autograd on the card. The path launches none of the
                   seven kernels. Its ``roofline`` record is
                   ``launch.roofline``'s count of that same full-width step
                   on fake tensors (in a CPU worker, while the card works):
                   its three terms over the H100's published peaks, the
                   bound, its term and the predicted peak memory beside
                   the profiled device ms, which must not be below the
                   bound
  mesh             several ranks: a world of 4 spawned processes, NCCL with
                   a card each where there are 4 cards, else gloo with all
                   of them on this one (built after the kernels, so no rank
                   builds); each collective the paths use checked on CUDA
                   tensors of each dtype; fig 17's arrays (M = 4, 8 over 4
                   and over 2 ranks, main_path_read's flags, graphed) bit
                   for bit against one process and at ARRAY_REFERENCE's
                   numbers, each rank's wall ms a round; one 8192-row batch
                   through the distributed timing update against
                   ``timing.update`` bit for bit; starcoder2-3b FULL
                   prefill (2 x 2048, bf16) on (data 2, model 2) through the
                   ``flash_attention`` kernel on 12 q heads a rank and on
                   the Megatron-SP route, within the ``serve_long`` bound of
                   the one-process prefill; qwen3-moe-30b-a3b (2 of 48
                   layers, float32, expert parallel, capacity E / k, the
                   one-process routing forced) against one process; and
                   starcoder2-3b at full width, 2 layers, float32: two
                   steps on (2, 2), a checkpoint, the reload onto (1, 2)
                   and a third step, against three one-process steps. The
                   ranks' kernel launches are summed into the kernels line

After the kernels phase, one line ``{"launch_floor": ...}`` times an
empty kernel (``csrc/launch_floor.cu``) through the wrappers' launch path:
the device ms, card ms and host microseconds that any launch costs, which
the kernels' own figures (host microseconds a call among them) are read
against.

Then one JSON line listing the kernels, the nvidia-smi line, and the last
line ``{"ok": true, "device": {...}}``. Any failure raises and exits
non-zero; without a card, or without the repository around it, the script
exits non-zero before printing a result.
"""
from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12     # H100 SXM dense bf16 tensor-core peak
ROUNDS = 24
# Rounds a profiled window of a longer run covers. The profiler's
# host-side processing of every device event (~1100-2900 a round) set
# the time of the phases that run 32-192 rounds: with whole-run windows
# the script took 1073-1269 s on one H100 host, against a 1200-s limit.
PROFILE_ROUNDS = 24
SUM_LEAF_ULP = 256          # cpu_vs_card bound for the metrics' float sums


class SmokeFailure(AssertionError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# perf_counter() at the start of the running phase (``run_phase``).
PHASE_START = [time.perf_counter()]


def run_phase(fn, *args):
    """Call one phase, its start noted for the ``phase_s`` of its line."""
    PHASE_START[0] = time.perf_counter()
    return fn(*args)


def emit(obj) -> None:
    """Print one JSON line; a record of the card's also says how many
    profiler windows since the last such record recorded no device event
    and were taken again (``PROFILER_TRIES``), how many ``device_ms``
    calls were timed with CUDA events for it and how many device records
    its kept windows missed, and a phase's line the
    seconds since its phase started (``phase_s``) where it does not time
    itself."""
    if "card" in obj:
        obj = {**obj, "empty_profiler_windows": EMPTY_WINDOWS[0],
               "event_timed_calls": EVENT_TIMED[0],
               "dropped_device_records": DROPPED_EVENTS[0]}
        EMPTY_WINDOWS[0] = EVENT_TIMED[0] = DROPPED_EVENTS[0] = 0
    if "phase" in obj and "phase_s" not in obj:
        obj = {**obj, "phase_s": time.perf_counter() - PHASE_START[0]}
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    )
    return out.stdout.strip().splitlines()[0]


# -- configurations (local_1drive: repro_torch/bench.py) ---------------------

KERNEL_FLAGS = dict(use_pallas=True, use_pallas_segscan=True,
                    use_pallas_reap=True, use_pallas_flash=True)
# main_path_read's flags: with use_pallas_flash off the flash stage's
# queueing scans run on seg_scan (with it on, that fold is die_contention
# and seg_scan has no caller on the DSA datapath). On reads these flags
# leave every result as it is with the flags off; where writes reach the
# flash stage their segmax scan re-associates fractional sums.
READ_FLAGS = dict(use_pallas=True, use_pallas_segscan=True,
                  use_pallas_reap=True)


# -- timing helpers -----------------------------------------------------------

def median_ms(fn, reps: int = 50) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bitwise_equal(a, b) -> bool:
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype.is_floating_point:
        bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}
        t = bits[a.element_size()]
        return bool(torch.equal(a.contiguous().view(t),
                                b.contiguous().view(t)))
    return bool(torch.equal(a, b))


def host_us(fn, calls: int = 1000) -> float:
    """Host microseconds a call: ``calls`` calls after a warmup, with no
    synchronisation between them, timed with ``time.perf_counter``."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host / calls * 1e6


def abs_err(got, want) -> float:
    """Largest |got - want|, where equal values and NaN against NaN count
    as 0."""
    import torch

    if not got.numel():
        return 0.0
    g, w = got.double(), want.double()
    same = (g == w) | (torch.isnan(g) & torch.isnan(w))
    return float(torch.where(same, 0.0, (g - w).abs()).max())


def bound(nbytes: float, ops: float, ops_per_s: float = F32_OPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def close_enough(got, want):
    """The attention kernels' tolerance against their plain versions:
    both compute in float32 with sums in another order, so float32
    outputs agree to 1e-4 absolute (outputs are O(1)) and bf16 outputs to
    one bf16 rounding step (2^-7 relative, plus 1e-5)."""
    import torch

    g, w = got.float(), want.float()
    if got.dtype == torch.bfloat16:
        return bool(((g - w).abs() <= w.abs() * 2.0 ** -7 + 1e-5).all())
    return bool(((g - w).abs() <= 1e-4).all())


# -- the port's CPU runs, in worker processes ----------------------------------

# Processes that run the port's eager CPU runs, which the phases hold the
# card's final states against, while the card works. A run on the CPU
# gives the same bits at any thread count; one thread a worker keeps the
# workers off each other's cores.
CPU_WORKERS = 6
_CPU_POOL: list = []


def _cpu_worker_init(src: str) -> None:
    sys.path.insert(0, src)
    import torch

    torch.set_num_threads(1)


def _cpu_state(cfg, ssd, wl, plat, rounds, num_devices):
    from repro_torch import convert
    from repro_torch.core import engine

    return convert.engine_state_to_numpy(engine.simulate(
        cfg, ssd, wl, plat, rounds=rounds, num_devices=num_devices,
        device="cpu"))


def cpu_pool():
    """The worker processes (started at the first call)."""
    if not _CPU_POOL:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        _CPU_POOL.append(ProcessPoolExecutor(
            CPU_WORKERS, mp_context=multiprocessing.get_context("spawn"),
            initializer=_cpu_worker_init, initargs=(str(SRC),)))
    return _CPU_POOL[0]


def cpu_state(cfg, ssd, wl, rounds, num_devices=1, plat=None):
    """A future of the port's eager run on the CPU (``engine.simulate``):
    its final state as numpy leaves, computed in a worker process."""
    from repro_torch.core.types import PlatformModel

    return cpu_pool().submit(_cpu_state, cfg, ssd, wl,
                             plat or PlatformModel(), rounds, num_devices)


def stop_cpu_workers() -> None:
    for pool in _CPU_POOL:
        pool.shutdown(cancel_futures=True)
    _CPU_POOL.clear()


# -- phase: kernels -----------------------------------------------------------

BASELINE_FOLD = "baseline per-request fold N=2048 K=512 cost=sched"


def kernel_cases(dev):
    """(name, kernel fn, plain fn, list of (label, (args, kwargs))) per
    kernel; the first case of each is the main path's shape."""
    import numpy as np
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.block_gather import block_gather
    from repro_torch.kernels.block_gather_tiled import block_gather_tiled
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.die_contention import die_contention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.fused_reap import fused_reap
    from repro_torch.kernels.seg_scan import seg_scan

    rng = np.random.default_rng(0)

    def t(x, dtype=None):
        return torch.as_tensor(np.asarray(x), device=dev, dtype=dtype)

    def ss(n, p_head):
        v = rng.uniform(-1e4, 1e4, n).astype(np.float32)
        h = rng.random(n) < p_head
        return (t(v), t(h)), {}

    seg = [("main n=8192", ss(8192, 0.02)), ("ragged n=8229", ss(8229, 0.02)),
           ("n=5", ss(5, 0.3)), ("n=1", ss(1, 0.0)),
           ("all heads", ss(4096, 1.1)), ("no heads", ss(4133, 0.0)),
           ("n=300007 multi-chunk carry", ss(300007, 1e-4))]

    def dc(n, k, p_event, one_die=False, fractional=False):
        if fractional:
            ready = rng.uniform(0, 5000, n).astype(np.float32)
            cost = rng.uniform(0.1, 300, n).astype(np.float32)
        else:
            ready = rng.integers(0, 5000, n).astype(np.float32)
            cost = rng.choice([40.0, 200.0, 240.0], n).astype(np.float32)
        chip = (np.zeros(n) if one_die else rng.integers(0, k, n)).astype(
            np.int32)
        event = rng.random(n) < p_event
        cur = (rng.uniform(0, 3000, k) if fractional
               else rng.integers(0, 3000, k)).astype(np.float32)
        return (t(ready), t(cost), t(chip), t(event), t(cur)), {}

    die = [("main N=8192 K=32", dc(8192, 32, 0.3)),
           ("no event rows", dc(8192, 32, 0.0)),
           ("one die", dc(8192, 32, 0.5, one_die=True)),
           ("N=37 K=3", dc(37, 3, 0.5)), ("N=8192 K=1", dc(8192, 1, 0.4))]

    def fr(q, d, n, p_valid, tail_lo=0, tail_hi=4096, bad_keys=False):
        dt = rng.uniform(0, 9, (q, d)).astype(np.float32)
        vt = rng.uniform(0, 9, (q, d)).astype(np.float32)
        rid = rng.integers(0, 99, (q, d)).astype(np.int32)
        tail = rng.integers(tail_lo, tail_hi, q).astype(np.int32)
        key = np.repeat(np.arange(q), -(-n // q))[:n].astype(np.int32)
        if bad_keys:
            key = rng.integers(-2, q + 3, n).astype(np.int32)
        valid = rng.random(n) < p_valid
        key = np.where(valid | bad_keys, key, q).astype(np.int32)
        done = rng.uniform(0, 1e5, n).astype(np.float32)
        req = rng.integers(0, 1 << 30, n).astype(np.int32)
        return tuple(t(x) for x in (dt, vt, rid, tail, key, done, req,
                                    valid)), {}

    reap = [("main Q=32 D=1024 N=8192", fr(32, 1024, 8192, 0.9)),
            ("all rows invalid", fr(32, 1024, 8192, 0.0)),
            ("tail wraps past D", fr(32, 1024, 8192, 1.0, 900, 1024)),
            ("tail near int32 max", fr(8, 64, 512, 0.8, 2**31 - 40,
                                       2**31 - 1)),
            ("D=4, slots reused in a chunk", fr(4, 4, 700, 0.9)),
            ("keys out of range", fr(8, 64, 1000, 0.7, bad_keys=True))]

    def bg(nb, width, n, dtype, lo=0, hi=None):
        flash = torch.randn(nb, width, device=dev).to(dtype)
        idx = rng.integers(lo, nb if hi is None else hi, n).astype(np.int32)
        return (flash, t(idx)), {}

    gather = [("main (16384,16) f32 n=8192", bg(16384, 16, 8192,
                                                torch.float32)),
              ("width 3 f32 (byte path)", bg(1000, 3, 777, torch.float32)),
              ("bf16 width 8", bg(512, 8, 300, torch.bfloat16)),
              ("f64 width 5", bg(256, 5, 100, torch.float64)),
              ("int32 width 16", bg(256, 16, 64, torch.int32)),
              ("indices out of range", bg(128, 16, 500, torch.float32,
                                          -50, 200)),
              ("n=0", bg(64, 16, 0, torch.float32))]

    def bgt(tile, *a, **k):
        args, _ = bg(*a, **k)
        return args, {"tile": tile}

    # No path calls it (nor its reference); the main case is block_gather's.
    tiled = [("main (16384,16) f32 n=8192 tile 8",
              bgt(8, 16384, 16, 8192, torch.float32)),
             ("tile 1", bgt(1, 1000, 16, 777, torch.float32)),
             ("tile 4 bf16 width 8", bgt(4, 512, 8, 300, torch.bfloat16)),
             ("tile 16 f64 width 5 (byte path)",
              bgt(16, 256, 5, 96, torch.float64)),
             ("tile 8 int32, indices out of range",
              bgt(8, 128, 16, 504, torch.int32, -50, 200)),
             ("n=0", bgt(8, 64, 16, 0, torch.float32))]

    bf16 = torch.bfloat16

    def fa(b, hq, hkv, s_len, dtype=bf16, d=128, **kw):
        g = torch.Generator(device=dev).manual_seed(s_len + hq)

        def x(h):
            return torch.randn(b, h, s_len, d, generator=g, device=dev,
                               dtype=dtype)

        return (x(hq), x(hkv), x(hkv)), kw

    # Main: starcoder2-3b prefill of the serve_long phase. Edge: gemma2's
    # window 64 and softcap 50 at its 32/16 heads, groups 1/2/12, ragged
    # S (not a multiple of the 128-row q tile), a single row, 128-row q
    # tiles straddling the diagonal at D = 64 and 256, float32 (the SIMT
    # body).
    flash = [("main starcoder2 (8,24,4096,128) bf16", fa(8, 24, 2, 4096)),
             ("gemma2 window 64 softcap 50, group 2, S=1000",
              fa(1, 32, 16, 1000, window=64, logit_softcap=50.0,
                 scale=144 ** -0.5)),
             ("group 1, S=777", fa(2, 4, 4, 777)),
             ("group 12, S=1, f32", fa(1, 24, 2, 1, torch.float32)),
             ("f32 group 12 window 100 S=513",
              fa(1, 24, 2, 513, torch.float32, window=100)),
             ("not causal, S=300", fa(1, 4, 2, 300, causal=False)),
             ("group 12, S=1337", fa(1, 24, 2, 1337)),
             ("D=64 group 2, S=300", fa(2, 4, 2, 300, d=64)),
             ("D=256 group 2, S=300", fa(2, 4, 2, 300, d=256)),
             ("D=256 window 100 softcap 30, S=513",
              fa(1, 8, 2, 513, d=256, window=100, logit_softcap=30.0))]
    # The serving shapes of the other architectures (``ARCH_SHAPES``):
    # recurrentgemma-9b's local layers (16 q heads on 1 KV head, D = 256,
    # window 2048, S past the window), musicgen-large (32 heads, D = 64),
    # qwen3-moe-30b-a3b (32 on 4) and qwen2-vl-72b (64 on 8).
    flash += [(ARCH_SHAPES[0], fa(2, 16, 1, 4096, d=256, window=2048)),
              (ARCH_SHAPES[1], fa(4, 32, 32, 1024, d=64)),
              (ARCH_SHAPES[2], fa(4, 32, 4, 1024)),
              (ARCH_SHAPES[3], fa(4, 64, 8, 1024))]

    def da(b, hq, hkv, s_len, lens, dtype=bf16, d=128, **kw):
        g = torch.Generator(device=dev).manual_seed(s_len + hq + b)

        def x(*shape):
            return torch.randn(*shape, generator=g, device=dev, dtype=dtype)

        return (x(b, hq, d), x(b, hkv, s_len, d), x(b, hkv, s_len, d),
                t(np.asarray(lens, np.int32))), kw

    # Main: serve_long's decode, q (8,24,128) against the 4224-row caches
    # at lengths 4097-4224 (22 splits of 192 rows). Edge: lengths at a
    # split boundary and one past it, a batch where only the first split
    # is live, gemma2's window and softcap, groups 1/2/12, lengths far
    # below S, ragged S, float32 and a bf16 head dim of 96 (the SIMT body).
    decode = [("main starcoder2 q (8,24,128) cache 4224 bf16",
               da(8, 24, 2, 4224, np.linspace(4097, 4224, 8).astype(int))),
              ("gemma2 window 64 softcap 50, group 2",
               da(2, 32, 16, 4224, [4224, 100], window=64,
                  logit_softcap=50.0, scale=144 ** -0.5)),
              ("group 1, lengths below S", da(4, 4, 4, 1000, [1, 17, 300, 999])),
              ("group 12, ragged S=1000, f32",
               da(2, 24, 2, 1000, [1000, 513], torch.float32)),
              ("f32 window 100 softcap 30",
               da(3, 8, 4, 700, [700, 64, 1], torch.float32, window=100,
                  logit_softcap=30.0)),
              ("lengths at split boundaries and one past",
               da(8, 24, 2, 4224, [192, 193, 384, 385, 3840, 3841, 4032,
                                   4033])),
              ("only the first split live",
               da(8, 24, 2, 4224, [1, 2, 64, 65, 128, 190, 191, 192])),
              ("D=256 window 100",
               da(2, 8, 2, 700, [700, 64], d=256, window=100)),
              ("D=64 group 12", da(2, 24, 2, 1000, [1000, 513], d=64)),
              ("bf16 D=96 (SIMT body)", da(2, 8, 2, 500, [500, 77], d=96))]
    decode += [(ARCH_SHAPES[0], da(4, 16, 1, 4224, [4224, 4097, 2049, 100],
                                   d=256, window=2048)),
               (ARCH_SHAPES[1], da(4, 32, 32, 1024, [1024, 1000, 513, 48],
                                   d=64)),
               (ARCH_SHAPES[2], da(4, 32, 4, 1024, [1024, 1000, 513, 48])),
               (ARCH_SHAPES[3], da(4, 64, 8, 1024, [1024, 1000, 513, 48]))]

    # Cases added with the redesigned die_contention and fused_reap; their
    # data is drawn after every earlier case's, which stays as it was.
    def unaligned(case, rows):
        """The case with the row inputs at positions ``rows`` replaced by
        contiguous views that start one element past an aligned address."""
        args, kw = case
        return tuple(a[1:] if i in rows else a
                     for i, a in enumerate(args)), kw

    def dc_special(n, k, p_event):
        """Readies of +inf and costs of -0 on 1% of the rows each."""
        (ready, cost, *rest), kw = dc(n, k, p_event)
        ready[t(rng.random(n) < 0.01)] = float("inf")
        cost[t(rng.random(n) < 0.01)] = -0.0
        return (ready, cost, *rest), kw

    def dc_zeros(n, k):
        """Readies and costs of +0 and -0 (costs mostly -0, which keeps the
        max's sign in the output), cursors of -0: of two zeros the max
        takes +0."""
        zeros = np.array([0.0, -0.0], np.float32)
        return (t(rng.choice(zeros, n)), t(rng.choice(zeros, n, p=[0.1, 0.9])),
                t(rng.integers(0, k, n).astype(np.int32)),
                t(rng.random(n) < 0.7), t(np.full(k, -0.0, np.float32))), {}

    def dc_nan(n, k):
        """NaN readies (two payloads) on 0.4% of the rows and NaN cursors
        on every seventh die: a NaN propagates."""
        (ready, cost, chip, event, cur), kw = dc(n, k, 0.5)
        nan = t(np.array([0x7FC00001, 0xFFA00042], np.uint32).view(np.float32))
        ready[t(rng.random(n) < 0.002)] = nan[0]
        ready[t(rng.random(n) < 0.002)] = nan[1]
        cur[::7] = nan[1]
        return (ready, cost, chip, event, cur), kw

    die += [("N=300007 K=32 (many tiles)", dc(300007, 32, 0.3)),
            ("N=8192 K=512 (16 die groups)", dc(8192, 512, 0.3)),
            ("K=1000 N=20000", dc(20000, 1000, 0.5)),
            ("one die N=65536 p=0.5 (long chain)",
             dc(65536, 32, 0.5, one_die=True)),
            ("fractional ready and cost", dc(8192, 32, 0.3, fractional=True)),
            ("+inf readies, -0 costs", dc_special(8192, 32, 0.3)),
            ("signed zeros", dc_zeros(8192, 32)),
            ("NaN readies and cursors", dc_nan(8192, 32)),
            ("unaligned rows", unaligned(dc(8193, 32, 0.3), range(4))),
            ("N=0", dc(0, 32, 0.3))]
    wrap6 = (t(np.zeros((1, 6), np.float32)), t(np.zeros((1, 6), np.float32)),
             t(np.full((1, 6), -1, np.int32)),
             t(np.array([2**31 - 7], np.int32)), t(np.zeros(10, np.int32)),
             t(np.arange(10, dtype=np.float32)),
             t(np.arange(10, dtype=np.int32)), t(np.ones(10, bool)))
    # The tail wraps past 2^31 inside a CQ's last D posts, D not dividing
    # 2^32: a slot's last writer is then not among the last D ranks.
    reap += [("D=6, tail 2^31-7 wraps at the 8th of 10 posts", (wrap6, {})),
             ("Q=4 D=1000 N=8192, tails wrap in the last D posts",
              fr(4, 1000, 8192, 0.9, 2**31 - 1500, 2**31 - 1000)),
             ("Q=2 D=60000 N=150000, slot table in global scratch, tails "
              "wrap", fr(2, 60000, 150000, 0.9, 2**31 - 60000, 2**31 - 10000)),
             ("unaligned rows", unaligned(fr(32, 1024, 8193, 0.9),
                                          range(4, 8))),
             ("N=0", fr(32, 1024, 0, 0.9))]

    # Cases added with the one-launch seg_scan and the lane-per-unit
    # block_gather; their data is drawn after every earlier case's. A tile
    # of seg_scan is 8192 elements (one cluster of 8 CTAs): 8193 and 16385
    # end one element into a tile, 2^20 + 3 runs 129 tiles through the
    # look-back.
    def ss_zeros(n, p_head):
        """Values of +0 and -0: of two zeros the max takes +0."""
        zeros = np.array([0.0, -0.0], np.float32)
        return (t(rng.choice(zeros, n)), t(rng.random(n) < p_head)), {}

    def ss_nan(n, p_head):
        """NaN values with two payloads on 0.2% of the elements each: a
        NaN propagates to the segment's end, as the canonical NaN."""
        (v, h), kw = ss(n, p_head)
        nan = t(np.array([0x7FC00001, 0xFFA00042], np.uint32).view(np.float32))
        v[t(rng.random(n) < 0.002)] = nan[0]
        v[t(rng.random(n) < 0.002)] = nan[1]
        return (v, h), kw

    seg += [("n=8193 (two tiles)", ss(8193, 0.02)),
            ("n=16384", ss(16384, 0.02)),
            ("n=16385", ss(16385, 0.02)),
            ("n=2^20+3", ss(2**20 + 3, 1e-4)),
            ("n=2^20+3 no heads (look-back to tile 0)", ss(2**20 + 3, 0.0)),
            ("n=16385 all heads", ss(16385, 1.1)),
            ("signed zeros n=8192", ss_zeros(8192, 0.01)),
            ("signed zeros n=300007", ss_zeros(300007, 1e-4)),
            ("NaN values n=8192", ss_nan(8192, 0.01)),
            ("NaN values n=300007", ss_nan(300007, 1e-4)),
            ("unaligned n=8193", unaligned(ss(8194, 0.02), range(2)))]

    def bg_view(nb, width, n):
        """A flash table one element past an aligned address: the byte
        path even where the row width is a multiple of 16 bytes."""
        flat = torch.randn(nb * width + 1, device=dev)
        idx = rng.integers(0, nb, n).astype(np.int32)
        return (flat[1:].view(nb, width), t(idx)), {}

    # Past 2 GiB: 2^25 + 4096 rows of 64 bytes, indices in the last 5000
    # rows and a few past the end (clamped to the last row).
    big = 2**25 + 4096
    gather += [("n=8191 (not a multiple of 32)",
                bg(16384, 16, 8191, torch.float32)),
               ("n=33 width 3 f32 (byte path)", bg(100, 3, 33, torch.float32)),
               ("n=1", bg(64, 16, 1, torch.float32)),
               ("width 4 f32 (one vector a row)",
                bg(512, 4, 1000, torch.float32)),
               ("width 200 f32 (50 vectors a row)",
                bg(1000, 200, 999, torch.float32)),
               ("width 1 f32 (4 bytes a row)", bg(64, 1, 100, torch.float32)),
               ("width 300 bf16 (600-byte rows, byte path)",
                bg(300, 300, 77, torch.bfloat16)),
               ("flash one element past alignment (byte path)",
                bg_view(4096, 16, 2000)),
               ("flash over 2 GiB, indices near its end",
                bg(big, 16, 8192, torch.float32, big - 5000, big + 10))]

    # The baseline's per-request fold: the main path's batch (32 SQs x
    # fetch 64 rows, FUTURE_40M's 512 instances, round-robin instances,
    # cost = sched 12.8 us at every row, 90% valid), fig 13's 1024
    # instances, and one instance's chain of 8192 rows. Their data is
    # drawn after every earlier case's.
    sched = np.float32(12.8)

    def fold(n, k, p_valid, rr=False):
        ready = np.sort(rng.uniform(0, 30000, n)).astype(np.float32)
        cur = rng.uniform(0, 30000, k).astype(np.float32)
        event = rng.random(n) < p_valid
        if rr:
            chip = (7 + np.maximum(np.cumsum(event) - 1, 0)) % k
        else:
            chip = rng.integers(0, k, n)
        return (t(ready), t(np.full(n, sched)), t(chip.astype(np.int32)),
                t(event), t(cur)), {}

    die += [(BASELINE_FOLD, fold(2048, 512, 0.9, rr=True)),
            ("per-request fold K=1024 N=8192", fold(8192, 1024, 0.8)),
            ("per-request fold K=1 chain N=8192", fold(8192, 1, 1.0))]

    return [
        ("seg_scan", seg_scan, ref.seg_scan_ref, seg),
        ("die_contention", die_contention, ref.die_contention_ref, die),
        ("fused_reap", fused_reap, ref.fused_reap_ref, reap),
        ("block_gather", block_gather, ref.block_gather_ref, gather),
        ("block_gather_tiled", block_gather_tiled, ref.block_gather_tiled_ref,
         tiled),
        ("flash_attention", flash_attention, ref.attention_ref, flash),
        ("decode_attention", decode_attention, ref.decode_attention_ref,
         decode),
    ]


EXACT = ("seg_scan", "die_contention", "fused_reap", "block_gather",
         "block_gather_tiled")
# The attention cases at the other architectures' serving shapes, timed
# beside the main case (``arch_shapes`` of the kernels line).
ARCH_SHAPES = ("recurrentgemma-9b local: 16 on 1 heads, D=256, window 2048",
               "musicgen-large: 32 heads, D=64",
               "qwen3-moe-30b-a3b: 32 on 4 heads",
               "qwen2-vl-72b: 64 on 8 heads")
ATTENTION = ("flash_attention", "decode_attention")


def kernel_work(name, args, kw):
    """(bytes, operations, peak operations/s) the function needs on these
    inputs: each input read once, each output written once, and for the
    attention kernels the products over the (row, column) pairs the masks
    keep, at the bf16 tensor-core peak."""
    import torch

    if name == "seg_scan":
        n = args[0].numel()
        return n * (4 + 1 + 4), n, F32_OPS_PER_S
    if name == "die_contention":
        n, k = args[0].numel(), args[4].numel()
        ev = int(args[3].sum())
        return n * (4 + 4 + 4 + 1 + 4) + 2 * 4 * k, 2 * ev, F32_OPS_PER_S
    if name == "fused_reap":
        q, d = args[0].shape
        n = args[4].numel()
        return 2 * q * d * 12 + 2 * 4 * q + n * 13, 0, F32_OPS_PER_S
    if name in ("block_gather", "block_gather_tiled"):
        flash, idx = args
        rows = torch.unique(idx.clamp(0, flash.shape[0] - 1)).numel()
        row_bytes = flash.shape[1] * flash.element_size()
        return (rows * row_bytes + idx.numel() * 4 + idx.numel() * row_bytes,
                0, F32_OPS_PER_S)
    window = kw.get("window")
    if name == "flash_attention":
        q, k, v = args
        b, hq, s_len, d = q.shape
        rows = torch.arange(s_len, device=q.device)[:, None]
        cols = torch.arange(s_len, device=q.device)[None, :]
        keep = cols <= rows if kw.get("causal", True) else cols >= 0
        if window is not None:
            keep = keep & (cols > rows - window)
        pairs = int(keep.sum()) * b * hq
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        return nbytes, 4 * d * pairs, BF16_OPS_PER_S
    q, kc, vc, lengths = args
    b, hq, d = q.shape
    hkv, s_len = kc.shape[1], kc.shape[2]
    lens = lengths.clamp(0, s_len).long()
    lo = (lens - window).clamp(min=0) if window is not None else 0 * lens
    rows = int((lens - lo).sum())
    nbytes = (2 * q.numel() * q.element_size() + lengths.numel() * 4
              + 2 * rows * hkv * d * kc.element_size())
    return nbytes, 4 * d * rows * hq, BF16_OPS_PER_S


def library_fn(name, args):
    """One PyTorch call computing the same function, the yardstick (the
    port never calls it): ``index_select`` for the gathers, SDPA for
    attention (causal with GQA at the prefill shape; at the decode shape
    over the whole cache, no mask past the length); None where there is
    none."""
    import torch
    import torch.nn.functional as F

    if name in ("block_gather", "block_gather_tiled"):
        return lambda: torch.index_select(args[0], 0, args[1])
    if name == "flash_attention":
        q, k, v = args
        return lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True)
    if name == "decode_attention":
        q, kc, vc, _ = args
        q4 = q[:, :, None, :]
        return lambda: F.scaled_dot_product_attention(
            q4, kc, vc, enable_gqa=True)
    return None


# On the card's machine, in most runs of the script, a profiler window
# misses the records of some of the kernels it saw launched: mostly the
# window's first; now and then many or all of them (stream costs of one
# ~0.001-ms kernel keeping 1 of 20; one window in the kernels phase of one
# run, three in a row in the workloads phase of another, keeping none).
# Such an empty window is taken again, up to this many times in all, and
# counted in EMPTY_WINDOWS; where every window of a call is empty, the
# call is timed with CUDA events instead and counted in EVENT_TIMED; the
# records a kept window missed are counted in DROPPED_EVENTS. The next
# record of the card prints all three.
PROFILER_TRIES = 3
EMPTY_WINDOWS = [0]
EVENT_TIMED = [0]
DROPPED_EVENTS = [0]


def device_ms(fn, reps: int = 20):
    """(device ms, device events) of one call of ``fn``: the summed
    duration and the number of the kernels (and copies) it launches, from
    one torch.profiler window over ``reps`` calls after a warmup. Unlike
    ``median_ms`` it leaves out the host's launch path, which sets the wall
    time of a call whose kernels take a few microseconds. Where the window
    holds fewer device records than host calls that put work on the device
    (``bench.HOST_LAUNCH_CALLS``), the events are the host's count and the
    summed duration is scaled by the same ratio (the missed records taken
    at the mean duration of the kept ones). Where the profiler records no
    device event in any of its windows, the ms are the CUDA-event time of
    ``reps`` calls over ``reps``, which counts the device's gaps between
    launches too, and the events are None (not measured)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.bench import HOST_LAUNCH_CALLS

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILER_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = prof.key_averages()
        dev_events = [e for e in rows if e.device_type == DeviceType.CUDA]
        us = sum(getattr(e, "self_device_time_total", 0) for e in dev_events)
        if us > 0:
            events = sum(e.count for e in dev_events)
            host = sum(e.count for e in rows
                       if e.device_type == DeviceType.CPU
                       and e.key.startswith(HOST_LAUNCH_CALLS))
            if host > events:
                DROPPED_EVENTS[0] += host - events
                us, events = us * host / events, host
            return us / reps / 1e3, events / reps
        EMPTY_WINDOWS[0] += 1
    EVENT_TIMED[0] += 1
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    check(ms > 0, "neither the profiler nor CUDA events saw device time")
    return ms, None


def profiled_window(fn, n):
    """``bench.profiled`` of ``fn`` (``n`` rounds or steps), its window
    taken again where the profiler recorded no device event in it."""
    from repro_torch.bench import profiled

    for _ in range(PROFILER_TRIES):
        prof = profiled(fn, n)
        if prof["device_events_per_round"] > 0:
            break
        EMPTY_WINDOWS[0] += 1
    return prof


def ptxas_report(log: str):
    """Registers, static shared memory and spills of every kernel that
    ``nvcc -Xptxas -v`` compiled, from its build log."""
    out, cur = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            cur = {"function": m.group(1)}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            cur["spill_stores"], cur["spill_loads"] = int(m[1]), int(m[2])
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m[1])
            m = re.search(r"(\d+) bytes smem", ln)
            cur["static_smem_bytes"] = int(m[1]) if m else 0
    return out


def phase_kernels(dev, card):
    import torch

    from repro_torch.kernels import build

    out = {}
    detail, arch_shapes = [], []
    for name, kern, plain, cases in kernel_cases(dev):
        for label, (args, kw) in cases:
            before = [a.clone() for a in args] if name == "fused_reap" else []
            got = kern(*args, **kw)
            want = plain(*args, **kw)
            torch.cuda.synchronize()
            check(all(bitwise_equal(a, b) for a, b in zip(before, args)),
                  f"{name} [{label}] wrote to its inputs")
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            if name in EXACT:
                ok = all(bitwise_equal(g, w) for g, w in zip(got, want))
            else:
                ok = all(close_enough(g, w) for g, w in zip(got, want))
            err = max(abs_err(g, w) for g, w in zip(got, want))
            detail.append({"kernel": name, "case": label, "ok": ok,
                           "max_abs_err": err})
            check(ok, f"{name} [{label}] differs from its plain version "
                      f"(max |diff| {err})")
            del got, want
            if label in ARCH_SHAPES:
                arch_shapes.append(shape_timing(name, kern, plain, args, kw,
                                                label))
        main, kw = cases[0][1]
        nbytes, ops, peak = kernel_work(name, main, kw)
        b_ms, b_by = bound(nbytes, ops, peak)
        lib = library_fn(name, main)
        dev_ms, events = device_ms(lambda: kern(*main, **kw))
        # Fewer calls where the device time would fill the launch queue.
        calls = 1000 if dev_ms < 0.1 else 100
        out[name] = {
            "ms": median_ms(lambda: kern(*main, **kw)),
            "device_ms": dev_ms, "device_events_per_call": events,
            "host_us": host_us(lambda: kern(*main, **kw), calls),
            "plain_ms": median_ms(lambda: plain(*main, **kw), reps=10),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": median_ms(lib) if lib else None,
            "library_device_ms": device_ms(lib)[0] if lib else None,
            "library_host_us": host_us(lib, calls) if lib else None,
            "max_abs_err": next(d["max_abs_err"] for d in detail
                                if d["kernel"] == name),
        }
        if name == "die_contention":
            # The one-die case is one chain: its device time over its
            # event rows is the measured time of a step of the chain.
            one_args, _ = dict(cases)["one die"]
            one_ms = device_ms(lambda: kern(*one_args))[0]
            steps = int(one_args[3].sum())
            out[name].update({"one_die_device_ms": one_ms,
                              "one_die_events": steps,
                              "one_die_device_ns_per_event":
                                  one_ms * 1e6 / steps})
            # The baseline's per-request fold (one row an instance's
            # chain step, K = 512).
            fold_args, _ = dict(cases)[BASELINE_FOLD]
            fold_ms, fold_events = device_ms(lambda: kern(*fold_args))
            out[name]["baseline_fold"] = {
                "ms": median_ms(lambda: kern(*fold_args)),
                "device_ms": fold_ms, "device_events_per_call": fold_events,
                "plain_ms": median_ms(lambda: plain(*fold_args), reps=10),
                **dict(zip(("bound_ms", "bound_by"), bound(
                    *kernel_work(name, fold_args, {})))),
            }
        del cases, main, lib
        torch.cuda.empty_cache()
    attention = {
        name: {"bound_share": out[name]["bound_ms"] / out[name]["ms"],
               "bound_share_device":
                   out[name]["bound_ms"] / out[name]["device_ms"],
               "ptxas": ptxas_report(build.BUILD_LOG.get(name, ""))}
        for name in ATTENTION
    }
    emit({"phase": "kernels", "card": card,
          "tolerance": {"gather and engine kernels": "bit-identical",
                        "attention f32": "|diff| <= 1e-4",
                        "attention bf16": "|diff| <= 2^-7 |plain| + 1e-5"},
          "cases": detail, "timing": out, "attention": attention,
          "arch_shapes": arch_shapes})
    return out


def shape_timing(name, kern, plain, args, kw, label):
    """An attention kernel's card ms, device ms and events a call, its
    plain version's ms, bound and (without a window) SDPA's ms at one
    case's inputs."""
    b_ms, b_by = bound(*kernel_work(name, args, kw))
    lib = library_fn(name, args) if kw.get("window") is None else None
    dev_ms, events = device_ms(lambda: kern(*args, **kw))
    return {"kernel": name, "case": label,
            "ms": median_ms(lambda: kern(*args, **kw)),
            "device_ms": dev_ms, "device_events_per_call": events,
            "plain_ms": median_ms(lambda: plain(*args, **kw), reps=10),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": median_ms(lib) if lib else None}


def phase_launch_floor(card):
    """The empty kernel of ``csrc/launch_floor.cu``, launched through the
    wrappers' own path (``build.bind``, ``build.launch_args``) and timed
    as the kernels are: the device's and the host's floor for one
    launch."""
    import ctypes

    from repro_torch.kernels import build

    fn = build.bind("launch_floor", [ctypes.c_int, ctypes.c_void_p])

    def launch():
        build.check("launch_floor", fn(*build.launch_args(0)))

    dev_ms, events = device_ms(launch)
    floor = {"device_ms": dev_ms, "device_events_per_call": events,
             "ms": median_ms(launch), "host_us": host_us(launch)}
    emit({"launch_floor": floor, "card": card})


# -- phases: the main path ----------------------------------------------------

# The virtual numbers of both paths: the reference's compiled run (the JAX
# package on a CPU: swarmio_cfg() on FUTURE_40M, 24 rounds at io_depth
# 256), which the port gives since its timing core fuses the reference's
# three multiply-adds (35.566916 MIOPS before); the graphed and the eager
# runner must reproduce them to the last digit.
VIRTUAL = {
    "read": {"virtual_miops": 35.566912, "p50_us": 201.6914520263672,
             "p99_us": 241.4418182373047},
    "mixed": {"virtual_miops": 0.5143973125},
    # The port run on the CPU (nvmevirt_1drive with the kernel flags, 24
    # rounds at io_depth 256); the phase runs it again beside the card.
    "baseline": {"virtual_iops": 75251.7109375, "completed": 2049.0,
                 "avg_target_us": 37.39775466918945,
                 "avg_proc_us": 2969.91796875,
                 "avg_e2e_us": 24248.681640625,
                 "p50_us": 25945.52734375, "p95_us": 25945.52734375,
                 "p99_us": 25945.52734375},
}
# The reference's run of nvmevirt_cfg() on FUTURE_40M (JAX on a CPU,
# default flags, io_depth 256, 24 rounds), where the kernel flags route as
# the reference does: the flags move the baseline datapath's queueing
# scans onto seg_scan, which re-associates their fractional sums, so
# avg_proc_us and avg_e2e_us are the port's own.
BASELINE_REFERENCE = {"virtual_iops": 75251.7109375, "completed": 2049.0,
                      "avg_target_us": 37.39775466918945,
                      "p50_us": 25945.52734375, "p99_us": 25945.52734375}
# Fig 11's drive: nvmevirt_cfg() on D7_PS1010 at io_depth 512, 32 rounds,
# default flags, as the port gives it on the CPU (and the reference, but
# avg_proc_us 2969.9189453125 and avg_e2e_us 24248.822265625 by its sums'
# order).
FIG11 = {"virtual_iops": 75251.7109375, "completed": 2049.0,
         "avg_target_us": 428.0857849121094, "avg_proc_us": 2969.919189453125,
         "avg_e2e_us": 24248.8203125, "p50_us": 25945.52734375,
         "p95_us": 25945.52734375, "p99_us": 25945.52734375}


def virtual_numbers(m):
    """A run's virtual-time figures (deterministic: the emulated drive's,
    not a speed of any chip)."""
    return {"virtual_miops": float(m.iops()) / 1e6,
            "virtual_iops": float(m.iops()), "completed": float(m.completed),
            "avg_target_us": float(m.avg_target_us()),
            "avg_proc_us": float(m.avg_proc_us()),
            "avg_e2e_us": float(m.avg_e2e_us()),
            "p50_us": float(m.p50_us()), "p95_us": float(m.p95_us()),
            "p99_us": float(m.p99_us())}


def differing(got, want):
    return {k: (got[k], v) for k, v in want.items() if got[k] != v}


def graph_proof(step):
    """The host's CUDA calls in a torch.profiler window over one call of
    ``step`` (one graphed round or decode step): exactly one
    ``cudaGraphLaunch`` and no kernel launch, copy or memset."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.bench import HOST_LAUNCH_CALLS

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    calls = {}
    for e in prof.events():
        if (e.device_type != torch.autograd.DeviceType.CUDA
                and e.name.startswith("cu")):
            calls[e.name] = calls.get(e.name, 0) + 1
    launches = {k: v for k, v in calls.items()
                if k.startswith(HOST_LAUNCH_CALLS) and k != "cudaGraphLaunch"}
    check(calls.get("cudaGraphLaunch") == 1 and not launches,
          f"a graphed step made these host calls: {calls}")
    return calls


def timed_runs(fn, reps):
    """Wall seconds of ``reps`` calls of ``fn``, each between two device
    synchronisations; the last call's result."""
    import torch

    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return out, walls


def profile_summary(wall_ms, prof):
    """One profiled run's figures a round (or step) beside the timed wall
    ms: the profiler's own window (its wall ms, device ms and events, the
    device's idle share in it, the host's launch calls) and the device ms
    over the timed wall ms (the profiler slows the host, not the
    device)."""
    return {"profiled": {k: prof[k] for k in (
                "wall_ms_per_round", "device_ms_per_round",
                "device_events_per_round", "device_idle_share",
                "host_calls_per_round")},
            "device_ms_over_timed_wall": prof["device_ms_per_round"] / wall_ms}


def speed(walls, completed, dev_prof):
    """Per-round figures of one runner: the median timed run's wall ms a
    round and emulated requests a wall-second, ``profile_summary`` and
    the profiled device ms a round of each engine kernel."""
    wall_ms = statistics.median(walls) * 1e3 / ROUNDS
    return {"wall_ms_per_round": wall_ms,
            "emulated_requests_per_wall_s":
                completed / statistics.median(walls),
            "wall_s_runs": walls, **profile_summary(wall_ms, dev_prof),
            "engine_kernel_device_ms_per_round":
                dev_prof["engine_kernel_device_ms_per_round"]}


def graph_vs_eager(cfg, ssd, wl, plat, dev, reps=3):
    """ROUNDS rounds from one initial state through the eager ``run`` and
    through the graphed ``make_runner``, each warmed up once and then
    timed ``reps`` times and profiled once; the final states must be
    bit-identical on every leaf. Launch counts cover exactly the timed
    runs of both; every engine kernel that the capture recorded must show
    device time in the profiled graphed run. Also a ``donate=True`` chain of two calls against one
    eager run of 2 * ROUNDS rounds, and the profiler's proof that a
    graphed round is one graph launch. Returns the graphed final state
    and the record."""
    from repro_torch import convert
    from repro_torch.core import engine
    from repro_torch.kernels import ops

    state = engine.init_state(cfg, ssd, wl, device=dev)
    init = convert.engine_state_to_numpy(state)
    runner = engine.make_runner(cfg, ssd, wl, plat, ROUNDS, device=dev)

    def eager():
        return engine.run(state, cfg, ssd, wl, plat, ROUNDS)

    eager()
    runner(state)  # the eager warm round and the capture
    ops.reset_launches()
    e_out, e_walls = timed_runs(eager, reps)
    launches_eager = dict(ops.LAUNCHES)
    ops.reset_launches()
    g_out, g_walls = timed_runs(lambda: runner(state), reps)
    launches_graph = dict(ops.LAUNCHES)
    e_np = convert.engine_state_to_numpy(e_out)
    g_np = convert.engine_state_to_numpy(g_out)
    diff = convert.leaf_differences(e_np, g_np)
    check(not diff, f"graphed and eager states differ in {diff}")
    check(not convert.leaf_differences(
        init, convert.engine_state_to_numpy(state)),
        "make_runner(donate=False) changed its input state")
    e_prof, g_prof = profiled_window(eager, ROUNDS), profiled_window(
        lambda: runner(state), ROUNDS)
    ran = g_prof["engine_kernel_device_ms_per_round"]
    idle = [k for k in ran if runner.graph.launches[k] and not ran[k] > 0]
    check(not idle, f"{idle} are in the graph but took no device time in "
                    f"a graphed run: {ran}")

    donating = engine.make_runner(cfg, ssd, wl, plat, ROUNDS, donate=True,
                                  device=dev)
    chained = donating(donating(engine.unalias(state)))
    twice = engine.run(state, cfg, ssd, wl, plat, 2 * ROUNDS)
    chain_diff = convert.leaf_differences(
        convert.engine_state_to_numpy(twice),
        convert.engine_state_to_numpy(chained))
    check(not chain_diff, f"two donated calls differ from one run of "
                          f"{2 * ROUNDS} rounds in {chain_diff}")

    one = engine.make_runner(cfg, ssd, wl, plat, 1, donate=True, device=dev)
    kept = one(engine.unalias(state))
    calls = graph_proof(lambda: one(kept))
    completed = float(g_out.metrics.completed)
    rec = {
        "eager": speed(e_walls, completed, e_prof),
        "graph": speed(g_walls, completed, g_prof),
        "graph_vs_eager_differing_leaves": diff,
        "donate_chain_vs_run_differing_leaves": chain_diff,
        "graphed_round_host_calls": calls,
        "launches_per_graph": runner.graph.launches,
        "launches_eager": launches_eager, "launches_graph": launches_graph,
        "launches": {k: launches_eager[k] + launches_graph[k]
                     for k in launches_eager},
        "rounds_per_run": ROUNDS, "timed_runs": reps,
    }
    return g_out, rec


def drive(cfg, ssd, wl, dev, path):
    """The main path through both runners (``graph_vs_eager``), with the
    virtual numbers that must equal the recorded ones (``VIRTUAL``)."""
    from repro_torch.core.types import PlatformModel

    out, rec = graph_vs_eager(cfg, ssd, wl, PlatformModel(), dev)
    virtual = virtual_numbers(out.metrics)
    bad = differing(virtual, VIRTUAL[path])
    check(not bad, f"virtual numbers (got, recorded) differ: {bad}")
    return out, {**virtual, "completed_per_run": virtual["completed"], **rec}


def check_outputs(state, cfg):
    import torch

    m = state.metrics
    check(float(m.completed) > 0, "no request completed")
    for name, v in (("clock", state.clock), ("sum_e2e", m.sum_e2e),
                    ("last_completion", m.last_completion),
                    ("busy_until", state.device.tstate.busy_until)):
        check(bool(torch.isfinite(v).all()), f"{name} is not finite")
    check(state.rings.submit_time.shape == (cfg.num_sqs, cfg.sq_depth),
          "ring shape changed")
    check(float(m.p50_us()) <= float(m.p99_us()), "p50 above p99")


def phase_main_read(dev, card):
    from repro_torch.bench import local_1drive
    from repro_torch.core.types import WorkloadConfig

    cfg, ssd = local_1drive(
        emulate_data=True, use_pallas=True, use_pallas_segscan=True,
        use_pallas_reap=True,
    )
    state, rec = drive(cfg, ssd, WorkloadConfig(io_depth=256), dev, "read")
    check_outputs(state, cfg)
    for k in ("seg_scan", "fused_reap", "block_gather"):
        check(rec["launches"][k] > 0, f"{k} did not launch on the main path")
        check(rec["launches_graph"][k] > 0, f"{k} is not in the graph")
    emit({"phase": "main_path_read", "card": card, **rec})
    return rec


def phase_main_mixed(dev, card):
    from repro_torch.bench import local_1drive
    from repro_torch.workloads import MixedReadWrite

    cfg, ssd = local_1drive(emulate_data=True, **KERNEL_FLAGS)
    wl = MixedReadWrite(read_frac=0.7, io_depth=256)
    state, rec = drive(cfg, ssd, wl, dev, "mixed")
    check_outputs(state, cfg)
    check(rec["launches"]["die_contention"] > 0,
          "die_contention did not launch on the main path")
    check(rec["launches_graph"]["die_contention"] > 0,
          "die_contention is not in the graph")
    check(float(state.device.flash.valid_pages) > 0, "no write was priced")
    emit({"phase": "main_path_mixed", "card": card, **rec})
    return rec


def phase_main_baseline(dev, card, read_rec):
    """The NVMeVirt baseline through both runners (``drive``), its virtual
    numbers against the port run on the CPU and the reference's; the
    ratio of main_path_read's graphed requests a wall-second to the
    baseline's (written down, not claimed); then fig 11's drive, graphed,
    against the CPU's numbers."""
    from repro_torch.bench import D7_PS1010, nvmevirt_1drive
    from repro_torch.core import engine
    from repro_torch.core.types import PlatformModel, WorkloadConfig

    cfg, ssd = nvmevirt_1drive(**KERNEL_FLAGS)
    wl = WorkloadConfig(io_depth=256)
    state, rec = drive(cfg, ssd, wl, dev, "baseline")
    check_outputs(state, cfg)
    for k in ("die_contention", "seg_scan", "fused_reap"):
        check(rec["launches"][k] > 0, f"{k} did not launch on the baseline")
        check(rec["launches_graph"][k] > 0, f"{k} is not in the graph")
    cpu = virtual_numbers(engine.simulate(
        cfg, ssd, wl, PlatformModel(), rounds=ROUNDS, device="cpu").metrics)
    bad = differing(rec, cpu)
    check(not bad, f"card and CPU baselines differ (card, CPU): {bad}")
    bad = differing(rec, BASELINE_REFERENCE)
    check(not bad, f"baseline off the reference (card, reference): {bad}")
    read_rate = read_rec["graph"]["emulated_requests_per_wall_s"]
    base_rate = rec["graph"]["emulated_requests_per_wall_s"]
    emit({"phase": "main_path_baseline", "card": card, **rec,
          "cpu_port_virtual": cpu, "reference_virtual": BASELINE_REFERENCE,
          "graphed_requests_per_wall_s_read_over_baseline":
              read_rate / base_rate})

    cfg11, _ = nvmevirt_1drive()
    wl11 = WorkloadConfig(io_depth=512)
    t0 = time.perf_counter()
    fig11 = virtual_numbers(engine.simulate(
        cfg11, D7_PS1010, wl11, PlatformModel(), rounds=32,
        device=dev).metrics)
    wall = time.perf_counter() - t0
    bad = differing(fig11, FIG11)
    emit({"fig11": {"ssd": "D7_PS1010", "io_depth": 512, "rounds": 32,
                    **fig11, "wall_s_with_capture": wall},
          "card": card})
    check(not bad, f"fig 11's run (card, CPU) differs: {bad}")
    return rec


def exact_setup():
    """An integer-timestamp drive at local_1drive's full width: sched_us =
    512/51.2e6 s = 10 us, the integer-cost platform that
    ``integer_timestamps`` accepts, the baseline datapath (so seg_scan
    also runs in the map/lane scans), and a 2^20-block drive whose free
    pool stays above the GC watermark for the whole run."""
    from repro_torch.bench import local_1drive
    from repro_torch.core.types import PlatformModel, integer_timestamps

    cfg, ssd = local_1drive(batched_datapath=False, emulate_data=True)
    ssd = ssd.replace(t_max_iops=51.2e6, num_blocks=1 << 20)
    plat = PlatformModel(
        cpu_sqe_fetch_us=10.0, cpu_coal_byte_us=0.0, cpu_coal_base_us=1.0,
        dsa_sqe_fetch_us=4.0, dsa_coal_base_us=18.0,
        dsa_desc_issue_us=1.0, dsa_batch_setup_us=1.0,
        dsa_bytes_per_us=64.0, doorbell_poll_us=1.0,
        host_txn_base_us=1.0, host_bytes_per_us=64.0,
        txn_base_us=1.0, link_bytes_per_us=64.0,
        per_req_map_us=3.0, lock_per_req_us=1.0, lock_per_batch_us=1.0,
    )
    check(integer_timestamps(cfg, ssd, plat), "exact-phase config is not "
          "integer-timestamped")
    return cfg, ssd, plat


def run_states(cfg, ssd, plat, wl, dev, rounds):
    from repro_torch import convert
    from repro_torch.core import engine

    st = engine.init_state(cfg, ssd, wl, device=dev)
    st = engine.make_runner(cfg, ssd, wl, plat, rounds, device=dev)(st)
    return convert.engine_state_to_numpy(st)


def phase_exact(dev, card):
    """Kernels off and on, each through the graphed and the eager runner:
    four bit-identical final states."""
    from repro_torch.convert import engine_state_to_numpy, leaf_differences
    from repro_torch.workloads import MixedReadWrite

    cfg, ssd, plat = exact_setup()
    wl = MixedReadWrite(read_frac=0.7, io_depth=256)
    off, rec_off = graph_vs_eager(cfg, ssd, wl, plat, dev, reps=1)
    on, rec_on = graph_vs_eager(cfg.replace(**KERNEL_FLAGS), ssd, wl,
                                   plat, dev, reps=1)
    off = engine_state_to_numpy(off)
    diff = leaf_differences(off, engine_state_to_numpy(on))
    emit({"phase": "exact", "card": card, "rounds": ROUNDS,
          "leaves": len(off), "differing_leaves": diff,
          "completed": float(off["metrics.completed"]),
          "kernels_off": rec_off, "kernels_on": rec_on})
    check(not diff, f"kernels on/off states differ in {diff}")


SUM_LEAVES = ("metrics.sum_e2e", "metrics.sum_target", "metrics.sum_proc",
              "metrics.tenant_sum_e2e")


def phase_cpu_vs_card(dev, card, rounds=8):
    """Card against CPU, both the port: stock local_1drive (kernels off),
    then the new streams (``stream_differences``), an 8-round Zipf run
    under ``lba_hash`` and an 8-round Poisson run at fig 18's size, and
    the vector search (``search_card_vs_cpu``)."""
    from repro_torch import workloads as tw
    from repro_torch.bench import D7_PS1010, local_1drive
    from repro_torch.convert import leaf_differences, ulp_distance
    from repro_torch.core.types import PlatformModel, WorkloadConfig

    cfg, ssd = local_1drive()
    bounds = dict.fromkeys(SUM_LEAVES, SUM_LEAF_ULP)
    runs = {
        "local_1drive": (ssd, WorkloadConfig(io_depth=256)),
        "zipf_0.9_lba_hash": (D7_PS1010.replace(routing="lba_hash"),
                              tw.ZipfClosedLoop(io_depth=1024, theta=0.9)),
        "poisson_open": (D7_PS1010, tw.PoissonOpenLoop(
            io_depth=1024, rate_iops=D7_PS1010.t_max_iops * 0.8)),
    }
    bad, worst = {}, {}
    for name, (ssd_r, wl) in runs.items():
        gpu = run_states(cfg, ssd_r, PlatformModel(), wl, dev, rounds)
        cpu = run_states(cfg, ssd_r, PlatformModel(), wl, "cpu", rounds)
        bad[name] = leaf_differences(cpu, gpu, bounds)
        worst[name] = {k: ulp_distance(cpu[k], gpu[k]) for k in cpu
                       if cpu[k].dtype.kind == "f"
                       and ulp_distance(cpu[k], gpu[k])}
    streams = stream_differences(dev)
    search = search_card_vs_cpu(dev)
    emit({"phase": "cpu_vs_card", "card": card, "rounds": rounds,
          "ulp_bound": {"metric sums": SUM_LEAF_ULP, "other floats": 0},
          "max_ulp": worst, "violations": bad,
          "stream_ids": 1 << 20, "stream_differing": streams,
          "search_differing": search})
    check(not any(bad.values()), f"card and CPU states differ: {bad}")
    check(not any(streams.values()), f"card and CPU streams differ: "
                                     f"{streams}")
    check(not any(search.values()), f"card and CPU searches differ: "
                                    f"{search}")


# -- phases: the vector-search case study and the workload generators --------

VS_N = 4096                  # fig 16's index (benchmarks/figures.py:268)
VS_BATCHES = (4, 16, 64, 256)
VS_IOPS = (2.5e6, 40e6)
SEARCH_LEAVES = ("indices", "distances")
SEARCH_NUMBERS = ("virtual_us", "qps", "avg_iter_us", "writeback_us")


def search_differences(a, b):
    """Keys on which two search results differ (tensors bit for bit)."""
    out = [k for k in SEARCH_LEAVES
           if not bitwise_equal(a[k].cpu(), b[k].cpu())]
    return out + [k for k in SEARCH_NUMBERS if a[k] != b[k]]


def search_numbers(out):
    return {k: out[k] for k in SEARCH_NUMBERS + ("recall", "gpu_iter_us",
                                                   "reads_per_iter")
            if k in out}


def phase_vector_search(dev, card):
    """Fig 16 at its own size (n = 4096, width 4, batches 4-256, 2.5e6 and
    40e6 IOPS), each cell through one ``vector_search.make_search``
    object, graphed (its one captured iteration replayed 24 times a
    search, the first search capturing it): qps, recall, virtual us, wall
    and device ms an iteration, and the 40e6-over-2.5e6 QPS ratio per
    batch. Then at batch 256, 40e6: the eager run bit-identical to the
    graphed one; write-back once; and, with the counts reset just before
    and read just after, the search with ``READ_FLAGS`` and the
    write-back with every kernel flag on, each bit-identical to its run
    with the flags off (seg_scan, fused_reap and die_contention must
    launch)."""
    import torch

    from repro_torch.apps import vector_search as vs
    from repro_torch.kernels import ops

    cfg = vs.SearchConfig(beam_width=4)
    t0 = time.perf_counter()
    vecs, graph = vs.build_index(0, VS_N, cfg, dev)
    torch.cuda.synchronize()
    index_s = time.perf_counter() - t0
    cells, outs = [], {}
    for iops in VS_IOPS:
        ssd, ecfg = vs.case_configs(VS_N, iops)
        for b in VS_BATCHES:
            q = vs.case_queries(b, cfg.dim, 0, dev)
            truth = vs.ground_truth(vecs, q, cfg.top_k)
            searcher = vs.make_search(cfg, ssd, ecfg=ecfg)

            def run():
                return searcher(q, vecs, graph)

            t0 = time.perf_counter()
            first = run()
            first_s = time.perf_counter() - t0
            out, walls = timed_runs(run, 3)
            check(not search_differences(first, out),
                  f"two graphed searches differ at batch {b}, {iops:g}")
            prof = profiled_window(run, cfg.iterations)
            out["recall"] = vs.recall_at_k(out["indices"], truth)
            check(bool(torch.isfinite(out["distances"]).all())
                  and out["distances"].shape == (b, cfg.top_k)
                  and 0.0 <= out["recall"] <= 1.0 and out["qps"] > 0,
                  f"search output off at batch {b}, {iops:g}: "
                  f"{search_numbers(out)}")
            outs[(b, iops)] = out
            wall_ms = statistics.median(walls) * 1e3 / cfg.iterations
            cells.append({
                "batch": b, "t_max_iops": iops, **search_numbers(out),
                "wall_ms_per_iteration": wall_ms,
                "first_call_s_with_capture": first_s,
                **profile_summary(wall_ms, prof), "wall_s_runs": walls})
    ratios = {b: outs[(b, 40e6)]["qps"] / outs[(b, 2.5e6)]["qps"]
              for b in VS_BATCHES}

    b, iops = 256, 40e6
    ssd, ecfg = vs.case_configs(VS_N, iops)
    q = vs.case_queries(b, cfg.dim, 0, dev)
    eager = vs.search(q, vecs, graph, cfg, ssd, ecfg=ecfg, graphed=False)
    eager_diff = search_differences(outs[(b, iops)], eager)
    wb = vs.search(q, vecs, graph, cfg, ssd, ecfg=ecfg, write_back=True)
    check(wb["writeback_us"] > 0, "write-back priced no time")
    ops.reset_launches()
    read_on = vs.search(q, vecs, graph, cfg, ssd,
                        ecfg=ecfg.replace(**READ_FLAGS))
    wb_on = vs.search(q, vecs, graph, cfg, ssd,
                      ecfg=ecfg.replace(**KERNEL_FLAGS), write_back=True)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    flags_diff = (search_differences(outs[(b, iops)], read_on)
                  + search_differences(wb, wb_on))
    emit({"phase": "vector_search", "card": card, "n": VS_N,
          "width": cfg.beam_width, "iterations": cfg.iterations,
          "index_build_s": index_s, "cells": cells,
          "qps_ratio_40e6_over_2_5e6": ratios,
          "eager_vs_graph_differing": eager_diff,
          "write_back": search_numbers(wb),
          "flags_on_vs_off_differing": flags_diff,
          "launches": launches})
    check(not eager_diff, f"eager and graphed searches differ: {eager_diff}")
    check(not flags_diff, f"kernel flags change the search: {flags_diff}")
    for k in ("seg_scan", "fused_reap", "die_contention"):
        check(launches[k] > 0, f"{k} did not launch in the search")
    return launches


def workload_cells():
    """(name, EngineConfig, SSDConfig, workload, rounds) of figs 18-20 at
    their full size (``benchmarks/figures.py:323-446``) and a two-tenant
    loop on local_1drive."""
    import numpy as np

    from repro_torch import workloads as tw
    from repro_torch.bench import D7_PS1010, local_1drive

    cfg, future = local_1drive()
    ssd = D7_PS1010
    depth, n_trace = 1024, 16384
    trace_t = np.cumsum(np.full(n_trace, 1e6 / (ssd.t_max_iops * 0.5))
                        ).astype(np.float32)
    trace = tw.TraceReplay.from_trace(
        trace_t, np.arange(n_trace) % ssd.num_blocks, np.zeros(n_trace), cfg)
    cells = [
        ("fig18/closed_loop", cfg, ssd, tw.ClosedLoop(io_depth=depth), 64),
        ("fig18/poisson_open", cfg, ssd, tw.PoissonOpenLoop(
            io_depth=depth, rate_iops=ssd.t_max_iops * 0.8), 64),
        ("fig18/zipf_0.9_lba_hash", cfg, ssd.replace(routing="lba_hash"),
         tw.ZipfClosedLoop(io_depth=depth, theta=0.9), 64),
        ("fig18/trace_replay", cfg, ssd, trace, 64),
    ]
    cfg50 = cfg.replace(poll_quantum_us=50.0)
    ssd19 = ssd.replace(num_blocks=1 << 14, num_channels=16,
                        chips_per_channel=8)
    for rf in (1.0, 0.9, 0.7, 0.5):
        cells.append((f"fig19/read_frac_{rf}", cfg50, ssd19,
                      tw.SteadyStateMixed(io_depth=64, read_frac=rf,
                                          theta=0.9), 192))
    ssd20 = ssd19.replace(num_blocks=1 << 15)
    cells.append(("fig20/fresh", cfg50, ssd20,
                  tw.MixedReadWrite(io_depth=64, read_frac=0.7, theta=0.9),
                  192))
    cells.append(("fig20/steady_state", cfg50, ssd20,
                  tw.SteadyStateMixed(io_depth=64, read_frac=0.7, theta=0.9),
                  192))
    cells.append(("multi_tenant_local_1drive", cfg, future,
                  tw.MultiTenant(io_depth=256, tenant_read_frac=(1.0, 0.0)),
                  ROUNDS))
    return cells


# The reference's figs 18-20 (``benchmarks/figures.py``, the JAX package
# on a CPU) at the same settings: virtual numbers of the emulated drive,
# deterministic, not speeds of any chip.
WORKLOAD_REFERENCE = {
    "fig18/closed_loop": dict(virtual_miops=2.4616845, p50_us=7365.25,
                              p99_us=12634.62890625),
    "fig18/poisson_open": dict(virtual_miops=1.727810625,
                               p50_us=98.2171859741211,
                               p99_us=117.57432556152344),
    "fig18/zipf_0.9_lba_hash": dict(virtual_miops=0.0972523671875,
                                    p50_us=8816.8310546875,
                                    p99_us=91398.171875),
    "fig18/trace_replay": dict(virtual_miops=1.125160875,
                               p50_us=68.53895568847656,
                               p99_us=82.04695892333984),
    "fig19/read_frac_1.0": dict(virtual_miops=2.449457,
                                p50_us=850.5258178710938,
                                p99_us=850.5258178710938, gc_count=0.0),
    "fig19/read_frac_0.9": dict(virtual_miops=0.7589703125,
                                p50_us=850.5258178710938,
                                p99_us=6152.654296875, gc_count=116.0),
    "fig19/read_frac_0.7": dict(virtual_miops=0.158587390625,
                                p50_us=12634.62890625,
                                p99_us=21673.921875, gc_count=389.0),
    "fig19/read_frac_0.5": dict(virtual_miops=0.083335265625,
                                p50_us=25945.52734375,
                                p99_us=37180.265625, gc_count=646.0),
    "fig20/fresh": dict(virtual_miops=2.068527, p50_us=1018.1517333984375,
                        p99_us=1218.814208984375, gc_count=0.0),
    "fig20/steady_state": dict(virtual_miops=0.19661240625,
                               p50_us=3586.6376953125,
                               p99_us=18105.58203125, gc_count=438.0),
}


def workload_numbers(state):
    m = state.metrics
    return {"virtual_miops": float(m.iops()) / 1e6,
            "completed": float(m.completed),
            "avg_e2e_us": float(m.avg_e2e_us()),
            "p50_us": float(m.p50_us()), "p95_us": float(m.p95_us()),
            "p99_us": float(m.p99_us()),
            "gc_count": float(state.device.flash.gc_count),
            "free_pages": float(state.device.flash.free_pages),
            "tenant_completed": state.metrics.tenant_completed.tolist()}


def phase_workloads(dev, card):
    """Every cell of ``workload_cells`` graphed through ``make_runner`` on
    the card with the reference's flags (all off): virtual numbers, wall
    ms a round, device ms a round over the first ``PROFILE_ROUNDS``
    rounds (``profiled_rounds``), and the final state against the port
    run eagerly on the CPU (integer leaves equal, float leaves bit-exact
    but the metric sums, within SUM_LEAF_ULP), and figs 18-20's virtual
    numbers against the reference's (``WORKLOAD_REFERENCE``, to the last
    digit). Then the same graphed with
    the kernel flags on (counts reset just before, read just after):
    ``READ_FLAGS`` where no write reaches the drive (seg_scan and
    fused_reap must launch), every flag where writes do (die_contention
    and fused_reap must launch); bit-identical to the flags off. Last, the
    Zipf power's and the Poisson log's own device cost (``stream_costs``)."""
    import torch

    from repro_torch import convert
    from repro_torch.core import engine
    from repro_torch.core.types import PlatformModel
    from repro_torch.kernels import ops

    plat = PlatformModel()
    bounds = dict.fromkeys(SUM_LEAVES, SUM_LEAF_ULP)
    recs, launches = [], dict.fromkeys(ops.LAUNCHES, 0)
    cells = workload_cells()
    cpu_runs = [cpu_state(cfg, ssd, wl, rounds, plat=plat)
                for _, cfg, ssd, wl, rounds in cells]
    for (name, cfg, ssd, wl, rounds), cpu in zip(cells, cpu_runs):
        state = engine.init_state(cfg, ssd, wl, device=dev)
        runner = engine.make_runner(cfg, ssd, wl, plat, rounds, device=dev)
        t0 = time.perf_counter()
        out = runner(state)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        _, walls = timed_runs(lambda: runner(state), 3)
        prof = profiled_rounds(cfg, ssd, wl, plat, state, runner, rounds,
                               dev)
        card_np = convert.engine_state_to_numpy(out)
        vs_cpu = convert.leaf_differences(cpu.result(), card_np, bounds)
        writes = (getattr(wl, "read_frac", 1.0) < 1.0
                  or hasattr(wl, "tenant_read_frac"))
        cfg_on = cfg.replace(**(KERNEL_FLAGS if writes else READ_FLAGS))
        ops.reset_launches()
        on = engine.make_runner(cfg_on, ssd, wl, plat, rounds, device=dev)(
            engine.init_state(cfg_on, ssd, wl, device=dev))
        torch.cuda.synchronize()
        counted = dict(ops.LAUNCHES)
        for k, v in counted.items():
            launches[k] += v
        vs_flags = convert.leaf_differences(
            card_np, convert.engine_state_to_numpy(on))
        numbers = workload_numbers(out)
        off_ref = differing(numbers, WORKLOAD_REFERENCE.get(name, {}))
        wall_ms = statistics.median(walls) * 1e3 / rounds
        rec = {"cell": name, "rounds": rounds, "io_depth": wl.io_depth,
               **numbers, "wall_ms_per_round": wall_ms,
               "profiled_rounds": min(rounds, PROFILE_ROUNDS),
               "first_call_s_with_capture": first_s,
               **profile_summary(wall_ms, prof),
               "card_vs_cpu_violations": vs_cpu,
               "card_vs_reference_differing": off_ref,
               "flags_on": "all" if writes else "READ_FLAGS",
               "flags_on_vs_off_differing": vs_flags,
               "launches_flags_on": counted}
        recs.append(rec)
        check(numbers["completed"] > 0, f"{name}: nothing completed")
        check(not vs_cpu, f"{name}: card and CPU differ: {vs_cpu}")
        check(not off_ref, f"{name}: virtual numbers (card, reference) "
                           f"differ: {off_ref}")
        check(not vs_flags, f"{name}: kernel flags change the run: "
                            f"{vs_flags}")
        for k in ("fused_reap",
                  "die_contention" if writes else "seg_scan"):
            check(counted[k] > 0, f"{name}: {k} did not launch")
    emit({"phase": "workloads", "card": card, "cells": recs,
          "stream_cost_per_round": stream_costs(dev),
          "launches": launches})
    return launches


def stream_costs(dev):
    """Device ms and events of the Zipf power and the Poisson log alone,
    at the shape one engine round gives them (``local_1drive``'s 32 SQs x
    256 fetch slots = 8192 ids, figs 18-20): ``xla_math.pow_f32`` (theta
    0.9) and ``log_f32`` on uniform float32, the whole ``address`` and
    ``gap_us`` calls, and torch.pow / torch.log on the same inputs (one
    library kernel each, not rounded as XLA rounds)."""
    import torch

    from repro_torch import workloads as tw
    from repro_torch.bench import D7_PS1010, local_1drive
    from repro_torch.core.xla_math import log_f32, pow_f32

    cfg, _ = local_1drive()
    n = cfg.num_sqs * cfg.fetch_width
    u = torch.rand(n, generator=torch.Generator().manual_seed(0)).to(dev)
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    zipf = tw.ZipfClosedLoop(theta=0.9)
    pois = tw.PoissonOpenLoop(rate_iops=D7_PS1010.t_max_iops * 0.8)
    alpha = 1.0 / (1.0 - zipf.theta)
    out = {"ids": n}
    for name, fn in (
            ("pow_f32", lambda: pow_f32(u, alpha)),
            ("torch_pow", lambda: torch.pow(u, alpha)),
            ("zipf_address", lambda: zipf.address(ids, D7_PS1010, 0)),
            ("log_f32", lambda: log_f32(u)),
            ("torch_log", lambda: torch.log(u)),
            ("poisson_gap_us", lambda: pois.gap_us(ids, cfg, 0))):
        ms, events = device_ms(fn)
        out[name] = {"device_ms": ms, "device_events": events}
    return out


def stream_differences(dev):
    """Zipf addresses (theta 0.9, 2^14 and 2^20 blocks, salts 0 and 5) and
    Poisson gaps (fig 18's rate on 32 SQs) of request ids 0..2^20-1, card
    against CPU, counted per stream."""
    import torch

    from repro_torch import workloads as tw
    from repro_torch.bench import D7_PS1010, local_1drive

    cfg, _ = local_1drive()
    out = {}
    for dv in (dev, "cpu"):
        ids = torch.arange(1 << 20, dtype=torch.int32, device=dv)
        zipf = tw.ZipfClosedLoop(theta=0.9)
        pois = tw.PoissonOpenLoop(rate_iops=D7_PS1010.t_max_iops * 0.8)
        for blocks in (1 << 14, 1 << 20):
            for salt in (0, 5):
                out.setdefault(f"zipf_{blocks}_{salt}", []).append(
                    zipf.address(ids, D7_PS1010.replace(num_blocks=blocks),
                                 salt).cpu())
        out.setdefault("poisson_gap_us", []).append(
            pois.gap_us(ids, cfg, 3).cpu())
    return {k: int((a.view(torch.int32) != b.view(torch.int32)).sum())
            for k, (a, b) in out.items()}


def search_card_vs_cpu(dev):
    """The vector search at n = 1024, batch 64, width 4, 2.5e6 and 40e6
    IOPS with write-back, on the card (graphed) and on the CPU from one
    index: the kNN graph built on each, and every result."""
    from repro_torch.apps import vector_search as vs

    cfg = vs.SearchConfig(beam_width=4)
    vecs, graph = vs.build_index(0, 1024, cfg, "cpu")
    graph_card = vs.knn_graph(vecs.to(dev), cfg.degree)
    diffs = {"knn_graph": [] if bitwise_equal(graph_card.cpu(), graph)
             else ["knn_graph"]}
    q = vs.case_queries(64, cfg.dim, 0, "cpu")
    for iops in (2.5e6, 40e6):
        ssd, ecfg = vs.case_configs(1024, iops)
        cpu = vs.search(q, vecs, graph, cfg, ssd, ecfg=ecfg, write_back=True)
        gpu = vs.search(q.to(dev), vecs.to(dev), graph.to(dev), cfg, ssd,
                        ecfg=ecfg, write_back=True)
        diffs[f"search_{iops:g}"] = search_differences(cpu, gpu)
    return diffs


# -- phase: the M-drive array -------------------------------------------------

ARRAY_DEVICES = (1, 2, 4, 8)
# The reference's fig 17 (``benchmarks/figures.py::fig17_array_scaling``,
# the JAX package on a CPU: swarmio_cfg() on FUTURE_40M, closed loop at
# depth 1024, 24 rounds, M vmapped drives). Virtual numbers of the
# emulated array, deterministic, not speeds of any chip;
# tests/test_torch_array_figures.py recomputes them.
ARRAY_REFERENCE = {
    1: dict(aggregate_miops=38.139072, fraction_of_target=0.9534768,
            p50_us=495.80682373046875, p99_us=850.5258178710938),
    2: dict(aggregate_miops=76.278144, fraction_of_target=0.9534768,
            p50_us=495.80682373046875, p99_us=850.5258178710938),
    4: dict(aggregate_miops=152.556288, fraction_of_target=0.9534768,
            p50_us=495.80682373046875, p99_us=850.5258178710938),
    8: dict(aggregate_miops=305.112576, fraction_of_target=0.9534768,
            p50_us=495.80682373046875, p99_us=850.5258178710938),
}
# fig 27's 4x40m_striped point (benchmarks/kv_serving.py, not quick):
# yi-34b's smoke dims, page 16, hot window 64, 100 us of GPU time a token,
# four drives of SSDConfig(40e6 IOPS, l_min 30 us, 512 instances, 2^14
# blocks), EngineConfig(num_units=8, fetch_width=64), batch 4 after 512
# tokens, 16 steps; the reference on a CPU (virtual time).
ARRAY_TIER_REFERENCE = {
    "tokens_per_s": 34517.150109851056,
    "avg_step_us": 115.8844223022461,
    "iops_demand": 7749100.199661562,
}
ARRAY_EVENTS_RATIO = 1.1     # graphed round's device events, M = 4 over 1


def array_numbers(state, m):
    from repro_torch.core import engine

    agg = float(engine.aggregate_iops(state))
    met = state.metrics
    return {"aggregate_miops": agg / 1e6,
            "fraction_of_target": agg / (m * 40e6),
            "p50_us": float(met.p50_us()), "p99_us": float(met.p99_us())}


def array_run(cfg, ssd, wl, m, dev, reps=3):
    """ROUNDS rounds of an M-drive array through ``make_array_runner`` on
    the card (one captured array round, replayed), warmed up and captured
    once, then timed ``reps`` times (launch counts covering exactly the
    timed runs) and profiled once. Returns (final state, record, counted
    launches, the graph's launches a round)."""
    from repro_torch.core import engine
    from repro_torch.core.types import PlatformModel
    from repro_torch.kernels import ops

    state = engine.init_array_state(cfg, ssd, wl, m, device=dev)
    runner = engine.make_array_runner(cfg, ssd, wl, PlatformModel(), ROUNDS,
                                      device=dev)
    t0 = time.perf_counter()
    runner(state)
    first_s = time.perf_counter() - t0
    ops.reset_launches()
    out, walls = timed_runs(lambda: runner(state), reps)
    counted = dict(ops.LAUNCHES)
    prof = profiled_window(lambda: runner(state), ROUNDS)
    completed = float(out.metrics.completed.sum())
    wall_ms = statistics.median(walls) * 1e3 / ROUNDS
    rec = {"devices": m, "wall_ms_per_round": wall_ms,
           "emulated_requests_per_wall_s": completed / statistics.median(
               walls),
           "completed_per_run": completed, "wall_s_runs": walls,
           "first_call_s_with_capture": first_s,
           **profile_summary(wall_ms, prof),
           "engine_kernel_device_ms_per_round":
               prof["engine_kernel_device_ms_per_round"],
           "launches_per_graph": runner.runner.graph.launches}
    return out, rec, counted, runner.runner.graph.launches


def flattened_kernel_cases(dev):
    """The four engine kernels on M = 3 drives in one card call each,
    against M calls of their plain versions on the CPU: indices wrapped
    and clamped per drive (block_gather), out-of-range keys of valid rows
    and a tail at the int32 wrap (fused_reap), a drive without a head at
    its first row (seg_scan). Returns the cases that differ."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops

    rng = np.random.default_rng(19)
    m = 3

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x))

    flash = t(rng.random((m, 64, 16), dtype=np.float32))
    idx = t(rng.integers(-80, 80, (m, 999)).astype(np.int32))
    heads = t(rng.random((m, 5000)) < 0.01)
    heads[1, 0] = False
    vals = t(rng.normal(size=(m, 5000)).astype(np.float32))
    k = 512
    dc = (t(rng.integers(0, 99, (m, 2048)).astype(np.float32)),
          t(rng.integers(1, 9, (m, 2048)).astype(np.float32)),
          t(rng.integers(0, k, (m, 2048)).astype(np.int32)),
          t(rng.random((m, 2048)) < 0.5),
          t(rng.integers(0, 50, (m, k)).astype(np.float32)))
    q, d, n = 32, 1024, 8192
    valid = t(rng.random((m, n)) < 0.8)
    key = t(rng.integers(-2, q + 3, (m, n)).astype(np.int32))
    tail = t(rng.integers(0, 5000, (m, q)).astype(np.int32))
    tail[1] = 2 ** 31 - 700
    fr = (t(rng.random((m, q, d), dtype=np.float32)),
          t(rng.random((m, q, d), dtype=np.float32)),
          t(rng.integers(0, 99, (m, q, d)).astype(np.int32)), tail, key,
          t(rng.random((m, n), dtype=np.float32)),
          t(rng.integers(0, 1 << 20, (m, n)).astype(np.int32)), valid)
    cases = {"block_gather": (ops.block_gather, (flash, idx)),
             "seg_scan": (ops.seg_scan, (vals, heads)),
             "die_contention": (ops.die_contention, dc),
             "fused_reap": (ops.fused_reap, fr)}
    bad = []
    for name, (fn, args) in cases.items():
        got = fn(*(a.to(dev) for a in args))
        got = got if isinstance(got, tuple) else (got,)
        for dr in range(m):
            want = fn(*(a[dr] for a in args))
            want = want if isinstance(want, tuple) else (want,)
            if not all(bitwise_equal(g[dr].cpu(), w)
                       for g, w in zip(got, want)):
                bad.append(f"{name}[drive {dr}]")
    return bad


def phase_array(dev, card):
    """The M-drive array on one card. Fig 17 at M = 1, 2, 4 and 8
    (local_1drive's stock config at depth 1024, 24 rounds, main_path_read's
    kernel flags, graphed): aggregate virtual MIOPS, fraction of 40e6 * M,
    p50 and p99 against ``ARRAY_REFERENCE``; wall ms and emulated requests
    a wall-second, device ms and events a round, device ms over the timed
    wall. Each engine kernel must launch as often a graphed round at every
    M, and a graphed round at M = 4 must hold within ``ARRAY_EVENTS_RATIO``
    of M = 1's device events. Then array_4drive (depth 256) and a 70/30
    array with data emulated and every kernel flag on, each eager and
    graphed: bit-identical to each other, to the port's run on the CPU
    (metric sums within SUM_LEAF_ULP; ``card_vs_cpu_max_ulp`` lists every
    float leaf that is not bit-identical) and, drive by drive, to
    single-drive runs of salt d on the card. Then the striped vector search (M = 4,
    n = 4096, width 4, batch 256, 40e6 IOPS) against the same search on
    the CPU, and the 4x40M striped KV tier against
    ``ARRAY_TIER_REFERENCE``. Last, the four kernels' flattened calls on
    the card against per-drive plain calls (not counted as launches)."""
    import torch

    from repro_torch import convert
    from repro_torch.apps import vector_search as vs
    from repro_torch.bench import array_4drive, local_1drive
    from repro_torch.core import engine
    from repro_torch.core.types import (
        EngineConfig, PlatformModel, SSDConfig, WorkloadConfig)
    from repro_torch.kernels import ops
    from repro_torch.serving import kv_tier
    from repro_torch.workloads import MixedReadWrite

    plat = PlatformModel()
    launches = dict.fromkeys(ops.LAUNCHES, 0)

    def add(counted):
        for k, v in counted.items():
            launches[k] += v

    cfg, ssd = local_1drive(**READ_FLAGS)
    fig17, per_graph = [], {}
    for m in ARRAY_DEVICES:
        out, rec, counted, graph = array_run(
            cfg, ssd, WorkloadConfig(io_depth=1024), m, dev)
        add(counted)
        nums = array_numbers(out, m)
        bad = differing(nums, ARRAY_REFERENCE[m])
        check(not bad, f"fig 17 at M={m} (got, reference) differs: {bad}")
        check(out.rings.submit_time.shape[0] == m
              and bool(torch.isfinite(out.clock).all()),
              f"fig 17 at M={m}: state off")
        per_graph[m] = graph
        fig17.append({**nums, **rec})
    for m in ARRAY_DEVICES:
        check(per_graph[m] == per_graph[1],
              f"kernel launches a graphed round differ at M={m}: "
              f"{per_graph[m]} vs {per_graph[1]}")
    events = {r["devices"]: r["profiled"]["device_events_per_round"]
              for r in fig17}
    events_ratio = events[4] / events[1]

    bounds = dict.fromkeys(SUM_LEAVES, SUM_LEAF_ULP)
    cfg4, ssd4, m4 = array_4drive(**READ_FLAGS)
    cells = {
        "array_4drive": (cfg4, ssd4, WorkloadConfig(io_depth=256)),
        "array_4drive_mixed_data": (
            cfg4.replace(emulate_data=True, **KERNEL_FLAGS), ssd4,
            MixedReadWrite(read_frac=0.7, io_depth=256)),
    }
    recs = []
    cpu_runs = {name: cpu_state(c, s, wl, ROUNDS, m4, plat)
                for name, (c, s, wl) in cells.items()}
    for name, (c, s, wl) in cells.items():
        graphed, rec, counted, graph = array_run(c, s, wl, m4, dev)
        add(counted)
        state = engine.init_array_state(c, s, wl, m4, device=dev)
        ops.reset_launches()
        eager = engine.run(state, c, s, wl, plat, ROUNDS)
        torch.cuda.synchronize()
        add(ops.LAUNCHES)
        g_np = convert.engine_state_to_numpy(graphed)
        vs_eager = convert.leaf_differences(
            convert.engine_state_to_numpy(eager), g_np)
        cpu_np = cpu_runs[name].result()
        vs_cpu = convert.leaf_differences(cpu_np, g_np, bounds)
        cpu_ulp = {k: convert.ulp_distance(cpu_np[k], g_np[k])
                   for k in cpu_np if cpu_np[k].dtype.kind == "f"
                   and convert.ulp_distance(cpu_np[k], g_np[k])}
        vs_single = {}
        for d in range(m4):
            one = engine.make_runner(c, s, wl, plat, ROUNDS, device=dev)(
                engine.init_state(c, s, wl, salt=d, device=dev))
            vs_single[d] = convert.leaf_differences(
                convert.engine_state_to_numpy(one),
                {k: v[d] for k, v in g_np.items()})
        recs.append({"cell": name, **array_numbers(graphed, m4),
                     "io_depth": wl.io_depth, **rec,
                     "graph_vs_eager_differing_leaves": vs_eager,
                     "card_vs_cpu_violations": vs_cpu,
                     "card_vs_cpu_max_ulp": cpu_ulp,
                     "drive_vs_single_drive_differing": vs_single})
        check(float(graphed.metrics.completed.min()) > 0,
              f"{name}: a drive completed nothing")
        check(not vs_eager, f"{name}: graphed and eager differ: {vs_eager}")
        check(not vs_cpu, f"{name}: card and CPU differ: {vs_cpu}")
        check(not any(vs_single.values()),
              f"{name}: drives differ from single drives: {vs_single}")
        single_graph = engine.make_runner(c, s, wl, plat, 1, device=dev)
        single_graph(engine.init_state(c, s, wl, device=dev))
        check(graph == single_graph.graph.launches,
              f"{name}: launches a graphed round {graph} differ from a "
              f"single drive's {single_graph.graph.launches}")

    # The striped vector search: index built on the card, the same search
    # on the CPU.
    scfg = vs.SearchConfig(beam_width=4)
    vecs, graph_idx = vs.build_index(0, VS_N, scfg, dev)
    q = vs.case_queries(256, scfg.dim, 0, dev)
    vssd, vecfg = vs.case_configs(VS_N, 40e6)
    searcher = vs.make_search(scfg, vssd, ecfg=vecfg.replace(**READ_FLAGS),
                              num_devices=4)
    searcher(q, vecs, graph_idx)   # the capture
    ops.reset_launches()
    s_out, s_walls = timed_runs(lambda: searcher(q, vecs, graph_idx), 3)
    add(ops.LAUNCHES)
    s_prof = profiled_window(lambda: searcher(q, vecs, graph_idx),
                             scfg.iterations)
    s_cpu = vs.search(q.cpu(), vecs.cpu(), graph_idx.cpu(), scfg, vssd,
                      ecfg=vecfg, num_devices=4)
    s_diff = search_differences(s_out, s_cpu)
    s_out["recall"] = vs.recall_at_k(s_out["indices"],
                                     vs.ground_truth(vecs, q, scfg.top_k))
    s_wall = statistics.median(s_walls) * 1e3 / scfg.iterations
    check(not s_diff, f"striped search: card and CPU differ: {s_diff}")

    # The 4 x 40M striped KV tier (fig 27).
    from repro_torch import configs

    ops.reset_launches()
    t0 = time.perf_counter()
    tier = kv_tier.decode_tokens_per_s(
        configs.get_config("yi-34b", smoke=True),
        kv_tier.KVTierConfig(page_tokens=16, hot_window=64,
                             gpu_step_us=100.0, num_devices=4),
        SSDConfig(t_max_iops=40e6, l_min_us=30.0, n_instances=512,
                  num_blocks=1 << 14),
        EngineConfig(num_units=8, fetch_width=64, use_pallas_reap=True),
        batch=4, start_len=512, n_steps=16, device=dev)
    torch.cuda.synchronize()
    tier_s = time.perf_counter() - t0
    add(ops.LAUNCHES)
    rel = {k: abs(tier[k] - v) / v for k, v in ARRAY_TIER_REFERENCE.items()}
    check(tier["data_check_max_abs"] == 0.0, "striped tier data check")
    check(all(r <= TIER_REL_TOL for r in rel.values()),
          f"striped tier off the reference: {rel}")

    flat_bad = flattened_kernel_cases(dev)
    emit({"phase": "array", "card": card, "rounds": ROUNDS,
          "fig17": fig17, "device_events_m4_over_m1": events_ratio,
          "cells": recs,
          "striped_search": {"devices": 4, "n": VS_N, "batch": 256,
                             "t_max_iops": 40e6, **search_numbers(s_out),
                             "wall_ms_per_iteration": s_wall,
                             **profile_summary(s_wall, s_prof),
                             "card_vs_cpu_differing": s_diff},
          "striped_tier": {"devices": 4, **tier, "wall_s": tier_s,
                           "rel_to_reference": rel},
          "flattened_kernels_differing": flat_bad,
          "launches": launches})
    check(events_ratio <= ARRAY_EVENTS_RATIO,
          f"a graphed round at M=4 has {events_ratio}x the device events "
          f"of M=1 (bound {ARRAY_EVENTS_RATIO})")
    check(not flat_bad, f"flattened kernel calls differ: {flat_bad}")
    for k in ("seg_scan", "fused_reap", "block_gather", "die_contention"):
        check(launches[k] > 0, f"{k} did not launch on the array path")
    return launches


# -- phases: the page cache and the coalescing completion queue -------------

# The reference's fig 22 (``benchmarks/figures.py::fig22_cache_hit_rate``,
# the JAX package on a CPU: swarmio_cfg(cache=...) on D7_PS1010,
# ZipfClosedLoop(io_depth=256, theta=0.9), 48 rounds, 4 ways, hit_us 0.5,
# chase 2), by number of sets (0: the cache off). Virtual numbers of the
# emulated drive, deterministic, not speeds of any chip;
# tests/test_torch_figures_cache.py recomputes them.
CACHE_SETS = (0, 16, 64, 256, 1024, 4096)
CACHE_REFERENCE = {
    0: dict(hit_rate=0.0, virtual_miops=2.440632,
            p50_us=2090.800048828125, p99_us=3586.6376953125),
    16: dict(hit_rate=0.15144863724708557, virtual_miops=2.87405625,
             p50_us=1746.5760498046875, p99_us=3586.6376953125),
    64: dict(hit_rate=0.22518838942050934, virtual_miops=3.1499685,
             p50_us=1459.024169921875, p99_us=3586.6376953125),
    256: dict(hit_rate=0.32365289330482483, virtual_miops=3.605818,
              p50_us=1018.1517333984375, p99_us=3586.6376953125),
    1024: dict(hit_rate=0.5714728832244873, virtual_miops=5.691086,
               p50_us=1.094113826751709, p99_us=3586.6376953125),
    4096: dict(hit_rate=0.5781870484352112, virtual_miops=5.781673,
               p50_us=1.094113826751709, p99_us=3586.6376953125),
}
# The reference's fig 21 (``benchmarks/figures.py::fig21_cq_coalescing``:
# swarmio_cfg(poll_quantum_us=25, qp=...) on FUTURE_40M at io_depth 1024,
# 32 rounds; QPConfig(cq_coalesce_n=n, cq_coalesce_us=50,
# cq_doorbell_us=1, cq_poll_us=0.3, cqe_reap_us=0.02); 0 is the neutral
# QP), recomputed by tests/test_torch_figures_qp.py.
QP_COALESCE = (1, 2, 4, 8, 16, 32, 0)
QP_REFERENCE = {
    1: dict(virtual_miops=28.914586, p50_us=1018.1517333984375,
            p99_us=1218.814208984375),
    2: dict(virtual_miops=37.102824, p50_us=710.4974365234375,
            p99_us=1018.1517333984375),
    4: dict(virtual_miops=37.174752, p50_us=850.5258178710938,
            p99_us=850.5258178710938),
    8: dict(virtual_miops=37.852468, p50_us=850.5258178710938,
            p99_us=850.5258178710938),
    16: dict(virtual_miops=38.028032, p50_us=850.5258178710938,
             p99_us=850.5258178710938),
    32: dict(virtual_miops=38.163124, p50_us=850.5258178710938,
             p99_us=850.5258178710938),
    0: dict(virtual_miops=38.39838, p50_us=850.5258178710938,
            p99_us=850.5258178710938),
}
# Fig 28's hot-window x cache sweep (``benchmarks/kv_serving.py::
# fig28_kv_tier_hierarchy``, not quick: yi-34b's smoke dims, page 16, 100
# us of GPU time a token, batch 4 after 512 tokens, 16 steps, a 2.5-MIOPS
# drive, EngineConfig(num_units=8, fetch_width=64, cache=...); small = 64
# sets x 4 ways, large = 512 x 8, both readahead 2), the reference on a
# CPU; tests/test_torch_figures_tier_cache.py recomputes the hot_window 32
# points.
TIER_CACHES = {
    "off": dict(enabled=False),
    "small": dict(enabled=True, num_sets=64, ways=4, readahead=2),
    "large": dict(enabled=True, num_sets=512, ways=8, readahead=2),
}
TIER_CACHE_REFERENCE = {
    "hw32_cache_off": dict(tokens_per_s=8728.73423231198,
                           avg_storage_us=458.256591796875,
                           blocks_per_step=962.0),
    "hw32_cache_small": dict(tokens_per_s=10532.1977236272,
                             avg_storage_us=379.78778076171875,
                             blocks_per_step=962.0),
    "hw32_cache_large": dict(tokens_per_s=37243.96055786379,
                             avg_storage_us=14.11871337890625,
                             blocks_per_step=962.0),
    "hw64_cache_off": dict(tokens_per_s=9245.57486043324,
                           avg_storage_us=432.639404296875,
                           blocks_per_step=898.0),
    "hw64_cache_small": dict(tokens_per_s=11293.967130033654,
                             avg_storage_us=354.17138671875,
                             blocks_per_step=898.0),
    "hw64_cache_large": dict(tokens_per_s=37243.96055786379,
                             avg_storage_us=14.11871337890625,
                             blocks_per_step=898.0),
    "hw128_cache_off": dict(tokens_per_s=10487.53532998066,
                            avg_storage_us=381.4051513671875,
                            blocks_per_step=770.0),
    "hw128_cache_small": dict(tokens_per_s=13204.06236066537,
                              avg_storage_us=302.93707275390625,
                              blocks_per_step=770.0),
    "hw128_cache_large": dict(tokens_per_s=37243.96055786379,
                              avg_storage_us=14.11871337890625,
                              blocks_per_step=770.0),
}


CACHE_ROUNDS = 48            # fig 22's rounds
QP_ROUNDS = 32               # fig 21's rounds
CACHE_ARRAY_SETS = 1024      # the array row and the kernel-flags row
CACHE_SEARCH_SETS = 256      # the vector search's cache: 1024 of 4096 blocks


def profiled_rounds(cfg, ssd, wl, plat, state, runner, rounds, dev):
    """``profiled_window`` over the first ``PROFILE_ROUNDS`` rounds of a
    run from ``state``: ``runner`` itself where the run is no longer,
    else a graphed runner of that many rounds."""
    from repro_torch.core import engine

    n = min(rounds, PROFILE_ROUNDS)
    if n < rounds:
        runner = engine.make_runner(cfg, ssd, wl, plat, n, device=dev)
    return profiled_window(lambda: runner(state), n)


def graphed_run(cfg, ssd, wl, rounds, dev, reps=2):
    """``rounds`` rounds of one drive through ``make_runner`` on the card
    (the first call captures), timed ``reps`` times, and its first
    ``PROFILE_ROUNDS`` rounds profiled once. Returns (final state, record,
    the graph's kernel launches a round)."""
    from repro_torch.core import engine
    from repro_torch.core.types import PlatformModel

    state = engine.init_state(cfg, ssd, wl, device=dev)
    runner = engine.make_runner(cfg, ssd, wl, PlatformModel(), rounds,
                                device=dev)
    t0 = time.perf_counter()
    runner(state)
    first_s = time.perf_counter() - t0
    out, walls = timed_runs(lambda: runner(state), reps)
    prof = profiled_rounds(cfg, ssd, wl, PlatformModel(), state, runner,
                           rounds, dev)
    wall_ms = statistics.median(walls) * 1e3 / rounds
    return out, {"rounds": rounds, "wall_ms_per_round": wall_ms,
                 "wall_s_runs": walls, "first_call_s_with_capture": first_s,
                 **profile_summary(wall_ms, prof),
                 "engine_kernel_device_ms_per_round":
                     prof["engine_kernel_device_ms_per_round"],
                 "launches_per_graph": runner.graph.launches}, \
        runner.graph.launches


def card_vs_cpu(out, cpu):
    """Leaves of the card's final state that break their contract with the
    port's eager run on the CPU (``cpu``: its ``cpu_state`` future;
    integer leaves equal, float leaves bit-exact but the metric sums,
    within SUM_LEAF_ULP)."""
    from repro_torch import convert

    return convert.leaf_differences(
        cpu.result(), convert.engine_state_to_numpy(out),
        dict.fromkeys(SUM_LEAVES, SUM_LEAF_ULP))


def eager_vs_graph(out, cfg, ssd, wl, rounds, dev):
    """One eager ``engine.run`` of ``rounds`` rounds on the card from the
    state ``graphed_run`` starts from: the leaves in which it differs from
    the graphed final state ``out`` (every leaf must be bit-identical) and
    its wall ms a round."""
    import torch

    from repro_torch import convert
    from repro_torch.core import engine
    from repro_torch.core.types import PlatformModel

    state = engine.init_state(cfg, ssd, wl, device=dev)
    t0 = time.perf_counter()
    eager = engine.run(state, cfg, ssd, wl, PlatformModel(), rounds)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / rounds
    return convert.leaf_differences(
        convert.engine_state_to_numpy(eager),
        convert.engine_state_to_numpy(out)), wall_ms


def cache_numbers(m):
    return {"hit_rate": float(m.hit_rate()),
            "virtual_miops": float(m.iops()) / 1e6,
            "p50_us": float(m.p50_us()), "p99_us": float(m.p99_us())}


def phase_cache(dev, card):
    """The stage-0 page cache. Fig 22's six rows at full size (the Zipf
    loop at depth 256 on D7_PS1010, 48 rounds, 4 ways, hit_us 0.5, chase
    2), graphed through make_runner with the reference's flags (all off):
    hit rate, virtual MIOPS, p50 and p99 against ``CACHE_REFERENCE`` to
    the last digit, the final state (``cache.tags`` and ``cache.rr``
    included) against the CPU port's, wall and device ms and device events
    a round; the 1024-set row's graphed state bit-identical to an eager
    run on the card. That row again with ``KERNEL_FLAGS`` (counts reset
    just before, read just after: die_contention and fused_reap must
    launch), against the CPU port with the same flags and against its
    own eager run on the card; then as a 4-drive array, graphed, whose drive d must equal a
    single drive of salt d. Last, ``vector_search.case_study`` with
    ``cache_sets`` on one drive and striped over 4 (n = 4096, batch 64,
    2.5e6 IOPS), each against the same search on the CPU."""
    import torch

    from repro_torch import convert
    from repro_torch.apps import vector_search as vs
    from repro_torch.bench import fig22_1024, local_1drive
    from repro_torch.core import engine
    from repro_torch.core.types import CacheConfig, PlatformModel
    from repro_torch.kernels import ops

    plat = PlatformModel()
    launches = dict.fromkeys(ops.LAUNCHES, 0)
    _, ssd, wl = fig22_1024()
    cfgs = {sets: local_1drive(cache=CacheConfig(
        enabled=sets > 0, num_sets=max(sets, 1), ways=4, hit_us=0.5,
        chase=2))[0] for sets in CACHE_SETS}
    cfg_on, ssd_on, wl_on = fig22_1024(**KERNEL_FLAGS)
    cpu_runs = {sets: cpu_state(cfg, ssd, wl, CACHE_ROUNDS)
                for sets, cfg in cfgs.items()}
    cpu_on = cpu_state(cfg_on, ssd_on, wl_on, CACHE_ROUNDS)
    rows = []
    for sets, cfg in cfgs.items():
        out, rec, _ = graphed_run(cfg, ssd, wl, CACHE_ROUNDS, dev)
        nums = cache_numbers(out.metrics)
        vs_cpu = card_vs_cpu(out, cpu_runs[sets])
        bad = differing(nums, CACHE_REFERENCE[sets])
        rows.append({"num_sets": sets, **nums,
                     "completed": float(out.metrics.completed),
                     "cache_hits": float(out.metrics.cache_hits), **rec,
                     "card_vs_cpu_violations": vs_cpu,
                     "card_vs_reference_differing": bad})
        check(not bad, f"fig 22 at {sets} sets (card, reference) differs: "
                       f"{bad}")
        check(not vs_cpu, f"fig 22 at {sets} sets: card and CPU differ: "
                          f"{vs_cpu}")
        check(bool(torch.isfinite(out.metrics.sum_e2e)), "sum_e2e")
        if sets == CACHE_ARRAY_SETS:
            diff, eager_ms = eager_vs_graph(out, cfg, ssd, wl, CACHE_ROUNDS,
                                            dev)
            rows[-1].update(graph_vs_eager_differing_leaves=diff,
                            eager_wall_ms_per_round=eager_ms)
            check(not diff, f"fig 22 at {sets} sets: graphed and eager "
                            f"states differ in {diff}")

    cfg, ssd, wl = cfg_on, ssd_on, wl_on
    ops.reset_launches()
    on, on_rec, _ = graphed_run(cfg, ssd, wl, CACHE_ROUNDS, dev, reps=1)
    torch.cuda.synchronize()
    counted = dict(ops.LAUNCHES)
    for k, v in counted.items():
        launches[k] += v
    on_vs_cpu = card_vs_cpu(on, cpu_on)
    on_vs_eager, on_eager_ms = eager_vs_graph(on, cfg, ssd, wl,
                                              CACHE_ROUNDS, dev)
    check(not on_vs_eager, f"fig 22 with the kernel flags: graphed and "
                           f"eager states differ in {on_vs_eager}")
    on_nums = cache_numbers(on.metrics)
    check(not on_vs_cpu, f"fig 22 with the kernel flags: card and CPU "
                         f"differ: {on_vs_cpu}")
    # A read-only DSA round with every flag on folds the flash stage on
    # die_contention (seg_scan has no caller there; the qp phase runs it).
    for k in ("die_contention", "fused_reap"):
        check(counted[k] > 0, f"{k} did not launch on the cached path")

    # The 4-drive array of the 1024-set row, graphed; drive d against a
    # single drive of salt d.
    cfg, ssd, wl = fig22_1024()
    m = 4
    state = engine.init_array_state(cfg, ssd, wl, m, device=dev)
    arr = engine.make_array_runner(cfg, ssd, wl, plat, CACHE_ROUNDS,
                                   device=dev)(state)
    a_np = convert.engine_state_to_numpy(arr)
    vs_single = {}
    for d in range(m):
        one = engine.make_runner(cfg, ssd, wl, plat, CACHE_ROUNDS,
                                 device=dev)(
            engine.init_state(cfg, ssd, wl, salt=d, device=dev))
        vs_single[d] = convert.leaf_differences(
            convert.engine_state_to_numpy(one),
            {k: v[d] for k, v in a_np.items()})
    check(a_np["cache.tags"].shape == (m, CACHE_ARRAY_SETS, 4),
          f"array cache tags {a_np['cache.tags'].shape}")
    check(not any(vs_single.values()),
          f"cached array drives differ from single drives: {vs_single}")

    # case_study(cache_sets=...) on one drive and striped over 4, on the
    # card; the same search on the CPU from the card's index.
    searches = []
    scfg = vs.SearchConfig()
    for nd in (1, 4):
        ops.reset_launches()
        t0 = time.perf_counter()
        out = vs.case_study(n=VS_N, cache_sets=CACHE_SEARCH_SETS,
                            num_devices=nd, device=dev)
        wall = time.perf_counter() - t0
        for k, v in ops.LAUNCHES.items():
            launches[k] += v
        # case_study's own index and queries, drawn and normalised on the
        # card.
        vecs, graph = vs._cached_index(VS_N, scfg.dim, scfg.degree, 0, dev)
        q = vs.case_queries(64, scfg.dim, 0, dev)
        vssd, vecfg = vs.case_configs(VS_N, 2.5e6, CACHE_SEARCH_SETS)
        cpu = vs.search(q.cpu(), vecs.cpu(), graph.cpu(), scfg, vssd,
                        ecfg=vecfg, num_devices=nd)
        diff = search_differences(out, cpu)
        _, plain = vs.case_configs(VS_N, 2.5e6)
        off = vs.search(q, vecs, graph, scfg, vssd, ecfg=plain,
                        num_devices=nd)
        searches.append({"devices": nd, "cache_sets": CACHE_SEARCH_SETS,
                         "n": VS_N, "batch": 64, "t_max_iops": 2.5e6,
                         **search_numbers(out), "wall_s_with_capture": wall,
                         "qps_cache_off": off["qps"],
                         "card_vs_cpu_differing": diff})
        check(not diff, f"cached search over {nd} drives: card and CPU "
                        f"differ: {diff}")
        check(out["qps"] > off["qps"] and 0.0 < out["recall"] <= 1.0,
              f"cached search over {nd} drives: {search_numbers(out)}, "
              f"{off['qps']} QPS with the cache off")
    emit({"phase": "cache", "card": card, "rows": rows,
          "kernel_flags_1024": {**on_nums, **on_rec,
                                "card_vs_cpu_violations": on_vs_cpu,
                                "graph_vs_eager_differing_leaves":
                                    on_vs_eager,
                                "eager_wall_ms_per_round": on_eager_ms,
                                "launches": counted},
          "array_1024": {"devices": m,
                         "hit_rate": arr.metrics.hit_rate().tolist(),
                         "aggregate_miops":
                             float(engine.aggregate_iops(arr)) / 1e6,
                         "drive_vs_single_drive_differing": vs_single},
          "searches": searches, "launches": launches})
    return launches


def phase_qp(dev, card):
    """The coalescing completion queue. Fig 21's seven rows at full size
    (local_1drive at depth 1024, a 25 us poll quantum, 32 rounds; 1 to 32
    completions a doorbell, then the neutral QP), graphed with the
    reference's flags (all off): virtual MIOPS, p50 and p99 against
    ``QP_REFERENCE`` to the last digit, the final state against the CPU
    port's, wall and device ms and device events a round. Then every row
    again with ``use_pallas_segscan`` on (counts reset just before, read
    just after), so that the doorbell queue runs on ``seg_scan``: each
    row's state against the CPU port's with the same flag. At one
    completion a doorbell both graphed states must be bit-identical to an
    eager run on the card."""
    import torch

    from repro_torch.bench import fig21_row
    from repro_torch.kernels import ops

    rows, launches = [], dict.fromkeys(ops.LAUNCHES, 0)
    cpu_runs = {}
    for n_coal in QP_COALESCE:
        cfg, ssd, wl = fig21_row(n_coal)
        cpu_runs[n_coal] = [cpu_state(c, ssd, wl, QP_ROUNDS) for c in (
            cfg, cfg.replace(use_pallas_segscan=True))]
    for n_coal in QP_COALESCE:
        cfg, ssd, wl = fig21_row(n_coal)
        out, rec, _ = graphed_run(cfg, ssd, wl, QP_ROUNDS, dev)
        nums = {k: v for k, v in virtual_numbers(out.metrics).items()
                if k in ("virtual_miops", "p50_us", "p99_us")}
        vs_cpu = card_vs_cpu(out, cpu_runs[n_coal][0])
        bad = differing(nums, QP_REFERENCE[n_coal])
        cfg_on = cfg.replace(use_pallas_segscan=True)
        ops.reset_launches()
        on, _, graph = graphed_run(cfg_on, ssd, wl, QP_ROUNDS, dev, reps=1)
        torch.cuda.synchronize()
        counted = dict(ops.LAUNCHES)
        for k, v in counted.items():
            launches[k] += v
        on_vs_cpu = card_vs_cpu(on, cpu_runs[n_coal][1])
        eager = {}
        if n_coal == 1:     # the costliest doorbell queue, eager on the card
            for name, c, o in (("flags_off", cfg, out),
                               ("segscan", cfg_on, on)):
                diff, ms = eager_vs_graph(o, c, ssd, wl, QP_ROUNDS, dev)
                eager[name] = {"graph_vs_eager_differing_leaves": diff,
                               "eager_wall_ms_per_round": ms}
                check(not diff, f"fig 21 at n=1 ({name}): graphed and "
                                f"eager states differ in {diff}")
        rows.append({"coalesce_n": n_coal, **nums,
                     **({"graph_vs_eager": eager} if eager else {}),
                     "completed": float(out.metrics.completed),
                     "bell_time_max": float(out.cq.bell_time.max()), **rec,
                     "card_vs_cpu_violations": vs_cpu,
                     "card_vs_reference_differing": bad,
                     "segscan": {**{k: v for k, v in virtual_numbers(
                         on.metrics).items() if k in nums},
                         "card_vs_cpu_violations": on_vs_cpu,
                         "launches": counted, "launches_per_graph": graph}})
        check(not bad, f"fig 21 at n={n_coal} (card, reference) differs: "
                       f"{bad}")
        check(not vs_cpu, f"fig 21 at n={n_coal}: card and CPU differ: "
                          f"{vs_cpu}")
        check(not on_vs_cpu, f"fig 21 at n={n_coal} on seg_scan: card and "
                             f"CPU differ: {on_vs_cpu}")
        check(counted["seg_scan"] > 0, f"seg_scan did not launch at "
                                       f"n={n_coal}")
    # The doorbell queue adds one seg_scan launch a graphed round to what
    # the neutral QP's round launches.
    per_round = {r["coalesce_n"]: r["segscan"]["launches_per_graph"]
                 ["seg_scan"] for r in rows}
    emit({"phase": "qp", "card": card, "rows": rows,
          "seg_scan_launches_per_graphed_round": per_round,
          "launches": launches})
    check(all(v == per_round[0] + 1 for k, v in per_round.items() if k),
          f"seg_scan launches a graphed round: {per_round}")
    return launches


# -- phase: the remote fabric, the ready-time lock, the tenant metrics -------

INF = float("inf")
FABRIC_M = 4                 # figs 23 and 25: a 4 x 40M remote array
FABRIC_ROUNDS = 24           # figs 23 and 25 (and remote_qos)
FIG23_BWS = (500.0, 1000.0, 2000.0, 4000.0, 8000.0, 16000.0, 32000.0, INF)
FIG23_RTTS = (0.0, 5.0, 20.0, 100.0)
FIG25_SWITCHES = (2000.0, 4000.0, 8000.0, 16000.0, 32000.0, 64000.0, INF)
FIG26_SHARES = ((1.0, 1.0), (2.0, 1.0), (3.0, 1.0), (7.0, 1.0))
FIG26_STARVATION = (("fifo", ()), ("wfq_1_1", (1.0, 1.0)),
                    ("wfq_4_1", (4.0, 1.0)))
FIG29_ARBITERS = (("fifo", ()), ("wfq_2_1", (2.0, 1.0)))
FIG29_ORDERS = ("program", "ready_time")
FIG29_SLO_US = 500.0
FIG24_FABRIC = dict(remote=True, rtt_us=5.0, tx_bytes_per_us=8000.0,
                    rx_bytes_per_us=2000.0, wire_txn_us=0.2, mtu_batch=8,
                    mtu_timeout_us=20.0)
FIG24_N = 4096
FIG28_FABRIC = dict(remote=True, tx_bytes_per_us=1_500.0,
                    rx_bytes_per_us=1_500.0, rtt_us=2.0, wire_txn_us=0.2,
                    mtu_batch=8, mtu_timeout_us=5.0,
                    switch_bytes_per_us=1_500.0, switch_fanin=1)
FIG28_MIXES = (("idle_fifo", 0, ()), ("bulk_fifo", 2048, ()),
               ("bulk_wfq_4_1", 2048, (4.0, 1.0)))


def _bw_key(x):
    return "inf" if x == INF else f"{x:g}"


def fabric_cells():
    """Every engine row of figs 23, 25, 26 and 29 at the figure's own
    settings (``benchmarks/figures.py``), as plain data that either
    package builds its configs from: name -> dict(figure, engine
    (``swarmio_cfg`` overrides), fabric (``FabricConfig`` fields), ssd
    (``FUTURE_40M`` or ``D7_PS1010``), wl (``WorkloadConfig`` or
    ``MultiTenant`` fields), rounds, devices)."""
    cells = {}
    for bw in FIG23_BWS:
        fin = bw != INF
        cells[f"fig23_bw_{_bw_key(bw)}"] = dict(
            figure="fig23", engine={}, fabric=dict(
                remote=True, rtt_us=10.0 if fin else 0.0,
                tx_bytes_per_us=bw, rx_bytes_per_us=bw,
                wire_txn_us=0.2 if fin else 0.0, mtu_batch=16 if fin else 1,
                mtu_timeout_us=20.0 if fin else 0.0),
            ssd="FUTURE_40M", wl=dict(io_depth=1024),
            rounds=FABRIC_ROUNDS, devices=FABRIC_M)
    for rtt in FIG23_RTTS:
        cells[f"fig23_rtt_{rtt:g}"] = dict(
            figure="fig23", engine={}, fabric=dict(remote=True, rtt_us=rtt),
            ssd="FUTURE_40M", wl=dict(io_depth=1024),
            rounds=FABRIC_ROUNDS, devices=FABRIC_M)
    for sw in FIG25_SWITCHES:
        cells[f"fig25_sw_{_bw_key(sw)}"] = dict(
            figure="fig25", engine={}, fabric=dict(
                remote=True, switch_bytes_per_us=sw, switch_fanin=FABRIC_M),
            ssd="FUTURE_40M", wl=dict(io_depth=1024),
            rounds=FABRIC_ROUNDS, devices=FABRIC_M)
    qos = dict(num_sqs=16, fetch_width=64, num_units=8)
    for w in FIG26_SHARES:
        cells[f"fig26_share_{w[0]:g}:{w[1]:g}"] = dict(
            figure="fig26", engine=qos, fabric=dict(
                remote=True, rx_bytes_per_us=2000.0, tx_bytes_per_us=8000.0,
                qos_weights=w),
            ssd="FUTURE_40M",
            wl=dict(io_depth=64, tenant_read_frac=(1.0, 1.0)),
            rounds=192, devices=1)
    for name, w in FIG26_STARVATION:
        cells[f"fig26_starve_{name}"] = dict(
            figure="fig26", engine=qos, fabric=dict(
                remote=True, tx_bytes_per_us=400.0,
                rx_bytes_per_us=16000.0, qos_weights=w),
            ssd="D7_PS1010",
            wl=dict(io_depth=64, tenant_read_frac=(1.0, 0.0)),
            rounds=96, devices=1)
    for name, w in FIG29_ARBITERS:
        for order in FIG29_ORDERS:
            cells[f"fig29_{name}_{order}"] = dict(
                figure="fig29", engine=dict(
                    num_sqs=16, fetch_width=64, num_units=16, sq_depth=128,
                    lock_order=order),
                fabric=dict(remote=True, tx_bytes_per_us=400.0,
                            rx_bytes_per_us=16000.0, qos_weights=w),
                ssd="D7_PS1010",
                wl=dict(io_depth=64, tenant_read_frac=(1.0, 0.0),
                        interleave=True),
                rounds=96, devices=1)
    return cells


def port_cell(cell):
    """(EngineConfig, SSDConfig, workload) of a ``fabric_cells`` entry."""
    from repro_torch import bench
    from repro_torch.core.types import FabricConfig, WorkloadConfig
    from repro_torch.workloads import MultiTenant

    cfg, _ = bench.local_1drive(fabric=FabricConfig(**cell["fabric"]),
                                **cell["engine"])
    ssd = getattr(bench, cell["ssd"])
    wl = (MultiTenant(**cell["wl"]) if "tenant_read_frac" in cell["wl"]
          else WorkloadConfig(**cell["wl"]))
    return cfg, ssd, wl


def fabric_numbers(figure, state):
    """The figure's own numbers of a final state (virtual time: the
    emulated drives', not speeds of any chip)."""
    from repro_torch.core import engine

    m = state.metrics
    if figure in ("fig23", "fig25"):
        return {"aggregate_miops": float(engine.aggregate_iops(state)) / 1e6,
                "p50_us": float(m.p50_us()), "p99_us": float(m.p99_us())}
    share = m.tenant_share()
    if figure == "fig26":
        lat = m.tenant_avg_e2e_us()
        return {"share0": float(share[0]), "tenant0_e2e_us": float(lat[0]),
                "tenant1_e2e_us": float(lat[1])}
    p99 = m.tenant_p99_us()
    return {"latency_p99_us": float(p99[0]), "bulk_p99_us": float(p99[1]),
            "latency_slo_attainment": float(
                m.slo_attainment(FIG29_SLO_US)[0]),
            "latency_share": float(share[0])}


def fig24_rows(device):
    """Fig 24 (``benchmarks/figures.py::fig24_stripe_replication``) on the
    port: stripe width 1-4 over a uniform batch, then 1-4 replicas of a
    batch homed on drive 0, n = 4096 reads on a remote 4-drive client,
    each from a fresh state: name -> (delivered Mreq/s, mean and p99 us)."""
    import torch

    from repro_torch import bench
    from repro_torch.core.client import StorageClient
    from repro_torch.core.types import F32, I32, EngineConfig, FabricConfig
    from repro_torch.core.xla_math import lane_mean

    ssd = bench.FUTURE_40M
    client = StorageClient(ssd, EngineConfig(
        num_units=8, fetch_width=64, fabric=FabricConfig(**FIG24_FABRIC)))
    flash = torch.zeros((ssd.num_blocks, 8), dtype=F32, device=device)
    n = FIG24_N
    uniform = (torch.arange(n, dtype=I32, device=device) * 13) \
        % ssd.num_blocks
    skewed = torch.div(uniform, FABRIC_M, rounding_mode="floor") * FABRIC_M
    rows = {}

    def stats(done):
        lat = torch.sort(done).values
        return {"mreq_per_s": n / float(done.max()),
                "mean_us": float(lane_mean(done)),
                "p99_us": float(lat[int(0.99 * (n - 1))])}

    for w in range(1, FABRIC_M + 1):
        state = client.init_array_state(FABRIC_M, device)
        rows[f"stripe_{w}"] = stats(client.read_striped(
            state, flash, uniform, 0.0, stripe_width=w)[2])
    for r in range(1, FABRIC_M + 1):
        state = client.init_array_state(FABRIC_M, device)
        rows[f"replicas_{r}"] = stats(client.read_replicated(
            state, flash, skewed, 0.0, replicas=r)[2])
    return rows


def tenant_mix(device):
    """Fig 28's tenant-mix points (``benchmarks/kv_serving.py``, not quick:
    yi-34b's smoke dims, batch 4 after 512 tokens, 16 steps, a 40-MIOPS
    drive behind a switched remote fabric, a bulk tenant of 0 or 2048
    blocks a step, FIFO or WFQ 4:1): name -> the tier's numbers."""
    from repro_torch import configs
    from repro_torch.core.types import EngineConfig, FabricConfig, SSDConfig
    from repro_torch.serving import kv_tier

    model = configs.get_config("yi-34b", smoke=True)
    ssd = SSDConfig(t_max_iops=40e6, l_min_us=30.0, n_instances=512,
                    num_blocks=1 << 14)
    out = {}
    for name, bulk, weights in FIG28_MIXES:
        ecfg = EngineConfig(num_units=8, fetch_width=64, fabric=FabricConfig(
            qos_weights=weights, **FIG28_FABRIC))
        r = kv_tier.decode_tokens_per_s(
            model, kv_tier.KVTierConfig(page_tokens=16, hot_window=64,
                                        gpu_step_us=100.0,
                                        bulk_blocks_per_step=bulk),
            ssd, ecfg, batch=4, start_len=512, n_steps=16, device=device)
        out[name] = {k: r[k] for k in ("tokens_per_s", "avg_storage_us",
                                       "blocks_per_step",
                                       "data_check_max_abs")}
    return out


# The reference's figures 23-26 and 29 (``benchmarks/figures.py``, not
# quick) and fig 28's tenant-mix points (``benchmarks/kv_serving.py``'s
# sweep at its own settings), the JAX package run once on a CPU; fig 29
# and fig 28 rebuilt from their settings, not by calling the functions
# that write BENCH_*.json. Virtual time: numbers of the emulated drives,
# not speeds of any chip. tests/test_torch_figures_fabric.py and
# tests/test_torch_figures_qos.py recompute a subset.
FABRIC_REFERENCE = {
    "fig23": {
        "bw_500": dict(aggregate_miops=3.473982, p50_us=5139.69677734375,
                       p99_us=8816.8310546875),
        "bw_1000": dict(aggregate_miops=6.7855845, p50_us=2502.865478515625,
                        p99_us=5139.69677734375),
        "bw_2000": dict(aggregate_miops=12.965157, p50_us=1459.024169921875,
                        p99_us=2502.865478515625),
        "bw_4000": dict(aggregate_miops=23.804368, p50_us=850.5258178710938,
                        p99_us=1459.024169921875),
        "bw_8000": dict(aggregate_miops=45.378184, p50_us=850.5258178710938,
                        p99_us=1459.024169921875),
        "bw_16000": dict(aggregate_miops=73.954032, p50_us=495.80682373046875,
                         p99_us=850.5258178710938),
        "bw_32000": dict(aggregate_miops=107.940536, p50_us=345.9891662597656,
                         p99_us=593.52294921875),
        "bw_inf": dict(aggregate_miops=152.556288, p50_us=495.80682373046875,
                       p99_us=850.5258178710938),
        "rtt_0": dict(aggregate_miops=152.556288, p50_us=495.80682373046875,
                      p99_us=850.5258178710938),
        "rtt_5": dict(aggregate_miops=151.812336, p50_us=495.80682373046875,
                      p99_us=850.5258178710938),
        "rtt_20": dict(aggregate_miops=146.177248, p50_us=495.80682373046875,
                       p99_us=850.5258178710938),
        "rtt_100": dict(aggregate_miops=107.957232, p50_us=414.1784362792969,
                        p99_us=593.52294921875),
    },
    "fig24": {
        "stripe_1": dict(mreq_per_s=3.1658624897016914,
                         mean_us=702.1622314453125, p99_us=1281.9781494140625),
        "stripe_2": dict(mreq_per_s=5.8353382449203615,
                         mean_us=406.22613525390625, p99_us=696.2501220703125),
        "stripe_3": dict(mreq_per_s=8.061299103163792,
                         mean_us=310.6265869140625, p99_us=503.9386901855469),
        "stripe_4": dict(mreq_per_s=10.121951749252492,
                         mean_us=256.9290771484375, p99_us=401.8250732421875),
        "replicas_1": dict(mreq_per_s=3.1658624897016914,
                           mean_us=702.1622314453125,
                           p99_us=1281.9781494140625),
        "replicas_2": dict(mreq_per_s=5.8353382449203615,
                           mean_us=406.22613525390625,
                           p99_us=696.2501220703125),
        "replicas_3": dict(mreq_per_s=8.061299103163792,
                           mean_us=310.6265869140625,
                           p99_us=503.9386901855469),
        "replicas_4": dict(mreq_per_s=10.121951749252492,
                           mean_us=256.9290771484375,
                           p99_us=401.8250732421875),
    },
    "fig25": {
        "sw_2000": dict(aggregate_miops=3.5365135, p50_us=5139.69677734375,
                        p99_us=8816.8310546875),
        "sw_4000": dict(aggregate_miops=7.0283195, p50_us=2502.865478515625,
                        p99_us=4293.51025390625),
        "sw_8000": dict(aggregate_miops=13.881159, p50_us=1218.814208984375,
                        p99_us=2502.865478515625),
        "sw_16000": dict(aggregate_miops=28.604272, p50_us=1218.814208984375,
                         p99_us=2090.800048828125),
        "sw_32000": dict(aggregate_miops=57.296448, p50_us=850.5258178710938,
                         p99_us=1746.5760498046875),
        "sw_64000": dict(aggregate_miops=113.010152, p50_us=593.52294921875,
                         p99_us=1218.814208984375),
        "sw_inf": dict(aggregate_miops=152.556288, p50_us=495.80682373046875,
                       p99_us=850.5258178710938),
    },
    "fig26": {
        "share_1:1": dict(share0=0.5006256103515625,
                          tenant0_e2e_us=261.8939208984375,
                          tenant1_e2e_us=262.5614318847656),
        "share_2:1": dict(share0=0.6471467614173889,
                          tenant0_e2e_us=198.11683654785156,
                          tenant1_e2e_us=382.579833984375),
        "share_3:1": dict(share0=0.7196875810623169,
                          tenant0_e2e_us=177.0667266845703,
                          tenant1_e2e_us=496.8709716796875),
        "share_7:1": dict(share0=0.8270922303199768,
                          tenant0_e2e_us=153.48284912109375,
                          tenant1_e2e_us=909.9852905273438),
        "starve_fifo": dict(share0=0.5925925970077515,
                            tenant0_e2e_us=1889.2822265625,
                            tenant1_e2e_us=2524.15478515625),
        "starve_wfq_1_1": dict(share0=0.5, tenant0_e2e_us=252.1001434326172,
                               tenant1_e2e_us=2650.13720703125),
        "starve_wfq_4_1": dict(share0=0.5, tenant0_e2e_us=212.88671875,
                               tenant1_e2e_us=4032.586669921875),
    },
    "fig29": {
        "fifo_program": dict(latency_p99_us=2996.142822265625,
                             bulk_p99_us=3586.6376953125,
                             latency_slo_attainment=0.3125,
                             latency_share=0.6274510025978088),
        "fifo_ready_time": dict(latency_p99_us=2996.142822265625,
                                bulk_p99_us=3586.6376953125,
                                latency_slo_attainment=0.3125,
                                latency_share=0.6270667314529419),
        "wfq_2_1_program": dict(latency_p99_us=2090.800048828125,
                                bulk_p99_us=3586.6376953125,
                                latency_slo_attainment=0.2495126724243164,
                                latency_share=0.5004878044128418),
        "wfq_2_1_ready_time": dict(latency_p99_us=241.4418182373047,
                                   bulk_p99_us=3586.6376953125,
                                   latency_slo_attainment=0.9980506896972656,
                                   latency_share=0.5004878044128418),
    },
    "fig28": {
        "idle_fifo": dict(tokens_per_s=8983.457790969429,
                          avg_storage_us=445.2628479003906,
                          blocks_per_step=898.0),
        "bulk_fifo": dict(tokens_per_s=3642.8564361262233,
                          avg_storage_us=1098.0394287109375,
                          blocks_per_step=898.0),
        "bulk_wfq_4_1": dict(tokens_per_s=5130.079002089418,
                             avg_storage_us=779.715087890625,
                             blocks_per_step=898.0),
    },
}


FABRIC_CPU_ROWS = ("fig23_bw_1000", "fig26_share_2:1",
                   "fig29_wfq_2_1_ready_time")


def fabric_violations(figure, got, want, state):
    """The numbers of a row off the reference's. Every number must be
    equal but a tenant's average E2E: the reference adds a tenant's
    latencies one after another in float32 (``segment_sum``), the port
    near-exactly, so the two averages may differ by that recursion's
    error bound, ``(n - 1) * 2^-24`` of the sum over n completions
    (Higham's gamma), plus one rounding of each quotient."""
    bad = {}
    done = state.metrics.tenant_completed.reshape(
        -1, state.metrics.tenant_completed.shape[-1]).sum(0).tolist()
    for k, v in want.items():
        if k.endswith("_e2e_us"):
            n = done[int(k[len("tenant")])]
            if abs(got[k] - v) > (max(n - 1, 0) * 2.0 ** -24
                                  + 2.0 ** -23) * v:
                bad[k] = (got[k], v)
        elif got[k] != v:
            bad[k] = (got[k], v)
    return bad


def counted(fn, launches):
    """``fn()`` with the launch counts reset just before and added to
    ``launches`` just after."""
    import torch

    from repro_torch.kernels import ops

    ops.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    for k, v in ops.LAUNCHES.items():
        launches[k] += v
    return out


def phase_fabric(dev, card, read_rec):
    """The remote fabric, the ready-time lock and the tenant metrics. Figs
    23 and 25 (a remote 4 x 40M array: 8 link bandwidths and 4 RTTs, 7
    switch roofs, 24 rounds), fig 26 (4 WFQ share rows for 192 rounds, 3
    starvation rows for 96) and fig 29 (FIFO and WFQ 2:1 x program and
    ready-time lock, 96 rounds), each graphed at the figure's own
    settings and flags, against ``FABRIC_REFERENCE``; three rows' final
    states against the CPU port's. Fig 24 through the remote 4-drive
    client (n = 4096). ``remote_qos``: graphed against eager with the
    reference's flags, then with main_path_read's flags (its scans and
    the four fabric hops' queueing scans on seg_scan) through both
    runners, timed beside main_path_read, its seg_scan launches a graphed
    round against a local drive's under the same loop, and its state
    against the CPU port's. Last ``case_study(remote=True)`` on 1 and 4
    drives against the same search on the CPU."""
    import torch

    from repro_torch.apps import vector_search as vs
    from repro_torch.bench import local_1drive, remote_qos
    from repro_torch.core import engine
    from repro_torch.core.types import PlatformModel
    from repro_torch.kernels import ops

    launches = dict.fromkeys(ops.LAUNCHES, 0)
    rows, bad = [], {}
    cpu_runs = {}
    for name in FABRIC_CPU_ROWS:
        cell = fabric_cells()[name]
        cpu_runs[name] = cpu_state(*port_cell(cell), cell["rounds"],
                                   cell["devices"])
    _, ssd_q, wl_q = remote_qos()
    cpu_on = cpu_state(remote_qos(**READ_FLAGS)[0], ssd_q, wl_q,
                       FABRIC_ROUNDS)
    t_rows = time.perf_counter()
    for name, cell in fabric_cells().items():
        fig = cell["figure"]
        cfg, ssd, wl = port_cell(cell)
        t0 = time.perf_counter()
        out = counted(lambda: engine.simulate(
            cfg, ssd, wl, rounds=cell["rounds"],
            num_devices=cell["devices"], device=dev), launches)
        wall = time.perf_counter() - t0
        nums = fabric_numbers(fig, out)
        off = fabric_violations(
            fig, nums, FABRIC_REFERENCE[fig][name[len(fig) + 1:]], out)
        rec = {"row": name, **nums, "wall_s_with_capture": wall}
        if name in FABRIC_CPU_ROWS:
            rec["card_vs_cpu_violations"] = card_vs_cpu(out,
                                                        cpu_runs[name])
            if rec["card_vs_cpu_violations"]:
                off["card_vs_cpu"] = rec["card_vs_cpu_violations"]
        if off:
            bad[name] = off
        rows.append(rec)
    rows_s = time.perf_counter() - t_rows

    t0 = time.perf_counter()
    fig24 = counted(lambda: fig24_rows(dev), launches)
    fig24_s = time.perf_counter() - t0
    for name, got in fig24.items():
        off = differing(got, FABRIC_REFERENCE["fig24"][name])
        if off:
            bad[f"fig24_{name}"] = off

    # remote_qos with the reference's flags (every scan on the combine
    # tree), graphed against eager.
    plat = PlatformModel()
    cfg, ssd, wl = remote_qos()
    plain, plain_rec, _ = graphed_run(cfg, ssd, wl, FABRIC_ROUNDS, dev,
                                      reps=1)
    plain_diff, plain_eager_ms = eager_vs_graph(plain, cfg, ssd, wl,
                                                FABRIC_ROUNDS, dev)
    check(not plain_diff, f"remote_qos: graphed and eager states differ in "
                          f"{plain_diff}")
    # ... and with main_path_read's flags, through both runners.
    cfg_on, _, _ = remote_qos(**READ_FLAGS)
    on, on_rec = graph_vs_eager(cfg_on, ssd, wl, plat, dev)
    for k, v in on_rec["launches"].items():
        launches[k] += v
    on_vs_cpu = card_vs_cpu(on, cpu_on)
    check(not on_vs_cpu, f"remote_qos on seg_scan: card and CPU differ: "
                         f"{on_vs_cpu}")
    local_cfg, _ = local_1drive(**READ_FLAGS)
    _, local_rec, local_graph = graphed_run(local_cfg, ssd, wl,
                                            FABRIC_ROUNDS, dev, reps=1)
    remote_scans = on_rec["launches_per_graph"]["seg_scan"]
    local_scans = local_graph["seg_scan"]
    check(remote_scans == local_scans + 4,
          f"seg_scan launches a graphed round: remote_qos {remote_scans}, "
          f"the local loop {local_scans} (four hops add four)")

    searches = []
    scfg = vs.SearchConfig()
    for nd in (1, 4):
        t0 = time.perf_counter()
        got = counted(lambda: vs.case_study(
            n=VS_N, remote=True, num_devices=nd, device=dev), launches)
        wall = time.perf_counter() - t0
        vecs, graph = vs._cached_index(VS_N, scfg.dim, scfg.degree, 0, dev)
        q = vs.case_queries(64, scfg.dim, 0, dev)
        vssd, vecfg = vs.case_configs(VS_N, 2.5e6, fabric=vs.REMOTE_FABRIC)
        cpu = vs.search(q.cpu(), vecs.cpu(), graph.cpu(), scfg, vssd,
                        ecfg=vecfg, num_devices=nd)
        diff = search_differences(got, cpu)
        searches.append({"devices": nd, "n": VS_N, "batch": 64,
                         "t_max_iops": 2.5e6, **search_numbers(got),
                         "wall_s_with_capture": wall,
                         "card_vs_cpu_differing": diff})
        check(not diff, f"remote search over {nd} drives: card and CPU "
                        f"differ: {diff}")

    def speed_of(rec):
        g = rec["graph"]
        return {k: g[k] for k in ("wall_ms_per_round",
                                  "emulated_requests_per_wall_s")} | {
            "device_ms_per_round": g["profiled"]["device_ms_per_round"],
            "device_events_per_round":
                g["profiled"]["device_events_per_round"]}

    emit({"phase": "fabric", "card": card, "rows": rows,
          "rows_s": rows_s, "fig24": fig24, "fig24_s": fig24_s,
          "remote_qos": {
              "flags_off": {**plain_rec,
                            "graph_vs_eager_differing_leaves": plain_diff,
                            "eager_wall_ms_per_round": plain_eager_ms},
              "read_flags": {**on_rec, "card_vs_cpu_violations": on_vs_cpu},
              "local_loop_read_flags": local_rec,
              "seg_scan_launches_per_graphed_round": {
                  "remote_qos": remote_scans, "local_loop": local_scans}},
          "searches": searches, "off_reference": bad,
          "launches": launches})
    emit({"remote_qos_vs_main_path_read": {
        "card": card, "remote_qos": speed_of(on_rec),
        "main_path_read": speed_of(read_rec)}})
    check(not bad, f"fabric rows off the reference: {bad}")
    return launches


# -- phases: the paper's own evaluation and the engine's last variants -------

FIG03_DEPTHS = (8, 32, 128, 512)
FIG10_OUTSTANDING = (256, 1024, 4096, 16384, 32768)
FIG12_UNITS = (1, 2, 4, 8, 16)
FIG12_TARGETS = (5e6, 10e6, 20e6, 30e6, 40e6, 45e6)
FIG13_CASES = (("base", None),
               ("D", dict(coalesced=False, dsa_fetch=False)),
               ("D+A", dict(coalesced=False, dsa_fetch=True)),
               ("D+C", dict(coalesced=True, dsa_fetch=False)),
               ("D+A+C", dict(coalesced=True, dsa_fetch=True)))
FIG14_UNITS = (2, 4, 8, 16)
FIG15_QUEUES = (32, 128, 512, 1024)
FIG15_BLOCKS = (1, 2, 4, 8, 16)
# benchmarks/figures.py::_frontend_only_platform (figs 03 and 13) and fig
# 15's DSA roof of 42 GB/s over 16 engines.
FRONTEND_ONLY = dict(per_req_map_us=0.0, dsa_desc_issue_us=0.0,
                     dsa_batch_setup_us=0.0, dsa_bytes_per_us=1e9,
                     lock_per_req_us=0.085, lock_per_batch_us=0.4)
FIG15_PLATFORM = dict(dsa_bytes_per_us=42000.0 / 16)
SSDS = {"FUTURE_40M": dict(t_max_iops=40e6, l_min_us=30.0),
        "D7_PS1010": dict(t_max_iops=2.47e6, l_min_us=50.0)}


def figure_cells():
    """Every engine run of figs 03, 10 and 12-15 at the figure's own
    settings (``benchmarks/figures.py:27-260``, not quick), as plain data
    that either package builds its configs from: name -> dict(figure, row
    (the row of ``FIGURES_REFERENCE``), engine (``swarmio_cfg`` or
    ``nvmevirt_cfg``), cfg (its overrides), ssd (``FUTURE_40M`` or
    ``D7_PS1010``), ssd_kw (``SSDConfig`` overrides), plat
    (``PlatformModel`` fields), depth (the closed loop's io_depth), rounds,
    read (which numbers the row reads))."""
    cells = {}

    def add(name, figure, row, engine, depth, rounds, read, cfg=None,
            ssd="FUTURE_40M", ssd_kw=None, plat=None):
        cells[name] = dict(figure=figure, row=row, engine=engine,
                           cfg=cfg or {}, ssd=ssd, ssd_kw=ssd_kw or {},
                           plat=plat or {}, depth=depth, rounds=rounds,
                           read=read)

    for d in FIG03_DEPTHS:
        for eng in ("nvmevirt", "swarmio"):
            add(f"fig03_{eng}_{d}", "fig03", f"depth_{d}", eng, d, 32,
                f"{eng}_miops", cfg=dict(transport="host", sq_depth=1024),
                plat=FRONTEND_ONLY)
    for n_out in FIG10_OUTSTANDING:
        depth = max(1, n_out // 32)
        add(f"fig10_{n_out}", "fig10", f"outstanding_{n_out}", "swarmio",
            depth, 48, "fig10", cfg=dict(sq_depth=max(1024, depth)),
            ssd="D7_PS1010")
    add("fig12_nvmevirt", "fig12", "units_0", "nvmevirt", 256, 8,
        "virtual_miops")
    for u in FIG12_UNITS:
        add(f"fig12_units_{u}", "fig12", f"units_{u}", "swarmio", 256, 8,
            "virtual_miops", cfg=dict(num_units=u))
    for t in FIG12_TARGETS:
        add(f"fig12_target_{t / 1e6:g}", "fig12", f"target_{t / 1e6:g}",
            "swarmio", 1024, 64, "sustained", ssd_kw=dict(t_max_iops=t))
    for name, kw in FIG13_CASES:
        add(f"fig13_{name}", "fig13", name,
            "nvmevirt" if kw is None else "swarmio", 1024, 24,
            "frontend_miops",
            cfg={} if kw is None else dict(batched_datapath=False, **kw),
            ssd_kw=dict(t_max_iops=100e6, n_instances=1024),
            plat=FRONTEND_ONLY)
    for u in FIG14_UNITS:
        for mode in ("aggregated", "per_request"):
            add(f"fig14_{mode}_{u}", "fig14", f"units_{u}", "swarmio", 1024,
                32, mode, cfg=dict(num_units=u, mode=mode),
                ssd_kw=dict(t_max_iops=10e6 * u / 4))
    for q in FIG15_QUEUES:
        depth = max(2048 * 32 // q, 8)
        add(f"fig15_queues_{q}", "fig15", f"queues_{q}", "swarmio", depth,
            24, "miops",
            cfg=dict(num_sqs=q, fetch_width=32, sq_depth=max(1024, depth)))
    for nb in FIG15_BLOCKS:
        add(f"fig15_block_{512 * nb}", "fig15", f"block_size_{512 * nb}",
            "swarmio", 1024, 24, "block_size",
            ssd_kw=dict(block_bytes=512 * nb), plat=FIG15_PLATFORM)
    return cells


def figure_config(cell, **flags):
    """The port's (EngineConfig, SSDConfig, WorkloadConfig, PlatformModel)
    of a ``figure_cells`` entry; ``flags`` adds EngineConfig fields."""
    from repro_torch import bench
    from repro_torch.core.types import PlatformModel, WorkloadConfig

    make = (bench.local_1drive if cell["engine"] == "swarmio"
            else bench.nvmevirt_1drive)
    cfg, _ = make(**cell["cfg"], **flags)
    ssd = getattr(bench, cell["ssd"]).replace(**cell["ssd_kw"])
    return (cfg, ssd, WorkloadConfig(io_depth=cell["depth"]),
            PlatformModel(**cell["plat"]))


def figure_numbers(cell, metrics):
    """A row's numbers of a final state's metrics, each computed as
    ``benchmarks/figures.py`` computes it (virtual time: the emulated
    drive's, not a speed of any chip)."""
    iops = float(metrics.iops())
    read = cell["read"]
    ssd = dict(SSDS[cell["ssd"]], **cell["ssd_kw"])
    if read == "fig10":
        n_out = int(cell["row"].split("_")[1])
        ref = min(ssd["t_max_iops"], n_out / (ssd["l_min_us"] * 1e-6))
        return {"device_miops": ref / 1e6, "swarmio_miops": iops / 1e6,
                "rel_err_pct": abs(iops - ref) / ref * 100,
                "avg_e2e_us": float(metrics.avg_e2e_us()),
                "p50_us": float(metrics.p50_us()),
                "p95_us": float(metrics.p95_us()),
                "p99_us": float(metrics.p99_us())}
    if read == "sustained":
        t = ssd["t_max_iops"]
        return {"miops": iops / 1e6, "fraction": iops / t}
    if read in ("aggregated", "per_request"):
        return {"target_miops": ssd["t_max_iops"] / 1e6,
                f"{read}_miops": iops / 1e6}
    if read == "block_size":
        nb = ssd["block_bytes"] // 512
        return {"miops": iops / 1e6, "gbps": iops * 512 * nb / 1e9}
    return {read: iops / 1e6}


def fig04_numbers():
    """Fig 04's closed form (``benchmarks/figures.py:52-67``) from the
    port's ``PlatformModel()``: map/unmap and copy us of the baseline's
    GPU-initiated copy path, map's share, the batched DSA path's us and
    the per-request speedup."""
    from repro_torch.core.types import PlatformModel

    plat = PlatformModel()
    txn = plat.txn_base_us + 512 / plat.link_bytes_per_us
    total = plat.per_req_map_us + txn
    dsa = plat.dsa_desc_issue_us + plat.dsa_batch_setup_us / 16 \
        + 512 / plat.dsa_bytes_per_us
    return {"map_us": plat.per_req_map_us, "copy_us": txn,
            "map_fraction": plat.per_req_map_us / total,
            "dsa_batched_us": dsa, "per_req_speedup": total / dsa}


# The averages the reference adds in another order (its float32 running
# sums), held to SUM_ULP of the recorded value; every other number to the
# last digit.
FIGURE_AVERAGES = ("avg_e2e_us",)
SUM_ULP = 16
FIGURE_CPU_ROWS = ("fig03_nvmevirt_8", "fig10_256", "fig12_units_1",
                   "fig13_D+A+C", "fig14_aggregated_2", "fig15_block_512")
FIGURE_FLAG_ROWS = ("fig10_256", "fig14_aggregated_2")


# The reference's numbers of figs 03, 04, 10 and 12-15 at their own
# settings: the rows of the CSVs that
#     BENCH_OUT=<dir> PYTHONPATH=src python -m benchmarks.run --only figNN
# wrote for fig03, fig04, fig10, fig12, fig13, fig14 and fig15 (not quick),
# run with the JAX package on a CPU at commit 0a5cc64, each row keyed as
# ``figure_cells`` keys it (fig 12's wall-clock columns, which time that
# host, are left out). Virtual time: numbers of the emulated drive,
# deterministic, not speeds of any chip.
FIGURES_REFERENCE = {
    "fig03": {
        "depth_8": dict(nvmevirt_miops=3.79064325, swarmio_miops=5.8833915),
        "depth_32": dict(nvmevirt_miops=5.6538575, swarmio_miops=23.525898),
        "depth_128": dict(nvmevirt_miops=6.4021795, swarmio_miops=38.7489),
        "depth_512": dict(nvmevirt_miops=6.4021795, swarmio_miops=39.262432),
    },
    "fig04": {
        "closed_form": dict(map_us=2.9, copy_us=0.316,
                            map_fraction=0.9017412935323383,
                            dsa_batched_us=0.05269166666666667,
                            per_req_speedup=61.034319152301116),
    },
    "fig10": {
        "outstanding_256": dict(device_miops=2.47, swarmio_miops=2.068867875,
                                rel_err_pct=16.240167004048583,
                                avg_e2e_us=115.77111053466797,
                                p50_us=117.57432556152344,
                                p95_us=140.7464599609375,
                                p99_us=140.7464599609375),
        "outstanding_1024": dict(device_miops=2.47, swarmio_miops=2.352694,
                                 rel_err_pct=4.74923076923077,
                                 avg_e2e_us=348.1757507324219,
                                 p50_us=414.1784362792969,
                                 p95_us=414.1784362792969,
                                 p99_us=495.80682373046875),
        "outstanding_4096": dict(device_miops=2.47, swarmio_miops=2.41947925,
                                 rel_err_pct=2.0453744939271252,
                                 avg_e2e_us=1085.333251953125,
                                 p50_us=1218.814208984375,
                                 p95_us=1746.5760498046875,
                                 p99_us=1746.5760498046875),
        "outstanding_16384": dict(device_miops=2.47, swarmio_miops=2.4539005,
                                  rel_err_pct=0.6518016194331984,
                                  avg_e2e_us=3623.385986328125,
                                  p50_us=3586.6376953125,
                                  p95_us=6152.654296875,
                                  p99_us=6152.654296875),
        "outstanding_32768": dict(device_miops=2.47, swarmio_miops=2.4615595,
                                  rel_err_pct=0.3417206477732793,
                                  avg_e2e_us=6916.1416015625, p50_us=7365.25,
                                  p95_us=12634.62890625,
                                  p99_us=12634.62890625),
    },
    "fig12": {
        "units_0": dict(virtual_miops=0.0752517109375),
        "units_1": dict(virtual_miops=9.922327),
        "units_2": dict(virtual_miops=16.002001),
        "units_4": dict(virtual_miops=22.532302),
        "units_8": dict(virtual_miops=28.308566),
        "units_16": dict(virtual_miops=32.834118),
        "target_5": dict(miops=4.9403115, fraction=0.9880623),
        "target_10": dict(miops=9.879422, fraction=0.9879422),
        "target_20": dict(miops=19.59205, fraction=0.9796025),
        "target_30": dict(miops=29.18038, fraction=0.9726793333333333),
        "target_40": dict(miops=38.660144, fraction=0.9665036),
        "target_45": dict(miops=43.424596, fraction=0.9649910222222222),
    },
    "fig13": {
        "base": dict(frontend_miops=0.096111),
        "D": dict(frontend_miops=1.5000465),
        "D+A": dict(frontend_miops=3.85764875),
        "D+C": dict(frontend_miops=7.751368),
        "D+A+C": dict(frontend_miops=47.700196),
    },
    "fig14": {
        "units_2": dict(target_miops=5.0, aggregated_miops=4.571787,
                        per_request_miops=3.572584),
        "units_4": dict(target_miops=10.0, aggregated_miops=9.393552,
                        per_request_miops=7.114146),
        "units_8": dict(target_miops=20.0, aggregated_miops=19.018744,
                        per_request_miops=9.850856),
        "units_16": dict(target_miops=40.0, aggregated_miops=38.308808,
                         per_request_miops=10.593315),
    },
    "fig15": {
        "queues_32": dict(miops=18.125096),
        "queues_128": dict(miops=19.61239),
        "queues_512": dict(miops=16.414801),
        "queues_1024": dict(miops=16.500257),
        "block_size_512": dict(miops=37.318796, gbps=19.107223552),
        "block_size_1024": dict(miops=35.55036, gbps=36.40356864),
        "block_size_2048": dict(miops=19.044238, gbps=39.002599424),
        "block_size_4096": dict(miops=9.874619, gbps=40.446439424),
        "block_size_8192": dict(miops=5.03042, gbps=41.20920064),
    },
}


def figure_violations(got, want):
    """The numbers of a row off the recorded ones: every number to the
    last digit but the averages of ``FIGURE_AVERAGES``, within ``SUM_ULP``
    float32 ULP (the reference adds each running sum in another order)."""
    import numpy as np

    bad = {}
    for k, v in want.items():
        if k in FIGURE_AVERAGES:
            a, b = np.array([got[k], v], np.float32).view(np.int32)
            if abs(int(a) - int(b)) > SUM_ULP:
                bad[k] = (got[k], v)
        elif got.get(k) != v:
            bad[k] = (got.get(k), v)
    return bad


def phase_figures(dev, card):
    """The paper's own evaluation at its settings. Every engine run of
    figs 03, 10 and 12-15 (``figure_cells``: 47 runs) graphed through
    ``make_runner`` with the reference's flags (all kernel flags off), and
    fig 04's closed form, against ``FIGURES_REFERENCE``; one run of each
    engine figure against the CPU port's final state, and fig 10's and
    fig 14's first runs again with main_path_read's flags against the CPU
    port's with the same flags. Fig 12 (a)'s graphed requests a
    wall-second (two timed calls after the capture) are written down, not
    compared. The paper's ratios (fig 12's achieved IOPS over NVMeVirt's,
    fig 13's D+A+C over base, fig 14's aggregated over per-request at 16
    units) are printed from the card's numbers."""
    from repro_torch.core import engine
    from repro_torch.kernels import ops

    launches = dict.fromkeys(ops.LAUNCHES, 0)
    t_phase = time.perf_counter()
    rows, records = {}, []
    cpu_runs = {}
    for name, cell in figure_cells().items():
        cfg, ssd, wl, plat = figure_config(cell)
        if name in FIGURE_CPU_ROWS:
            cpu_runs[name] = cpu_state(cfg, ssd, wl, cell["rounds"],
                                       plat=plat)
        if name in FIGURE_FLAG_ROWS:
            cpu_runs[name, "flags"] = cpu_state(
                figure_config(cell, **READ_FLAGS)[0], ssd, wl,
                cell["rounds"], plat=plat)
    for name, cell in figure_cells().items():
        cfg, ssd, wl, plat = figure_config(cell)
        t0 = time.perf_counter()
        state = engine.init_state(cfg, ssd, wl, device=dev)
        runner = engine.make_runner(cfg, ssd, wl, plat, cell["rounds"],
                                    device=dev)
        out = counted(lambda: runner(state), launches)
        nums = figure_numbers(cell, out.metrics)
        rec = {"cell": name, **nums,
               "wall_s_with_capture": time.perf_counter() - t0}
        if cell["figure"] == "fig12" and cell["read"] == "virtual_miops":
            _, walls = counted(lambda: timed_runs(lambda: runner(state), 2),
                               launches)
            rec["graphed_requests_per_wall_s"] = (
                float(out.metrics.completed) / statistics.median(walls))
            rec["graphed_wall_s_runs"] = walls
        if name in FIGURE_CPU_ROWS:
            rec["card_vs_cpu_violations"] = card_vs_cpu(out,
                                                        cpu_runs[name])
        if name in FIGURE_FLAG_ROWS:
            cfg_on, _, _, _ = figure_config(cell, **READ_FLAGS)
            on = counted(lambda: engine.make_runner(
                cfg_on, ssd, wl, plat, cell["rounds"], device=dev)(
                engine.init_state(cfg_on, ssd, wl, device=dev)), launches)
            rec["read_flags_card_vs_cpu_violations"] = card_vs_cpu(
                on, cpu_runs[name, "flags"])
        rows.setdefault(cell["figure"], {}).setdefault(cell["row"], {}) \
            .update(nums)
        records.append(rec)
    rows["fig04"] = {"closed_form": fig04_numbers()}

    bad = {}
    for fig, want_rows in FIGURES_REFERENCE.items():
        for row, want in want_rows.items():
            off = figure_violations(rows.get(fig, {}).get(row, {}), want)
            if off:
                bad[f"{fig}/{row}"] = off
    for rec in records:
        for k in ("card_vs_cpu_violations",
                  "read_flags_card_vs_cpu_violations"):
            if rec.get(k):
                bad[f"{rec['cell']}/{k}"] = rec[k]

    f12, f13, f14 = rows["fig12"], rows["fig13"], rows["fig14"]
    best = max(f12[f"units_{u}"]["virtual_miops"] for u in FIG12_UNITS)
    ratios = {
        "fig12_achieved_iops_over_nvmevirt":
            best / f12["units_0"]["virtual_miops"],
        "fig13_d_a_c_over_base":
            f13["D+A+C"]["frontend_miops"] / f13["base"]["frontend_miops"],
        "fig14_aggregated_over_per_request_16_units":
            f14["units_16"]["aggregated_miops"]
            / f14["units_16"]["per_request_miops"],
    }
    emit({"phase": "figures", "card": card, "rows": rows,
          "records": records, "paper_ratios": ratios,
          "off_reference": bad, "launches": launches,
          "phase_s": time.perf_counter() - t_phase})
    check(not bad, f"figure rows off the reference: {bad}")
    return launches


SKEW_CFG = dict(num_sqs=8, sq_depth=256, fetch_width=64, num_units=8,
                workers_per_unit=2, num_bufs=512, emulate_data=False)
SKEW_SSD = dict(t_max_iops=1e7, l_min_us=30.0, n_instances=64,
                num_blocks=1 << 12)
SKEW_ROUNDS = 48


def skewed_state(cfg, ssd, device):
    """``tests/test_engine.py``'s skewed load: io_depth 256 prefilled, then
    every SQ but SQ 0 emptied (all load on one unit)."""
    import dataclasses

    from repro_torch.core import engine
    from repro_torch.core.types import WorkloadConfig

    st = engine.init_state(cfg, ssd, WorkloadConfig(io_depth=256),
                           device=device)
    r = st.rings
    tail, submit = r.tail.clone(), r.submit_time.clone()
    tail[1:] = r.head[1:]
    submit[1:] = 3e38
    return dataclasses.replace(st, rings=dataclasses.replace(
        r, submit_time=submit, tail=tail))


def tree_differences(a, b):
    """Indices of the leaves in which two trees of tensors (dataclasses and
    tuples of them) differ, bit for bit, dtype and shape included; the
    second tree's leaves are moved to the first's device."""
    from repro_torch.cuda_graph import leaves

    def flat(t):
        if isinstance(t, tuple):
            return [x for part in t for x in flat(part)]
        return leaves(t)

    la, lb = flat(a), flat(b)
    return [i for i, (x, y) in enumerate(zip(la, lb))
            if not bitwise_equal(x, y.to(x.device))] + (
        ["count"] if len(la) != len(lb) else [])


def phase_variants(dev, card):
    """The engine's last variants on the card. ``tests/test_engine.py``'s
    skewed load (all of it on one of 8 units, 48 rounds) under the global
    and the local timing scope: graphed equal to eager, card equal to the
    CPU port, global IOPS over twice the local. Stock ``local_1drive``
    (depth 256, 24 rounds) graphed sanitized and unsanitized: bit-identical
    final states, and the device ms and events the checks add to a round;
    the same drive under the ready-time lock (whose admission permutation
    the checks also read), sanitized and unsanitized, bit-identical.
    A local-scope, sanitized 2-drive ``simulate`` against the CPU port. A
    fetched batch with one out-of-range SQ id through ``process`` with the
    flags given: ``SanitizeError`` naming the SQ id, and the sanitized
    runner then still gives its earlier state. One ``_submit_direct``
    call of 8192 rows against the CPU port's, bit for bit."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import convert
    from repro_torch.bench import local_1drive
    from repro_torch.core import device as devmod
    from repro_torch.core import engine, frontend
    from repro_torch.core.types import (EngineConfig, PlatformModel,
                                        SSDConfig, WorkloadConfig)
    from repro_torch.kernels import ops

    launches = dict.fromkeys(ops.LAUNCHES, 0)
    t_phase = time.perf_counter()
    plat = PlatformModel()
    bad = {}

    skew = {}
    ssd = SSDConfig(**SKEW_SSD)
    wl1 = WorkloadConfig(io_depth=1)
    for scope in ("global", "local"):
        cfg = EngineConfig(**SKEW_CFG, timing_scope=scope)
        runner = engine.make_runner(cfg, ssd, wl1, plat, SKEW_ROUNDS,
                                    device=dev)
        graphed = counted(lambda: runner(skewed_state(cfg, ssd, dev)),
                          launches)
        eager = counted(lambda: engine.run(skewed_state(cfg, ssd, dev), cfg,
                                           ssd, wl1, plat, SKEW_ROUNDS),
                        launches)
        cpu = engine.run(skewed_state(cfg, ssd, "cpu"), cfg, ssd, wl1, plat,
                         SKEW_ROUNDS)
        g_np = convert.engine_state_to_numpy(graphed)
        skew[scope] = {
            "virtual_miops": float(graphed.metrics.iops()) / 1e6,
            "graph_vs_eager_differing_leaves": convert.leaf_differences(
                convert.engine_state_to_numpy(eager), g_np),
            "card_vs_cpu_violations": convert.leaf_differences(
                convert.engine_state_to_numpy(cpu), g_np,
                dict.fromkeys(SUM_LEAVES, SUM_LEAF_ULP))}
        for k in ("graph_vs_eager_differing_leaves",
                  "card_vs_cpu_violations"):
            if skew[scope][k]:
                bad[f"skew_{scope}/{k}"] = skew[scope][k]
    g, loc = skew["global"]["virtual_miops"], skew["local"]["virtual_miops"]
    if not g > 2 * loc:
        bad["skew_global_over_local"] = (g, loc)

    cfg, ssd40 = local_1drive()
    wl = WorkloadConfig(io_depth=256)
    state = engine.init_state(cfg, ssd40, wl, device=dev)
    outs, speeds, runners = {}, {}, {}
    for s in (False, True):
        runners[s] = engine.make_runner(cfg, ssd40, wl, plat, ROUNDS,
                                        device=dev, sanitize=s)
        outs[s] = counted(lambda: runners[s](state), launches)
        _, walls = timed_runs(lambda: runners[s](state), 3)
        prof = profiled_window(lambda: runners[s](state), ROUNDS)
        speeds["sanitized" if s else "unsanitized"] = {
            "wall_ms_per_round": statistics.median(walls) * 1e3 / ROUNDS,
            **profile_summary(statistics.median(walls) * 1e3 / ROUNDS,
                              prof)}
    san = convert.leaf_differences(convert.engine_state_to_numpy(outs[False]),
                                   convert.engine_state_to_numpy(outs[True]))
    if san:
        bad["sanitized_vs_unsanitized"] = san
    rcfg = cfg.replace(lock_order="ready_time")
    rstate = engine.init_state(rcfg, ssd40, wl, device=dev)
    ready = [convert.engine_state_to_numpy(counted(
        lambda: engine.make_runner(rcfg, ssd40, wl, plat, ROUNDS, device=dev,
                                   sanitize=s)(rstate), launches))
        for s in (False, True)]
    ready_san = convert.leaf_differences(*ready)
    if ready_san:
        bad["ready_time_sanitized_vs_unsanitized"] = ready_san
    on, off = (speeds[k]["profiled"] for k in ("sanitized", "unsanitized"))
    added = {k: on[k] - off[k] for k in ("device_ms_per_round",
                                         "device_events_per_round")}

    lcfg = cfg.replace(timing_scope="local", sanitize=True)
    arr = counted(lambda: engine.simulate(lcfg, ssd40, wl, plat, rounds=8,
                                          num_devices=2, device=dev),
                  launches)
    arr_viol = card_vs_cpu(arr, cpu_state(lcfg, ssd40, wl, 8, 2))
    if arr_viol:
        bad["local_sanitized_array"] = arr_viol

    scfg = cfg.replace(sanitize=True)
    st = engine.init_state(scfg, ssd40, wl, device=dev)
    pipe = devmod.DevicePipeline(scfg, ssd40, plat)
    unit = frontend.fetch_row_units(scfg, dev)
    _, disp, batch, fetch_done = frontend.fetch(
        st.rings, st.clock, st.device.disp_time, scfg, plat)
    dstate = dataclasses.replace(st.device, disp_time=disp)
    flags = devmod.new_flags(dev)
    pipe.process(dstate, batch, fetch_done, unit, st.cq, ring_layout=True,
                 flags=flags)
    clean_bits = int(flags.item())
    sq_id, valid = batch.sq_id.clone(), batch.valid.clone()
    sq_id[0], valid[0] = scfg.num_sqs + 3, True
    pipe.process(dstate, dataclasses.replace(batch, sq_id=sq_id, valid=valid),
                 fetch_done, unit, st.cq, ring_layout=True, flags=flags)
    try:
        devmod.raise_if_flagged(flags)
        caught = None
    except devmod.SanitizeError as e:
        caught = str(e)
    if clean_bits or not (caught and "SQ id" in caught):
        bad["injected_sq_id"] = (clean_bits, caught)
    again = counted(lambda: runners[True](state), launches)
    after = convert.leaf_differences(convert.engine_state_to_numpy(outs[True]),
                                     convert.engine_state_to_numpy(again))
    if after:
        bad["run_after_injection"] = after

    rng = np.random.default_rng(0)
    n = 8192
    host = dict(
        lba=torch.from_numpy(rng.integers(0, 1 << 14, n).astype(np.int32)),
        t=torch.from_numpy((100 + 40 * rng.random(n)).astype(np.float32)),
        valid=torch.from_numpy(rng.random(n) < 0.85),
        opcode=torch.from_numpy((rng.random(n) < 0.3).astype(np.int32)))
    results = {}
    for key, where in (("card", dev), ("cpu", torch.device("cpu"))):
        x = {k: v.to(where) for k, v in host.items()}
        b = devmod.make_direct_batch(x["lba"], x["t"], x["valid"],
                                     x["opcode"])
        p = devmod.DevicePipeline(cfg, ssd40, plat)
        results[key] = counted(
            lambda: p._submit_direct(p.init_state(where), b), launches)
    direct = tree_differences(results["cpu"], results["card"])
    if direct:
        bad["submit_direct_card_vs_cpu"] = direct

    emit({"phase": "variants", "card": card, "skewed_load": skew,
          "sanitizer": {**speeds, "added_per_round": added,
                        "sanitized_vs_unsanitized_differing_leaves": san,
                        "ready_time_sanitized_vs_unsanitized_differing_leaves":
                            ready_san},
          "local_sanitized_array_card_vs_cpu_violations": arr_viol,
          "injected_sq_id": {"clean_bits": clean_bits, "raised": caught,
                             "run_after_differing_leaves": after},
          "submit_direct_card_vs_cpu_differing": direct,
          "off_reference": bad, "launches": launches,
          "phase_s": time.perf_counter() - t_phase})
    check(not bad, f"variants off: {bad}")
    return launches


# -- phases: the serving path -------------------------------------------------

# The reference's kv_tier.decode_tokens_per_s at the serve command's
# starcoder2-3b full-width settings (KVTierConfig(hot_window=16,
# page_tokens=8); SSDConfig(t_max_iops=40e6, n_instances=1000,
# num_blocks=1<<14); EngineConfig(num_units=4, fetch_width=64); batch 4,
# prompt 32, 16 steps), run with the JAX package on a CPU. Virtual time:
# numbers of the emulated drive, deterministic, not speeds of any chip.
TIER_REFERENCE = {
    "tokens_per_s": 2094.0494563255083,
    "avg_step_us": 1910.174560546875,
    "iops_demand": 2638502.3149701403,
}
TIER_REL_TOL = 1e-5
LOGIT_REL_BOUND = 0.05      # max |diff| <= 0.05 * max |logits|, per step
LOGIT_MIN_COSINE = 0.999    # cosine of the two runs' logits, per step
LEFT_BYTES_BOUND = 64 << 20  # device bytes a serving phase may leave behind


def tier_cache_sweep(dev):
    """Fig 28's hot-window x cache sweep on the card (the settings of
    ``TIER_CACHE_REFERENCE``): each point's numbers and wall seconds, and
    the points off the reference beyond ``TIER_REL_TOL``."""
    import torch

    from repro_torch import configs
    from repro_torch.core.types import CacheConfig, EngineConfig, SSDConfig
    from repro_torch.serving import kv_tier

    model = configs.get_config("yi-34b", smoke=True)
    ssd = SSDConfig(t_max_iops=2.5e6, l_min_us=30.0, n_instances=64,
                    num_blocks=1 << 14)
    points, bad = [], {}
    for hw in (32, 64, 128):
        for name, kw in TIER_CACHES.items():
            t0 = time.perf_counter()
            r = kv_tier.decode_tokens_per_s(
                model, kv_tier.KVTierConfig(page_tokens=16, hot_window=hw,
                                            gpu_step_us=100.0), ssd,
                EngineConfig(num_units=8, fetch_width=64,
                             cache=CacheConfig(**kw)),
                batch=4, start_len=512, n_steps=16, device=dev)
            torch.cuda.synchronize()
            key = f"hw{hw}_cache_{name}"
            rel = {k: abs(r[k] - v) / v
                   for k, v in TIER_CACHE_REFERENCE[key].items()}
            if r["data_check_max_abs"] != 0.0 or any(
                    v > TIER_REL_TOL for v in rel.values()):
                bad[key] = rel
            points.append({"point": key, **{k: r[k] for k in (
                "tokens_per_s", "avg_storage_us", "blocks_per_step",
                "data_check_max_abs")}, "rel_to_reference": rel,
                "wall_s": time.perf_counter() - t0})
    return points, bad


def phase_serve_tier(dev, card):
    """The objects ``launch/serve.py`` builds for --arch starcoder2-3b
    --iops 40e6 (full width, batch 4, prompt 32, 16 tokens), attention
    kernels on: generation plus the KV tier through the engine pipeline,
    then the tier again with fused_reap on."""
    import torch

    from repro_torch.core.types import EngineConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.serving import kv_tier
    from repro_torch.serving import loop as serve_loop

    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(dev)
    cfg, params, tokens, ssd, scfg = serve.setup(
        "starcoder2-3b", iops=40e6, device=str(dev))
    cfg = cfg.replace(use_pallas=True)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    out = serve_loop.serve_with_kv_tier(cfg, params, tokens, scfg, ssd)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    toks = out["tokens"]
    check(toks.shape == (scfg.batch, scfg.gen_tokens)
          and toks.dtype == torch.int32,
          f"tokens {tuple(toks.shape)} {toks.dtype}")
    check(bool(((toks >= 0) & (toks < cfg.vocab)).all()), "token out of range")
    check(out["data_check_max_abs"] == 0.0, "KV tier data check failed")
    check(out["blocks_per_step"] == 5040.0,
          f"blocks_per_step {out['blocks_per_step']}")
    rel = {k: abs(out[k] - v) / v for k, v in TIER_REFERENCE.items()}
    check(all(r <= TIER_REL_TOL for r in rel.values()),
          f"tier stats off the reference: {rel}")
    for k in ("flash_attention", "decode_attention"):
        check(launches[k] > 0, f"{k} did not launch on the serving path")

    ecfg = EngineConfig(num_units=4, fetch_width=64, use_pallas_reap=True)
    ops.reset_launches()
    reap = kv_tier.decode_tokens_per_s(
        cfg, scfg.tier, ssd, ecfg, batch=scfg.batch,
        start_len=scfg.prompt_len, n_steps=scfg.gen_tokens, device=dev)
    reap_launches = dict(ops.LAUNCHES)
    check(reap_launches["fused_reap"] > 0, "fused_reap did not launch")
    stats = {k: out[k] for k in reap}
    check(reap == stats, f"fused_reap changed the tier: {reap} vs {stats}")
    prefill_s, decode_s = out["prefill_s"], out["wall_s"]
    first_row = toks[0].tolist()
    sweep, sweep_bad = tier_cache_sweep(dev)
    ops.reset_launches()
    t0 = time.perf_counter()
    mix = tenant_mix(dev)
    torch.cuda.synchronize()
    mix_s = time.perf_counter() - t0
    mix_launches = dict(ops.LAUNCHES)
    mix_rel = {name: {k: abs(got[k] - v) / v for k, v in
                      FABRIC_REFERENCE["fig28"][name].items()}
               for name, got in mix.items()}
    mix_bad = {name: rel for name, rel in mix_rel.items()
               if mix[name]["data_check_max_abs"] != 0.0
               or any(v > TIER_REL_TOL for v in rel.values())}
    del params, tokens, out, toks
    torch.cuda.synchronize()
    left = torch.cuda.memory_allocated(dev) - held
    emit({"phase": "serve_tier", "card": card, "arch": cfg.name,
          "stats": stats, "rel_to_reference": rel,
          "tokens_first_row": first_row,
          "prefill_s": prefill_s, "decode_wall_s": decode_s,
          "wall_s_total": wall, "launches": launches,
          "reap_run_launches": reap_launches, "reap_run_identical": True,
          "fig28_hot_window_x_cache": sweep,
          "fig28_tenant_mix": {name: {**mix[name],
                                      "rel_to_reference": mix_rel[name]}
                               for name in mix},
          "fig28_tenant_mix_s": mix_s,
          "allocated_bytes_left_after_phase": left})
    check(not sweep_bad, f"fig 28's cache sweep off the reference: "
                         f"{sweep_bad}")
    check(not mix_bad, f"fig 28's tenant mix off the reference: {mix_bad}")
    # The phase's weights alone are 6 GB. What may outlive it: the
    # capture stream's cuBLAS workspace (32 MiB, once a process) and the
    # engine's cached device constants (kilobytes).
    check(left <= LEFT_BYTES_BOUND,
          f"serve_tier left {left} bytes allocated on the card")
    torch.cuda.empty_cache()
    return {k: launches[k] + reap_launches[k] + mix_launches[k]
            for k in launches}


def phase_serve_long(dev, card, batch=8, prompt=4096, gen=128,
                     prof_steps=8):
    """generate at full width (batch 8, prompt 4096, 128 tokens: cache
    4224) with the kernels on, its decode step a CUDA graph (each
    generate runs its first step eagerly, captures, then replays), run
    twice, the second timed; peak device memory over the first. The same
    decode as an eager loop of ``transformer.decode_step`` from the same
    prefill, timed: the tokens must be equal and the logits bit-identical
    at every step (were they not, the phase names the first step that
    differs and holds both to the plain path's rule below). Then a
    ``DecodeStep`` of the phase's own on those caches: its first step and
    capture, then 126 replays, timed, which must give generate's tokens.
    Device ms a step of the eager and the graphed step from a profiler
    window of ``prof_steps`` steps, and the profiler's proof that a
    graphed step is one graph launch. Then the plain path, teacher-forced
    on the kernel run's tokens, must agree on the prefill's and every
    decode step's logits."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import transformer
    from repro_torch.serving import loop as serve_loop

    cfg, params, tokens, _, scfg = serve.setup(
        "starcoder2-3b", batch=batch, prompt=prompt, gen=gen, iops=40e6,
        device=str(dev))
    kern_cfg = cfg.replace(use_pallas=True)
    cache_len = prompt + gen
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    out = serve_loop.generate(kern_cfg, params, tokens, scfg,
                              keep_logits=True)
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    check(launches["flash_attention"] == cfg.n_layers
          and launches["decode_attention"] == cfg.n_layers * (gen - 1),
          f"unexpected launch counts {launches}")
    again = serve_loop.generate(kern_cfg, params, tokens, scfg)
    check(bool(torch.equal(again["tokens"], out["tokens"])),
          "a second graphed generate gave other tokens")

    # The eager decode loop from the same prefill.
    with torch.no_grad():
        logits, caches = transformer.prefill(params, kern_cfg, tokens,
                                             cache_len=cache_len)
        positions = torch.arange(cache_len, dtype=torch.int32, device=dev)
        toks, kept = [torch.argmax(logits, dim=-1).to(torch.int32)], [logits]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(gen - 1):
            lg, _ = transformer.decode_step(params, kern_cfg, toks[-1],
                                            caches, positions[prompt + i])
            toks.append(torch.argmax(lg, dim=-1).to(torch.int32))
            kept.append(lg)
        torch.cuda.synchronize()
        eager_wall = time.perf_counter() - t0
    check(bool(torch.equal(torch.stack(toks, dim=1), out["tokens"])),
          "graphed and eager decode gave other tokens")
    same = [bitwise_equal(a, b) for a, b in zip(kept, out["logits"])]
    first_diff = None if all(same) else same.index(False)
    graph_vs_eager = {"logits_bit_identical_steps": sum(same),
                      "steps": len(same), "first_differing_step": first_diff}
    if first_diff is not None:
        rel = max(float((a - b).abs().max() / a.abs().max())
                  for a, b in zip(kept, out["logits"]))
        cos = min(float(torch.nn.functional.cosine_similarity(
            a.reshape(1, -1).double(), b.reshape(1, -1).double()))
            for a, b in zip(kept, out["logits"]))
        graph_vs_eager.update(worst_max_abs_over_max_logit=rel,
                              worst_cosine=cos)
        check(rel <= LOGIT_REL_BOUND and cos >= LOGIT_MIN_COSINE,
              f"graphed and eager logits disagree: {graph_vs_eager}")

    with torch.no_grad():
        def eager_steps():
            for i in range(prof_steps):
                transformer.decode_step(params, kern_cfg, toks[i], caches,
                                        positions[prompt + i])

        eager_prof = profiled_window(eager_steps, prof_steps)
        # The graphed step on the same caches: the eager first step and
        # the capture, then the remaining gen - 2 steps as replays, timed.
        step = serve_loop.DecodeStep(kern_cfg, params, caches, batch,
                                     cache_len, dev)
        step.start(toks[0], prompt)
        step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(gen - 2):
            step()
        torch.cuda.synchronize()
        graph_wall = time.perf_counter() - t0
        check(bool(torch.equal(step.tokens[:, prompt:], out["tokens"])),
              "replays of the phase's own graphed step gave other tokens")
        step.start(toks[0], prompt)

        def graph_steps():
            for _ in range(prof_steps):
                step()

        graph_prof = profiled_window(graph_steps, prof_steps)
        step.start(toks[0], prompt)
        calls = graph_proof(step)

    plain_cfg = cfg.replace(use_pallas=False)
    toks = out["tokens"]
    worst_rel, worst_cos, steps = 0.0, 1.0, []
    with torch.no_grad():
        logits, caches = transformer.prefill(params, plain_cfg, tokens,
                                             cache_len=cache_len)
        for i in range(gen):
            if i:
                logits, caches = transformer.decode_step(
                    params, plain_cfg, toks[:, i - 1], caches, prompt + i - 1)
            k = out["logits"][i]
            check(bool(torch.isfinite(k).all()), f"step {i}: logits not finite")
            rel = float((k - logits).abs().max() / k.abs().max())
            cos = float(torch.nn.functional.cosine_similarity(
                k.reshape(1, -1).double(), logits.reshape(1, -1).double()))
            row_cos = float(torch.nn.functional.cosine_similarity(
                k.double(), logits.double(), dim=1).min())
            steps.append((rel, cos, row_cos))
            worst_rel, worst_cos = max(worst_rel, rel), min(worst_cos, cos)
    ok = worst_rel <= LOGIT_REL_BOUND and worst_cos >= LOGIT_MIN_COSINE
    prefill_ms = again["prefill_s"] * 1e3
    decode_ms = again["wall_s"] * 1e3 / (gen - 1)

    def per_step(wall_ms, prof):
        return {"wall_ms_per_step": wall_ms,
                **profile_summary(wall_ms, prof)}

    emit({"phase": "serve_long", "card": card, "arch": cfg.name,
          "batch": batch, "prompt": prompt, "gen": gen,
          "prefill_ms": prefill_ms, "decode_ms_per_step": decode_ms,
          "graph_device_ms_per_step": graph_prof["device_ms_per_round"],
          "graph_wall_ms_per_step": graph_wall * 1e3 / (gen - 2),
          "graph": per_step(graph_wall * 1e3 / (gen - 2), graph_prof),
          "eager": per_step(eager_wall * 1e3 / (gen - 1), eager_prof),
          "graph_vs_eager": graph_vs_eager,
          "graphed_step_host_calls": calls,
          "launches_per_graph": step.graph.launches,
          "generated_tokens_per_wall_s":
              batch * gen / (again["prefill_s"] + again["wall_s"]),
          "decode_tokens_per_wall_s": batch * (gen - 1) / again["wall_s"],
          "max_memory_allocated_bytes": peak, "launches": launches,
          "bound": {"max_abs_over_max_logit": LOGIT_REL_BOUND,
                    "min_cosine": LOGIT_MIN_COSINE},
          "worst_max_abs_over_max_logit": worst_rel,
          "worst_cosine": worst_cos,
          "worst_row_cosine": min(c for _, _, c in steps),
          "prefill_step": steps[0],
          "tokens_first_row_head": toks[0, :16].tolist()})
    check(ok, f"plain and kernel logits disagree: max rel {worst_rel}, "
              f"min cosine {worst_cos}")
    del params, out, again, caches, step
    torch.cuda.empty_cache()
    return launches


# -- phase: every architecture on the serving path ---------------------------

# The reference's kv_tier.decode_tokens_per_s at the serve command's
# settings for the two architectures served through it (KVTierConfig(
# hot_window=16, page_tokens=8); SSDConfig(t_max_iops=2.5e6,
# n_instances=64, num_blocks=1<<14); EngineConfig(num_units=4,
# fetch_width=64); 16 steps): recurrentgemma-9b at the defaults (batch 4,
# prompt 32), qwen2-moe-a2.7b at --batch 1 --prompt 24. A step submits
# 2·b·pages·layers·blocks ops (every read and write slot, valid or not);
# qwen2-moe's 128 blocks a page over 24 layers fit the 32768-entry rings
# only at b·pages <= 5, and prompt 32 + 16 tokens is 6 pages. Run with the
# JAX package on a CPU. Virtual time.
ARCH_TIER_REFERENCE = {
    "recurrentgemma-9b": {
        "tokens_per_s": 948.0161500661425,
        "avg_step_us": 4219.33740234375,
        "iops_demand": 1513033.7755055635,
    },
    "qwen2-moe-a2.7b": {
        "tokens_per_s": 238.38102040113193,
        "avg_step_us": 4194.96484375,
        "iops_demand": 1189998.0538424505,
    },
}
# (arch, batch, prompt, layers kept or None for all, served through
# launch.serve).
# qwen3-moe-30b-a3b's 48 layers are 61 GB of bf16 weights and qwen2-vl-72b's
# 80 are 145 GB: both keep every width, expert count and top-k, and run 8
# and 2 layers.
SERVE_ARCHS = (
    ("recurrentgemma-9b", 4, 32, None, True),
    ("qwen2-moe-a2.7b", 1, 24, None, True),
    ("xlstm-1.3b", 4, 32, None, False),
    ("musicgen-large", 4, 32, None, False),
    ("qwen3-moe-30b-a3b", 4, 32, 8, False),
    ("qwen2-vl-72b", 4, 32, 2, False),
)
VL_IMAGE_TOKENS = 8          # qwen2-vl's prompt: 8 image tokens of the 32
# The card's plain path against the port on the CPU at each SMOKE config
# (float32, TF32 off): the same products summed in another order, so the
# logits agree to 1e-5 of their largest magnitude (they are O(1)).
ARCH_CPU_REL = 1e-5


def arch_setup(arch, batch, prompt, depth, dev):
    """``launch.serve.setup``'s objects at full width (16 tokens, 2.5e6
    IOPS), with ``depth`` layers where the depth is cut (the same
    seeds)."""
    import torch

    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import transformer

    if depth is None:
        return serve.setup(arch, batch=batch, prompt=prompt, device=str(dev))
    _, _, _, ssd, scfg = serve.setup(arch, smoke=True, batch=batch,
                                     prompt=prompt, device=str(dev))
    cfg = configs.get_config(arch).replace(n_layers=depth)
    params = transformer.init_model(
        torch.Generator(device=dev).manual_seed(serve.PARAM_SEED), cfg)
    tokens = torch.randint(
        0, cfg.vocab, (batch, scfg.prompt_len), dtype=torch.int32,
        device=dev,
        generator=torch.Generator(device=dev).manual_seed(serve.TOKEN_SEED))
    return cfg, params, tokens, ssd, scfg


def prompt_inputs(cfg, tokens, dev):
    """prefill's keyword inputs: the token ids, or for the vision model
    ``vision_patch_embeddings`` (8 image tokens of the prompt) and their
    M-RoPE ids."""
    import torch

    from repro_torch.models import modality

    if cfg.modality != "vision":
        return {"tokens": tokens}
    b, s = tokens.shape
    emb, mrope = modality.vision_patch_embeddings(
        torch.Generator(device=dev).manual_seed(2), cfg, b, s,
        VL_IMAGE_TOKENS)
    return {"embeds": emb, "mrope_positions": mrope}


def logit_agreement(got, want):
    """(max |got - want| over max |got|, cosine) of two logits tensors."""
    import torch

    rel = float((got - want).abs().max() / got.abs().max())
    cos = float(torch.nn.functional.cosine_similarity(
        got.reshape(1, -1).double(), want.reshape(1, -1).double()))
    return rel, cos


def arch_card_vs_cpu(arch, dev):
    """The SMOKE config's prefill (a frontend's embeddings where the model
    has one) and two decode steps, plain path, on the card and on the
    CPU from the same parameters: the worst max |diff| over max |logits|,
    and whether both runs took the same greedy tokens."""
    import torch

    from repro_torch import configs
    from repro_torch.models import modality, transformer

    cfg = configs.get_config(arch, smoke=True)
    b, s = 2, 16
    cpu = torch.device("cpu")
    params = transformer.init_model(torch.Generator().manual_seed(0), cfg)
    gen = torch.Generator().manual_seed(1)
    inputs = {"tokens": torch.randint(0, cfg.vocab, (b, s), generator=gen,
                                      dtype=torch.int32)}
    if cfg.modality == "audio":
        inputs = {"embeds": modality.audio_frame_embeddings(gen, cfg, b, s)}
    elif cfg.modality == "vision":
        emb, mrope = modality.vision_patch_embeddings(gen, cfg, b, s)
        inputs = {"embeds": emb, "mrope_positions": mrope}
    runs = {}
    for where in (cpu, dev):
        p = tree_to(params, where)
        logits, caches = transformer.prefill(
            p, cfg, cache_len=s + 2,
            **{k: v.to(where) for k, v in inputs.items()})
        out = [logits]
        for i in range(2):
            tok = torch.argmax(out[-1], dim=-1).to(torch.int32)
            logits, caches = transformer.decode_step(p, cfg, tok, caches,
                                                     s + i)
            out.append(logits)
        runs[where.type] = [x.cpu() for x in out]
    worst = max(float((c - g).abs().max() / c.abs().max())
                for c, g in zip(runs["cpu"], runs["cuda"]))
    same_tokens = all(bool(torch.equal(c.argmax(-1), g.argmax(-1)))
                      for c, g in zip(runs["cpu"], runs["cuda"]))
    return worst, same_tokens


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, tuple):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_to(tree, device):
    """A copy of a parameter tree on ``device`` (never the same tensors:
    a train step updates its parameters in place)."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(tree_to(v, device) for v in tree)
    return tree.to(device, copy=True)


def tree_float_(tree) -> None:
    """Every tensor of a parameter tree (held in dicts) made float32 in
    place, one leaf at a time."""
    for v in (tree.values() if isinstance(tree, dict) else tree):
        if isinstance(v, (dict, tuple)):
            tree_float_(v)
    if isinstance(tree, dict):
        for k, v in tree.items():
            if not isinstance(v, (dict, tuple)):
                tree[k] = v.float()


def teacher_forced(cfg, params, tokens, inputs, s, gen, dev, profile):
    """From a kernel prefill of the prompt: ``gen - 1`` graphed decode
    steps; the eager loop of ``decode_step`` on the same tokens from a
    second prefill (logits bit for bit); with ``profile`` the graphed
    step's wall and device ms and its one graph launch; then the plain
    full-sequence ``forward`` + ``logits_fn`` over the same tokens (for the
    vision model the prompt's embeddings and M-RoPE ids, then the tokens'
    embeddings at positions on all three streams, as ``decode_step``
    feeds them). Returns (record, its agreement part, the decoded
    tokens)."""
    import torch

    from repro_torch.models import transformer
    from repro_torch.serving import loop as serve_loop

    b = tokens.shape[0]
    cache_len = s + gen
    with torch.no_grad():
        logits, caches = transformer.prefill(params, cfg,
                                             cache_len=cache_len, **inputs)
        first = torch.argmax(logits, dim=-1).to(torch.int32)
        step = serve_loop.DecodeStep(cfg, params, caches, b, cache_len, dev)
        step.start(first, s)
        graphed = [logits]
        for _ in range(gen - 1):
            step()
            graphed.append(step.logits.clone())
        toks = step.tokens[:, s:].clone()

        eager = eager_decode(cfg, params, inputs, toks, s, gen, dev)
        same = [bitwise_equal(x, y) for x, y in zip(graphed, eager)]
        eager_tokens = torch.stack([x.argmax(-1) for x in eager], 1)

        rec = {"dtype": cfg.dtype, "capacity_factor": cfg.capacity_factor}
        if profile:
            step.start(first, s)
            prof = profiled_window(
                lambda: [step() for _ in range(gen - 2)], gen - 2)
            step.start(first, s)
            rec["graphed_step"] = {
                "wall_ms": prof["wall_ms_per_round"],
                "device_ms": prof["device_ms_per_round"],
                "device_events": prof["device_events_per_round"],
                "device_idle_share": prof["device_idle_share"],
                "host_calls": graph_proof(step)}
        del step, caches
        want, aux = plain_logits(cfg, params, tokens, inputs, toks, s, gen,
                                 dev)
    checked = agreement(graphed, want)
    rec.update(checked)
    rec["graph_vs_eager"] = {
        "logits_bit_identical_steps": sum(same), "steps": len(same),
        "tokens_equal": bool(torch.equal(eager_tokens.to(torch.int32),
                                         toks))}
    rec["no_nan"] = all(bool(torch.isfinite(x).all())
                        for x in graphed + eager + [want, aux])
    return rec, checked, toks


def eager_decode(cfg, params, inputs, toks, s, gen, dev):
    """A prefill of the prompt, then ``gen - 1`` eager ``decode_step``s
    fed ``toks``: the logits of each (prefill's first)."""
    import torch

    from repro_torch.models import transformer

    cache_len = s + gen
    logits, caches = transformer.prefill(params, cfg, cache_len=cache_len,
                                         **inputs)
    out = [logits]
    positions = torch.arange(cache_len, dtype=torch.int32, device=dev)
    for i in range(gen - 1):
        lg, _ = transformer.decode_step(params, cfg, toks[:, i], caches,
                                        positions[s + i])
        out.append(lg)
    return out


def plain_logits(cfg, params, tokens, inputs, toks, s, gen, dev):
    """The plain full-sequence ``forward`` + ``logits_fn`` over the prompt
    and ``toks[:, :-1]`` (for the vision model the prompt's embeddings and
    M-RoPE ids, then the tokens' embeddings at positions on all three
    streams, as ``decode_step`` feeds them): (logits at the prompt's last
    position and after, aux loss)."""
    import torch

    from repro_torch.models import transformer

    b = tokens.shape[0]
    plain = cfg.replace(use_pallas=False)
    if "embeds" in inputs:
        emb = torch.cat([inputs["embeds"],
                         params["embed"][toks[:, :-1].long()]], dim=1)
        tail = (s + torch.arange(gen - 1, dtype=torch.int32,
                                 device=dev)).expand(3, b, gen - 1)
        mrope = torch.cat([inputs["mrope_positions"], tail], dim=2)
        h, aux = transformer.forward(params, plain, embeds=emb,
                                     mrope_positions=mrope)
    else:
        h, aux = transformer.forward(
            params, plain, torch.cat([tokens, toks[:, :-1]], dim=1))
    return transformer.logits_fn(params, plain, h[:, s - 1:]), aux


def agreement(steps, want):
    """The worst ``logit_agreement`` of each step's logits with the plain
    forward's at its position, and the prefill's."""
    agree = [logit_agreement(g, want[:, i]) for i, g in enumerate(steps)]
    return {"worst_max_abs_over_max_logit": max(r for r, _ in agree),
            "worst_cosine": min(c for _, c in agree),
            "prefill_step": agree[0]}


def moe_routing(cfg, params, tokens, inputs, toks, s, gen, dev):
    """Where a MoE model's kernel path and its plain path route apart, in
    the model's own dtype. The plain forward records each MoE layer's
    router probabilities and top-k experts (``moe.route``); the kernel
    path (prefill, then ``eager_decode`` fed the same tokens) runs once on
    its own routing and once with the plain path's experts forced on it
    (weighted by its own router's probabilities of them). For each run
    and MoE layer, over the prefill and over the decode steps: the top-k
    choices of its own router that differ from the plain path's, the gap
    between the plain path's k-th and (k+1)-th probabilities where they
    differ and its median over every token, and the largest change of a
    probability. Returns (record, the forced run's agreement with the
    plain forward)."""
    import torch

    from repro_torch.models import moe

    k = cfg.top_k
    route = moe.route
    plain = []

    def record(params_, xt, cfg_, t_for_cap):
        r = route(params_, xt, cfg_, t_for_cap)
        plain.append((r["probs"], r["top_e"]))
        return r

    moe.route = record
    try:
        with torch.no_grad():
            want, _ = plain_logits(cfg, params, tokens, inputs, toks, s, gen,
                                   dev)
    finally:
        moe.route = route
    n_moe, b = len(plain), tokens.shape[0]
    plain = [(p.reshape(b, s + gen - 1, -1), e.reshape(b, s + gen - 1, k))
             for p, e in plain]

    def run(force):
        calls, seen = [0], [[[] for _ in range(n_moe)] for _ in range(2)]

        def routed(params_, xt, cfg_, t_for_cap):
            r = route(params_, xt, cfg_, t_for_cap)
            layer, step = calls[0] % n_moe, calls[0] // n_moe
            calls[0] += 1
            pos = slice(0, s) if step == 0 else slice(s + step - 1,
                                                      s + step)
            probs, top_e = (x[:, pos].reshape(xt.shape[0], -1)
                            for x in plain[layer])
            hit = (r["top_e"][:, :, None] == top_e[:, None, :]).any(-1)
            srt = torch.sort(probs, dim=-1, descending=True).values
            seen[step > 0][layer].append(torch.stack([
                (~hit).sum(-1).to(probs.dtype), srt[:, k - 1] - srt[:, k],
                (r["probs"] - probs).abs().max(-1).values], 1))
            if force:
                e_flat = top_e.reshape(-1).to(torch.int32)
                rank = moe.segment_rank(e_flat)
                keep = rank < r["cap"]
                top_p = torch.gather(r["probs"], 1, top_e)
                r.update(top_e=top_e, rank=rank, keep=keep,
                         top_p=top_p / top_p.sum(-1, keepdim=True),
                         slot=torch.where(keep, e_flat * r["cap"] + rank,
                                          cfg.n_experts * r["cap"]).long())
            return r

        moe.route = routed
        try:
            with torch.no_grad():
                got = eager_decode(cfg, params, inputs, toks, s, gen, dev)
        finally:
            moe.route = route
        check(calls[0] == n_moe * gen, f"MoE layers routed {calls[0]} "
                                       f"times, not {n_moe} x {gen}")
        out = {}
        for name, layers in zip(("prefill", "decode"), seen):
            rows = []
            for x in layers:
                x = torch.cat(x)
                miss = x[:, 0] > 0
                rows.append({
                    "choices_differing": int(x[:, 0].sum()),
                    "max_gap_where_differing":
                        float(x[miss, 1].max()) if miss.any() else None,
                    "median_gap": float(x[:, 1].median()),
                    "max_prob_change": float(x[:, 2].max())})
            out[name] = rows
        return {**agreement(got, want), "per_moe_layer": out}

    own, forced = run(False), run(True)
    return {"own_routing": own, "plain_routing_forced": forced}, {
        k: forced[k] for k in ("worst_max_abs_over_max_logit",
                               "worst_cosine", "prefill_step")}


def serve_arch(arch, batch, prompt, depth, via_serve, dev):
    """One architecture on the card; returns (record, launches of its main
    run). The main run, kernels on, is ``serve_with_kv_tier``
    (``via_serve``: the tier held to ``ARCH_TIER_REFERENCE``) or
    ``generate`` (for the vision model its prefill from patch embeddings
    and its graphed ``DecodeStep``). Then ``teacher_forced`` at a config
    that drops no token (a MoE model's capacity raised to cover every
    token, so that prefill + decode and one forward route alike; the
    served decode steps drop none at B tokens either), held to the
    ``serve_long`` bound in bf16; for a MoE model instead ``moe_routing``
    in bf16, the bound held with the plain path's routing forced, and
    ``teacher_forced`` on a float32 copy of the weights, held to it too;
    then the SMOKE config on the card against the CPU."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    from repro_torch.serving import loop as serve_loop

    t_arch = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    cfg, params, tokens, ssd, scfg = arch_setup(arch, batch, prompt, depth,
                                                dev)
    kcfg = cfg.replace(use_pallas=True)
    s, gen = scfg.prompt_len, scfg.gen_tokens
    cache_len = s + gen
    inputs = prompt_inputs(cfg, tokens, dev)
    torch.cuda.synchronize()
    # A decode step reads every weight once (a MoE step every expert: the
    # reference's dispatch runs all E on their capacity rows), but of an
    # untied embedding only the B tokens' rows.
    weight_bytes = sum(x.numel() * x.element_size()
                       for x in tree_leaves(params))
    if not cfg.tie_embeddings:
        weight_bytes -= params["embed"].numel() * params["embed"].element_size()
    rec = {"arch": arch, "batch": batch, "prompt": s, "gen": gen,
           "layers": cfg.n_layers, "layers_cut": depth is not None,
           "params": sum(x.numel() for x in tree_leaves(params)),
           "step_weight_bytes": weight_bytes,
           "step_bound_ms": weight_bytes / HBM_BYTES_PER_S * 1e3,
           "setup_s": time.perf_counter() - t_arch}

    ops.reset_launches()
    if via_serve:
        out = serve_loop.serve_with_kv_tier(kcfg, params, tokens, scfg, ssd)
        rel = {k: abs(out[k] - v) / v
               for k, v in ARCH_TIER_REFERENCE[arch].items()}
        check(out["data_check_max_abs"] == 0.0, f"{arch}: tier data check")
        check(all(r <= TIER_REL_TOL for r in rel.values()),
              f"{arch}: tier off the reference: {rel}")
        rec["tier"] = {k: out[k] for k in (
            "tokens_per_s", "avg_step_us", "avg_storage_us",
            "blocks_per_step", "iops_demand", "data_check_max_abs")}
        rec["tier_rel_to_reference"] = rel
    elif "tokens" in inputs:
        out = serve_loop.generate(kcfg, params, tokens, scfg)
    else:
        # generate's prefill and graphed decode, the prompt embedded.
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = transformer.prefill(params, kcfg,
                                             cache_len=cache_len, **inputs)
        step = serve_loop.DecodeStep(kcfg, params, caches, batch,
                                     cache_len, dev)
        step.start(torch.argmax(logits, dim=-1).to(torch.int32), s)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(gen - 1):
            step()
        torch.cuda.synchronize()
        out = {"tokens": step.tokens[:, s:].clone(), "prefill_s": t1 - t0,
               "wall_s": time.perf_counter() - t1}
        del step, caches, logits
    launches = dict(ops.LAUNCHES)
    main_tokens = out["tokens"]
    rec["prefill_ms"] = out["prefill_s"] * 1e3
    # generate's decode wall: its first step runs eagerly and captures.
    rec["decode_wall_ms_per_step"] = out["wall_s"] * 1e3 / (gen - 1)
    check(main_tokens.shape == (batch, gen)
          and bool(((main_tokens >= 0) & (main_tokens < cfg.vocab)).all()),
          f"{arch}: tokens {tuple(main_tokens.shape)} out of range")
    n_attn = sum(k in ("attn", "attn_local") for k in
                 cfg.pattern * cfg.n_periods + cfg.remainder)
    check(launches["flash_attention"] == n_attn
          and launches["decode_attention"] == n_attn * (gen - 1),
          f"{arch}: launches {launches}, {n_attn} attention layers")
    rec["launches"] = {k: v for k, v in launches.items() if v}

    # Teacher forcing at a config that drops no token.
    tf_cfg = kcfg
    if cfg.n_experts:
        tf_cfg = kcfg.replace(capacity_factor=cfg.n_experts / cfg.top_k)
    tf, checked, toks = teacher_forced(tf_cfg, params, tokens, inputs, s,
                                       gen, dev, profile=True)
    rec["graphed_step"] = tf.pop("graphed_step")
    rec["teacher_forced"] = tf
    bounded = {"teacher_forced": checked}
    if cfg.n_experts:
        # In bf16 the kernel and the plain attention round differently,
        # and a random router's near-tied top-k choices may flip on that
        # difference (each flip moves a token by a whole expert's
        # output): ``moe_routing`` records where, and the bound is held
        # with the plain path's experts forced on the kernel path, and on
        # a float32 copy of the same weights, kernels and graphs as in
        # bf16.
        rec["routing"], forced = moe_routing(tf_cfg, params, tokens, inputs,
                                             toks, s, gen, dev)
        del inputs
        tree_float_(params)
        tf32, checked32, _ = teacher_forced(
            tf_cfg.replace(dtype="float32"), params, tokens,
            prompt_inputs(cfg, tokens, dev), s, gen, dev, profile=False)
        rec["teacher_forced_float32"] = tf32
        bounded = {"bf16 with the plain path's routing forced": forced,
                   "float32": checked32}
    rec["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated(dev)
    del params, tokens
    torch.cuda.empty_cache()
    worst, same_tokens = arch_card_vs_cpu(arch, dev)
    rec["smoke_card_vs_cpu"] = {"worst_max_abs_over_max_logit": worst,
                                "same_tokens": same_tokens,
                                "bound": ARCH_CPU_REL}
    rec["arch_s"] = time.perf_counter() - t_arch
    for name in ("teacher_forced", "teacher_forced_float32"):
        got = rec.get(name)
        if got is None:
            continue
        check(got["no_nan"], f"{arch}: a logit or the aux loss is not finite")
        check(got["graph_vs_eager"]["logits_bit_identical_steps"]
              == got["graph_vs_eager"]["steps"]
              and got["graph_vs_eager"]["tokens_equal"],
              f"{arch}: graphed and eager decode differ ({name}): "
              f"{got['graph_vs_eager']}")
    for name, got in bounded.items():
        check(got["worst_max_abs_over_max_logit"] <= LOGIT_REL_BOUND
              and got["worst_cosine"] >= LOGIT_MIN_COSINE,
              f"{arch}: kernel decode and plain forward disagree ({name}): "
              f"{got}")
    check(worst <= ARCH_CPU_REL and same_tokens,
          f"{arch}: card and CPU disagree at SMOKE size: {worst}")
    return rec, launches


def phase_serve_archs(dev, card):
    """Every architecture the reference serves, through prefill and the
    graphed decode step with the attention kernels on, one at a time (the
    weights freed between them): ``SERVE_ARCHS``."""
    import torch

    recs, total = [], {}
    for arch, batch, prompt, depth, via_serve in SERVE_ARCHS:
        rec, launches = serve_arch(arch, batch, prompt, depth, via_serve,
                                   dev)
        recs.append(rec)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        torch.cuda.empty_cache()
    emit({"phase": "serve_archs", "card": card, "archs": recs,
          "bound": {"max_abs_over_max_logit": LOGIT_REL_BOUND,
                    "min_cosine": LOGIT_MIN_COSINE,
                    "smoke_card_vs_cpu": ARCH_CPU_REL}})
    return total


# -- phase: training -----------------------------------------------------------

TRAIN_ARCHS = ("starcoder2-3b", "gemma2-27b", "recurrentgemma-9b",
               "xlstm-1.3b", "qwen2-moe-a2.7b")
# SMOKE cuts of the train step (the CPU tests' own): remat on, two
# attention and two loss chunks at seq 64.
TRAIN_SMOKE_CUT = dict(remat=True, attn_chunk=32, loss_chunk=32)
VJP_CARD_REL = 1e-4        # flash_vjp grads vs autograd, of the largest |g|
TRAIN_CPU_REL = 1e-5       # SMOKE step: loss and parameters, card vs CPU
CUT_LOSS_REL = 1e-5        # full width, 2 layers, float32: loss ...
CUT_NORM_REL = 1e-4        # ... and gradient norm, card vs CPU
TRAIN_BATCH, TRAIN_SEQ = 4, 128    # launch.train's defaults
TRAIN_TIMED_STEPS = 3
# Expected first loss of a random model: logits of unit variance (the
# tied N(0, 1/d_model) embedding against the unit-variance LayerNorm
# output) give ln V + 1/2 (11.30 at V = 49152), not ln V.
FIRST_LOSS_TOL = 0.5


def vjp_case(name, b, hq, hkv, s, d, window, cap, scale, chunk, dev):
    """flash_vjp on the card against torch autograd through the plain
    full-softmax ``attention_ref`` on the card, float32, from one seeded
    draw: the largest |Δ| of o, dq, dk, dv over that tensor's largest."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.models.flash_vjp import flash_attention_jnp

    gen = torch.Generator(device=dev).manual_seed(11)
    q, k, v, ct = (torch.randn(shape, generator=gen, device=dev)
                   for shape in ((b, hq, s, d), (b, hkv, s, d),
                                 (b, hkv, s, d), (b, hq, s, d)))
    outs = []
    for fn in (lambda q, k, v: flash_attention_jnp(
                   q, k, v, True, window, cap, scale, chunk, chunk),
               lambda q, k, v: ref.attention_ref(
                   q, k, v, causal=True, window=window, logit_softcap=cap,
                   scale=scale)):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        o = fn(*leaves)
        (o * ct).sum().backward()
        torch.cuda.synchronize()
        outs.append(([o.detach()] + [x.grad for x in leaves],
                     (time.perf_counter() - t0) * 1e3))
    (got, ms), (want, plain_ms) = outs
    rel = {n: float((g - w).abs().max() / w.abs().max())
           for n, g, w in zip(("o", "dq", "dk", "dv"), got, want)}
    return {"case": name, "shape": [b, hq, hkv, s, d], "window": window,
            "softcap": cap, "chunk": chunk, "rel_err": rel,
            "bound": VJP_CARD_REL, "fwd_bwd_ms": ms,
            "plain_fwd_bwd_ms": plain_ms}


def train_step_card_vs_cpu(arch, dev):
    """One ``make_train_step`` step of the SMOKE config on the card and on
    the CPU from the same parameters and batch: |Δ loss| over |loss|, and
    the largest |Δ| of the updated parameters over their largest |value|."""
    import torch

    from repro_torch import configs
    from repro_torch.models import transformer
    from repro_torch.train import data, loop, optimizer

    cfg = configs.get_config(arch, smoke=True).replace(**TRAIN_SMOKE_CUT)
    tcfg = loop.TrainConfig(batch=4, seq=64)
    params = transformer.init_model(torch.Generator().manual_seed(0), cfg)
    batch = data.synth_batch(0, tcfg.batch, tcfg.seq, cfg.vocab)
    runs = []
    for where in (torch.device("cpu"), dev):
        p = tree_to(params, where)
        p, _, _, m = loop.make_train_step(cfg, tcfg)(
            p, optimizer.init_opt_state(p), {}, data.to_device(batch, where))
        runs.append((float(m["loss"]), tree_to(p, "cpu")))
    (l_cpu, p_cpu), (l_card, p_card) = runs
    top = max(float(x.abs().max()) for x in tree_leaves(p_cpu))
    worst = max(float((a - b).abs().max())
                for a, b in zip(tree_leaves(p_cpu), tree_leaves(p_card)))
    return {"arch": arch, "loss_card": l_card, "loss_cpu": l_cpu,
            "loss_rel": abs(l_card - l_cpu) / abs(l_cpu),
            "params_max_abs_over_max": worst / top,
            "bound": TRAIN_CPU_REL}


def full_width_cut(dev):
    """starcoder2-3b at full width cut to 2 of 30 layers, float32, batch
    1 x 128: the loss and the gradient norm of ``value_and_grad`` on the
    card against the CPU, from parameters drawn on the card."""
    import torch

    from repro_torch import configs
    from repro_torch.models import transformer
    from repro_torch.train import data, loop, optimizer

    cfg = configs.get_config("starcoder2-3b").replace(n_layers=2,
                                                      dtype="float32")
    params = transformer.init_model(
        torch.Generator(device=dev).manual_seed(0), cfg)
    batch = data.synth_batch(0, 1, TRAIN_SEQ, cfg.vocab)
    out = []
    for where in (dev, torch.device("cpu")):
        p = tree_to(params, where)
        t0 = time.perf_counter()
        loss, g = loop.value_and_grad(p, cfg, *data.to_device(
            batch, where).values())
        norm = float(optimizer.global_norm(g))
        out.append({"loss": float(loss), "grad_norm": norm,
                    "s": time.perf_counter() - t0})
        del p, g
    card, cpu = out
    return {"layers": cfg.n_layers, "d_model": cfg.d_model,
            "vocab": cfg.vocab, "batch": [1, TRAIN_SEQ], "card": card,
            "cpu": cpu,
            "loss_rel": abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"]),
            "grad_norm_rel": abs(card["grad_norm"] - cpu["grad_norm"])
            / cpu["grad_norm"],
            "bound": {"loss": CUT_LOSS_REL, "grad_norm": CUT_NORM_REL}}


def full_width_steps(dev):
    """starcoder2-3b FULL through ``launch.train.setup`` and the loop's
    cold start, on ``Prefetcher`` batches at batch 4 x 128: one warm-up
    step, ``TRAIN_TIMED_STEPS`` timed steps (a synchronise around each),
    then one profiled step. Returns its record."""
    import math

    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    from repro_torch.train import data, loop

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    cfg, tcfg, device, _ = launch_train.setup(
        "starcoder2-3b", batch=TRAIN_BATCH, seq=TRAIN_SEQ, device=str(dev))
    check(cfg.remat and not cfg.use_pallas and cfg.dtype == "bfloat16",
          f"starcoder2-3b FULL: remat {cfg.remat}, use_pallas "
          f"{cfg.use_pallas}, {cfg.dtype}")
    t0 = time.perf_counter()
    params, opt_state, residuals = loop.cold_start(cfg, tcfg, device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(x.numel() for x in tree_leaves(params))
    # In bf16 an update of ~lr moves only the elements below ~lr/2^-8 (the
    # warm-up's lr is 3e-6 a step): the zero-initialised biases, and a few
    # percent of the embedding.
    moved_leaves = {"embed": lambda p: p["embed"],
                    "attn_bq": lambda p: p["periods"][0]["attn"]["bq"]}
    before = {k: f(params).clone() for k, f in moved_leaves.items()}
    step_fn = loop.make_train_step(cfg, tcfg)
    prefetch = data.Prefetcher(tcfg.batch, tcfg.seq, cfg.vocab, tcfg.seed,
                               device=device)
    it = iter(prefetch)
    ops.reset_launches()
    losses, norms, walls = [], [], []
    try:
        for i in range(1 + TRAIN_TIMED_STEPS):
            _, batch = next(it)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt_state, residuals, m = step_fn(params, opt_state,
                                                      residuals, batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        _, batch = next(it)

        state = {"opt": opt_state}

        def one_step():
            # A window taken again (``PROFILER_TRIES``) is one more step,
            # counted like the others.
            _, state["opt"], _, m = step_fn(params, state["opt"], residuals,
                                            batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))

        prof = profiled_window(one_step, 1)
        opt_state = state["opt"]
    finally:
        prefetch.close()
    torch.cuda.synchronize()
    launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    timed_ms = [w * 1e3 for w in walls[1:]]
    step_ms = statistics.median(timed_ms)
    moved = {k: int((moved_leaves[k](params) != v).sum())
             for k, v in before.items()}
    del before
    rec = {
        "arch": cfg.name, "layers": cfg.n_layers, "dtype": cfg.dtype,
        "remat": cfg.remat, "params": n_params,
        "batch": [tcfg.batch, tcfg.seq],
        "tokens_per_step": tcfg.batch * tcfg.seq, "init_s": init_s,
        "losses": losses, "grad_norms": norms,
        "first_loss_expected": math.log(cfg.vocab) + 0.5,
        "ln_vocab": math.log(cfg.vocab),
        "warmup_step_ms": walls[0] * 1e3, "timed_step_ms": timed_ms,
        "step_wall_ms": step_ms,
        "tokens_per_wall_s": tcfg.batch * tcfg.seq / (step_ms / 1e3),
        "profiled_step": {k: prof[k] for k in (
            "wall_ms_per_round", "device_ms_per_round",
            "device_events_per_round", "device_idle_share",
            "top_device_ms_per_round")},
        "opt_step": int(opt_state["step"]),
        "elements_moved": moved,
        "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
        "kernel_launches": launches,
    }
    check(all(math.isfinite(x) for x in losses + norms)
          and all(x > 0 for x in norms),
          f"full-width losses {losses}, gradient norms {norms}")
    check(abs(losses[0] - rec["first_loss_expected"]) <= FIRST_LOSS_TOL,
          f"first loss {losses[0]} not within {FIRST_LOSS_TOL} of "
          f"{rec['first_loss_expected']}")
    check(rec["opt_step"] == len(losses),
          f"opt_state step {rec['opt_step']} after {len(losses)} steps")
    check(all(v > 0 for v in moved.values()), f"parameters unmoved: {moved}")
    check(not launches, f"the training path launched kernels: {launches}")
    del params, opt_state, residuals, m, state, batch
    return rec


def train_roofline(batch: int, seq: int) -> dict:
    """``launch.roofline``'s terms of ``full_width_steps``' step
    (``loop.make_train_step`` of starcoder2-3b FULL through
    ``launch.train.setup``, one device, batch x seq), counted once on
    fake tensors on the CPU: no value is computed and nothing is
    allocated. Runs in a CPU worker."""
    from repro_torch.launch import roofline, specs
    from repro_torch.launch import train as launch_train
    from repro_torch.train import loop

    t0 = time.perf_counter()
    cfg, tcfg, _, _ = launch_train.setup("starcoder2-3b", batch=batch,
                                         seq=seq, device="cpu")
    mode = specs.fake_mode()
    params = specs.abstract_params(cfg, mode)
    args = (params, specs.abstract_opt_state(params, mode),
            specs.train_batch_specs(cfg, batch, seq, mode)[0])
    step = loop.make_train_step(cfg, tcfg)
    counts = roofline.count_step(lambda p, o, b: step(p, o, {}, b), args,
                                 mode)
    out = roofline.analyze(counts, 1,
                           6.0 * cfg.active_param_count() * batch * seq)
    out["flops_by_op"] = counts["flops_by_op"]
    out["count_s"] = time.perf_counter() - t0
    return out


def roofline_record(roof: dict, full: dict) -> dict:
    """The counted step's terms beside the measured one's device ms."""
    bound_ms = roof["roofline_bound_s"] * 1e3
    device_ms = full["profiled_step"]["device_ms_per_round"]
    return {
        "source": "repro_torch.launch.roofline count_step + analyze of "
                  "loop.make_train_step, fake tensors on the CPU",
        "peaks": "H100 SXM, dense, 700 W: 989e12 bf16 FLOP/s, 3.35e12 B/s "
                 "HBM, 450e9 B/s NVLink",
        **{k: roof[k] for k in (
            "flops_per_device", "bytes_per_device", "flops_by_op",
            "compute_s", "memory_s", "collective_s", "bottleneck",
            "model_flops_total", "useful_compute_ratio",
            "hbm_argument_bytes", "hbm_temp_bytes", "hbm_peak_bytes",
            "count_s")},
        "roofline_bound_s": roof["roofline_bound_s"],
        "bound_ms": bound_ms,
        "predicted_peak_gb": roof["hbm_peak_bytes"] / 1e9,
        "measured_device_ms": device_ms,
        "measured_peak_memory_gb": full["peak_memory_gb"],
        "measured_over_bound": device_ms / bound_ms,
    }


def train_restart(dev):
    """``train()`` on starcoder2-3b SMOKE on the card, 8 steps with a
    checkpoint every 2, crashed at step 5 and restarted from step 4,
    against an uninterrupted run, each under a temporary directory that is
    removed afterwards."""
    import tempfile

    from repro_torch import configs
    from repro_torch.train import loop

    cfg = configs.get_config("starcoder2-3b", smoke=True)
    runs = {}
    for name, fail in (("restarted", {5}), ("uninterrupted", None)):
        with tempfile.TemporaryDirectory() as d:
            tcfg = loop.TrainConfig(batch=2, seq=32, steps=8, ckpt_every=2,
                                    ckpt_dir=d)
            runs[name] = loop.train(cfg, tcfg, resume=False, fail_at=fail,
                                    device=dev)
    got, want = runs["restarted"], runs["uninterrupted"]
    return {"restarts": got.restarts, "final_step": got.step,
            "losses": got.losses, "uninterrupted_losses": want.losses,
            "losses_equal": got.losses == want.losses[:5] + want.losses[4:]}


def autograd_refusal(dev):
    """The CUDA attention routes raise on inputs that require grad."""
    import torch

    from repro_torch.kernels import ops

    q = torch.randn(1, 4, 64, 64, device=dev)
    kv = torch.randn(1, 2, 64, 64, device=dev)
    lengths = torch.full((1,), 64, dtype=torch.int32, device=dev)
    out = {}
    for name, call in (
            ("flash_attention", lambda: ops.flash_attention(
                q.clone().requires_grad_(True), kv, kv, causal=True)),
            ("decode_attention", lambda: ops.decode_attention(
                q[:, :, 0].clone().requires_grad_(True), kv, kv,
                lengths))):
        try:
            call()
            out[name] = "no error"
        except RuntimeError as e:
            out[name] = str(e)
    return out


def phase_train(dev, card):
    """Training on the card (``TRAIN_ARCHS``, starcoder2-3b FULL)."""
    import torch

    from repro_torch import configs

    # The full-width step's count, in a CPU worker while the card works.
    roof = cpu_pool().submit(train_roofline, TRAIN_BATCH, TRAIN_SEQ)
    g2 = configs.get_config("gemma2-27b")
    vjp = [
        vjp_case("starcoder2-3b attention", 2, 24, 2, 1024, 128, None, None,
                 128 ** -0.5, 256, dev),
        # gemma2-27b's heads, softcap and scale; the window cut from 4096
        # to 512 so that it masks inside S = 1024.
        vjp_case("gemma2-27b local attention", 1, g2.n_heads, g2.n_kv_heads,
                 1024, g2.d_head, 512, g2.attn_softcap, g2.attn_scale, 256,
                 dev),
    ]
    torch.cuda.empty_cache()
    smoke = [train_step_card_vs_cpu(arch, dev) for arch in TRAIN_ARCHS]
    cut = full_width_cut(dev)
    torch.cuda.empty_cache()
    full = full_width_steps(dev)
    torch.cuda.empty_cache()
    restart = train_restart(dev)
    refusal = autograd_refusal(dev)
    roof = roofline_record(roof.result(), full)
    emit({"phase": "train", "card": card, "flash_vjp": vjp,
          "smoke_card_vs_cpu": smoke, "full_width_2_layers": cut,
          "full_width": full, "roofline": roof, "restart": restart,
          "autograd_refusal": refusal})
    for rec in vjp:
        check(max(rec["rel_err"].values()) <= VJP_CARD_REL,
              f"flash_vjp on the card: {rec}")
    for rec in smoke:
        check(rec["loss_rel"] <= TRAIN_CPU_REL
              and rec["params_max_abs_over_max"] <= TRAIN_CPU_REL,
              f"SMOKE train step, card against CPU: {rec}")
    check(cut["loss_rel"] <= CUT_LOSS_REL
          and cut["grad_norm_rel"] <= CUT_NORM_REL,
          f"full width, 2 layers, card against CPU: {cut}")
    check(restart["restarts"] == 1 and restart["final_step"] == 8
          and restart["losses_equal"], f"train() restart: {restart}")
    check(all("use_pallas=False" in v for v in refusal.values()),
          f"attention kernels under autograd: {refusal}")
    check(roof["measured_device_ms"] >= roof["bound_ms"],
          f"the full-width step's {roof['measured_device_ms']} device ms "
          f"beat its roofline bound of {roof['bound_ms']} ms")
    return full["kernel_launches"]


# -- mesh: a world of ranks ---------------------------------------------------

MESH_WORLD = 4
MESH_TIMEOUT_S = 300.0
# (M drives, ranks): fig 17's local_1drive arrays over 4 and over 2 ranks.
MESH_ARRAYS = ((4, 4), (8, 4), (4, 2), (8, 2))
MESH_UPDATE_ROWS = 8192     # one local_1drive-sized batch, split 4 ways
MESH_PREFILL_BATCH, MESH_PREFILL_SEQ = 2, 2048
MESH_PREFILL_LAYERS = 30    # starcoder2-3b's all 30
MESH_MOE_LAYERS, MESH_MOE_BATCH, MESH_MOE_SEQ = 2, 2, 256
MESH_MOE_REL = 1e-4         # float32, routing forced: hidden vs one process
MESH_TRAIN_LAYERS, MESH_TRAIN_BATCH, MESH_TRAIN_SEQ = 2, 4, 128
# The losses (the three steps' and the next batch's after them) and each
# step's gradient norm within 1e-5 relative of one process.
MESH_TRAIN_REL = 1e-5
# Each leaf's change over the three steps (p3 - p0) within
# MESH_TRAIN_CHANGE_REL of its largest |change| in one process, on the
# elements whose one-process |gradient| is at least MESH_TRAIN_GRAD_FLOOR
# of the leaf's largest at every step. Adam moves an element by about the
# learning rate whatever its gradient's size, so an element whose
# gradient is near its rounding error moves by noise; elsewhere the
# change differs by the parameters' float32 rounding: over three warm-up
# steps (1.8e-5) a ULP is 4e-4 of the change for a weight near 0.1 and
# 6.6e-3 for a norm weight near 1, so the bound takes three of the
# latter, while the resumed step alone is half the change
# (``third_step_share_min``).
MESH_TRAIN_CHANGE_REL = 2e-2
MESH_TRAIN_GRAD_FLOOR = 1e-4


def mesh_backend():
    """NCCL with one card a rank where there are enough cards, else gloo
    with every rank on ``cuda:0`` (NCCL refuses two ranks on one card)."""
    import torch

    return "nccl" if torch.cuda.device_count() >= MESH_WORLD else "gloo"


def mesh_collectives(rank, dev):
    """Each collective the mesh paths use, on CUDA tensors of each dtype
    they carry (float32, bfloat16, int32, bool), under the world's
    backend, through ``sharding._collective``: the result must be the
    right one. (torch 2.11's gloo takes all of them on CUDA tensors, so
    the port composes none.)"""
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import sharding as shd

    n = dist.get_world_size()
    group = dist.group.WORLD
    out = {}
    for dtype in (torch.float32, torch.bfloat16, torch.int32, torch.bool):
        base = torch.arange(8, device=dev) + 16 * rank
        every = torch.arange(8, device=dev) + 16 * torch.arange(
            n, device=dev)[:, None]
        if dtype == torch.bool:
            base, every = base % 3 == 0, every % 3 == 0
        x, every = base.to(dtype), every.to(dtype)
        total = (every.any(0) if dtype == torch.bool
                 else every.sum(0).to(dtype))
        cases = {
            "all_gather": (every.reshape(-1), (8 * n,)),
            "reduce_scatter": (total[rank * 8 // n:(rank + 1) * 8 // n],
                               (8 // n,)),
            "all_reduce": (total, (8,)),
        }
        for kind, (want, shape) in cases.items():
            buf = torch.empty(shape, dtype=dtype, device=dev)
            got = shd._collective(kind, buf, x, group)
            out[f"{kind}_{str(dtype).split('.')[-1]}"] = bool(
                torch.equal(got, want))
    return out


def mesh_engine(rank, dev):
    """The sharded array runner on fig 17's arrays (main_path_read's
    flags and functional data, depth 1024, ``ROUNDS`` graphed rounds):
    each rank's wall seconds of the assembly (``engine._assemble`` timed
    alone on the rank's block) and of its rounds (the runner's call less
    that), and on rank 0 the states against the one-process
    ``make_array_runner`` on the card, leaf for leaf, and fig 17's
    numbers."""
    import gc

    import torch

    from repro_torch import convert, cuda_graph
    from repro_torch.bench import local_1drive
    from repro_torch.core import engine
    from repro_torch.core.types import PlatformModel, WorkloadConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_axis_mesh

    # main_path_read's flags and its functional data (block_gather on the
    # reads); fig 17's virtual numbers do not depend on the data.
    cfg, ssd = local_1drive(emulate_data=True, **READ_FLAGS)
    wl = WorkloadConfig(io_depth=1024)
    meshes = {4: make_axis_mesh("dev"), 2: make_axis_mesh("dev",
                                                          ranks=[0, 1])}
    recs, launches, states = [], dict.fromkeys(ops.LAUNCHES, 0), {}
    for m, n in MESH_ARRAYS:
        if rank >= n:
            continue
        init = engine.init_array_state(cfg, ssd, wl, m, device=dev)
        run = engine.make_sharded_array_runner(
            cfg, ssd, wl, PlatformModel(), ROUNDS, mesh=meshes[n])
        run(init)                      # capture, warm
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        out = run(init)
        torch.cuda.synchronize()
        call_s = time.perf_counter() - t0
        for k, v in ops.LAUNCHES.items():
            launches[k] += v
        # The assembly alone, on this rank's block of the result.
        step = m // n
        mine = cuda_graph.map_leaves(
            lambda x: x.narrow(0, rank * step, step).clone(), out)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine._assemble(mine, meshes[n].get_group("dev"), n)
        torch.cuda.synchronize()
        assemble_s = time.perf_counter() - t0
        rec = {"drives": m, "ranks": n, "rank": rank,
               "wall_ms_per_round": (call_s - assemble_s) * 1e3 / ROUNDS,
               "assemble_ms": assemble_s * 1e3,
               "launches": dict(ops.LAUNCHES)}
        if rank == 0:
            states[(m, n)] = convert.engine_state_to_numpy(out)
            rec["fig17"] = array_numbers(out, m)
        recs.append(rec)
        # This case's graphs go before the next capture starts.
        del out, init, run
        gc.collect()
        torch.cuda.synchronize()
    if rank == 0:
        for m in sorted({m for m, _ in MESH_ARRAYS}):
            init = engine.init_array_state(cfg, ssd, wl, m, device=dev)
            one = engine.make_array_runner(cfg, ssd, wl, PlatformModel(),
                                           ROUNDS, device=dev)
            one(init)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = convert.engine_state_to_numpy(one(init))
            one_ms = (time.perf_counter() - t0) * 1e3 / ROUNDS
            for rec in recs:
                if rec["drives"] == m:
                    rec["one_process_wall_ms_per_round"] = one_ms
                    rec["differing_leaves"] = convert.leaf_differences(
                        want, states[(m, rec["ranks"])])
    torch.cuda.synchronize()
    return recs, launches


def mesh_update(rank, dev, inp):
    """One batch of ``MESH_UPDATE_ROWS`` rows on local_1drive's drive,
    split over the 4 ranks through ``timing.update(axis_name=)``; rank 0
    holds it against ``timing.update`` over the whole batch on the card,
    bit for bit."""
    import numpy as np
    import torch

    from repro_torch.bench import local_1drive
    from repro_torch.core import timing
    from repro_torch.core.types import RequestBatch, TimingState
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_axis_mesh

    _, ssd = local_1drive()
    mesh = make_axis_mesh("dev")
    n = MESH_WORLD
    nl = MESH_UPDATE_ROWS // n
    u = inp["update"]

    def batch_of(lo, hi):
        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a[lo:hi])).to(dev)

        lba = t(u["lba"])
        z = torch.zeros_like(lba)
        return RequestBatch(arrival=t(u["arrival"]), sq_id=z, slot=z,
                            opcode=z, lba=lba, nblocks=torch.ones_like(lba),
                            buf_id=z, req_id=z, valid=t(u["valid"]))

    state = TimingState(torch.from_numpy(u["busy"]).to(dev),
                        torch.tensor(int(u["rr"]), dtype=torch.int32,
                                     device=dev))
    with shd.region(mesh):
        st, comp = timing.update(state, batch_of(rank * nl, (rank + 1) * nl),
                                 ssd, axis_name="dev")
    g = shd._gather(comp.view(torch.int32), mesh.get_group("dev"), 0)
    rec = {"rows": MESH_UPDATE_ROWS, "ranks": n}
    if rank == 0:
        st1, comp1 = timing.update(state, batch_of(0, MESH_UPDATE_ROWS), ssd)
        rec["completion_differing"] = int(
            (g != comp1.view(torch.int32)).sum())
        rec["busy_differing"] = int(
            (st.busy_until.view(torch.int32)
             != st1.busy_until.view(torch.int32)).sum())
        rec["rr_equal"] = bool(torch.equal(st.rr, st1.rr))
    return rec


def mesh_prefill(rank, dev, inp):
    """starcoder2-3b FULL (bf16; ``MESH_PREFILL_LAYERS`` layers) prefill
    of a 2 x 2048 batch on the (2, 2) mesh: with ``use_pallas=True`` (the
    q heads split over ``model``: every rank launches the
    ``flash_attention`` kernel on its 12 heads), then on the Megatron-SP
    route; rank 0 holds both logits to the one-process plain prefill on
    the card within the ``serve_long`` bound."""
    import torch

    from repro_torch import configs
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer

    cfg = configs.get_config("starcoder2-3b").replace(
        n_layers=MESH_PREFILL_LAYERS)
    params = transformer.init_model(
        torch.Generator(device=dev).manual_seed(0), cfg)
    tokens = torch.from_numpy(inp["prefill_tokens"]).to(dev)
    mesh = make_mesh(2, 2)
    rec = {"arch": "starcoder2-3b", "layers": cfg.n_layers,
           "full_layers": 30, "batch": MESH_PREFILL_BATCH,
           "seq": MESH_PREFILL_SEQ, "dtype": cfg.dtype,
           "q_heads_per_rank": cfg.n_heads // 2}
    got, launches = {}, dict.fromkeys(ops.LAUNCHES, 0)
    for name, pallas in (("kernel", True), ("megatron", False)):
        c = cfg.replace(use_pallas=pallas)
        with torch.no_grad(), shd.use_rules(mesh, shd.DEFAULT_RULES):
            if pallas:
                transformer.prefill(params, c, tokens)   # warm
            torch.cuda.synchronize()
            ops.reset_launches()
            t0 = time.perf_counter()
            logits, _ = transformer.prefill(params, c, tokens)
            logits = shd.full_tensor(logits)
            torch.cuda.synchronize()
            rec[f"{name}_wall_ms"] = (time.perf_counter() - t0) * 1e3
        rec[f"{name}_launches"] = dict(ops.LAUNCHES)
        for k, v in ops.LAUNCHES.items():
            launches[k] += v
        got[name] = logits.float()
    if rank == 0:
        with torch.no_grad():
            c = cfg.replace(use_pallas=False)
            transformer.prefill(params, c, tokens)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want, _ = transformer.prefill(params, c, tokens)
            torch.cuda.synchronize()
            rec["one_process_wall_ms"] = (time.perf_counter() - t0) * 1e3
        for name, logits in got.items():
            r, cos = logit_agreement(logits, want.float())
            rec[f"{name}_max_abs_over_max_logit"] = r
            rec[f"{name}_cosine"] = cos
    del params
    torch.cuda.empty_cache()
    return rec, launches


def mesh_moe(rank, dev, inp):
    """qwen3-moe-30b-a3b at full width, ``MESH_MOE_LAYERS`` of 48 layers,
    float32, ``moe_ep=True`` on the (2, 2) mesh, at a capacity factor of
    E / k (an expert's capacity is then every token, so no pair drops on
    either path and expert parallelism computes the one-device sum).
    Rank 0 runs the one-process forward first and every rank forces its
    experts (``moe.route``), as ``serve_archs`` does for MoE; the hidden
    states are held within ``MESH_MOE_REL`` of their largest."""
    import torch
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe, transformer

    base = configs.get_config("qwen3-moe-30b-a3b")
    cf = base.n_experts / base.top_k
    cfg = base.replace(n_layers=MESH_MOE_LAYERS, dtype="float32",
                       moe_ep=True, capacity_factor=cf, use_pallas=False)
    params = transformer.init_model(
        torch.Generator(device=dev).manual_seed(0), cfg)
    b, s = MESH_MOE_BATCH, MESH_MOE_SEQ
    tokens = torch.from_numpy(inp["moe_tokens"]).to(dev)
    route = moe.route
    rec = {"arch": "qwen3-moe-30b-a3b", "layers": cfg.n_layers,
           "full_layers": base.n_layers, "dtype": cfg.dtype,
           "capacity_factor": cf, "batch": b, "seq": s}
    plain, want = [], None
    if rank == 0:
        def record(p_, xt, c_, t):
            r = route(p_, xt, c_, t)
            plain.append(r["top_e"].cpu())
            check(r["cap"] >= xt.shape[0], f"capacity {r['cap']} drops")
            return r

        moe.route = record
        try:
            with torch.no_grad():
                want, _ = transformer.forward(params, cfg, tokens)
        finally:
            moe.route = route
    box = [plain]
    dist.broadcast_object_list(box, src=0)
    plain = box[0]
    mesh = make_mesh(2, 2)
    dp = mesh.get_coordinate()[0]
    calls = [0]

    def forced(p_, xt, c_, t):
        r = route(p_, xt, c_, t)
        check(r["cap"] >= xt.shape[0], f"EP capacity {r['cap']} drops")
        top = plain[calls[0] % len(plain)].reshape(b, s, -1)
        calls[0] += 1
        rows = b // 2
        top_e = top[dp * rows:(dp + 1) * rows].reshape(-1, top.shape[-1])
        top_e = top_e.to(xt.device)
        top_p = torch.gather(r["probs"], 1, top_e)
        r.update(top_e=top_e, top_p=top_p / top_p.sum(-1, keepdim=True))
        return r

    moe.route = forced
    try:
        with torch.no_grad(), shd.use_rules(mesh, shd.DEFAULT_RULES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            h, _ = transformer.forward(params, cfg, tokens)
            h = shd.full_tensor(h)
            torch.cuda.synchronize()
            rec["wall_ms"] = (time.perf_counter() - t0) * 1e3
    finally:
        moe.route = route
    rec["moe_layer_calls"] = calls[0]
    if rank == 0:
        rec["max_abs_over_max"] = float((h - want).abs().max()
                                        / want.abs().max())
    del params
    torch.cuda.empty_cache()
    return rec


def mesh_train(rank, dev, inp):
    """starcoder2-3b at full width, ``MESH_TRAIN_LAYERS`` layers, float32:
    two steps on the (2, 2) mesh (parameters and AdamW state replicated),
    a checkpoint (rank 0 writes it), the reload onto (1, 2) with the
    rules' shardings (the only step of sharded parameters and AdamW
    blocks), a third step there and the loss of the next batch after it.
    Rank 0 then runs the uninterrupted three steps in one process (with
    each step's gradient) and holds the losses, each step's gradient norm
    and each leaf's change over the three steps to them."""
    import torch

    from repro_torch import checkpoint, configs
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer
    from repro_torch.train import data, loop
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import tree as port_tree

    cfg = configs.get_config("starcoder2-3b").replace(
        n_layers=MESH_TRAIN_LAYERS, dtype="float32", use_pallas=False)
    tcfg = loop.TrainConfig(batch=MESH_TRAIN_BATCH, seq=MESH_TRAIN_SEQ,
                            steps=3)
    step_fn = loop.make_train_step(cfg, tcfg)

    def fresh():
        p = transformer.init_model(
            torch.Generator(device=dev).manual_seed(0), cfg)
        return p, opt_lib.init_opt_state(p)

    def batch(i):
        return data.to_device(data.synth_batch(i, tcfg.batch, tcfg.seq,
                                               cfg.vocab), dev)

    def run(p, o, first, n, grads=None):
        losses, norms = [], []
        for i in range(first, first + n):
            bt = batch(i)
            if grads is not None:
                # Each element's least |gradient| over the steps, and each
                # leaf's largest.
                _, g = loop.value_and_grad(p, cfg, bt["tokens"],
                                           bt["labels"])
                for k, t in port_tree.jax_leaves(g):
                    a = t.abs()
                    least, top = grads.get(k, (a, 0.0))
                    grads[k] = (torch.minimum(least, a),
                                max(top, float(a.max())))
                del g
            p, o, _, met = step_fn(p, o, {}, bt)
            losses.append(float(met["loss"]))
            norms.append(float(met["grad_norm"]))
        return p, o, losses, norms

    def next_loss(p):
        bt = batch(3)
        with torch.no_grad():
            loss = transformer.loss_fn(p, cfg, bt["tokens"], bt["labels"])
        return float(loss.to_local() if shd.is_global(loss) else loss)

    rec = {"arch": "starcoder2-3b", "layers": cfg.n_layers,
           "dtype": cfg.dtype, "batch": tcfg.batch, "seq": tcfg.seq}
    mesh = make_mesh(2, 2)
    with shd.use_rules(mesh, shd.DEFAULT_RULES):
        p, o = fresh()
        p, o = shd.distribute_tree(p, mesh), shd.distribute_tree(o, mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, o, losses, norms = run(p, o, 0, 2)
        rec["mesh_step_wall_ms"] = (time.perf_counter() - t0) * 1e3 / 2
        t0 = time.perf_counter()
        checkpoint.save(inp["ckpt"], 2, {"params": p, "opt": o})
        rec["save_s"] = time.perf_counter() - t0
    del p, o
    torch.cuda.empty_cache()
    small = make_mesh(1, 2, ranks=[0, 1])
    resumed = None
    if rank < 2:
        with shd.use_rules(small, shd.DEFAULT_RULES):
            p, o = fresh()
            axes = transformer.model_axes(cfg)
            p_sh = shd.sharding_tree(axes, shd.DEFAULT_RULES, small, p)
            o_sh = {"m": p_sh, "v": p_sh,
                    "step": shd.NamedSharding(small, shd.P())}
            t0 = time.perf_counter()
            state, manifest = checkpoint.load(
                inp["ckpt"], {"params": p, "opt": o},
                shardings={"params": p_sh, "opt": o_sh})
            rec["load_s"] = time.perf_counter() - t0
            del p, o
            p, o = state["params"], state["opt"]
            rec["resumed_sharded_leaves"] = sum(
                any(pl.is_shard() for pl in t.placements)
                for _, t in port_tree.jax_leaves(p))
            p, o, last, last_norm = run(p, o, manifest["step"], 1)
            losses += last + [next_loss(p)]
            norms += last_norm
            resumed = {k: shd.full_tensor(t)
                       for k, t in port_tree.jax_leaves(p)}
            del p, o, state
    rec["losses"] = losses
    rec["grad_norms"] = norms
    if rank == 0:
        p, o = fresh()
        init = {k: t.clone() for k, t in port_tree.jax_leaves(p)}
        grads = {}
        p, o, want, want_norms = run(p, o, 0, 2, grads)
        before = next_loss(p)
        second = {k: t.clone() for k, t in port_tree.jax_leaves(p)}
        p, o, last, last_norm = run(p, o, 2, 1, grads)
        want += last + [next_loss(p)]
        want_norms += last_norm
        rec["one_process_losses"] = want
        rec["one_process_grad_norms"] = want_norms
        rec["loss_rel"] = max(abs(a - b) / abs(b)
                              for a, b in zip(losses, want))
        rec["grad_norm_rel"] = max(abs(a - b) / abs(b)
                                   for a, b in zip(norms, want_norms))
        # What the third step alone moves: the fourth loss, and each
        # leaf's change (a step left out would be off by this much).
        rec["third_step_loss_move_rel"] = abs(want[3] - before) / abs(
            want[3])
        change, third, held_share = {}, {}, {}
        for k, t in port_tree.jax_leaves(p):
            least, top = grads[k]
            held = least >= MESH_TRAIN_GRAD_FLOOR * top
            want_d = (t - init[k])[held]
            scale = want_d.abs().max()
            change[k] = float((resumed[k] - t)[held].abs().max() / scale)
            third[k] = float((t - second[k])[held].abs().max() / scale)
            held_share[k] = float(held.float().mean())
        worst = max(change, key=change.get)
        rec["change_rel"] = change[worst]
        rec["worst_leaf"] = {"key": worst, "change_rel": change[worst],
                             "held_share": held_share[worst]}
        rec["third_step_share_min"] = min(third.values())
        rec["held_share_min"] = min(held_share.values())
        del p, o, second
    del resumed
    torch.cuda.empty_cache()
    return rec


def mesh_rank(rank, inp):
    """What each rank of the ``mesh`` phase's world runs; returns its
    records and the kernel launches counted on its main-path runs."""
    import torch

    from repro_torch.launch.mesh import rank_device

    dev = rank_device("cuda")
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import ops

    out = {"rank": rank, "device": str(dev)}
    t0 = time.perf_counter()
    out["collectives"] = mesh_collectives(rank, dev)
    out["engine"], eng = mesh_engine(rank, dev)
    out["update"] = mesh_update(rank, dev, inp)
    out["prefill"], pre = mesh_prefill(rank, dev, inp)
    out["moe"] = mesh_moe(rank, dev, inp)
    out["train"] = mesh_train(rank, dev, inp)
    out["rank_s"] = time.perf_counter() - t0
    out["launches"] = {k: eng.get(k, 0) + pre.get(k, 0) for k in ops.LAUNCHES}
    return out


def phase_mesh(dev, card):
    """Several ranks: a world of ``MESH_WORLD`` spawned processes (NCCL
    with a card each where there are enough cards, else gloo with all on
    one card), built after the kernels, so that no rank builds them. See
    the ``mesh_*`` functions for the cases; every check runs here on the
    ranks' results, and a failing or hung rank fails the phase."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch.distributed.world import run_world

    torch.cuda.empty_cache()
    backend = mesh_backend()
    rng = np.random.default_rng(25)
    n = MESH_UPDATE_ROWS
    inp = {
        "update": dict(
            busy=np.sort(rng.uniform(0, 50, 512)).astype(np.float32),
            rr=np.int32(rng.integers(0, 512)),
            arrival=np.sort(rng.uniform(0, 200, n)).astype(np.float32),
            lba=rng.integers(0, 1 << 24, n).astype(np.int32),
            valid=rng.random(n) < 0.9),
        "prefill_tokens": rng.integers(
            0, 49152, (MESH_PREFILL_BATCH, MESH_PREFILL_SEQ)).astype(
                np.int32),
        "moe_tokens": rng.integers(
            0, 151936, (MESH_MOE_BATCH, MESH_MOE_SEQ)).astype(np.int32),
    }
    with tempfile.TemporaryDirectory(prefix="mesh_ckpt_") as tmp:
        inp["ckpt"] = tmp
        # The ranks import this file as the module ``chip_smoke`` (not as
        # the spawned ``__mp_main__``).
        sys.path.insert(0, str(ROOT))
        import chip_smoke

        ranks = run_world(chip_smoke.mesh_rank, MESH_WORLD, inp,
                          backend=backend, threads=2,
                          timeout_s=MESH_TIMEOUT_S, store_dir=tmp)
    r0 = ranks[0]
    launches = {k: sum(r["launches"][k] for r in ranks)
                for k in r0["launches"]}
    wall = {f"{e['drives']}x{e['ranks']}": [
        r["engine"][i]["wall_ms_per_round"] for r in ranks
        if i < len(r["engine"]) and r["engine"][i]["ranks"] == e["ranks"]]
        for i, e in enumerate(r0["engine"])}
    emit({"phase": "mesh", "card": card, "backend": backend,
          "world": MESH_WORLD, "device_count": torch.cuda.device_count(),
          "composed_collectives": [],
          "collectives": r0["collectives"], "engine": r0["engine"],
          "wall_ms_per_round_by_rank": wall, "update": r0["update"],
          "prefill": r0["prefill"], "moe": r0["moe"], "train": r0["train"],
          "rank_s": [r["rank_s"] for r in ranks], "launches": launches})
    for r in ranks:
        bad = [k for k, ok in r["collectives"].items() if not ok]
        check(not bad, f"rank {r['rank']} collectives: {bad}")
    for e in r0["engine"]:
        check(not e["differing_leaves"],
              f"sharded array {e}: differs from one process")
        check(e["fig17"] == ARRAY_REFERENCE[e["drives"]],
              f"sharded fig 17 at M = {e['drives']}: {e['fig17']}")
    u = r0["update"]
    check(u["completion_differing"] == 0 and u["busy_differing"] == 0
          and u["rr_equal"], f"distributed timing update: {u}")
    pre = r0["prefill"]
    for name in ("kernel", "megatron"):
        check(pre[f"{name}_max_abs_over_max_logit"] <= LOGIT_REL_BOUND
              and pre[f"{name}_cosine"] >= LOGIT_MIN_COSINE,
              f"sharded prefill ({name}): {pre}")
    check(sum(r["prefill"]["kernel_launches"]["flash_attention"]
              for r in ranks) > 0, "the sharded prefill launched no "
          "flash_attention kernel")
    check(r0["moe"]["max_abs_over_max"] <= MESH_MOE_REL,
          f"expert-parallel MoE: {r0['moe']}")
    tr = r0["train"]
    check(len(tr["losses"]) == 4 and len(tr["grad_norms"]) == 3
          and tr["resumed_sharded_leaves"] > 0
          and tr["loss_rel"] <= MESH_TRAIN_REL
          and tr["grad_norm_rel"] <= MESH_TRAIN_REL
          and tr["change_rel"] <= MESH_TRAIN_CHANGE_REL,
          f"training on the mesh and the elastic resume: {tr}")
    # The checks can see the resumed step: it alone moves the next loss
    # and every held leaf by more than their bounds.
    check(tr["third_step_loss_move_rel"] > MESH_TRAIN_REL
          and tr["third_step_share_min"] > MESH_TRAIN_CHANGE_REL,
          f"the resumed step moves less than the bounds: {tr}")
    for k in ("seg_scan", "fused_reap", "block_gather"):
        check(launches[k] > 0, f"the sharded runner launched no {k}")
    return launches


# -- main ---------------------------------------------------------------------

TPU_KERNELS = {
    "seg_scan": "src/repro/kernels/seg_scan.py:67",
    "die_contention": "src/repro/kernels/die_contention.py:63",
    "fused_reap": "src/repro/kernels/fused_reap.py:68",
    "block_gather": "src/repro/kernels/block_gather.py:50",
    "block_gather_tiled": "src/repro/kernels/block_gather.py:111",
    "flash_attention": "src/repro/kernels/flash_attention.py:141",
    "decode_attention": "src/repro/kernels/decode_attention.py:144",
}


def main() -> int:
    try:
        return run_all()
    finally:
        stop_cpu_workers()


def run_all() -> int:
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke.py: src/repro_torch not found beside the script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import build

    smi = nvidia_smi()
    card = smi
    PHASE_START[0] = time.perf_counter()
    build_s = build.build_all()
    ptxas = {k: [ln.strip() for ln in v.splitlines() if "registers" in ln]
             for k, v in build.BUILD_LOG.items()}
    emit({"phase": "env", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "build_s": build_s, "ptxas": ptxas})

    timing = run_phase(phase_kernels, dev, card)
    phase_launch_floor(card)
    launches = dict.fromkeys(build.KERNELS, 0)
    read = run_phase(phase_main_read, dev, card)
    for rec in (read, run_phase(phase_main_mixed, dev, card),
                run_phase(phase_main_baseline, dev, card, read)):
        for k, v in rec["launches"].items():
            launches[k] += v
    run_phase(phase_exact, dev, card)
    run_phase(phase_cpu_vs_card, dev, card)
    for fn, *args in ((phase_vector_search,), (phase_workloads,),
                      (phase_array,), (phase_cache,), (phase_qp,),
                      (phase_fabric, read), (phase_figures,),
                      (phase_variants,), (phase_serve_tier,),
                      (phase_serve_long,), (phase_serve_archs,),
                      (phase_train,), (phase_mesh,)):
        for k, v in run_phase(fn, dev, card, *args).items():
            launches[k] += v

    kernels = []
    for name in build.KERNELS:
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": TPU_KERNELS[name], "launches": launches[name],
            **timing[name],
        })
    emit({"kernels": kernels, "card": card})
    print(smi, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
