"""The paper's 40-MIOPS drive for the port, under SwarmIO and under the
NVMeVirt baseline, and profiles of its rounds and of the serving decode
step.

``local_1drive`` is ``benchmarks/emulator_speed.py``'s configuration of
that name: ``benchmarks/common.py::swarmio_cfg()`` (32 SQs x 1024, fetch
width 256, 16 service units, aggregated timing, coalesced DSA fetch,
DSA datapath) on ``FUTURE_40M`` (40e6 IOPS, 512 instances, 16384 blocks).
``nvmevirt_1drive`` is ``benchmarks/common.py::nvmevirt_cfg()`` (32 SQs x
1024, fetch width 64, one dispatcher over all SQs, one entry a
transaction, per-request timing and lock, 32 CPU copy workers) on the
same drive. ``array_4drive`` is emulator_speed's configuration of that
name: ``local_1drive``'s drive four times over, an emulated 4-drive array
in one program. ``remote_qos`` is emulator_speed's third configuration:
``local_1drive``'s engine with the drive behind a remote fabric (30000
B/us links each way, 2 us RTT, 0.2 us a wire transaction, MTU batches of
8 flushed after 5 us, a 60000 B/us switch shared by 4 links, weighted
fair queueing at 2:1) under a two-tenant loop (``MultiTenant``, depth
256, a read tenant and a write tenant).

    python -m repro_torch.bench [--rounds 24] [--mixed] [--plain] [--baseline]
                                [--array M] [--cache] [--qp N] [--remote]
                                [--trace PATH]
    python -m repro_torch.bench --serve [--steps 16] [--trace PATH]

The first runs the drive read-only with the kernel flags on and profiles
two runners from one initial state: the eager ``engine.run`` and the
runner of ``engine.make_runner`` (a CUDA graph of one round, replayed once
a round), each once to warm up and once under ``torch.profiler``.
``--mixed`` runs the drive under the 70/30 read/write mix instead
(``MixedReadWrite(read_frac=0.7)``, ``chip_smoke.py``'s
``main_path_mixed``) with ``use_pallas_flash`` on as well, so that the
rounds also price writes on the dies through ``die_contention``;
``--array M`` runs an M-drive array of the drive instead
(``engine.init_array_state`` and ``make_array_runner``: one round of all
M drives, one CUDA graph; ``--array 4`` is ``array_4drive``);
``--plain`` turns every kernel flag off, so that the rounds run the scans
on ``segops.associative_scan``; ``--baseline`` runs ``nvmevirt_1drive``
instead (``chip_smoke.py``'s ``main_path_baseline``: the per-request fold on
``die_contention`` and the baseline datapath's scans). ``--cache`` runs
fig 22's 1024-set row instead (``fig22_1024``: the Zipf loop at depth 256
on ``D7_PS1010`` with the page cache on, 1024 sets x 4 ways, two chased
hits a slot a round; ``chip_smoke.py``'s ``cache`` phase), and ``--qp N``
fig 21's row N (``local_1drive`` at depth 1024, a 25 us poll quantum, N
completions a doorbell with fig 21's doorbell, poll and reap costs, N = 0
the neutral QP; the ``qp`` phase), and ``--remote`` ``remote_qos``'s
rounds (``chip_smoke.py``'s ``fabric`` phase), each with the kernel
flags of the read rounds. ``--serve`` profiles the
serving decode step instead: starcoder2-3b at full width with the
attention kernels on, batch 8 after a 4096-token prompt
(``chip_smoke.py``'s ``serve_long``),
``--steps`` steps of the eager ``transformer.decode_step`` loop and of
the captured ``serving.loop.DecodeStep``, each after one warm-up step.
Each prints one JSON line holding, for each runner or step: wall and
device kernel time per round (or step), the device's idle share, device
events (kernels and copies), memcpy calls and the host's launch calls
(``cudaLaunchKernel``, ``cudaGraphLaunch``, ...) per round, the
host-device synchronisations in the window, the ops with the most device
time, and the device time per round of each of the port's engine kernels.
It needs a card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from repro_torch.core.types import EngineConfig, SSDConfig

FUTURE_40M = SSDConfig(name="future-40m", t_max_iops=40e6, l_min_us=30.0,
                       n_instances=512, num_blocks=1 << 14)


D7_PS1010 = SSDConfig(t_max_iops=2.47e6, l_min_us=50.0, n_instances=64,
                      num_blocks=1 << 14)


def nvmevirt_1drive(**kw):
    """(EngineConfig, SSDConfig) of the NVMeVirt baseline on ``FUTURE_40M``
    (``benchmarks/common.py::nvmevirt_cfg``); ``kw`` overrides
    EngineConfig fields."""
    base = dict(
        num_sqs=32, sq_depth=1024, fetch_width=64, num_units=1,
        workers_per_unit=32, frontend="centralized", mode="per_request",
        coalesced=False, dsa_fetch=False, batched_datapath=False,
        emulate_data=False, num_bufs=1 << 10,
    )
    base.update(kw)
    return EngineConfig(**base), FUTURE_40M


def local_1drive(**kw):
    """(EngineConfig, SSDConfig) of ``local_1drive``; ``kw`` overrides
    EngineConfig fields."""
    base = dict(
        num_sqs=32, sq_depth=1024, fetch_width=256, num_units=16,
        workers_per_unit=1, frontend="distributed", mode="aggregated",
        coalesced=True, batched_datapath=True, emulate_data=False,
        num_bufs=1 << 10,
    )
    base.update(kw)
    return EngineConfig(**base), FUTURE_40M


def fig22_1024(**kw):
    """(EngineConfig, SSDConfig, workload) of fig 22's 1024-set row
    (``benchmarks/figures.py::fig22_cache_hit_rate``); ``kw`` overrides
    EngineConfig fields."""
    from repro_torch.core.types import CacheConfig
    from repro_torch.workloads import ZipfClosedLoop

    cfg, _ = local_1drive(cache=CacheConfig(
        enabled=True, num_sets=1024, ways=4, hit_us=0.5, chase=2), **kw)
    return cfg, D7_PS1010, ZipfClosedLoop(io_depth=256, theta=0.9)


def fig21_row(n_coal: int, **kw):
    """(EngineConfig, SSDConfig, workload) of fig 21's row ``n_coal``
    (``benchmarks/figures.py::fig21_cq_coalescing``; 0 is its neutral
    QP); ``kw`` overrides EngineConfig fields."""
    from repro_torch.core.types import QPConfig, WorkloadConfig

    qp = (QPConfig(cq_coalesce_n=n_coal, cq_coalesce_us=50.0,
                   cq_doorbell_us=1.0, cq_poll_us=0.3, cqe_reap_us=0.02)
          if n_coal else QPConfig())
    cfg, ssd = local_1drive(poll_quantum_us=25.0, qp=qp, **kw)
    return cfg, ssd, WorkloadConfig(io_depth=1024)


def remote_qos(**kw):
    """(EngineConfig, SSDConfig, workload) of ``remote_qos``
    (``benchmarks/emulator_speed.py``); ``kw`` overrides EngineConfig
    fields."""
    from repro_torch.core.types import FabricConfig
    from repro_torch.workloads import MultiTenant

    fab = FabricConfig(
        remote=True, tx_bytes_per_us=30_000.0, rx_bytes_per_us=30_000.0,
        rtt_us=2.0, wire_txn_us=0.2, mtu_batch=8, mtu_timeout_us=5.0,
        switch_bytes_per_us=60_000.0, switch_fanin=4,
        qos_weights=(2.0, 1.0),
    )
    cfg, ssd = local_1drive(fabric=fab, **kw)
    return cfg, ssd, MultiTenant(io_depth=256, tenant_read_frac=(1.0, 0.0))


def array_4drive(**kw):
    """(EngineConfig, SSDConfig, M) of ``array_4drive``
    (``benchmarks/emulator_speed.py``): ``local_1drive`` on each of M = 4
    drives; ``kw`` overrides EngineConfig fields."""
    cfg, ssd = local_1drive(**kw)
    return cfg, ssd, 4


_SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
               "cudaEventSynchronize")
# Host API calls that put work on the device (names starting so), counted
# per round or step.
HOST_LAUNCH_CALLS = ("cudaGraphLaunch", "cudaLaunchKernel", "cuLaunchKernel",
                     "cudaLaunchKernelExC", "cudaMemcpy", "cudaMemset")

# Device-side names of the engine kernels' CUDA functions, by kernel.
_ENGINE_KERNELS = {
    "seg_scan": ("seg_scan_kernel",),
    "die_contention": ("die_contention_kernel",),
    "fused_reap": ("fused_reap_kernel",),
    "block_gather": ("gather_rows",),
}


def profiled(fn, n: int, trace: "str | None" = None) -> dict:
    """Run ``fn`` once under ``torch.profiler`` (after the caller's
    warm-up) and summarise it per each of its ``n`` rounds or steps."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels, syncs, memcpys, by_name = [], 0, 0, {}
    calls: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dur = e.time_range.end - e.time_range.start
            kernels.append(dur)
            by_name[e.name] = by_name.get(e.name, 0.0) + dur
            continue
        if e.name.startswith(_SYNC_CALLS):
            syncs += 1
        elif e.name.startswith("cudaMemcpy"):
            memcpys += 1
        if e.name.startswith(HOST_LAUNCH_CALLS):
            calls[e.name] = calls.get(e.name, 0) + 1
    if trace:
        prof.export_chrome_trace(trace)
    busy_us = float(sum(kernels))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    engine = {
        k: sum(v for name, v in by_name.items()
               if any(f in name for f in fns)) / 1e3 / n
        for k, fns in _ENGINE_KERNELS.items()
    }
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    return {
        "card": smi, "rounds": n,
        "wall_ms_per_round": wall * 1e3 / n,
        "device_ms_per_round": busy_us / 1e3 / n,
        "device_idle_share": 1.0 - busy_us / (wall * 1e6),
        "device_events_per_round": len(kernels) / n,
        # The window ends with one torch.cuda.synchronize() of its own.
        "host_syncs_in_window": syncs,
        "memcpy_calls_per_round": memcpys / n,
        "host_calls_per_round": {k: v / n for k, v in calls.items()},
        "top_device_ms_per_round": {
            k[:80]: v / 1e3 / n for k, v in top
        },
        "engine_kernel_device_ms_per_round": engine,
    }


def profile_rounds(rounds: int, trace: "str | None", mixed: bool = False,
                   plain: bool = False, baseline: bool = False,
                   num_devices: int = 1, cache: bool = False,
                   qp: "int | None" = None, remote: bool = False) -> dict:
    from repro_torch.core import engine
    from repro_torch.core.types import PlatformModel, WorkloadConfig
    from repro_torch.workloads import MixedReadWrite

    dev = torch.device("cuda", 0)
    on = not plain
    flags = dict(use_pallas=on, use_pallas_segscan=on, use_pallas_reap=on)
    wl = (MixedReadWrite(read_frac=0.7, io_depth=256) if mixed
          else WorkloadConfig(io_depth=256))
    if baseline:
        cfg, ssd = nvmevirt_1drive(use_pallas_flash=on, **flags)
    elif cache:
        cfg, ssd, wl = fig22_1024(**flags)
    elif qp is not None:
        cfg, ssd, wl = fig21_row(qp, **flags)
    elif remote:
        cfg, ssd, wl = remote_qos(**flags)
    else:
        cfg, ssd = local_1drive(emulate_data=True,
                                use_pallas_flash=mixed and on, **flags)
    plat = PlatformModel()
    if num_devices == 1:
        state = engine.init_state(cfg, ssd, wl, device=dev)
        runner = engine.make_runner(cfg, ssd, wl, plat, rounds, device=dev)
    else:
        state = engine.init_array_state(cfg, ssd, wl, num_devices,
                                        device=dev)
        runner = engine.make_array_runner(cfg, ssd, wl, plat, rounds,
                                          device=dev)

    def eager():
        return engine.run(state, cfg, ssd, wl, plat, rounds)

    out = {}
    for name, fn in (("eager", eager), ("make_runner", lambda: runner(state))):
        fn()
        out[name] = profiled(fn, rounds, trace and f"{trace}.{name}.json")
    path = "mixed 70/30 rounds" if mixed else "read rounds"
    if baseline:
        path = "NVMeVirt baseline " + path
    elif cache:
        path = "fig 22's 1024-set cached Zipf rounds"
    elif qp is not None:
        path = f"fig 21's rounds at {qp} completions a doorbell"
    elif remote:
        path = "remote_qos rounds"
    if num_devices > 1:
        path = f"{num_devices}-drive array, " + path
    return {"path": path + (", kernels off" if plain else ""),
            "num_devices": num_devices, **out}


def profile_decode(steps: int, trace: "str | None", batch: int = 8,
                   prompt: int = 4096) -> dict:
    from repro_torch.launch import serve
    from repro_torch.models import transformer
    from repro_torch.serving import loop

    dev = torch.device("cuda", 0)
    cache_len = prompt + steps + 2
    cfg, params, tokens, _, _ = serve.setup(
        "starcoder2-3b", batch=batch, prompt=prompt, gen=steps + 2,
        device="cuda")
    cfg = cfg.replace(use_pallas=True)
    positions = torch.arange(cache_len, dtype=torch.int32, device=dev)
    out = {}
    with torch.no_grad():
        logits, caches = transformer.prefill(params, cfg, tokens,
                                             cache_len=cache_len)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        transformer.decode_step(params, cfg, tok, caches, positions[prompt])

        def eager():
            for i in range(steps):
                transformer.decode_step(params, cfg, tok, caches,
                                        positions[prompt + 1 + i])

        out["eager"] = profiled(eager, steps, trace and f"{trace}.eager.json")
        step = loop.DecodeStep(cfg, params, caches, batch, cache_len, dev)
        step.start(tok, prompt)
        step()  # the eager first step, then the capture

        def graphed():
            for _ in range(steps):
                step()

        out["graph"] = profiled(graphed, steps,
                                trace and f"{trace}.graph.json")
    return {"path": "serve decode step", "batch": batch,
            "cache_len": cache_len, **out}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=24)
    ap.add_argument("--serve", action="store_true",
                    help="profile the serving decode step instead")
    ap.add_argument("--mixed", action="store_true",
                    help="profile rounds of the 70/30 read/write mix")
    ap.add_argument("--plain", action="store_true",
                    help="rounds with every kernel flag off")
    ap.add_argument("--baseline", action="store_true",
                    help="profile rounds of the NVMeVirt baseline")
    ap.add_argument("--array", type=int, default=1, metavar="M",
                    help="profile rounds of an M-drive array")
    ap.add_argument("--cache", action="store_true",
                    help="profile fig 22's 1024-set cached rounds")
    ap.add_argument("--qp", type=int, default=None, metavar="N",
                    help="profile fig 21's rounds at N completions a "
                         "doorbell (0: the neutral QP)")
    ap.add_argument("--remote", action="store_true",
                    help="profile remote_qos's rounds (remote fabric, "
                         "two tenants)")
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--trace", default=None,
                    help="write the chrome trace here")
    args = ap.parse_args()
    # --cache, --qp and --remote bring their own drive and workload: they
    # take no other rounds' option, so the label names the rounds profiled.
    own = [f for f, on in (("--cache", args.cache),
                           ("--qp", args.qp is not None),
                           ("--remote", args.remote),
                           ("--mixed", args.mixed),
                           ("--baseline", args.baseline)) if on]
    if (args.cache or args.qp is not None or args.remote) and len(own) > 1:
        ap.error(" and ".join(own) + " do not combine")
    if not torch.cuda.is_available():
        raise SystemExit("repro_torch.bench needs a CUDA device")
    if args.serve:
        res = profile_decode(args.steps, args.trace)
    else:
        res = profile_rounds(args.rounds, args.trace, args.mixed, args.plain,
                             args.baseline, args.array, args.cache, args.qp,
                             args.remote)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
