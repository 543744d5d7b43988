#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``, then
runs six phases, printing one JSON line each:

  env              nvidia-smi's card name and power limit, torch/CUDA
                   versions, kernel build seconds
  kernels          every kernel against its plain PyTorch version on the
                   card, exact equality, at the main path's shapes and at
                   edge shapes; median CUDA-event times and bounds
  main_path_read   the paper's 40-MIOPS drive (``local_1drive``: 32 SQs x
                   1024, fetch 256, 16 units, DSA datapath, closed loop at
                   io_depth 256) for 24 rounds with the block_gather,
                   seg_scan and fused_reap kernels on
  main_path_mixed  the same drive under the 70/30 read/write mix with the
                   die_contention kernel on as well
  exact            an integer-timestamp drive at full width: kernels on and
                   off give bit-identical final states
  cpu_vs_card      stock local_1drive, kernels off, on the card and on the
                   CPU: integer leaves equal, float leaves within a stated
                   ULP bound

Then one JSON line listing the kernels, the nvidia-smi line, and the last
line ``{"ok": true, "device": {...}}``. Any failure raises and exits
non-zero; without a card, or without the repository around it, the script
exits non-zero before printing a result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
ROUNDS = 24
SUM_LEAF_ULP = 256          # cpu_vs_card bound for the metrics' float sums


class SmokeFailure(AssertionError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def emit(obj) -> None:
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


def bound(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- phase: kernels -----------------------------------------------------------

def kernel_cases(dev):
    """(name, kernel fn, plain fn, list of (label, args)) per kernel."""
    import numpy as np
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.block_gather import block_gather
    from repro_torch.kernels.die_contention import die_contention
    from repro_torch.kernels.fused_reap import fused_reap
    from repro_torch.kernels.seg_scan import seg_scan

    rng = np.random.default_rng(0)

    def t(x, dtype=None):
        return torch.as_tensor(np.asarray(x), device=dev, dtype=dtype)

    def ss(n, p_head):
        v = rng.uniform(-1e4, 1e4, n).astype(np.float32)
        h = rng.random(n) < p_head
        return (t(v), t(h))

    seg = [("main n=8192", ss(8192, 0.02)), ("ragged n=8229", ss(8229, 0.02)),
           ("n=5", ss(5, 0.3)), ("n=1", ss(1, 0.0)),
           ("all heads", ss(4096, 1.1)), ("no heads", ss(4133, 0.0)),
           ("n=300007 multi-chunk carry", ss(300007, 1e-4))]

    def dc(n, k, p_event, one_die=False):
        ready = rng.integers(0, 5000, n).astype(np.float32)
        cost = rng.choice([40.0, 200.0, 240.0], n).astype(np.float32)
        chip = (np.zeros(n) if one_die else rng.integers(0, k, n)).astype(
            np.int32)
        event = rng.random(n) < p_event
        cur = rng.integers(0, 3000, k).astype(np.float32)
        return (t(ready), t(cost), t(chip), t(event), t(cur))

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
        return tuple(t(x) for x in (dt, vt, rid, tail, key, done, req, valid))

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
        return (flash, t(idx))

    gather = [("main (16384,16) f32 n=8192", bg(16384, 16, 8192,
                                                torch.float32)),
              ("width 3 f32 (byte path)", bg(1000, 3, 777, torch.float32)),
              ("bf16 width 8", bg(512, 8, 300, torch.bfloat16)),
              ("f64 width 5", bg(256, 5, 100, torch.float64)),
              ("int32 width 16", bg(256, 16, 64, torch.int32)),
              ("indices out of range", bg(128, 16, 500, torch.float32,
                                          -50, 200)),
              ("n=0", bg(64, 16, 0, torch.float32))]

    return [
        ("seg_scan", seg_scan, ref.seg_scan_ref, seg),
        ("die_contention", die_contention, ref.die_contention_ref, die),
        ("fused_reap", fused_reap, ref.fused_reap_ref, reap),
        ("block_gather", block_gather, ref.block_gather_ref, gather),
    ]


def kernel_work(name, args):
    """(bytes, operations) the function needs on these inputs."""
    import torch

    if name == "seg_scan":
        n = args[0].numel()
        return n * (4 + 1 + 4), n
    if name == "die_contention":
        n, k = args[0].numel(), args[4].numel()
        ev = int(args[3].sum())
        return n * (4 + 4 + 4 + 1 + 4) + 2 * 4 * k, 2 * ev
    if name == "fused_reap":
        q, d = args[0].shape
        n = args[4].numel()
        return 2 * q * d * 12 + 2 * 4 * q + n * 13, 0
    flash, idx = args
    rows = torch.unique(idx.clamp(0, flash.shape[0] - 1)).numel()
    row_bytes = flash.shape[1] * flash.element_size()
    return rows * row_bytes + idx.numel() * 4 + idx.numel() * row_bytes, 0


def phase_kernels(dev, card):
    import torch

    out = {}
    detail = []
    for name, kern, plain, cases in kernel_cases(dev):
        for label, args in cases:
            got = kern(*args)
            want = plain(*args)
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            ok = all(bitwise_equal(g, w) for g, w in zip(got, want))
            detail.append({"kernel": name, "case": label, "exact": ok})
            check(ok, f"{name} [{label}] differs from its plain version")
        main = cases[0][1]
        got, want = kern(*main), plain(*main)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = max(
            float((g.double() - w.double()).abs().max()) if g.numel() else 0.0
            for g, w in zip(got, want)
        )
        nbytes, ops = kernel_work(name, main)
        b_ms, b_by = bound(nbytes, ops)
        lib = None
        if name == "block_gather":
            lib = median_ms(lambda: torch.index_select(main[0], 0, main[1]))
        out[name] = {
            "ms": median_ms(lambda: kern(*main)),
            "plain_ms": median_ms(lambda: plain(*main), reps=10),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
            "max_abs_err": err,
        }
    emit({"phase": "kernels", "card": card, "cases": detail,
          "timing": out})
    return out


# -- phases: the main path ----------------------------------------------------

def drive(cfg, ssd, wl, dev, reps=3):
    """Warm up once, then time ``reps`` runs of ROUNDS rounds each from the
    initial state; the launch counts cover exactly the timed runs."""
    import torch

    from repro_torch.core import engine
    from repro_torch.core.types import PlatformModel
    from repro_torch.kernels import ops

    state = engine.init_state(cfg, ssd, wl, device=dev)
    runner = engine.make_runner(cfg, ssd, wl, PlatformModel(), ROUNDS, dev)
    runner(state)
    torch.cuda.synchronize()
    ops.reset_launches()
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = runner(state)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    launches = dict(ops.LAUNCHES)
    m = out.metrics
    completed = float(m.completed)
    return out, {
        "virtual_miops": float(m.iops()) / 1e6,
        "p50_us": float(m.p50_us()), "p99_us": float(m.p99_us()),
        "completed_per_run": completed,
        "wall_s_median": statistics.median(walls),
        "emulated_requests_per_wall_s": completed / statistics.median(walls),
        "rounds_per_run": ROUNDS, "timed_runs": reps,
        "launches": launches,
    }


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
    state, rec = drive(cfg, ssd, WorkloadConfig(io_depth=256), dev)
    check_outputs(state, cfg)
    for k in ("seg_scan", "fused_reap", "block_gather"):
        check(rec["launches"][k] > 0, f"{k} did not launch on the main path")
    emit({"phase": "main_path_read", "card": card, **rec})
    return rec["launches"]


def phase_main_mixed(dev, card):
    from repro_torch.bench import local_1drive
    from repro_torch.workloads import MixedReadWrite

    cfg, ssd = local_1drive(emulate_data=True, **KERNEL_FLAGS)
    wl = MixedReadWrite(read_frac=0.7, io_depth=256)
    state, rec = drive(cfg, ssd, wl, dev)
    check_outputs(state, cfg)
    check(rec["launches"]["die_contention"] > 0,
          "die_contention did not launch on the main path")
    check(float(state.device.flash.valid_pages) > 0, "no write was priced")
    emit({"phase": "main_path_mixed", "card": card, **rec})
    return rec["launches"]


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
    st = engine.make_runner(cfg, ssd, wl, plat, rounds, dev)(st)
    return convert.engine_state_to_numpy(st)


def phase_exact(dev, card):
    from repro_torch.convert import leaf_differences
    from repro_torch.workloads import MixedReadWrite

    cfg, ssd, plat = exact_setup()
    wl = MixedReadWrite(read_frac=0.7, io_depth=256)
    off = run_states(cfg, ssd, plat, wl, dev, ROUNDS)
    on = run_states(cfg.replace(**KERNEL_FLAGS), ssd, plat, wl, dev, ROUNDS)
    diff = leaf_differences(off, on)
    emit({"phase": "exact", "card": card, "rounds": ROUNDS,
          "leaves": len(off), "differing_leaves": diff,
          "completed": float(off["metrics.completed"])})
    check(not diff, f"kernels on/off states differ in {diff}")


SUM_LEAVES = ("metrics.sum_e2e", "metrics.sum_target", "metrics.sum_proc",
              "metrics.tenant_sum_e2e")


def phase_cpu_vs_card(dev, card, rounds=8):
    from repro_torch.bench import local_1drive
    from repro_torch.convert import leaf_differences, ulp_distance
    from repro_torch.core.types import PlatformModel, WorkloadConfig

    cfg, ssd = local_1drive()
    wl = WorkloadConfig(io_depth=256)
    gpu = run_states(cfg, ssd, PlatformModel(), wl, dev, rounds)
    cpu = run_states(cfg, ssd, PlatformModel(), wl, "cpu", rounds)
    bounds = dict.fromkeys(SUM_LEAVES, SUM_LEAF_ULP)
    bad = leaf_differences(cpu, gpu, bounds)
    worst = {k: ulp_distance(cpu[k], gpu[k]) for k in cpu
             if cpu[k].dtype.kind == "f"}
    emit({"phase": "cpu_vs_card", "card": card, "rounds": rounds,
          "ulp_bound": {"metric sums": SUM_LEAF_ULP, "other floats": 0},
          "max_ulp": {k: v for k, v in worst.items() if v},
          "violations": bad})
    check(not bad, f"card and CPU states differ: {bad}")


# -- main ---------------------------------------------------------------------

TPU_KERNELS = {
    "seg_scan": "src/repro/kernels/seg_scan.py:67",
    "die_contention": "src/repro/kernels/die_contention.py:63",
    "fused_reap": "src/repro/kernels/fused_reap.py:68",
    "block_gather": "src/repro/kernels/block_gather.py:50",
}


def main() -> int:
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
    build_s = build.build_all()
    ptxas = {k: [ln.strip() for ln in v.splitlines() if "registers" in ln]
             for k, v in build.BUILD_LOG.items()}
    emit({"phase": "env", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "build_s": build_s, "ptxas": ptxas})

    timing = phase_kernels(dev, card)
    launches = dict.fromkeys(build.KERNELS, 0)
    for counts in (phase_main_read(dev, card), phase_main_mixed(dev, card)):
        for k, v in counts.items():
            launches[k] += v
    phase_exact(dev, card)
    phase_cpu_vs_card(dev, card)

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
