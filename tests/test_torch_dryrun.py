"""The port's roofline counts (``repro_torch.launch.roofline``) against
hand counts, and its dry run (``repro_torch.launch.dryrun``) held to the
reference's record (``tests/test_dryrun_integration.py:25-33``).

A fake process group is initialised only in subprocesses
(``tests/torch_dryrun_checks.py`` and ``python -m
repro_torch.launch.dryrun``), never in a pytest worker. Hand counts:

- one bf16 (M, K) @ (K, N) product: 2·M·N·K FLOPs and (MK + KN + MN)·2
  bytes; a view moves nothing, an in-place add reads and writes;
- the same product on DTensors whose rows are split over 2 ranks:
  ``FlopCounterMode`` charges the global 2·M·N·K, ``count_step`` the
  rank's half;
- one all-gather of a (4, 32) float32 block over 2 ranks: its 512 operand
  bytes, on both of the port's routes (``sharding._gather``'s c10d op and
  a DTensor redistribution's functional op);
- starcoder2-3b SMOKE (B = 8, S = 64) on a fake (2, 2) mesh: rank 0's
  FLOPs times 4 against one device's, within ``MESH_FLOPS_RATIO``: the
  train step 1 to 1.1 and the prefill 1 to 1.15 (every ``model`` rank
  projects the GQA k and v heads whole; measured 1.083 and 1.114), the
  decode step 1 to 2 (each rank decodes its ``data`` rows with the
  parameters gathered whole, so the two ``model`` ranks repeat the
  products; measured 1.818).

The record of ``--arch starcoder2-3b --shape train_4k --mesh single``
(about a minute of counting on fake tensors) must be ``ok`` on 256
chips with positive FLOPs and collective bytes, a bottleneck among the
three, ``0.05 < useful_compute_ratio <= 1.5``, and terms formed with the
H100's constants; ``long_500k`` gives the reference's skip record.
"""
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.launch import dryrun, roofline, specs
from port_threads import one_torch_thread  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
TIMEOUT_S = 600
M, K, N = 8, 16, 32
MESH_FLOPS_RATIO = {"train": (1.0, 1.1), "prefill": (1.0, 1.15),
                    "decode": (1.0, 2.0)}
# analyze()'s keys: the reference's but its three XLA-only ones.
ANALYZE_KEYS = {
    "chips", "flops_per_device", "bytes_per_device",
    "collective_bytes_per_device", "collective_by_op", "compute_s",
    "memory_s", "collective_s", "bottleneck", "hbm_argument_bytes",
    "hbm_output_bytes", "hbm_temp_bytes", "hbm_peak_bytes",
    "model_flops_total", "model_flops_per_device", "useful_compute_ratio",
    "roofline_bound_s", "roofline_fraction"}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The checks script and two dry-run commands, run side by side."""
    tmp = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    dry = [sys.executable, "-m", "repro_torch.launch.dryrun",
           "--arch", "starcoder2-3b", "--out", str(tmp)]
    cmds = {
        "checks": [sys.executable,
                   os.path.join(HERE, "torch_dryrun_checks.py"),
                   str(tmp / "checks.json")],
        "train": dry + ["--shape", "train_4k", "--mesh", "single"],
        "skip": dry + ["--shape", "long_500k", "--mesh", "both"],
    }
    procs = {}
    for name, cmd in cmds.items():
        log = open(tmp / f"{name}.log", "w")
        procs[name] = (subprocess.Popen(cmd, env=env, cwd=REPO, stdout=log,
                                        stderr=subprocess.STDOUT), log)
    try:
        for name, (proc, log) in procs.items():
            proc.wait(timeout=TIMEOUT_S)
            log.close()
            assert proc.returncode == 0, (
                name, (tmp / f"{name}.log").read_text()[-3000:])
    finally:
        for proc, log in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    return tmp


def record(tmp, arch, shape, mesh):
    with open(tmp / f"{arch}__{shape}__{mesh}.json") as f:
        return json.load(f)


def test_matmul_counts_by_hand():
    mode = specs.fake_mode()
    a = specs.sds((M, K), torch.bfloat16, mode)
    b = specs.sds((K, N), torch.bfloat16, mode)
    c = roofline.count_step(lambda x, y: x @ y, (a, b), mode)
    assert c["flops"] == 2 * M * N * K
    assert c["flops_by_op"] == {"aten.mm": 2 * M * N * K}
    assert c["bytes"] == (M * K + K * N + M * N) * 2
    assert c["collective_bytes"] == 0 and c["collective_by_op"] == {}
    assert c["argument_bytes"] == (M * K + K * N) * 2
    assert c["output_bytes"] == c["temp_bytes"] == M * N * 2


def test_views_move_nothing_and_in_place_ops_read_and_write():
    mode = specs.fake_mode()
    x = specs.sds((M, K), torch.float32, mode)
    views = roofline.count_step(lambda t: (t.t(), t[0], t.reshape(K, M)),
                                (x,), mode)
    assert views["bytes"] == 0 and views["flops"] == 0
    assert views["temp_bytes"] == 0
    add = roofline.count_step(lambda t: t.add_(1.0), (x,), mode)
    assert add["bytes"] == 2 * M * K * 4 and add["temp_bytes"] == 0


def test_dtensor_matmul_is_charged_at_the_rank_s_share(runs):
    got = json.loads((runs / "checks.json").read_text())["matmul"]
    assert got["flop_counter_mode"] == 2 * M * N * K
    assert got["count_step"] == 2 * (M // 2) * N * K
    assert got["bytes"] == ((M // 2) * K + K * N + (M // 2) * N) * 2


def test_all_gather_operand_bytes_on_both_routes(runs):
    got = json.loads((runs / "checks.json").read_text())["all_gather"]
    assert got["c10d"] == {"all-gather": got["operand_bytes"]} == {
        "all-gather": 4 * 32 * 4}
    assert got["functional"] == {"all-gather": 4 * 32 * 4}


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_mesh_flops_against_one_device(runs, kind):
    got = json.loads((runs / "checks.json").read_text())["smoke"][kind]
    one, mesh = got["one_device"], got["mesh"]
    lo, hi = MESH_FLOPS_RATIO[kind]
    assert lo <= 4 * mesh["flops"] / one["flops"] <= hi
    assert one["collective_bytes"] == 0 < mesh["collective_bytes"]
    assert 0 < mesh["argument_bytes"] < one["argument_bytes"]
    assert mesh["temp_bytes"] > 0 and mesh["bytes"] > 0


def test_model_flops_are_the_reference_s():
    from repro_torch import configs

    cfg = configs.get_config("qwen3-moe-30b-a3b")
    n = cfg.active_param_count()
    assert n < cfg.param_count()
    sh = configs.SHAPES
    assert dryrun.model_flops(cfg, sh["train_4k"]) == 6.0 * n * 256 * 4096
    assert dryrun.model_flops(cfg, sh["prefill_32k"]) == 2.0 * n * 32 * 32768
    assert dryrun.model_flops(cfg, sh["decode_32k"]) == 2.0 * n * 128


def test_analyze_forms_the_h100_terms():
    counts = {"flops": 989e12, "bytes": 6.7e12, "collective_bytes": 450e9,
              "collective_by_op": {"all-gather": 450e9},
              "argument_bytes": 10, "output_bytes": 4, "temp_bytes": 5}
    out = roofline.analyze(counts, 256, model_flops=256 * 494.5e12)
    assert set(out) == ANALYZE_KEYS
    assert out["compute_s"] == 1.0 and out["memory_s"] == 2.0
    assert out["collective_s"] == 1.0 and out["bottleneck"] == "memory"
    assert out["roofline_bound_s"] == 2.0 and out["roofline_fraction"] == 0.5
    assert out["useful_compute_ratio"] == 0.5
    assert out["hbm_peak_bytes"] == 15 and out["chips"] == 256
    assert "useful_compute_ratio" not in roofline.analyze(counts, 256)


def test_dryrun_record_matches_the_reference_s_assertions(runs):
    rec = record(runs, "starcoder2-3b", "train_4k", "single")
    assert rec["status"] == "ok", rec
    assert rec["chips"] == 256 and rec["mesh"] == "16x16"
    assert rec["flops_per_device"] > 0
    assert rec["collective_bytes_per_device"] > 0
    assert rec["bottleneck"] in ("compute", "memory", "collective")
    assert 0.05 < rec["useful_compute_ratio"] <= 1.5
    assert rec["compute_s"] == rec["flops_per_device"] / 989e12
    assert rec["memory_s"] == rec["bytes_per_device"] / 3.35e12
    assert rec["collective_s"] == rec["collective_bytes_per_device"] / 450e9
    assert rec["count_s"] > 0
    assert "lower_s" not in rec and "compile_s" not in rec


def test_skip_records_for_full_attention_long_500k(runs):
    for mesh in ("single", "multi"):
        rec = record(runs, "starcoder2-3b", "long_500k", mesh)
        assert rec == {"cell": f"starcoder2-3b__long_500k__{mesh}",
                       "status": "skipped", "reason": dryrun.SKIP_REASON}
    # The reference's text (repro/launch/dryrun.py:35-37).
    assert dryrun.SKIP_REASON == (
        "long_500k needs sub-quadratic attention; this arch is pure "
        "full-attention (see DESIGN.md §Arch-applicability)")
