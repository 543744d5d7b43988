"""Helpers of the port's mesh tests: the reference's side in a subprocess
(``tests/torch_mesh_reference.py`` on 4 virtual CPU devices, ``XLA_FLAGS``
set before JAX starts) running while the port's world of gloo ranks runs
(``repro_torch.distributed.world.run_world``, rendezvous through a file).

    proc = start_reference("engine", inputs, tmp_path)
    port = run_world(body, 4, ...)        # meanwhile
    ref = reference_result(proc)
"""
import os
import pickle
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
REFERENCE_TIMEOUT_S = 240
WORLD_TIMEOUT_S = 240


def start_reference(case: str, inputs: dict, tmp_dir) -> tuple:
    """Start the reference's ``case`` on ``inputs``; returns a handle for
    ``reference_result``."""
    in_path = os.path.join(str(tmp_dir), f"{case}_in.pkl")
    out_path = os.path.join(str(tmp_dir), f"{case}_out.pkl")
    with open(in_path, "wb") as f:
        pickle.dump(inputs, f)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src"), ROOT, env.get("PYTHONPATH", "")])
    proc = subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_mesh_reference.py"), case,
         in_path, out_path],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return proc, out_path


def reference_result(handle) -> dict:
    """Wait for the reference's process (killed past its timeout); its
    results, or an assertion error with its output."""
    proc, out_path = handle
    try:
        out, _ = proc.communicate(timeout=REFERENCE_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
        raise AssertionError("reference timed out:\n" + out.decode()[-4000:])
    assert proc.returncode == 0, out.decode()[-4000:]
    with open(out_path, "rb") as f:
        return pickle.load(f)
