"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, loaded with ``ctypes``. The build runs
at first use, all sources at once (one ``nvcc`` process per source), into
``build/repro_torch_kernels/`` at the repository root; a library's file
name carries a hash of its source and flags, so an edited source is
rebuilt and a stale library is never loaded. A failed build raises.

``LAUNCHES`` counts, per kernel, the wrapper calls that launched it; the
wrappers add one right after their launch and nowhere else.
``launch_floor.cu`` (an empty kernel, the device's cost of one launch) is
built with the kernels but is not one of them: it has no count.

A wrapper's launch path is part of its cost, since the main path's
kernels take microseconds: ``bind`` sets a launch function's signature
once and returns the cached function after that, pointers and the stream
pass as Python ints.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Tuple

KERNELS = ("seg_scan", "die_contention", "fused_reap", "block_gather",
           "block_gather_tiled", "flash_attention", "decode_attention")

LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}

# Built beside the kernels, timed by chip_smoke.py, launched by no path.
SOURCES = KERNELS + ("launch_floor",)

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = (
    Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
_FNS: Dict[str, Tuple["ctypes._CFuncPtr", tuple]] = {}
_LOCK = threading.Lock()
BUILD_LOG: Dict[str, str] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{tag}.so"


def build_all() -> float:
    """Compile every kernel that has no up-to-date library; returns the
    wall seconds the build took (0 when everything was built already)."""
    todo = [n for n in SOURCES if not _lib_path(n).exists()]
    if not todo:
        return 0.0
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        BUILD_LOG[name] = out
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{out}")
            os.unlink(tmp)
        else:
            os.replace(tmp, _lib_path(name))
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building all kernels first
    if any is missing."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = _lib_path(name)
            if not path.exists():
                build_all()
            lib = ctypes.CDLL(str(path))
            err = getattr(lib, f"{name}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


def check(name: str, rc: int) -> None:
    """Raise if a launch function returned a CUDA error."""
    if rc != 0:
        msg = getattr(library(name), f"{name}_error_string")(rc)
        raise RuntimeError(
            f"CUDA kernel {name} failed to launch: error {rc} "
            f"({msg.decode(errors='replace')})"
        )


def require(t, what: str, dtype=None, ndim=None, device=None) -> None:
    """Validate one kernel input: a contiguous CUDA tensor of the given
    dtype, rank and device (a ``torch.device`` or its index). Raises
    ``ValueError`` naming the input."""
    import torch

    if not isinstance(t, torch.Tensor) or not t.is_cuda:
        raise ValueError(f"{what} must be a CUDA tensor")
    if device is not None:
        index = device if isinstance(device, int) else device.index
        if t.get_device() != index:
            raise ValueError(f"{what} is on {t.device}, expected cuda:{index}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{what} must be {dtype}, got {t.dtype}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{what} must have {ndim} dims, got {t.dim()}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def launch_args(device) -> Tuple[int, int]:
    """(device index, stream handle) for a launch on the current PyTorch
    stream of ``device`` (a ``torch.device`` or its index), as ints."""
    import torch

    index = device if isinstance(device, int) else device.index
    return index, torch.cuda.current_stream(index).cuda_stream


def ptr(t) -> int:
    return t.data_ptr()


def bind(name: str, argtypes) -> "ctypes._CFuncPtr":
    """The C launch function ``<name>_launch`` with its signature set; the
    first call loads the library and sets the signature, later calls
    return the cached function. A later call with other ``argtypes``
    raises ``ValueError``: one function has one signature."""
    sig = tuple(argtypes)
    got = _FNS.get(name)
    if got is None:
        fn = getattr(library(name), f"{name}_launch")
        fn.argtypes = sig
        fn.restype = ctypes.c_int
        _FNS[name] = got = (fn, sig)
    elif got[1] != sig:
        raise ValueError(
            f"{name}_launch is bound with argtypes {got[1]}, not {sig}")
    return got[0]
