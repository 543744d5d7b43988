"""Device meshes over the process group (port of ``repro/launch/mesh.py``).

A mesh is a ``DeviceMesh`` of the initialised world with the reference's
axis names, built by a function: importing this module touches no
device or process group. The device type is ``cuda`` unless named; on a
card rank r uses ``cuda:(r % torch.cuda.device_count())``, so a world of
more ranks than cards shares them (under gloo; NCCL refuses two ranks on
one card).
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _device_type(device) -> str:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device found; pass device='cpu' to build a mesh "
                "of CPU ranks")
        return "cuda"
    return torch.device(device).type


def rank_device(device=None) -> torch.device:
    """This rank's device: ``cuda:(rank % device_count)`` on a card, else
    the CPU."""
    if _device_type(device) == "cuda":
        return torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
    return torch.device("cpu")


def _mesh(shape: tuple, names: tuple, device, ranks=None):
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    if not dist.is_initialized():
        raise ValueError("a mesh needs an initialised process group of "
                         "its ranks (torch.distributed.init_process_group, "
                         "or torchrun)")
    n = 1
    for s in shape:
        n *= s
    have = dist.get_world_size() if ranks is None else len(ranks)
    if n != have:
        raise ValueError(f"a {shape} mesh needs {n} ranks; "
                         + ("the world has" if ranks is None else "given")
                         + f" {have}")
    kind = _device_type(device)
    if kind == "cuda":
        torch.cuda.set_device(rank_device("cuda"))
    if ranks is None:
        return init_device_mesh(kind, shape, mesh_dim_names=names)
    # Every rank of the world builds it (its groups are made collectively);
    # a rank outside ``ranks`` holds no coordinate.
    return DeviceMesh(kind, torch.tensor(list(ranks)).reshape(shape),
                      mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device)


def make_mesh(data: int, model: int, pod: int = 1, device=None, ranks=None):
    """Elastic meshes for downsized restarts and tests: over the whole
    world, or over ``ranks`` of it (an elastic downsize inside one
    world)."""
    if pod > 1:
        return _mesh((pod, data, model), ("pod", "data", "model"), device,
                     ranks)
    return _mesh((data, model), ("data", "model"), device, ranks)


def make_axis_mesh(axis_name: str = "dev", device=None, ranks=None):
    """A 1-D mesh named ``axis_name`` over the whole world or over
    ``ranks`` (the reference's ``Mesh(devices, (axis_name,))``)."""
    n = dist.get_world_size() if ranks is None else len(ranks)
    return _mesh((n,), (axis_name,), device, ranks)
