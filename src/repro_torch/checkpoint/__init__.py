"""Atomic checkpoints in the reference's layout (port of
``repro/checkpoint/__init__.py``), so that a checkpoint written by either
package loads in the other.

Layout: ``<dir>/step_<N>/`` (``step_%08d``) holding one ``leaf_%05d.npy``
per leaf, numbered in JAX's flatten order (dict keys sorted), and
``manifest.json`` with the step, each leaf's key string as
``jax.tree_util.keystr`` writes it and its dtype. A bfloat16 leaf is
stored as its uint16 payload with ``"dtype": "bfloat16"``. Writes go to
``step_<N>.tmp``, each file fsynced, and the directory is renamed only
then: a crashed writer never corrupts the latest checkpoint.

On a mesh (leaves that are DTensors) every rank gathers each leaf whole
and rank 0 alone writes. ``load`` reads every leaf on the host and places
it on one device, or, given ``shardings`` (a tree of
``sharding.NamedSharding``, e.g. from ``sharding.sharding_tree``), on the
current mesh as a DTensor under its spec: the reference's elastic
reshard-on-load, whatever mesh wrote the checkpoint.
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed import sharding as shd
from repro_torch.train.tree import map_with_keys, jax_leaves, tree_map


def _to_numpy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """(array to store, manifest dtype): bfloat16 as its uint16 payload."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def save(ckpt_dir: str, step: int, tree, extra: dict | None = None) -> str:
    """Atomically write checkpoint for ``step``. Returns the final path.
    A tree of DTensors is gathered on every rank and written by rank 0;
    the other ranks wait for the write."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if any(shd.is_global(t) for _, t in jax_leaves(tree)):
        whole = tree_map(shd.full_tensor, tree)
        if dist.get_rank() == 0:
            save(ckpt_dir, step, whole, extra)
        dist.barrier()
        return final
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)

    names = {}
    for i, (key, val) in enumerate(jax_leaves(tree)):
        fname = f"leaf_{i:05d}.npy"
        arr, dtype_str = _to_numpy(val)
        with open(os.path.join(tmp, fname), "wb") as f:
            np.save(f, arr)
            f.flush()
            os.fsync(f.fileno())
        names[key] = {"file": fname, "dtype": dtype_str}
    manifest = {
        "step": step,
        "leaves": names,
        "extra": extra or {},
        "treedef": None,  # structure re-derived from a template on load
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [
        int(d.split("_")[1])
        for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and not d.endswith(".tmp")
    ]
    return max(steps) if steps else None


def _from_numpy(arr: np.ndarray, entry) -> torch.Tensor:
    """The stored array as a tensor; a bfloat16 leaf's uint16 payload is
    viewed as bfloat16 (no ``ml_dtypes`` needed)."""
    if isinstance(entry, dict) and entry["dtype"] == "bfloat16":
        return torch.from_numpy(
            arr.copy(order="C").view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr.copy(order="C"))


def load(ckpt_dir: str, template, step: int | None = None, device=None,
         shardings=None):
    """Load into ``template``'s structure, each leaf in its template leaf's
    dtype, on ``device`` (each template leaf's own device when None);
    ``shardings`` (same structure or None) re-places each leaf on the
    current mesh (elastic reshard). Returns (tree, manifest)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)

    def leaf(key, tmpl):
        entry = manifest["leaves"][key]
        fname = entry["file"] if isinstance(entry, dict) else entry
        t = _from_numpy(np.load(os.path.join(path, fname)), entry)
        if tuple(t.shape) != tuple(tmpl.shape):
            raise ValueError(
                f"shape mismatch for {key}: ckpt {tuple(t.shape)} vs "
                f"template {tuple(tmpl.shape)}"
            )
        dev = device if device is not None else (
            tmpl.to_local().device if shd.is_global(tmpl) else tmpl.device)
        return t.to(device=dev, dtype=tmpl.dtype)

    tree = map_with_keys(leaf, template)
    if shardings is not None:
        tree = tree_map(lambda t, sh: shd.distribute(t, sh.mesh, sh.spec),
                        tree, shardings)
    return tree, manifest


def gc_old(ckpt_dir: str, keep: int = 3):
    """Delete all but the newest ``keep`` checkpoints (and stale tmps)."""
    if not os.path.isdir(ckpt_dir):
        return
    entries = sorted(
        d for d in os.listdir(ckpt_dir) if d.startswith("step_")
    )
    tmps = [d for d in entries if d.endswith(".tmp")]
    finals = [d for d in entries if not d.endswith(".tmp")]
    for d in tmps + finals[:-keep] if keep else tmps:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)
