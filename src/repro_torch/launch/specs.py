"""Abstract input trees and their logical axes for every (arch x shape)
dry-run cell (port of ``repro/launch/specs.py``).

The reference's ``ShapeDtypeStruct`` trees are FakeTensors here: every
leaf has its shape, dtype and the CPU as its device, and holds no
storage. They are made under one ``FakeTensorMode``, which
``input_specs`` returns with them so that a step can run on them in the
same mode (``launch/roofline.py``). Nothing is allocated, and no leaf
lives on any device: a tree is the description of a step's inputs, not
the inputs. The mode takes real tensors as inputs too
(``allow_non_fake_inputs``): a ``DeviceMesh`` holds its ranks in a real
tensor, which the sharded steps read.
"""
from __future__ import annotations

from typing import Any

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import configs
from repro_torch.distributed.sharding import REPLICATED, _is_axes
from repro_torch.models import transformer
from repro_torch.models.config import (
    ATTN, ATTN_LOCAL, MLSTM, RGLRU, SLSTM, ModelConfig,
)
from repro_torch.train import optimizer as opt_lib

_SEED = 0   # stands in for the reference's PRNGKey(0); fake draws no value


def fake_mode() -> FakeTensorMode:
    """A fresh mode for one cell's abstract trees."""
    return FakeTensorMode(allow_non_fake_inputs=True)


def sds(shape, dtype, mode: FakeTensorMode) -> torch.Tensor:
    """An abstract tensor of ``shape`` and ``dtype`` (a torch dtype or its
    name) made in ``mode`` (``jax.ShapeDtypeStruct``)."""
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    with mode:
        return torch.empty(tuple(shape), dtype=dtype, device="cpu")


# ---------------------------------------------------------------------------
# Batch specs per shape kind.
# ---------------------------------------------------------------------------

def train_batch_specs(cfg: ModelConfig, batch: int, seq: int,
                      mode: FakeTensorMode):
    """(specs, logical axes) for a training batch."""
    spec: dict = {"labels": sds((batch, seq), torch.int32, mode)}
    axes: dict = {"labels": ("batch", "seq")}
    if cfg.modality == "none":
        spec["tokens"] = sds((batch, seq), torch.int32, mode)
        axes["tokens"] = ("batch", "seq")
    else:
        spec["embeds"] = sds((batch, seq, cfg.d_model), cfg.dtype, mode)
        axes["embeds"] = ("batch", "seq", "embed")
    if cfg.rope == "mrope":
        spec["mrope_positions"] = sds((3, batch, seq), torch.int32, mode)
        axes["mrope_positions"] = (None, "batch", "seq")
    return spec, axes


def prefill_batch_specs(cfg: ModelConfig, batch: int, seq: int,
                        mode: FakeTensorMode):
    spec: dict = {}
    axes: dict = {}
    if cfg.modality == "none":
        spec["tokens"] = sds((batch, seq), torch.int32, mode)
        axes["tokens"] = ("batch", "seq")
    else:
        spec["embeds"] = sds((batch, seq, cfg.d_model), cfg.dtype, mode)
        axes["embeds"] = ("batch", "seq", "embed")
    if cfg.rope == "mrope":
        spec["mrope_positions"] = sds((3, batch, seq), torch.int32, mode)
        axes["mrope_positions"] = (None, "batch", "seq")
    return spec, axes


def decode_batch_specs(cfg: ModelConfig, batch: int, mode: FakeTensorMode):
    spec: dict = {"pos": sds((), torch.int32, mode)}
    axes: dict = {"pos": REPLICATED}
    spec["token"] = sds((batch,), torch.int32, mode)
    axes["token"] = ("batch",)
    if cfg.modality != "none":
        # The token path is unused by the modality stubs.
        spec["embeds"] = sds((batch, cfg.d_model), cfg.dtype, mode)
        axes["embeds"] = ("batch", "embed")
    return spec, axes


# ---------------------------------------------------------------------------
# Model params / optimizer / caches: abstract trees + axes.
# ---------------------------------------------------------------------------

def abstract_params(cfg: ModelConfig, mode: FakeTensorMode):
    """``transformer.init_model``'s tree, fake."""
    with mode:
        return transformer.init_model(
            torch.Generator(device="cpu").manual_seed(_SEED), cfg)


def abstract_opt_state(params, mode: FakeTensorMode):
    """``optimizer.init_opt_state``'s {"m", "v", "step"} tree, fake."""
    with mode:
        return opt_lib.init_opt_state(params)


def opt_axes(p_axes):
    return {
        "m": p_axes,
        "v": p_axes,
        "step": REPLICATED,
    }


def _block_cache_axes(cfg: ModelConfig, kind: str):
    if kind in (ATTN, ATTN_LOCAL):
        kv = ("batch", "kv_heads", "kv_seq", "head_dim")
        return (kv, kv)
    if kind == RGLRU:
        return (("batch", "conv", "lru"), ("batch", "lru"))
    if kind == MLSTM:
        return (
            ("batch", "conv", "heads"),
            (
                ("batch", "heads", "head_dim", "head_dim"),
                ("batch", "heads", "head_dim"),
                ("batch", "heads"),
            ),
        )
    if kind == SLSTM:
        one = ("batch", "heads", "head_dim")
        return (one, one, one, one)
    raise ValueError(kind)


def _prepend(axes, name="layers"):
    if _is_axes(axes):
        return (name, *axes)
    return tuple(_prepend(a, name) for a in axes)


def cache_axes(cfg: ModelConfig):
    period = tuple(
        _prepend(_block_cache_axes(cfg, kind)) for kind in cfg.pattern
    )
    rem = tuple(_block_cache_axes(cfg, kind) for kind in cfg.remainder)
    return (period, rem)


def abstract_caches(cfg: ModelConfig, batch: int, cache_len: int,
                    mode: FakeTensorMode):
    """``transformer.init_caches``' tree, fake."""
    with mode:
        return transformer.init_caches(cfg, batch, cache_len, "cpu")


# ---------------------------------------------------------------------------
# Assembled per-cell specs.
# ---------------------------------------------------------------------------

def input_specs(arch: str, shape: str,
                mode: "FakeTensorMode | None" = None) -> dict[str, Any]:
    """All abstract inputs + axes for one dry-run cell, and the fake mode
    (``"fake_mode"``) they were made in (a fresh one unless given)."""
    mode = mode or fake_mode()
    cfg = configs.get_config(arch)
    sh = configs.SHAPES[shape]
    params = abstract_params(cfg, mode)
    p_axes = transformer.model_axes(cfg)
    out: dict = {"cfg": cfg, "shape": sh, "params": params,
                 "param_axes": p_axes, "fake_mode": mode}
    if sh.kind == "train":
        batch, axes = train_batch_specs(cfg, sh.global_batch, sh.seq_len,
                                        mode)
        out["opt_state"] = abstract_opt_state(params, mode)
        out["opt_axes"] = opt_axes(p_axes)
        out["batch"] = batch
        out["batch_axes"] = axes
    elif sh.kind == "prefill":
        batch, axes = prefill_batch_specs(cfg, sh.global_batch, sh.seq_len,
                                          mode)
        out["batch"] = batch
        out["batch_axes"] = axes
    else:  # decode
        batch, axes = decode_batch_specs(cfg, sh.global_batch, mode)
        out["batch"] = batch
        out["batch_axes"] = axes
        out["caches"] = abstract_caches(cfg, sh.global_batch, sh.seq_len,
                                        mode)
        out["cache_axes"] = cache_axes(cfg)
    return out
