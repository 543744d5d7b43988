"""Modality frontend stubs (port of ``repro/models/modality.py``).

The ``audio`` (musicgen) and ``vision`` (qwen2-vl) configurations specify
the transformer backbone; the EnCodec tokenizer and the vision tower are
stubs that provide precomputed frame or patch embeddings of the right
shape, plus the M-RoPE position-id streams for the VLM. The embeddings
are draws of an explicit ``torch.Generator`` (on its device); the
position ids are integers and equal the reference's.
"""
from __future__ import annotations

import torch

from repro_torch.models import layers
from repro_torch.models.config import ModelConfig


def audio_frame_embeddings(gen: torch.Generator, cfg: ModelConfig,
                           batch: int, seq: int) -> torch.Tensor:
    """EnCodec-token embeddings summed over 4 codebooks (upstream stub)."""
    return layers.normal(gen, (batch, seq, cfg.d_model), 0.02,
                         getattr(torch, cfg.dtype))


def vision_patch_embeddings(gen: torch.Generator, cfg: ModelConfig,
                            batch: int, seq: int,
                            image_tokens: "int | None" = None
                            ) -> "tuple[torch.Tensor, torch.Tensor]":
    """Patch+text embedding stub (B, S, D) and (3, B, S) int32 M-RoPE
    position ids. The first ``image_tokens`` positions (default ``seq //
    4``) are an image grid: temporal id frozen at 0, height and width ids
    raster-scanned over rows of ``side``; the rest are text, whose three
    streams advance together from ``side`` on (Qwen2-VL's M-RoPE)."""
    image_tokens = image_tokens if image_tokens is not None else seq // 4
    side = max(int(image_tokens ** 0.5), 1)
    emb = layers.normal(gen, (batch, seq, cfg.d_model), 0.02,
                        getattr(torch, cfg.dtype))
    idx = torch.arange(seq, dtype=torch.int32, device=gen.device)
    is_img = idx < image_tokens
    zero = torch.zeros_like(idx)
    # Text positions continue after the image's max position.
    text_pos = torch.clamp(idx - image_tokens, min=0) + side
    t = torch.where(is_img, zero, text_pos)
    h = torch.where(is_img, idx // side, text_pos)
    w = torch.where(is_img, idx % side, text_pos)
    pos = torch.stack([t, h, w])                                # (3, S)
    return emb, pos[:, None, :].expand(3, batch, seq)
