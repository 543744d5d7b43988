"""Serving loop: batched prefill + greedy decode with virtual-time step
accounting from the SSD-backed KV tier (port of
``repro/serving/loop.py``).

``generate`` runs the real model: prefill, then one ``decode_step`` per
generated token, the position a host integer and the tokens staying on
the device, so nothing in the loop waits for the card until the end.
``serve_with_kv_tier`` adds the tier's virtual-time stats
(``kv_tier.decode_tokens_per_s``: ``tokens_per_s``, ``avg_step_us``,
``avg_storage_us``, ``blocks_per_step``, ``iops_demand`` and
``data_check_max_abs``, which must be exactly 0.0). Virtual tokens/s is
the emulated deployment's metric; ``prefill_s`` and ``wall_s`` are the
card's (or the CPU's) own wall-clock times.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.core.types import EngineConfig, SSDConfig
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.serving import kv_tier


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    batch: int = 4
    prompt_len: int = 32
    gen_tokens: int = 16
    greedy: bool = True
    tier: kv_tier.KVTierConfig = kv_tier.KVTierConfig()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(
    cfg: ModelConfig,
    params,
    tokens: torch.Tensor,           # (B, prompt) i32 on the model's device
    scfg: ServeConfig,
    keep_logits: bool = False,
) -> dict:
    """Greedy generation of ``scfg.gen_tokens`` tokens. Returns
    ``tokens`` (B, gen) i32, ``prefill_s`` and ``wall_s`` (the decode
    loop), both ending in a device synchronize, and with ``keep_logits``
    the prefill's and every decode step's (B, V) float32 logits."""
    b, s = tokens.shape
    device = tokens.device
    cache_len = s + scfg.gen_tokens
    _sync(device)
    t0 = time.perf_counter()
    logits, caches = transformer.prefill(params, cfg, tokens,
                                         cache_len=cache_len)
    out = [torch.argmax(logits, dim=-1).to(torch.int32)]
    kept = [logits] if keep_logits else []
    _sync(device)
    t1 = time.perf_counter()
    for i in range(scfg.gen_tokens - 1):
        logits, caches = transformer.decode_step(params, cfg, out[-1], caches,
                                                 s + i)
        out.append(torch.argmax(logits, dim=-1).to(torch.int32))
        if keep_logits:
            kept.append(logits)
    _sync(device)
    res = {
        "tokens": torch.stack(out, dim=1),
        "prefill_s": t1 - t0,
        "wall_s": time.perf_counter() - t1,
    }
    if keep_logits:
        res["logits"] = kept
    return res


def serve_with_kv_tier(
    cfg: ModelConfig,
    params,
    tokens: torch.Tensor,
    scfg: ServeConfig,
    ssd: SSDConfig,
    ecfg: "EngineConfig | None" = None,
) -> dict:
    """Generate + virtual-time accounting for the SSD cold-KV tier (on
    the tokens' device)."""
    gen = generate(cfg, params, tokens, scfg)
    ecfg = ecfg or EngineConfig(num_units=4, fetch_width=64)
    stats = kv_tier.decode_tokens_per_s(
        cfg, scfg.tier, ssd, ecfg,
        batch=tokens.shape[0],
        start_len=tokens.shape[1],
        n_steps=scfg.gen_tokens,
        device=tokens.device,
    )
    return {**gen, **stats}
