"""Serving loop: batched prefill + greedy decode with virtual-time step
accounting from the SSD-backed KV tier (port of
``repro/serving/loop.py``).

``generate`` runs the real model: prefill, then one greedy decode step
per generated token (``DecodeStep``). The step reads its token and its
position from device buffers and writes the next token, the logits and
the next position back into them, so nothing in the loop waits for the
card until the end. On a card the step is a CUDA graph: its first call
runs it eagerly and captures it, every later call is one replay. Each
``generate`` builds its own step on its own caches and drops it on
return, so the graph, its memory pool, the caches and the step's hold on
the parameters live no longer than the call. On the CPU the step runs
eagerly. Prefill stays eager.
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

from repro_torch import cuda_graph
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


class DecodeStep:
    """One greedy decode step on static buffers: ``tokens`` (B, cache
    length) i32 holds the tokens by position, ``pos`` () i32 the position
    of the next input token, ``logits`` (B, V) f32 the last step's
    logits. A call reads ``tokens[:, pos]``, writes its k/v rows into
    ``caches`` (the caller's, updated in place) at ``pos``, the argmax
    into ``tokens[:, pos + 1]`` and adds one to ``pos``; ``pos + 1`` must
    stay below the cache length.

    On a card the first call runs the step eagerly on the capture stream
    and then captures it; every later call replays the graph. A capture
    that fails raises. The caller owns the step: dropping it frees the
    graph and its buffers."""

    def __init__(self, cfg: ModelConfig, params, caches, batch: int,
                 cache_len: int, device: torch.device):
        self.cfg, self.params, self.caches = cfg, params, caches
        self.tokens = torch.zeros((batch, cache_len), dtype=torch.int32,
                                  device=device)
        self.pos = torch.zeros((), dtype=torch.int32, device=device)
        self.logits = torch.zeros((batch, cfg.vocab), dtype=torch.float32,
                                  device=device)
        self.graph: "cuda_graph.Captured | None" = None

    def start(self, first: torch.Tensor, pos: int) -> None:
        """Continue with token ``first`` (B,) i32 at position ``pos``."""
        self.tokens[:, pos] = first
        self.pos.fill_(pos)

    def _step(self) -> None:
        at = self.pos.reshape(1).long()
        tok = self.tokens.index_select(1, at)[:, 0]
        logits, _ = transformer.decode_step(self.params, self.cfg, tok,
                                            self.caches, self.pos)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        self.tokens.index_copy_(1, at + 1, nxt[:, None])
        self.logits.copy_(logits)
        self.pos.add_(1)

    def __call__(self) -> None:
        if self.tokens.device.type != "cuda":
            self._step()
        elif self.graph is None:
            self.graph = cuda_graph.Captured(self._step, self.tokens.device,
                                             warm=self._step)
        else:
            self.graph.replay()


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
    step = DecodeStep(cfg, params, caches, b, cache_len, device)
    step.start(torch.argmax(logits, dim=-1).to(torch.int32), s)
    kept = [logits] if keep_logits else []
    _sync(device)
    t1 = time.perf_counter()
    for _ in range(scfg.gen_tokens - 1):
        step()
        if keep_logits:
            kept.append(step.logits.clone())
    _sync(device)
    res = {
        "tokens": step.tokens[:, s:cache_len].clone(),
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
