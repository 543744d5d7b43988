"""Declarative model configuration covering the full assigned-arch zoo
(port of ``repro/models/config.py``, field for field).

One dataclass describes any member of the pool: dense / MoE / SSM / hybrid
LM backbones, with per-layer-pattern heterogeneity (gemma2 local-global
alternation, griffin 1:2 recurrent:attention, xLSTM 7:1 mLSTM:sLSTM)
expressed as a repeating ``pattern`` of block kinds that the runtime scans
over (params stacked per pattern member — HLO stays O(pattern), not O(L)).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

# Block kinds appearing in `pattern`.
ATTN = "attn"            # full (global) self-attention + MLP
ATTN_LOCAL = "attn_local"  # sliding-window self-attention + MLP
RGLRU = "rglru"          # griffin RG-LRU recurrent block + MLP
MLSTM = "mlstm"          # xLSTM matrix-memory block (no separate MLP)
SLSTM = "slstm"          # xLSTM scalar-memory block (no separate MLP)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int

    # Block structure.
    pattern: tuple[str, ...] = (ATTN,)
    parallel_block: bool = False        # attn+mlp in parallel (command-r)
    norm: str = "rmsnorm"               # "rmsnorm" | "layernorm"
    post_norms: bool = False            # gemma2 post-sublayer norms
    use_bias: bool = False
    mlp_act: str = "silu"               # "silu" | "gelu"
    mlp_gated: bool = True              # SwiGLU/GeGLU vs plain
    qk_norm: bool = False               # qwen3 per-head q/k RMSNorm
    qkv_bias: bool = False              # qwen2-style bias on q/k/v only

    # Attention details.
    rope: str = "rope"                  # "rope" | "mrope" | "none"
    rope_theta: float = 10000.0
    mrope_sections: tuple[int, ...] = (16, 24, 24)
    window: int = 4096                  # local-attention window
    attn_softcap: float | None = None
    final_softcap: float | None = None
    attn_scale: float | None = None     # override 1/sqrt(d_head)

    # MoE (n_experts == 0 ⇒ dense).
    n_experts: int = 0
    top_k: int = 0
    d_expert: int = 0
    n_shared_experts: int = 0
    d_shared_expert: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # Expert-parallel (experts sharded over "model" in shard_map). Measured
    # on qwen3-moe train_4k @16x16: cuts expert-grad all-reduce 12x and
    # total collectives 1.4x, but the seq all-gather/reduce-scatter pair
    # raises the (dominant) memory term 1.5x -> off by default at this
    # scale; the right choice at larger E/d_expert (see EXPERIMENTS §Perf).
    moe_ep: bool = False

    # Recurrent details.
    conv_width: int = 4                 # griffin temporal conv
    rglru_c: float = 8.0

    # Modality frontend stub ("none" | "audio" | "vision").
    modality: str = "none"

    # Embedding / head.
    tie_embeddings: bool = True
    embed_scale_by_dim: bool = False    # gemma: h *= sqrt(d_model)

    # Numerics / execution.
    dtype: str = "bfloat16"             # activation/param compute dtype
    loss_chunk: int = 512               # vocab-proj chunking (memory bound)
    remat: bool = True                  # activation checkpoint per block
    use_pallas: bool = False            # hand-written attention kernels
    attn_chunk: int = 1024              # jnp flash-style kv chunk

    def replace(self, **kw: Any) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    @property
    def n_periods(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def remainder(self) -> tuple[str, ...]:
        """Layers beyond the scanned periods (unrolled)."""
        r = self.n_layers - self.n_periods * len(self.pattern)
        return self.pattern[:r]

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, v = self.d_model, self.vocab
        total = v * d  # embedding
        if not self.tie_embeddings:
            total += d * v  # separate LM head
        qkv = d * (self.n_heads + 2 * self.n_kv_heads) * self.d_head
        out = self.n_heads * self.d_head * d
        mlp_in = 2 * d * self.d_ff if self.mlp_gated else d * self.d_ff
        mlp = mlp_in + self.d_ff * d
        for kind in self.pattern * self.n_periods + self.remainder:
            if kind in (ATTN, ATTN_LOCAL):
                total += qkv + out
                if self.n_experts:
                    e_in = (2 if self.mlp_gated else 1) * d * self.d_expert
                    total += self.n_experts * (e_in + self.d_expert * d)
                    total += d * self.n_experts  # router
                    if self.n_shared_experts:
                        s = self.d_shared_expert
                        total += (2 if self.mlp_gated else 1) * d * s + s * d
                        total += d  # shared gate
                else:
                    total += mlp
            elif kind == RGLRU:
                lru = d  # lru width == d_model
                total += 2 * d * lru + lru * d        # in/gate/out proj
                total += self.conv_width * lru + 2 * lru  # conv + lru params
                total += mlp
            elif kind == MLSTM:
                dh = self.n_heads * self.d_head
                total += d * 2 * dh * 2 + 2 * dh * d  # up-proj x2, q/k/v, down
            elif kind == SLSTM:
                dh = self.n_heads * self.d_head
                total += 4 * d * dh + 4 * dh + d * 4 * self.d_ff // max(self.d_ff, 1)
                total += d * dh
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed top-k + shared)."""
        if not self.n_experts:
            return self.param_count()
        full = self.param_count()
        e_in = (2 if self.mlp_gated else 1) * self.d_model * self.d_expert
        per_expert = e_in + self.d_expert * self.d_model
        n_attn = sum(
            1 for k in self.pattern * self.n_periods + self.remainder
            if k in (ATTN, ATTN_LOCAL)
        )
        return full - n_attn * (self.n_experts - self.top_k) * per_expert
