# Port of repro/configs/qwen3_moe_30b_a3b.py (data only).
"""qwen3-moe-30b-a3b [moe] — 48L d_model=2048 32H (GQA kv=4) d_ff=768
vocab=151936, MoE 128 experts top-8. [hf:Qwen/Qwen3-30B-A3B; hf]"""
from repro_torch.models.config import ATTN, ModelConfig

FULL = ModelConfig(
    name="qwen3-moe-30b-a3b",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, d_head=128,
    d_ff=768, vocab=151936,
    pattern=(ATTN,),
    norm="rmsnorm", mlp_act="silu", mlp_gated=True,
    qk_norm=True,                       # qwen3 per-head q/k RMSNorm
    rope="rope", rope_theta=1e6,
    n_experts=128, top_k=8, d_expert=768,
    tie_embeddings=False,
)

SMOKE = FULL.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=32, vocab=256, n_experts=8, top_k=2, d_expert=32,
    dtype="float32", loss_chunk=64, attn_chunk=64, remat=False,
)
