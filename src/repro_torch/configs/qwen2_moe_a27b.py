# Port of repro/configs/qwen2_moe_a27b.py (data only).
"""qwen2-moe-a2.7b [moe] — 24L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=151936, MoE 60e top-4 + 4 shared experts.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]"""
from repro_torch.models.config import ATTN, ModelConfig

FULL = ModelConfig(
    name="qwen2-moe-a2.7b",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, d_head=128,
    d_ff=1408, vocab=151936,
    pattern=(ATTN,),
    norm="rmsnorm", mlp_act="silu", mlp_gated=True,
    qkv_bias=True,                      # qwen1.5/qwen2-family q/k/v biases
    rope="rope", rope_theta=1e6,
    n_experts=60, top_k=4, d_expert=1408,
    n_shared_experts=4, d_shared_expert=4 * 1408,   # fused shared branch
    tie_embeddings=False,
)

SMOKE = FULL.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
    d_ff=32, vocab=256, n_experts=6, top_k=2, d_expert=32,
    n_shared_experts=2, d_shared_expert=64,
    dtype="float32", loss_chunk=64, attn_chunk=64, remat=False,
)
