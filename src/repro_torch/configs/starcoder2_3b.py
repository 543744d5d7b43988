# Port of repro/configs/starcoder2_3b.py (data only).
"""starcoder2-3b [dense] — 30L d_model=3072 24H (GQA kv=2) d_ff=12288
vocab=49152. GQA, RoPE, biases, plain-GELU MLP, LayerNorm.
[arXiv:2402.19173; hf]"""
from repro_torch.models.config import ATTN, ModelConfig

FULL = ModelConfig(
    name="starcoder2-3b",
    n_layers=30, d_model=3072, n_heads=24, n_kv_heads=2, d_head=128,
    d_ff=12288, vocab=49152,
    pattern=(ATTN,),
    norm="layernorm", mlp_act="gelu", mlp_gated=False, use_bias=True,
    rope="rope", rope_theta=999999.0,
    tie_embeddings=True,
)

SMOKE = FULL.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab=256,
    dtype="float32", loss_chunk=64, attn_chunk=64, remat=False,
)
