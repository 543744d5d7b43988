# Port of repro/configs/recurrentgemma_9b.py (data only).
"""recurrentgemma-9b [hybrid] — 38L d_model=4096 16H (MQA kv=1)
d_ff=12288 vocab=256000. Griffin: RG-LRU + local attention, 1:2.
[arXiv:2402.19427; unverified]"""
from repro_torch.models.config import ATTN_LOCAL, RGLRU, ModelConfig

FULL = ModelConfig(
    name="recurrentgemma-9b",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, d_head=256,
    d_ff=12288, vocab=256000,
    pattern=(RGLRU, RGLRU, ATTN_LOCAL),  # 12 periods + 2 remainder RG-LRU
    norm="rmsnorm", mlp_act="gelu", mlp_gated=True,
    rope="rope", rope_theta=10000.0,
    window=2048,
    conv_width=4,
    tie_embeddings=True, embed_scale_by_dim=True,
)

SMOKE = FULL.replace(
    n_layers=8, d_model=64, n_heads=4, n_kv_heads=1, d_head=16,
    d_ff=128, vocab=256, window=32,
    dtype="float32", loss_chunk=64, attn_chunk=64, remat=False,
)
