# Port of repro/configs/gemma2_27b.py (data only).
"""gemma2-27b [dense] — 46L d_model=4608 32H (GQA kv=16) d_ff=36864
vocab=256000. Local(4096)/global alternating attention, attn-logit
softcap 50, final softcap 30, post-norms, GeGLU. [arXiv:2408.00118; hf]"""
from repro_torch.models.config import ATTN, ATTN_LOCAL, ModelConfig

FULL = ModelConfig(
    name="gemma2-27b",
    n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16, d_head=128,
    d_ff=36864, vocab=256000,
    pattern=(ATTN_LOCAL, ATTN),          # local first, then global
    norm="rmsnorm", mlp_act="gelu", mlp_gated=True, post_norms=True,
    rope="rope", rope_theta=10000.0,
    window=4096, attn_softcap=50.0, final_softcap=30.0,
    attn_scale=(4608 / 32) ** -0.5,      # query_pre_attn_scalar = d/H = 144
    tie_embeddings=True, embed_scale_by_dim=True,
)

SMOKE = FULL.replace(
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab=256, window=32, attn_scale=16.0 ** -0.5,
    dtype="float32", loss_chunk=64, attn_chunk=64, remat=False,
)
