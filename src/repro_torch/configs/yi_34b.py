# Port of repro/configs/yi_34b.py (data only).
"""yi-34b [dense] — 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000. Llama-arch GQA. [arXiv:2403.04652; hf]"""
from repro_torch.models.config import ATTN, ModelConfig

FULL = ModelConfig(
    name="yi-34b",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, d_head=128,
    d_ff=20480, vocab=64000,
    pattern=(ATTN,),
    norm="rmsnorm", mlp_act="silu", mlp_gated=True,
    rope="rope", rope_theta=5e6,
    tie_embeddings=False,
)

SMOKE = FULL.replace(
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_head=8,
    d_ff=128, vocab=256,
    dtype="float32", loss_chunk=64, attn_chunk=64, remat=False,
)
