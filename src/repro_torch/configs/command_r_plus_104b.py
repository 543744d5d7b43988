# Port of repro/configs/command_r_plus_104b.py (data only).
"""command-r-plus-104b [dense] — 64L d_model=12288 96H (GQA kv=8)
d_ff=33792 vocab=256000. Parallel attn+FFN block, no biases.
[hf:CohereForAI/c4ai-command-r-v01; unverified]"""
from repro_torch.models.config import ATTN, ModelConfig

FULL = ModelConfig(
    name="command-r-plus-104b",
    n_layers=64, d_model=12288, n_heads=96, n_kv_heads=8, d_head=128,
    d_ff=33792, vocab=256000,
    pattern=(ATTN,),
    parallel_block=True,                # attn and FFN share the input norm
    norm="layernorm", mlp_act="silu", mlp_gated=True, use_bias=False,
    rope="rope", rope_theta=75e6,
    tie_embeddings=True,
)

SMOKE = FULL.replace(
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_head=8,
    d_ff=128, vocab=256,
    dtype="float32", loss_chunk=64, attn_chunk=64, remat=False,
)
