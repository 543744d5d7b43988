# Port of repro/configs/musicgen_large.py (data only).
"""musicgen-large [audio] — 48L d_model=2048 32H (MHA kv=32) d_ff=8192
vocab=2048. Decoder-only over EnCodec tokens; the EnCodec frontend is a
STUB (input_specs provides precomputed frame embeddings).
[arXiv:2306.05284; hf]"""
from repro_torch.models.config import ATTN, ModelConfig

FULL = ModelConfig(
    name="musicgen-large",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, d_head=64,
    d_ff=8192, vocab=2048,
    pattern=(ATTN,),
    norm="layernorm", mlp_act="gelu", mlp_gated=False, use_bias=True,
    rope="none",                         # learned/sinusoidal pos in frontend
    modality="audio",
    tie_embeddings=False,
)

SMOKE = FULL.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
    d_ff=128, vocab=256,
    dtype="float32", loss_chunk=64, attn_chunk=64, remat=False,
)
