# Port of repro/configs/qwen2_vl_72b.py (data only).
"""qwen2-vl-72b [vlm] — 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064. M-RoPE, dynamic resolution; the vision tower is a STUB
(input_specs provides patch embeddings + (3,B,S) position ids).
[arXiv:2409.12191; hf]"""
from repro_torch.models.config import ATTN, ModelConfig

FULL = ModelConfig(
    name="qwen2-vl-72b",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_head=128,
    d_ff=29568, vocab=152064,
    pattern=(ATTN,),
    norm="rmsnorm", mlp_act="silu", mlp_gated=True,
    qkv_bias=True,
    rope="mrope", rope_theta=1e6, mrope_sections=(16, 24, 24),
    modality="vision",
    tie_embeddings=False,
)

SMOKE = FULL.replace(
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_head=8,
    d_ff=128, vocab=256, mrope_sections=(2, 1, 1),
    dtype="float32", loss_chunk=64, attn_chunk=64, remat=False,
)
