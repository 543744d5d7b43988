# Port of repro/configs/xlstm_13b.py (data only).
"""xlstm-1.3b [ssm] — 48L d_model=2048 4H d_ff=0 vocab=50304.
sLSTM + mLSTM blocks at 7:1 (xLSTM[7:1]). [arXiv:2405.04517; unverified]"""
from repro_torch.models.config import MLSTM, SLSTM, ModelConfig

FULL = ModelConfig(
    name="xlstm-1.3b",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4, d_head=512,
    d_ff=0, vocab=50304,
    pattern=(MLSTM,) * 7 + (SLSTM,),     # 7:1 mLSTM:sLSTM
    norm="layernorm",
    rope="none",
    tie_embeddings=False,
)

SMOKE = FULL.replace(
    n_layers=8, d_model=64, n_heads=2, n_kv_heads=2, d_head=32,
    vocab=256,
    dtype="float32", loss_chunk=64, attn_chunk=64, remat=False,
)
