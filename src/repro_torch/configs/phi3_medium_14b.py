"""phi3-medium-14b [dense] -- 40L d_model=5120 40H (GQA kv=10) d_ff=17920
vocab=100352, RoPE SwiGLU GQA. [arXiv:2404.14219; unverified]"""
from repro_torch.models.config import ModelConfig, BlockSpec

CONFIG = ModelConfig(
    name="phi3-medium-14b", family="dense",
    num_layers=40, d_model=5120, num_heads=40, num_kv_heads=10,
    head_dim=128, d_ff=17920, vocab_size=100352,
    pattern=(BlockSpec(kind="attn"),),
)

SMOKE = ModelConfig(
    name="phi3-medium-14b-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=1,
    head_dim=16, d_ff=192, vocab_size=256,
    pattern=(BlockSpec(kind="attn"),),
    param_dtype="float32", activation_dtype="float32",
)
