"""qwen3-moe-235b-a22b [moe] -- 94L d_model=4096 64H (GQA kv=4)
d_ff(expert)=1536 vocab=151936, MoE 128 experts top-8, qk_norm.
[hf:Qwen/Qwen3-30B-A3B; hf]  head_dim=128 (Qwen3 convention).
94 layers is prime-ish for scan; pattern length 1, repeat 94."""
from repro_torch.models.config import ModelConfig, BlockSpec

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    num_layers=94, d_model=4096, num_heads=64, num_kv_heads=4,
    head_dim=128, d_ff=1536, vocab_size=151936,
    qk_norm=True, rope_theta=1e6,
    num_experts=128, top_k=8, expert_d_ff=1536,
    pattern=(BlockSpec(kind="attn", moe=True),),
)

SMOKE = ModelConfig(
    name="qwen3-moe-235b-a22b-smoke", family="moe",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    head_dim=16, d_ff=96, vocab_size=256,
    qk_norm=True, num_experts=8, top_k=2, expert_d_ff=96,
    pattern=(BlockSpec(kind="attn", moe=True),),
    param_dtype="float32", activation_dtype="float32",
)
