"""granite-moe-3b-a800m [moe] -- 32L d_model=1536 24H (GQA kv=8)
d_ff(expert)=512 vocab=49155, MoE 40 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
NB assignment lists both "40e" and "32 experts"; we use the structured
field 40e (DESIGN.md Sec. 8)."""
from repro_torch.models.config import ModelConfig, BlockSpec

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    num_layers=32, d_model=1536, num_heads=24, num_kv_heads=8,
    head_dim=64, d_ff=512, vocab_size=49155,
    num_experts=40, top_k=8, expert_d_ff=512, tie_embeddings=True,
    pattern=(BlockSpec(kind="attn", moe=True),),
)

SMOKE = ModelConfig(
    name="granite-moe-3b-a800m-smoke", family="moe",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    head_dim=16, d_ff=64, vocab_size=256,
    num_experts=8, top_k=2, expert_d_ff=64, tie_embeddings=True,
    pattern=(BlockSpec(kind="attn", moe=True),),
    param_dtype="float32", activation_dtype="float32",
)
