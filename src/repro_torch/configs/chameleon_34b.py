"""chameleon-34b [vlm] -- 48L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=65536, early-fusion VQ image tokens. [arXiv:2405.09818; unverified]
The VQ tokenizer frontend is a STUB per the assignment: input_specs()
provides interleaved text+image token ids in the unified 65536 vocab; the
backbone is a standard dense decoder (qk-layernorm per Chameleon)."""
from repro_torch.models.config import ModelConfig, BlockSpec

CONFIG = ModelConfig(
    name="chameleon-34b", family="vlm",
    num_layers=48, d_model=8192, num_heads=64, num_kv_heads=8,
    head_dim=128, d_ff=22016, vocab_size=65536,
    qk_norm=True,
    pattern=(BlockSpec(kind="attn"),),
)

SMOKE = ModelConfig(
    name="chameleon-34b-smoke", family="vlm",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    head_dim=16, d_ff=160, vocab_size=256, qk_norm=True,
    pattern=(BlockSpec(kind="attn"),),
    param_dtype="float32", activation_dtype="float32",
)
