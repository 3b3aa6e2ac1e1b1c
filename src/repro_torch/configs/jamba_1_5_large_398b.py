"""jamba-1.5-large-398b [hybrid] -- 72L d_model=8192 64H (GQA kv=8)
d_ff=24576 vocab=65536, MoE 16 experts top-2, Mamba:attn 7:1 interleave.
[arXiv:2403.19887; hf]
Layout per Jamba paper: 8-layer period, attention at index 4 (middle),
MoE replaces the FFN every other layer (odd indices). SSM layers use our
SSD (Mamba-2) block -- the TPU-idiomatic chunked form (DESIGN.md Sec. 8).
"""
from repro_torch.models.config import ModelConfig, BlockSpec

_PATTERN = tuple(
    BlockSpec(kind=("attn" if i == 4 else "mamba"), moe=(i % 2 == 1))
    for i in range(8)
)

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    num_layers=72, d_model=8192, num_heads=64, num_kv_heads=8,
    head_dim=128, d_ff=24576, vocab_size=65536,
    num_experts=16, top_k=2, expert_d_ff=24576,
    ssm_state=128, ssm_expand=2, ssm_head_dim=128,
    pattern=_PATTERN,
)

SMOKE = ModelConfig(
    name="jamba-1.5-large-398b-smoke", family="hybrid",
    num_layers=8, d_model=64, num_heads=4, num_kv_heads=2,
    head_dim=16, d_ff=128, vocab_size=256,
    num_experts=4, top_k=2, expert_d_ff=128,
    ssm_state=16, ssm_expand=2, ssm_head_dim=32, ssm_chunk=16,
    pattern=tuple(
        BlockSpec(kind=("attn" if i == 4 else "mamba"), moe=(i % 2 == 1))
        for i in range(8)),
    param_dtype="float32", activation_dtype="float32",
)
