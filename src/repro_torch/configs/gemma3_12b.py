"""gemma3-12b [dense] -- 48L d_model=3840 16H (GQA kv=8) d_ff=15360
vocab=262144, 5:1 local:global sliding window, 128k ctx.
[hf:google/gemma-3-1b-pt; unverified]
head_dim=256 (Gemma-3 convention; see DESIGN.md Sec. 8), window=1024."""
from repro_torch.models.config import ModelConfig, BlockSpec

_PATTERN = tuple([BlockSpec(kind="attn", window=1024)] * 5
                 + [BlockSpec(kind="attn", window=None)])

CONFIG = ModelConfig(
    name="gemma3-12b", family="dense",
    num_layers=48, d_model=3840, num_heads=16, num_kv_heads=8,
    head_dim=256, d_ff=15360, vocab_size=262144,
    qk_norm=True, rope_theta=1e6, tie_embeddings=True,
    pattern=_PATTERN,
)

SMOKE = ModelConfig(
    name="gemma3-12b-smoke", family="dense",
    num_layers=6, d_model=64, num_heads=4, num_kv_heads=2,
    head_dim=16, d_ff=128, vocab_size=256,
    qk_norm=True, tie_embeddings=True,
    pattern=tuple([BlockSpec(kind="attn", window=16)] * 5
                  + [BlockSpec(kind="attn", window=None)]),
    param_dtype="float32", activation_dtype="float32",
)
