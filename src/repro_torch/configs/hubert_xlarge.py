"""hubert-xlarge [audio] -- 48L d_model=1280 16H (MHA kv=16) d_ff=5120
vocab=504, encoder-only (w2v2 arch). [arXiv:2106.07447; unverified]
Modality frontend is a STUB per the assignment: input_specs() provides
precomputed frame embeddings (batch, frames, d_model); the conv feature
extractor is out of scope. Loss: frame-level CE over the 504 cluster
vocabulary (masked-prediction stub). No decode shapes (encoder)."""
from repro_torch.models.config import ModelConfig, BlockSpec

CONFIG = ModelConfig(
    name="hubert-xlarge", family="audio",
    num_layers=48, d_model=1280, num_heads=16, num_kv_heads=16,
    head_dim=80, d_ff=5120, vocab_size=504,
    causal=False, frontend="frames",
    pattern=(BlockSpec(kind="attn"),),
)

SMOKE = ModelConfig(
    name="hubert-xlarge-smoke", family="audio",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    head_dim=16, d_ff=128, vocab_size=32,
    causal=False, frontend="frames",
    pattern=(BlockSpec(kind="attn"),),
    param_dtype="float32", activation_dtype="float32",
)
