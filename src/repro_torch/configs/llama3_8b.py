"""llama3-8b [dense] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256 (128k vocab) [arXiv:2407.21783; unverified].
Pure full attention => long_500k skipped.
"""
from ..models.config import Block, ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b",
    d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=128256,
    stages=((32, (Block("attn"),)),),
    rope_theta=500_000.0,
    subquadratic=False,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="llama3-smoke",
        d_model=128, n_heads=8, n_kv_heads=2, head_dim=16,
        d_ff=448, vocab=512,
        stages=((2, (Block("attn"),)),),
        rope_theta=500_000.0,
        dtype="float32",
    )
