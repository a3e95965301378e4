"""stablelm-3b [dense] — 32L d_model=2560 32H (GQA kv=32 => MHA)
d_ff=6912 vocab=50304 [hf:stabilityai/stablelm-2-1_6b; unverified].
Pure full attention => long_500k skipped.
"""
from ..models.config import Block, ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b",
    d_model=2560, n_heads=32, n_kv_heads=32, head_dim=80,
    d_ff=6912, vocab=50304,
    stages=((32, (Block("attn"),)),),
    rope_theta=10_000.0,
    subquadratic=False,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="stablelm-smoke",
        d_model=80, n_heads=4, n_kv_heads=4, head_dim=20,
        d_ff=216, vocab=160,
        stages=((2, (Block("attn"),)),),
        rope_theta=10_000.0,
        dtype="float32",
    )
