"""minitron-8b [dense] — pruned nemotron.  32L d_model=4096 32H
(GQA kv=8) d_ff=16384 vocab=256000 [arXiv:2407.14679; hf].
Pure full attention => long_500k skipped.
"""
from ..models.config import Block, ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b",
    d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab=256000,
    stages=((32, (Block("attn"),)),),
    rope_theta=10_000.0,
    subquadratic=False,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="minitron-smoke",
        d_model=128, n_heads=8, n_kv_heads=2, head_dim=16,
        d_ff=512, vocab=1024,
        stages=((2, (Block("attn"),)),),
        rope_theta=10_000.0,
        dtype="float32",
    )
