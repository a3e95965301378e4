"""zamba2-7b [hybrid] — Mamba2 backbone + *shared* attention blocks
[arXiv:2411.15242; unverified].  81L d_model=3584 32H (GQA kv=32)
d_ff=14336 vocab=32000, ssm_state=64.

Stages: 13 x (5 mamba2 + 1 shared_attn) + 3 trailing mamba2 = 81
layers; the shared attention(+MLP) block's weights are held once and
applied at all 13 occurrences, each with its own KV cache.  Hybrid =>
runs long_500k.
"""
from ..models.config import Block, ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    d_model=3584, n_heads=32, n_kv_heads=32, head_dim=112,
    d_ff=14336, vocab=32000,
    stages=(
        (13, (Block("mamba2"),) * 5 + (Block("shared_attn"),)),
        (1, (Block("mamba2"),) * 3),
    ),
    ssm_state=64, ssm_heads=112, ssm_head_dim=64,
    shared_attn_d_ff=14336,
    rope_theta=10_000.0,
    subquadratic=True,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="zamba2-smoke",
        d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=256,
        stages=(
            (2, (Block("mamba2"),) * 2 + (Block("shared_attn"),)),
            (1, (Block("mamba2"),)),
        ),
        ssm_state=16, ssm_heads=4, ssm_head_dim=32, ssm_chunk=32,
        shared_attn_d_ff=128,
        rope_theta=10_000.0,
        dtype="float32",
        subquadratic=True,
    )
