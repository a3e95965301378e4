"""mamba2-1.3b [ssm] — SSD (state-space duality).  48L d_model=2048,
attn-free, vocab=50280, ssm_state=128 [arXiv:2405.21060; unverified].
d_inner = 2*d_model = 4096, head_dim 64 => 64 SSM heads.
Attention-free => runs long_500k (state is O(1) per sequence).
"""
from ..models.config import Block, ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    d_model=2048, n_heads=0, n_kv_heads=0, head_dim=0,
    d_ff=0, vocab=50280,
    stages=((48, (Block("mamba2"),)),),
    ssm_state=128, ssm_heads=64, ssm_head_dim=64,
    tie_embeddings=True,
    subquadratic=True,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mamba2-smoke",
        d_model=64, n_heads=0, n_kv_heads=0, head_dim=0,
        d_ff=0, vocab=256,
        stages=((2, (Block("mamba2"),)),),
        ssm_state=16, ssm_heads=4, ssm_head_dim=32, ssm_chunk=32,
        tie_embeddings=True,
        dtype="float32",
        subquadratic=True,
    )
