"""internvl2-1b [vlm] — InternViT + Qwen2-0.5B backbone
[arXiv:2404.16821; hf].  24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151655.  The InternViT frontend is a STUB: ``input_specs()``
provides precomputed patch embeddings replacing the first 256
positions.  Pure full attention => long_500k skipped.
"""
from ..models.config import Block, ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    d_model=896, n_heads=14, n_kv_heads=2, head_dim=64,
    d_ff=4864, vocab=151655,
    stages=((24, (Block("attn"),)),),
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    frontend="vision",
    subquadratic=False,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="internvl2-smoke",
        d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=224, vocab=512,
        stages=((2, (Block("attn"),)),),
        rope_theta=1_000_000.0,
        tie_embeddings=True,
        frontend="vision",
        dtype="float32",
    )
