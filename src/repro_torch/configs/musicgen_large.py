"""musicgen-large [audio] — decoder-only over EnCodec tokens.

48L d_model=2048 32H (GQA kv=32 => MHA) d_ff=8192 vocab=2048
[arXiv:2306.05284; hf].  The EnCodec/T5 frontend is a STUB: the
caller passes precomputed conditioning frame embeddings as
``frontend_emb`` (64 frames, the reference's ``FRONTEND_LEN["audio"]``),
which replace the first positions, as internvl2's patch embeddings do.
Pure full attention => long_500k skipped.
"""
from ..models.config import Block, ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab=2048,
    stages=((48, (Block("attn"),)),),
    rope_theta=10_000.0,
    frontend="audio",
    subquadratic=False,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="musicgen-smoke",
        d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=256, vocab=128,
        stages=((2, (Block("attn"),)),),
        rope_theta=10_000.0,
        frontend="audio",
        dtype="float32",
    )
