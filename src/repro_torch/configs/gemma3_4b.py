"""gemma3-4b [dense] — 34L d_model=2560 8H (GQA kv=4) d_ff=10240
vocab=262144, 5:1 local:global (sliding window 1024), 128k context
[hf:google/gemma-3-1b-pt; unverified].

Stages: 5 x (5 local + 1 global) + 4 trailing local = 34 layers.
A windowed layer decodes from a ring buffer of min(window, s_max) slots
(`models/transformer.py:_cache_len`); the global layers keep every
position.

Like the reference (`repro.configs.gemma3_4b`, which the port matches
field for field), the model leaves out Gemma's RMSNorm on q and k, the
sqrt(d_model) scale of the embeddings and the post-attention and
post-MLP norms, so no weights of a published checkpoint load into it
unchanged.
"""
from ..models.config import Block, ModelConfig

WINDOW = 1024

CONFIG = ModelConfig(
    name="gemma3-4b",
    d_model=2560, n_heads=8, n_kv_heads=4, head_dim=256,
    d_ff=10240, vocab=262144,
    stages=(
        (5, (Block("attn", window=WINDOW),) * 5 + (Block("attn"),)),
        (1, (Block("attn", window=WINDOW),) * 4),
    ),
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    subquadratic=True,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="gemma3-smoke",
        d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=256, vocab=512,
        stages=(
            (2, (Block("attn", window=16),) * 2 + (Block("attn"),)),
            (1, (Block("attn", window=16),)),
        ),
        rope_theta=1_000_000.0,
        tie_embeddings=True,
        dtype="float32",
        subquadratic=True,
    )
