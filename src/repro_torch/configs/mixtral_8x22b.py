"""mixtral-8x22b [moe] — 56L d_model=6144 48H (GQA kv=8) d_ff=16384,
MoE 8 experts top-2, SWA (window 4096) [arXiv:2401.04088; hf].
vocab=32768.  Every layer is windowed: decode attends a ring buffer of
the trailing 4096 positions (`models/transformer.py:_cache_len`).
"""
from ..models.config import Block, ModelConfig

WINDOW = 4096

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab=32768,
    stages=((56, (Block("moe", window=WINDOW),)),),
    n_experts=8, top_k=2, capacity_factor=1.25,
    rope_theta=1_000_000.0,
    subquadratic=True,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mixtral-smoke",
        d_model=96, n_heads=6, n_kv_heads=2, head_dim=16,
        d_ff=256, vocab=512,
        stages=((2, (Block("moe", window=16),)),),
        # cf >= E/K => capacity >= T: prefill never drops, so the
        # decode-vs-prefill consistency test is exact
        n_experts=4, top_k=2, capacity_factor=4.0,
        rope_theta=1_000_000.0,
        dtype="float32",
        subquadratic=True,
    )
