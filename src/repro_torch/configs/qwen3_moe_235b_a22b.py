"""qwen3-moe-235b-a22b [moe] — 94L d_model=4096 64H (GQA kv=4)
head_dim=128, d_ff=1536 per expert, vocab=151936, 128 experts top-8
[hf:Qwen/Qwen3-235B-A22B config.json].  The q/o projections run to
64 * 128 = 8192 with o back to d_model.  Pure full attention => long_500k
skipped.

Like the reference (`repro.configs.qwen3_moe_235b_a22b`, which the port
matches field for field), the model leaves out Qwen3's RMSNorm on q and
k, so no weights of a published checkpoint load into it unchanged.
"""
from ..models.config import Block, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128,
    d_ff=1536, vocab=151936,
    stages=((94, (Block("moe"),)),),
    n_experts=128, top_k=8, capacity_factor=1.25,
    rope_theta=1_000_000.0,
    subquadratic=False,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-smoke",
        d_model=64, n_heads=8, n_kv_heads=2, head_dim=16,
        d_ff=96, vocab=512,
        stages=((2, (Block("moe"),)),),
        # cf >= E/K => capacity >= T: prefill never drops
        n_experts=8, top_k=2, capacity_factor=8.0,
        rope_theta=1_000_000.0,
        dtype="float32",
    )
