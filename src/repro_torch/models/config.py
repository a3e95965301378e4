"""Architecture configuration (a copy of `repro.models.config`).

A model is a list of *stages*; each stage is (repeat, [block, ...]).
The port runs the layers of a stage as a plain Python loop over the
repeat dimension with the inner blocks in order.

Block kinds:
    attn        — pre-norm GQA attention (+ SwiGLU MLP) with optional
                  sliding window (cfg.window or block override)
    moe         — attention + mixture-of-experts MLP
    mamba2      — pre-norm Mamba2 SSD mixer (no MLP)
    shared_attn — attention + MLP with weights *shared* across all
                  occurrences (zamba2); each occurrence keeps its own
                  decode cache

Every kind is ported.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Block:
    kind: str                    # attn | moe | mamba2 | shared_attn
    window: int | None = None    # sliding-window size (None = full causal)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    stages: tuple = ()           # tuple[(repeat, tuple[Block,...]), ...]
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # --- SSM (mamba2) ---
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256
    # --- shared attention (zamba2) ---
    shared_attn_d_ff: int = 0
    # --- misc ---
    rope_theta: float = 500_000.0
    flash_chunk: int = 1024      # q/kv tile size of the flash path
    kv_quant: bool = False       # int8 decode KV cache (per-token scales)
    tie_embeddings: bool = False
    frontend: str | None = None   # "audio" | "vision" stub (input_specs)
    dtype: str = "bfloat16"
    remat: str = "block"          # none | block
    # long-context capability: archs able to run the 500k decode shape
    subquadratic: bool = False

    @property
    def n_layers(self) -> int:
        return sum(r * len(blocks) for r, blocks in self.stages)

    @property
    def d_inner(self) -> int:
        return self.ssm_heads * self.ssm_head_dim

    def param_count(self) -> int:
        """Analytic parameter count."""
        d, hd = self.d_model, self.head_dim
        n = self.vocab * d * (1 if self.tie_embeddings else 2)
        for repeat, blocks in self.stages:
            for b in blocks:
                if b.kind in ("attn", "moe", "shared_attn"):
                    attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) \
                        + self.n_heads * hd * d
                    if b.kind == "moe":
                        mlp = self.n_experts * 3 * d * self.d_ff \
                            + d * self.n_experts
                    elif b.kind == "shared_attn":
                        mlp = 3 * d * self.shared_attn_d_ff
                    else:
                        mlp = 3 * d * self.d_ff
                    cnt = attn + mlp + 2 * d
                elif b.kind == "mamba2":
                    di, ns, nh = self.d_inner, self.ssm_state, self.ssm_heads
                    conv_dim = di + 2 * ns
                    cnt = d * (2 * di + 2 * ns + nh) + di * d \
                        + conv_dim * self.ssm_conv + 3 * nh + di + d
                else:
                    raise ValueError(b.kind)
                if b.kind == "shared_attn":
                    # weights shared across occurrences: count once
                    n += cnt / max(repeat, 1)
                else:
                    n += cnt * repeat
        return int(n)

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if not self.n_experts:
            return self.param_count()
        d = self.d_model
        total = self.param_count()
        moe_blocks = sum(r for r, blocks in self.stages
                         for b in blocks if b.kind == "moe")
        dead = moe_blocks * (self.n_experts - self.top_k) * 3 * d * self.d_ff
        return int(total - dead)
