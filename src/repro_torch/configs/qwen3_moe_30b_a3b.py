"""qwen3-moe-30b-a3b [hf:Qwen/Qwen3-30B-A3B; hf].

48L d_model=2048 32H (GQA kv=4, head_dim 128 — Qwen3 uses a decoupled head
dim) expert d_ff=768, vocab 151936, MoE 128 experts top-8, QK-norm.  The
same FULL and SMOKE as ``repro.configs.qwen3_moe_30b_a3b``.
"""

from repro_torch.configs.shapes import LM_SHAPES
from repro_torch.models.transformer import LMConfig

FAMILY = "lm"
SHAPES = LM_SHAPES

FULL = LMConfig(
    name="qwen3-moe-30b-a3b",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, d_head=128,
    d_ff=0, vocab=151936,
    n_experts=128, top_k=8, d_ff_expert=768,
    qk_norm=True, tie_embeddings=False, rope_theta=1_000_000.0,
    mlp_act="swiglu",
)

SMOKE = LMConfig(
    name="qwen3-moe-smoke",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_head=16,
    d_ff=0, vocab=256,
    n_experts=8, top_k=2, d_ff_expert=32, capacity_factor=4.0,
    qk_norm=True, rope_theta=1_000_000.0, mlp_act="swiglu",
)
