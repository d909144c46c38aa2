"""granite-moe-3b-a800m [hf:ibm-granite/granite-3.0-3b-a800m-base; hf].

32L d_model=1536 24H (GQA kv=8, head 64) expert d_ff=512, vocab 49155,
MoE 40 experts top-8, tied embeddings.  The same FULL and SMOKE as
``repro.configs.granite_moe_3b_a800m``.  Its head width of 64 is K7's
narrower instantiation.
"""

from repro_torch.configs.shapes import LM_SHAPES
from repro_torch.models.transformer import LMConfig

FAMILY = "lm"
SHAPES = LM_SHAPES

FULL = LMConfig(
    name="granite-moe-3b-a800m",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, d_head=64,
    d_ff=0, vocab=49155,
    n_experts=40, top_k=8, d_ff_expert=512,
    tie_embeddings=True, rope_theta=10_000.0, mlp_act="swiglu",
)

# Reduced same-family smoke config: MoE, non-divisible heads, tied embed.
SMOKE = LMConfig(
    name="granite-moe-smoke",
    n_layers=2, d_model=48, n_heads=6, n_kv_heads=2, d_head=8,
    d_ff=0, vocab=256,
    n_experts=5, top_k=2, d_ff_expert=32, capacity_factor=4.0,
    tie_embeddings=True, rope_theta=10_000.0, mlp_act="swiglu",
)
