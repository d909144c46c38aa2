"""command-r-35b [hf:CohereForAI/c4ai-command-r-v01; unverified].

40L d_model=8192 64H (GQA kv=8, head 128) d_ff=22528, vocab 256000,
no biases, tied embeddings (Cohere ties input/output embeddings).  The
same FULL and SMOKE as ``repro.configs.command_r_35b``.
"""

from repro_torch.configs.shapes import LM_SHAPES
from repro_torch.models.transformer import LMConfig

FAMILY = "lm"
SHAPES = LM_SHAPES

FULL = LMConfig(
    name="command-r-35b",
    n_layers=40, d_model=8192, n_heads=64, n_kv_heads=8, d_head=128,
    d_ff=22528, vocab=256000,
    tie_embeddings=True, rope_theta=10_000.0, mlp_act="swiglu",
)

SMOKE = LMConfig(
    name="command-r-smoke",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_head=8,
    d_ff=160, vocab=256,
    tie_embeddings=True, rope_theta=10_000.0, mlp_act="swiglu",
)
