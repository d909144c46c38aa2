"""minitron-8b [arXiv:2407.14679; hf] — pruned Nemotron-4.

32L d_model=4096 32H (GQA kv=8, head 128) d_ff=16384, vocab 256000.
Nemotron lineage: squared-ReLU MLP (no gate), untied embeddings.
The same FULL and SMOKE as ``repro.configs.minitron_8b``.
"""

from repro_torch.configs.shapes import LM_SHAPES
from repro_torch.models.transformer import LMConfig

FAMILY = "lm"
SHAPES = LM_SHAPES

FULL = LMConfig(
    name="minitron-8b",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=16384, vocab=256000,
    tie_embeddings=False, rope_theta=10_000.0, mlp_act="relu2",
)

SMOKE = LMConfig(
    name="minitron-smoke",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_head=8,
    d_ff=128, vocab=256,
    rope_theta=10_000.0, mlp_act="relu2",
)
