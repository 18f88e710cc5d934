"""gemma3-1b — the paper's high-end model (Gemma-3 1B).

The same fields as ``repro/configs/gemma3_1b.py``: L=26 blocks, d=1152,
4 heads over 1 kv head of width 256, ff 6912, vocab 262144, tanh-GELU
gated MLP, qk-norm, tied embeddings, rope theta 1e6, no window.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab=262144,
    act="gelu",
    qk_norm=True,
    tie_embeddings=True,
    rope_theta=1e6,
    source="gemma-3 model card (paper's high-end model)",
)
