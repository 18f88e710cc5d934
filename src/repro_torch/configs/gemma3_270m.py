"""gemma3-270m — the paper's low-end model, as the reference repo sizes it.

The same fields as ``repro/configs/gemma3_270m.py``: L=6 blocks, d=640,
4 heads over 1 kv head of width 256, ff 2048, vocab 262144, tanh-GELU
gated MLP, qk-norm, tied embeddings, rope theta 1e6, no window.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-270m",
    family="dense",
    n_layers=6,
    d_model=640,
    n_heads=4,
    n_kv_heads=1,
    head_dim=256,
    d_ff=2048,
    vocab=262144,
    act="gelu",
    qk_norm=True,
    tie_embeddings=True,
    rope_theta=1e6,
    source="gemma-3 model card (paper's low-end model)",
)
