"""yi-6b — Llama-architecture GQA [arXiv:2403.04652].

The same fields as ``repro/configs/yi_6b.py``: L=32, d=4096, 32 heads
over 4 kv heads (width 128 = d / heads), SiLU gated MLP of ff 11008,
vocab 64000, an untied head, rope theta 5e6.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab=64000,
    act="silu",
    rope_theta=5e6,
    source="arXiv:2403.04652",
)
