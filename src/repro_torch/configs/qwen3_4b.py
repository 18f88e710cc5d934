"""qwen3-4b — qk-norm, GQA [hf:Qwen/Qwen3-8B family].

The same fields as ``repro/configs/qwen3_4b.py``: L=36, d=2560, 32 heads
over 8 kv heads of width 128, qk-norm, SiLU gated MLP of ff 9728, vocab
151936, tied embeddings, rope theta 1e6.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b",
    family="dense",
    n_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab=151936,
    act="silu",
    qk_norm=True,
    rope_theta=1e6,
    tie_embeddings=True,
    source="hf:Qwen/Qwen3-8B",
)
