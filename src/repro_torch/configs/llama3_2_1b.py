"""llama3.2-1b — small Llama 3 [hf:meta-llama/Llama-3.2-1B].

The same fields as ``repro/configs/llama3_2_1b.py``: L=16, d=2048, 32
heads over 8 kv heads of width 64, SiLU gated MLP of ff 8192, vocab
128256, tied embeddings, rope theta 5e5.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab=128256,
    act="silu",
    rope_theta=500000.0,
    tie_embeddings=True,
    source="hf:meta-llama/Llama-3.2-1B",
)
