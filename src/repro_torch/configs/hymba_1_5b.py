"""hymba-1.5b — parallel attention and Mamba heads in every layer.

The same fields as ``repro/configs/hymba_1_5b.py`` [arXiv:2411.13676]:
32 layers, d_model 1600, 25 heads over 5 kv heads (dh 64), gated SiLU
MLP d_ff 5504, vocab 32001 (untied head), rope, sliding window 1024, 128
learned meta tokens, and an SSM branch of d_state 16 (expand 2: 50 heads
of 64), depthwise conv k=4, SSD chunk 64.
"""
from repro_torch.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab=32001,
    act="silu",
    window=1024,            # hymba uses SWA on most layers
    n_meta_tokens=128,
    ssm=SSMConfig(d_state=16, head_dim=64, expand=2, d_conv=4, chunk=64),
    source="arXiv:2411.13676",
)
