"""mamba2-780m — SSD (state-space duality), attention-free.

The same fields as ``repro/configs/mamba2_780m.py`` [arXiv:2405.21060]:
48 layers, d_model 1536, vocab 50280, ssm_state 128, expand 2
(d_inner 3072), head_dim 64 (48 SSM heads), one B/C group, depthwise
conv k=4, gated (z) branch, SSD chunk 256, tied embeddings.
"""
from repro_torch.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    rope="none",
    tie_embeddings=True,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, d_conv=4, chunk=256,
                  n_groups=1),
    source="arXiv:2405.21060",
)
