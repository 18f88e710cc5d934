"""qwen2-vl-2b — the VLM with M-RoPE [arXiv:2409.12191].

The same fields as ``repro/configs/qwen2_vl_2b.py``: L=28, d=1536, 12
heads over 2 kv heads (width 128 = d / heads), q/k/v/o biases, M-RoPE
with sections (16, 24, 24) over the 64 frequency bands (temporal, height,
width), SiLU gated MLP of ff 8960, vocab 151936, tied embeddings, rope
theta 1e6. The vision encoder and projector are a stub, as in the
reference: a prefill takes merged token/patch embeddings ``[B, S, D]``
with their 3-component positions ``[3, B, S]``, or text tokens, whose
three components are equal.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab=151936,
    act="silu",
    attn_bias=True,
    rope="mrope",
    rope_theta=1e6,
    mrope_sections=(16, 24, 24),   # sums to head_dim // 2 = 64
    tie_embeddings=True,
    source="arXiv:2409.12191",
)
