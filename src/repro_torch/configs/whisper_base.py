"""whisper-base — encoder-decoder over audio frames [arXiv:2212.04356].

The same fields as ``repro/configs/whisper_base.py``: 6 encoder and 6
decoder layers, d=512, 8 heads over 8 kv heads of width 64 (MHA),
q/k/v/o biases, layernorm, a non-gated tanh-GELU MLP of ff 2048, no
rope (sinusoidal positions), vocab 51865, an untied head, 1500 frames
and 448 target positions. The mel-spectrogram and conv frontend is a
stub, as in the reference: callers give frame embeddings ``[B, 1500,
512]``.
"""
from repro_torch.config import EncDecConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="encdec",
    n_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab=51865,
    act="gelu",
    gated_mlp=False,
    norm="layernorm",
    attn_bias=True,
    rope="none",
    encdec=EncDecConfig(n_enc_layers=6, n_frames=1500,
                        max_target_positions=448),
    source="arXiv:2212.04356",
)
