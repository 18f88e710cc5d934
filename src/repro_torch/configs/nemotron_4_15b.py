"""nemotron-4-15b — GQA, squared-ReLU ungated MLP [arXiv:2402.16819].

The same fields as ``repro/configs/nemotron_4_15b.py``: L=32, d=6144, 48
heads over 8 kv heads (width 128 = d / heads), an ungated relu² MLP of ff
24576, layernorm, vocab 256000, an untied head, rope theta 1e4.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=24576,
    vocab=256000,
    act="relu2",
    gated_mlp=False,
    norm="layernorm",
    source="arXiv:2402.16819",
)
