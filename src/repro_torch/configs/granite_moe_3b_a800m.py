"""granite-moe-3b-a800m — 40 routed experts, top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base family].

The same fields as ``repro/configs/granite_moe_3b_a800m.py``: L=32,
d=1536, 24 heads over 8 kv heads (dh 64), SiLU gated experts of ff 512,
40 experts (stored 48: the expert axis is padded to a multiple of 16),
top 8, no shared expert, no leading dense layer, vocab 49155, tied
embeddings. Every layer is a MoE layer with a K/V cache.
"""
from repro_torch.config import MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    vocab=49155,
    act="silu",
    tie_embeddings=True,
    moe=MoEConfig(n_experts=40, top_k=8, expert_ff=512),
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
