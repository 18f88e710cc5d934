"""deepseek-v3-671b — MLA attention, 1 shared + 256 routed experts, MTP.

The same fields as ``repro/configs/deepseek_v3_671b.py``
[arXiv:2412.19437]: 61 layers, d_model 7168, 128 heads, vocab 129280,
untied head; the first 3 layers dense (ff 18432), the rest MoE (256
experts of ff 2048, top-8, one shared expert); MLA with q_lora 1536,
kv_lora 512, qk_nope 128, qk_rope 64, v 128. The MLA latent cache holds
576 values per token per layer, so a prompt-cache blob is small while
the model is large: the paper's best case for cache sharing.

The whole model (671B parameters) does not fit one card, so the port
serves it cut: to its leading dense layers (:func:`dense_cut`, an empty
MoE segment), or to those and its first MoE layers (:func:`moe_cut`).
"""
import dataclasses

from repro_torch.config import MLAConfig, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    head_dim=128,
    d_ff=18432,
    vocab=129280,
    act="silu",
    mtp=True,
    moe=MoEConfig(n_experts=256, top_k=8, n_shared=1, expert_ff=2048,
                  shared_ff=2048, first_k_dense=3, dense_ff=18432),
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_dim=128, qk_rope_dim=64, v_dim=128),
    source="arXiv:2412.19437",
)


def dense_cut(cfg: ModelConfig, n_layers: int) -> ModelConfig:
    """``cfg`` cut to its first ``n_layers`` layers, all dense MLA (at most
    ``cfg.moe.first_k_dense`` of them), with no MTP head. The MoE segment
    that follows is empty. Apply the same ``replace`` to the reference's
    config to get the same ``model_meta``."""
    return cfg.replace(n_layers=n_layers, mtp=False,
                       moe=dataclasses.replace(cfg.moe,
                                               first_k_dense=n_layers))


def moe_cut(cfg: ModelConfig, n_moe: int) -> ModelConfig:
    """``cfg``'s ``first_k_dense`` dense MLA layers followed by its first
    ``n_moe`` MoE layers, with no MTP head. Apply the same ``replace`` to
    the reference's config to get the same ``model_meta``."""
    return cfg.replace(n_layers=cfg.moe.first_k_dense + n_moe, mtp=False)
