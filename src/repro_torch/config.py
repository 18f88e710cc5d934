"""Model and prompt-cache configuration (dense, SSM and MLA models).

A copy of the dense, SSM, MoE and MLA parts of ``repro.config``: the
same field names and defaults, so :func:`repro_torch.core.keys.model_meta`
hashes a config to the same bytes as the reference does.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0            # routed experts
    top_k: int = 0
    n_shared: int = 0             # shared (always-on) experts
    expert_ff: int = 0            # hidden dim of each routed expert
    shared_ff: int = 0            # hidden dim of the shared expert(s)
    first_k_dense: int = 0        # leading dense layers (deepseek-v3 style)
    dense_ff: int = 0             # ff of those leading dense layers
    aux_coef: float = 0.01        # load-balance aux loss coefficient
    capacity_factor: float = 2.0  # EP dispatch capacity slack


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    d_conv: int = 4
    chunk: int = 64               # SSD chunk length
    n_groups: int = 1             # B/C groups (mamba2 "G")


@dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_dim: int = 128


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # this port runs "dense", "ssm" and "moe"
                                  # with no MoE layer
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0             # 0 -> d_model // n_heads
    act: str = "silu"             # silu | gelu | relu2
    gated_mlp: bool = True
    norm: str = "rmsnorm"         # rmsnorm | layernorm
    qk_norm: bool = False
    attn_bias: bool = False
    rope: str = "standard"        # standard | none
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    window: Optional[int] = None  # sliding-window size (None = full attention)
    n_meta_tokens: int = 0        # learned prefix tokens (not in this port)
    mtp: bool = False             # deepseek multi-token prediction head
    moe: MoEConfig = field(default_factory=MoEConfig)
    ssm: SSMConfig = field(default_factory=SSMConfig)
    mla: MLAConfig = field(default_factory=MLAConfig)
    source: str = ""              # citation for the config

    @property
    def dh(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def uses_mla(self) -> bool:
        return self.family == "moe" and self.mla.kv_lora_rank > 0 and \
            self.name.startswith("deepseek")

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm.expand * self.d_model

    @property
    def ssm_n_heads(self) -> int:
        return self.ssm_d_inner // self.ssm.head_dim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """The reference's tiny same-family variant for CPU tests."""
        kw = dict(
            name=self.name + "-reduced",
            n_layers=2,
            d_model=min(self.d_model, 128),
            n_heads=min(self.n_heads, 4),
            n_kv_heads=min(self.n_kv_heads, 2),
            head_dim=32 if self.head_dim else 0,
            d_ff=min(self.d_ff, 256) if self.d_ff else 0,
            vocab=min(self.vocab, 512),
        )
        if self.family == "moe":
            kw["moe"] = dataclasses.replace(
                self.moe,
                n_experts=min(self.moe.n_experts, 4),
                top_k=min(self.moe.top_k, 2),
                expert_ff=min(self.moe.expert_ff, 128),
                shared_ff=min(self.moe.shared_ff, 128) if self.moe.shared_ff else 0,
                first_k_dense=min(self.moe.first_k_dense, 1),
                dense_ff=min(self.moe.dense_ff, 128) if self.moe.dense_ff else 0,
            )
        if self.family == "ssm":
            kw["ssm"] = dataclasses.replace(
                self.ssm, d_state=min(self.ssm.d_state, 16),
                head_dim=16, chunk=16)
        if self.window is not None:
            kw["window"] = min(self.window, 16)
        return self.replace(**kw)


@dataclass(frozen=True)
class CacheConfig:
    """Distributed prompt cache configuration (paper §3-§4)."""
    bloom_capacity: int = 1_000_000   # paper: 1M entries
    bloom_fp_rate: float = 0.01       # paper: 1% target FP ratio
    compress: bool = True             # zlib-compressed state blobs
    compress_level: int = 1
    max_ranges: int = 4               # prompt ranges registered per upload
    range_stride: int = 0             # >0: also register every k tokens
    min_match_tokens: int = 4         # minimum prefix worth fetching
    sync_interval_s: float = 1.0      # catalog sync period
