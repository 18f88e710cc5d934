"""Model and prompt-cache configuration (dense, VLM, SSM, hybrid, MoE,
MLA and encoder-decoder models).

A copy of the model and cache parts of ``repro.config``: the same field
names and defaults, so
:func:`repro_torch.core.keys.model_meta` hashes a config to the same
bytes as the reference does.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


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
class EncDecConfig:
    n_enc_layers: int = 6
    n_frames: int = 1500          # stub audio frontend output length
    max_target_positions: int = 448


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | vlm | ssm | hybrid | moe | encdec
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
    rope: str = "standard"        # standard | mrope | none
    rope_theta: float = 10000.0
    mrope_sections: Tuple[int, ...] = ()
    tie_embeddings: bool = False
    window: Optional[int] = None  # sliding-window size (None = full attention)
    n_meta_tokens: int = 0        # learned prefix tokens (hymba)
    mtp: bool = False             # deepseek multi-token prediction head
    moe: MoEConfig = field(default_factory=MoEConfig)
    ssm: SSMConfig = field(default_factory=SSMConfig)
    mla: MLAConfig = field(default_factory=MLAConfig)
    encdec: EncDecConfig = field(default_factory=EncDecConfig)
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
        if self.family in ("ssm", "hybrid"):
            kw["ssm"] = dataclasses.replace(
                self.ssm, d_state=min(self.ssm.d_state, 16),
                head_dim=16, chunk=16)
        if self.family == "encdec":
            kw["encdec"] = dataclasses.replace(
                self.encdec, n_enc_layers=2, n_frames=16)
        if self.rope == "mrope":
            # 3 sections summing to head_dim // 2 = 16
            kw["mrope_sections"] = (4, 6, 6)
        if self.n_meta_tokens:
            kw["n_meta_tokens"] = 8
        if self.window is not None:
            kw["window"] = min(self.window, 16)
        return self.replace(**kw)

    def param_count(self) -> int:
        """Analytical parameter count N, as the reference counts it."""
        d, dh = self.d_model, self.dh
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        if self.family == "encdec":
            # encoder self-attention + MLP; decoder self- and
            # cross-attention + MLP (biases and norms not counted)
            attn = 2 * d * (self.n_heads + 2 * self.n_kv_heads) * dh + \
                self.n_heads * dh * d
            enc_l = attn + 2 * d * self.d_ff
            dec_l = 2 * attn + 2 * d * self.d_ff
            return emb + self.encdec.n_enc_layers * enc_l + \
                self.n_layers * dec_l
        if self.family == "ssm":
            di, ns = self.ssm_d_inner, self.ssm.d_state
            in_proj = d * (2 * di + 2 * self.ssm.n_groups * ns
                           + self.ssm_n_heads)
            per = in_proj + di * d + di * self.ssm.d_conv
            return emb + self.n_layers * per
        if self.uses_mla:
            m = self.mla
            attn = (d * m.q_lora_rank
                    + m.q_lora_rank * self.n_heads
                    * (m.qk_nope_dim + m.qk_rope_dim)
                    + d * (m.kv_lora_rank + m.qk_rope_dim)
                    + m.kv_lora_rank * self.n_heads * (m.qk_nope_dim + m.v_dim)
                    + self.n_heads * m.v_dim * d)
        else:
            attn = d * (self.n_heads + 2 * self.n_kv_heads) * dh \
                + self.n_heads * dh * d
        mult = 3 if self.gated_mlp else 2
        if self.family == "moe":
            mo = self.moe
            moe_mlp = mo.n_experts * mult * d * mo.expert_ff \
                + mo.n_shared * mult * d * (mo.shared_ff or mo.expert_ff) \
                + d * mo.n_experts
            n_moe = self.n_layers - mo.first_k_dense
            mlp_total = n_moe * moe_mlp + mo.first_k_dense * mult * d * (
                mo.dense_ff or self.d_ff)
        else:
            mlp_total = self.n_layers * mult * d * self.d_ff
        if self.family == "hybrid":    # the SSM branch beside attention
            di, ns = self.ssm_d_inner, self.ssm.d_state
            attn += d * (2 * di + 2 * ns + self.ssm_n_heads) + di * d
        return emb + self.n_layers * attn + mlp_total

    def active_param_count(self) -> int:
        """Parameters a token runs through (MoE: the routed top-k and the
        shared experts only)."""
        if self.family != "moe":
            return self.param_count()
        mo = self.moe
        mult = 3 if self.gated_mlp else 2
        n_moe = self.n_layers - mo.first_k_dense
        idle = n_moe * (mo.n_experts - mo.top_k) * mult * self.d_model \
            * mo.expert_ff
        return self.param_count() - idle


@dataclass(frozen=True)
class CacheConfig:
    """Distributed prompt cache configuration (paper §3-§4)."""
    bloom_capacity: int = 1_000_000   # paper: 1M entries
    bloom_fp_rate: float = 0.01       # paper: 1% target FP ratio
    compress: bool = True             # compressed state blobs
    compress_level: int = 1
    # blob codec: 'auto' picks zstd where zstandard imports, else zlib
    compress_codec: str = "auto"
    quantize: bool = False            # int8 K/V and latent leaves
    chunk_layers: int = 1             # layers per v3 stream chunk
    max_ranges: int = 4               # prompt ranges registered per upload
    range_stride: int = 0             # >0: also register every k tokens
    min_match_tokens: int = 4         # minimum prefix worth fetching
    sync_interval_s: float = 1.0      # catalog sync period
    # per-server LRU byte budget for the blob store; 0 = unbounded.
    # Evicted keys stay in the Bloom catalogs as tombstones (§3.3)
    max_store_bytes: int = 0
