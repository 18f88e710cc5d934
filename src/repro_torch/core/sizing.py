"""Analytic state-blob sizes (bytes) for the port's cache families.

A copy of what ``repro.core.sizing`` computes for K/V caches, recurrent
(SSM) state, MLA latent caches and an encoder-decoder's audio K/V. The
fetch planner prices a (peer, range) candidate from these numbers before
any byte moves.
"""
from __future__ import annotations


def state_bytes_per_token(cfg, dtype_bytes: int = 2) -> float:
    """Serialized state each prompt token adds."""
    if cfg.family == "ssm":
        return 0.0                      # a constant-size state
    if cfg.uses_mla:
        m = cfg.mla
        return cfg.n_layers * (m.kv_lora_rank + m.qk_rope_dim) * dtype_bytes
    return cfg.n_layers * 2 * cfg.n_kv_heads * cfg.dh * dtype_bytes


def state_bytes_const(cfg, dtype_bytes: int = 2,
                      with_logits: bool = True) -> float:
    """State that does not grow with the prompt: the SSM's conv window
    and fp32 recurrent state, an encoder-decoder's cross K/V over its
    frames, and the last token's fp16 logits. A hybrid (hymba) carries
    its SSM branch's state beside its attention's K/V, as the reference
    counts it."""
    const = 0.0
    if cfg.family in ("ssm", "hybrid"):
        s = cfg.ssm
        conv_dim = cfg.ssm_d_inner + 2 * s.n_groups * s.d_state
        const += cfg.n_layers * ((s.d_conv - 1) * conv_dim * dtype_bytes
                                 + cfg.ssm_n_heads * s.head_dim
                                 * s.d_state * 4)
    if cfg.family == "encdec":
        const += cfg.n_layers * 2 * cfg.encdec.n_frames * cfg.n_kv_heads \
            * cfg.dh * dtype_bytes
    if with_logits:
        const += cfg.vocab * 2
    return const


def state_bytes(cfg, n_tokens: int, dtype_bytes: int = 2,
                with_logits: bool = True) -> int:
    n_eff = n_tokens + cfg.n_meta_tokens
    if cfg.window:
        n_eff = min(n_eff, cfg.window)
    return int(state_bytes_per_token(cfg, dtype_bytes) * n_eff
               + state_bytes_const(cfg, dtype_bytes, with_logits))


def stream_chunk_count(cfg, chunk_layers: int = 1) -> int:
    """Data chunks of a layer-streamed (``PC3``) blob: one per layer
    group. With K chunks, suffix-prefill group g can start once chunk g
    has landed, so about 1/K of the transfer is serial with compute."""
    return max(1, -(-cfg.n_layers // max(int(chunk_layers), 1)))
