"""Edge-device performance emulation (the paper's Table 1/3 calibration).

A copy of ``repro.core.perfmodel``'s two Raspberry Pi records. Analytic
work (2 x active parameters FLOPs a token) becomes seconds at per-device
effective rates calibrated from the paper's Table 3:

  low-end  (Pi Zero 2W, Gemma-3 270M): P-decode 12.58 s for 65.27 prompt
    tokens -> 5.19 tok/s; R-decode ~5.2 tok/s; Token 53 us/tok;
    Bloom 75 us/query; Sample 1.7 ms/tok.
  high-end (Pi 5, Gemma-3 1B): P-decode 2.688 s for 334.11 tokens
    -> 124.3 tok/s; R-decode ~27.5 tok/s; Token 4.8 us/tok;
    Bloom ~2 us; Sample 0.7 ms/tok.

These are modeled seconds of an emulated edge device. No accelerator
figure is kept here.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class DevicePerfModel:
    name: str
    eff_prefill_flops: float      # sustained FLOP/s during prompt decode
    eff_decode_flops: float       # sustained FLOP/s during token decode
    tokenize_s_per_tok: float
    bloom_s_per_query: float
    sample_s_per_tok: float

    def flops_per_token(self, cfg) -> float:
        return 2.0 * cfg.active_param_count()

    def time_tokenize(self, n_tokens: int) -> float:
        return self.tokenize_s_per_tok * n_tokens

    def time_bloom(self, n_queries: int) -> float:
        return self.bloom_s_per_query * n_queries

    def time_prefill(self, cfg, n_tokens: int) -> float:
        return self.flops_per_token(cfg) * n_tokens / self.eff_prefill_flops

    def time_decode(self, cfg, n_tokens: int) -> float:
        return self.flops_per_token(cfg) * n_tokens / self.eff_decode_flops

    def time_sample(self, n_tokens: int) -> float:
        return self.sample_s_per_tok * n_tokens


# calibrated against a 0.201B-param gemma3-270m config (module docstring)
_N270 = 2 * 0.201e9
_N1B = 2 * 1.0e9

PI_ZERO_2W = DevicePerfModel(
    name="pi-zero-2w(270m)",
    eff_prefill_flops=_N270 * 5.19,
    eff_decode_flops=_N270 * 5.15,
    tokenize_s_per_tok=53e-6,
    bloom_s_per_query=75e-6,
    sample_s_per_tok=1.7e-3,
)

PI_5 = DevicePerfModel(
    name="pi-5(1b)",
    eff_prefill_flops=_N1B * 124.3,
    eff_decode_flops=_N1B * 27.5,
    tokenize_s_per_tok=4.8e-6,
    bloom_s_per_query=2e-6,
    sample_s_per_tok=0.7e-3,
)
