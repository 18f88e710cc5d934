"""Registry of the configs the port runs (``--arch <id>``).

Counterpart of ``repro/configs/registry.py``: ``ARCHS``, ``get_config``
and ``list_archs``, over the configs this port serves. The reference's
other architectures raise a ``KeyError`` that names the ROADMAP item
that ports them.
"""
from repro_torch.configs import (deepseek_v3_671b, gemma3_1b, gemma3_270m,
                                 hymba_1_5b, llama3_2_1b, mamba2_780m,
                                 nemotron_4_15b, qwen2_vl_2b, qwen3_4b, yi_6b)

ARCHS = {c.name: c for c in (
    gemma3_270m.CONFIG, gemma3_1b.CONFIG, llama3_2_1b.CONFIG,
    qwen3_4b.CONFIG, yi_6b.CONFIG, nemotron_4_15b.CONFIG,
    qwen2_vl_2b.CONFIG, mamba2_780m.CONFIG, hymba_1_5b.CONFIG,
    deepseek_v3_671b.CONFIG)}

# reference architectures the port does not run yet -> what ports them
NOT_YET = {
    "granite-moe-3b-a800m": "ROADMAP Queue 1, item 9.4 (MoE layers)",
    "whisper-base": "ROADMAP Queue 1, item 9.5 (encoder-decoder)",
}


def get_config(arch: str):
    if arch in NOT_YET:
        raise KeyError(f"arch {arch!r} is not in this port yet: "
                       f"{NOT_YET[arch]}")
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch]


def list_archs():
    return sorted(ARCHS)
