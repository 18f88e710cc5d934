"""Registry of the configs the port runs (``--arch <id>``).

Counterpart of ``repro/configs/registry.py``: ``ARCHS``, ``get_config``
and ``list_archs``, over every architecture of the reference's
registry.
"""
from repro_torch.configs import (deepseek_v3_671b, gemma3_1b, gemma3_270m,
                                 granite_moe_3b_a800m, hymba_1_5b,
                                 llama3_2_1b, mamba2_780m, nemotron_4_15b,
                                 qwen2_vl_2b, qwen3_4b, whisper_base, yi_6b)

ARCHS = {c.name: c for c in (
    gemma3_270m.CONFIG, gemma3_1b.CONFIG, llama3_2_1b.CONFIG,
    qwen3_4b.CONFIG, yi_6b.CONFIG, nemotron_4_15b.CONFIG,
    qwen2_vl_2b.CONFIG, mamba2_780m.CONFIG, hymba_1_5b.CONFIG,
    granite_moe_3b_a800m.CONFIG, deepseek_v3_671b.CONFIG,
    whisper_base.CONFIG)}


def get_config(arch: str):
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch]


def list_archs():
    return sorted(ARCHS)
