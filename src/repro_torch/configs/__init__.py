"""Model configs the port can run."""
from repro_torch.config import ModelConfig
from repro_torch.configs.deepseek_v3_671b import CONFIG as _DEEPSEEK_V3_671B
from repro_torch.configs.gemma3_1b import CONFIG as _GEMMA3_1B
from repro_torch.configs.gemma3_270m import CONFIG as _GEMMA3_270M
from repro_torch.configs.mamba2_780m import CONFIG as _MAMBA2_780M

ARCHS = {c.name: c for c in (_GEMMA3_270M, _GEMMA3_1B, _MAMBA2_780M,
                              _DEEPSEEK_V3_671B)}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown config {name!r}; the port knows "
                       f"{sorted(ARCHS)}")
    return ARCHS[name]
