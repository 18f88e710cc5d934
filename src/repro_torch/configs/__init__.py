"""Model configs the port can run (the registry's)."""
from repro_torch.configs.registry import (ARCHS, get_config,  # noqa: F401
                                          list_archs)
