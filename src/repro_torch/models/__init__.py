"""Dense and SSM models for serving: common blocks, MLP, attention, the
Mamba-2 layer, layer stacks, the ``Model`` facade."""
from repro_torch.models.model import Model  # noqa: F401
