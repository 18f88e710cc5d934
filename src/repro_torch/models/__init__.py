"""Dense model for serving: common blocks, MLP, attention, layer stack,
the ``Model`` facade."""
from repro_torch.models.model import Model  # noqa: F401
