"""Token samplers over batched host logits [..., V] (the paper decodes
greedily)."""
from __future__ import annotations

import numpy as np


def greedy(logits: np.ndarray, rng=None) -> np.ndarray:
    return np.argmax(logits, axis=-1).astype(np.int32)
