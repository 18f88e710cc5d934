"""Single-request inference engine, the substrate the edge client drives.

Counterpart of ``repro.serving.engine.InferenceEngine``:

  * ``start(inputs)``                    — fresh prefill (Case 1, miss)
  * ``resume(inputs, cache, n_prefix)``  — continue from a downloaded
                                           prefix (Cases 2-4)
  * ``adopt(cache, n_tokens, logits)``   — full hit (Case 5): no compute
  * ``generate(state, n, sampler)``      — greedy decode loop

Prefill inputs of a dense or MLA model are padded to power-of-two
buckets, as in the reference. The padding writes junk K/V (or latents)
past the true length; the
next prefill or decode starts at the true length and the kernels mask by
``kv_len``, so it is never read. Unlike the reference, the bucket is also
capped at the room left in the cache after ``start_pos``, so a resume
near the end of the cache never writes past it. A model whose cache holds
recurrent state (an SSM) is never padded: every pad token would advance
its state (the reference pads it; ROADMAP Queue 3).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict

import numpy as np

from repro_torch import clock
from repro_torch.serving.sampler import greedy


def _bucket(n: int, minimum: int = 16) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


@dataclass
class EngineState:
    cache: Any
    pos: int                       # next token position
    last_logits: np.ndarray        # [B, V] on the host
    timings: Dict[str, float] = field(default_factory=dict)


class InferenceEngine:
    def __init__(self, model, max_len: int, cache_dtype=None):
        self.model = model
        self.max_len = max_len            # in prompt-token space
        self.cache_dtype = cache_dtype or model.dtype

    def new_cache(self):
        return self.model.init_cache(
            1, self.model.cache_len(self.max_len), self.cache_dtype)

    def _pad_inputs(self, inputs: Dict[str, np.ndarray], start_pos: int = 0):
        """Pad the token axis to a bucket; returns (padded, true_len)."""
        tokens = np.asarray(inputs["tokens"])
        n = tokens.shape[1]
        room = self.max_len - start_pos
        if n > room:
            raise ValueError(f"{n} tokens at position {start_pos} do not fit "
                             f"a cache of {self.max_len}")
        if self.model.cfg.window or self.model.has_recurrent_state:
            return inputs, n           # ring caches and states take no padding
        b = min(_bucket(n), room)
        if b == n:
            return inputs, n
        out = dict(inputs)
        out["tokens"] = np.pad(tokens, ((0, 0), (0, b - n)), mode="edge")
        return out, n

    # ------------------------------------------------------------------
    def start(self, inputs) -> EngineState:
        """Fresh prefill of the full prompt (cache miss)."""
        return self._run_prefill(inputs, self.new_cache(), 0, resume=False)

    def resume(self, inputs, cache, n_prefix: int) -> EngineState:
        """Continue prefill from a restored prefix of ``n_prefix`` tokens."""
        return self._run_prefill(inputs, cache, n_prefix, resume=True)

    def adopt(self, cache, n_tokens: int, logits: np.ndarray) -> EngineState:
        """Full hit: adopt a downloaded state with no model execution."""
        return EngineState(cache=cache, pos=n_tokens, last_logits=logits)

    def _run_prefill(self, inputs, cache, start_pos, *, resume):
        t0 = clock.monotonic()
        padded, true_n = self._pad_inputs(inputs, start_pos)
        logits, cache = self.model.prefill(padded, cache, start_pos,
                                           true_n - 1, resume=resume)
        logits = logits.cpu().numpy()          # waits for the device
        st = EngineState(cache=cache, pos=start_pos + true_n,
                         last_logits=logits)
        st.timings["prefill_wall"] = clock.monotonic() - t0
        return st

    # ------------------------------------------------------------------
    def decode_one(self, st: EngineState, token: np.ndarray) -> np.ndarray:
        """Feed ``token`` [B, 1], return logits [B, V]; advances state."""
        logits, st.cache = self.model.decode_step(st.cache, token, st.pos)
        st.pos += 1
        st.last_logits = logits.cpu().numpy()
        return st.last_logits

    def generate(self, st: EngineState, max_tokens: int,
                 sampler: Callable = greedy, rng=None) -> np.ndarray:
        """``max_tokens`` sampled tokens [B, max_tokens]; like the
        reference, every sampled token is also fed to the model."""
        t0 = clock.monotonic()
        out = []
        logits = st.last_logits
        for _ in range(max_tokens):
            tok = sampler(logits, rng)           # [B]
            out.append(tok)
            logits = self.decode_one(st, tok[:, None])
        st.timings["decode_wall"] = clock.monotonic() - t0
        return np.stack(out, axis=1)
