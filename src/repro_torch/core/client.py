"""Edge client — the paper's inference procedure (§3.1 Steps 1-4, §3.2).

A lean counterpart of ``repro.core.client.EdgeClient`` for one cache
server. Given a structured prompt, the client

  1. derives the prefix-range keys, longest range first;
  2. probes its local Bloom catalog for them (ranges shorter than
     ``min_match_tokens`` are never fetched);
  3. GETs the first candidate the catalog admits; a Bloom false positive
     (the server has no blob) falls through to the next candidate, then
     to local prefill (§3.3: latency, never correctness);
  4. on a hit restores the state: a full hit with logits is adopted with
     no model call, a partial hit resumes prefill for the suffix; on a
     miss it prefills the whole prompt and uploads a v2 blob per range;
  5. decodes the response greedily.

A model whose cache is recurrent state (an SSM) differs in three ways:
its state is not cut to a prefix, so each shorter range's state is
rebuilt at upload time by prefilling boundary by boundary; every blob it
uploads carries its logits; and a blob without logits is not resumed at
``matched - 1`` (that would run the prefix's last token through the
state twice) but skipped like a miss.

Times are wall seconds on this process's clock, with the device
synchronised at each step's end. TTFT runs to the first output token's
logits on the host; TTLT to the last token. Uploads run after the
response, off its latency, as the paper's asynchronous uploads are.
The multi-peer planner, hedging, deadlines, tracing, the decision
ledger, the fetch broker and TCP are later slices of the port.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List

import numpy as np

from repro_torch import clock
from repro_torch.config import CacheConfig
from repro_torch.core import state_io
from repro_torch.core.catalog import Catalog
from repro_torch.core.keys import PromptKey, model_meta
from repro_torch.core.segments import PromptSegments
from repro_torch.core.server import CacheServer
from repro_torch.core.transport import InProcTransport
from repro_torch.device import dtype_name
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.sampler import greedy


@dataclass
class InferResult:
    case: int                      # paper Cases 1-5
    matched_tokens: int
    prompt_tokens: int
    output_tokens: list
    ttft_s: float                  # wall: request start -> first token
    ttlt_s: float                  # wall: request start -> last token
    blob_bytes_down: int = 0
    blob_bytes_up: int = 0
    false_positive: bool = False   # catalog said yes, server said no
    timings: Dict[str, float] = field(default_factory=dict)


class EdgeClient:
    def __init__(self, name: str, engine: InferenceEngine,
                 server: CacheServer, cache_cfg: CacheConfig = CacheConfig()):
        self.name = name
        self.engine = engine
        self.transport = InProcTransport(server)
        self.cache_cfg = cache_cfg
        self.catalog = Catalog(cache_cfg)
        self.meta = model_meta(engine.model.cfg,
                               dtype_name(engine.cache_dtype))

    def sync_catalog(self) -> None:
        self.catalog.maybe_sync(self.transport, clock.monotonic())

    # ------------------------------------------------------------------
    def infer(self, prompt: PromptSegments, max_new_tokens: int = 16,
              sampler: Callable = greedy, rng=None,
              upload_on_miss: bool = True) -> InferResult:
        t0 = clock.monotonic()
        n = len(prompt.token_ids)
        keys = prompt.keys(self.meta, self.cache_cfg.max_ranges,
                           self.cache_cfg.range_stride)
        tm = {"bloom_s": 0.0, "fetch_s": 0.0, "restore_s": 0.0,
              "prefill_s": 0.0, "decode_s": 0.0, "upload_s": 0.0}
        recurrent = self.engine.model.has_recurrent_state

        # Step 2: catalog probe, longest range first
        min_match = self.cache_cfg.min_match_tokens
        candidates = [k for k in keys if k.n_tokens >= min_match
                      and self.catalog.lookup(k.digest)]
        tm["bloom_s"] = clock.monotonic() - t0

        matched, false_pos, down_bytes, state = 0, False, 0, None
        for cand in candidates:
            resp, dt, _ = self.transport.request("get", {"key": cand.digest})
            tm["fetch_s"] += dt
            if not (resp.get("ok") and resp.get("blob")):
                false_pos = True       # §3.3: try the next range
                continue
            blob = resp["blob"]
            tr = clock.monotonic()
            payload = state_io.parse_state(blob, self.meta)
            if recurrent and not payload.get("logits"):
                continue               # a state cannot re-run its last token
            state = state_io.restore_state(payload, self.engine.new_cache())
            tm["restore_s"] = clock.monotonic() - tr
            matched, down_bytes = cand.n_tokens, len(blob)
            break

        # Step 3: adopt / resume / full local prefill
        if matched == n and state[2] is not None:
            cache, _, logits = state
            st = self.engine.adopt(cache, n, logits)
        elif matched > 0:
            cache, _, logits = state
            # a blob without logits cannot give the first suffix token's
            # input: re-run the prefix's last token
            resume_from = matched if logits is not None else matched - 1
            suffix = np.asarray(prompt.token_ids[resume_from:],
                                np.int32)[None]
            st = self.engine.resume({"tokens": suffix}, cache, resume_from)
            tm["prefill_s"] = st.timings["prefill_wall"]
        else:
            tokens = np.asarray(prompt.token_ids, np.int32)[None]
            st = self.engine.start({"tokens": tokens})
            tm["prefill_s"] = st.timings["prefill_wall"]
        prompt_logits = st.last_logits
        ttft = clock.monotonic() - t0
        upload = matched == 0 and upload_on_miss
        prompt_cache = st.cache
        if upload and recurrent:       # decode advances the state in place
            prompt_cache = _clone(st.cache)

        # Step 4: decode the response
        out = self.engine.generate(st, max_new_tokens, sampler, rng=rng)
        tm["decode_s"] = st.timings["decode_wall"]
        ttlt = clock.monotonic() - t0

        up = 0
        if upload:
            tu = clock.monotonic()
            up = self._upload_ranges(prompt, keys, prompt_cache,
                                     prompt_logits)
            tm["upload_s"] = clock.monotonic() - tu
        return InferResult(
            case=self._case_of(prompt, matched), matched_tokens=matched,
            prompt_tokens=n, output_tokens=[int(t) for t in out[0]],
            ttft_s=ttft, ttlt_s=ttlt, blob_bytes_down=down_bytes,
            blob_bytes_up=up, false_positive=false_pos and matched == 0,
            timings=tm)

    # ------------------------------------------------------------------
    def _range_states(self, prompt: PromptSegments, keys: List[PromptKey],
                      cache, logits: np.ndarray):
        """(key, cache, logits or None) for every prefix range. A KV cache
        is cut to each range when serialized, so the prompt's cache serves
        them all, with logits on the full prompt's range only. A recurrent
        state is not: each shorter range's state is rebuilt by prefilling
        the prompt boundary by boundary on a fresh cache, each piece
        resuming from the last, and carries its own logits."""
        n = len(prompt.token_ids)
        if not self.engine.model.has_recurrent_state:
            for k in keys:
                yield k, cache, logits if k.n_tokens == n else None
            return
        tokens = np.asarray(prompt.token_ids, np.int32)[None]
        st = None
        for k in sorted(keys, key=lambda k: k.n_tokens):
            if k.n_tokens == n:
                yield k, cache, logits
                continue
            if st is None:
                st = self.engine.start({"tokens": tokens[:, :k.n_tokens]})
            else:
                st = self.engine.resume(
                    {"tokens": tokens[:, st.pos:k.n_tokens]}, st.cache, st.pos)
            yield k, st.cache, st.last_logits

    def _upload_ranges(self, prompt: PromptSegments, keys: List[PromptKey],
                       cache, logits: np.ndarray) -> int:
        """Register every prefix range of the prompt (paper Fig. 3): one v2
        blob per range, holding that range's state."""
        model = self.engine.model
        total = 0
        for k, range_cache, range_logits in self._range_states(
                prompt, keys, cache, logits):
            blob = state_io.extract_state(
                range_cache, model.cache_len(k.n_tokens), self.meta,
                logits=range_logits, compress=self.cache_cfg.compress,
                level=self.cache_cfg.compress_level)
            resp, _, _ = self.transport.request(
                "put", {"key": k.digest, "blob": blob})
            if not resp.get("stored", True):
                continue               # never advertise a rejected blob
            self.catalog.register(k.digest)
            total += len(blob)
        return total

    def _case_of(self, prompt: PromptSegments, matched: int) -> int:
        """Map the matched length onto the paper's Cases 1-5."""
        if matched == 0:
            return 1
        bounds = list(prompt.boundaries)
        if matched == len(prompt.token_ids):
            return 5
        try:
            i = bounds.index(matched)
        except ValueError:
            return 1
        return min(2 + i, 4)


def _clone(cache):
    return {"segments": [{name: t.clone() for name, t in seg.items()}
                         for seg in cache["segments"]]}
