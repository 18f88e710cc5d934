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
     miss it prefills the whole prompt and uploads a v3 ``PC3`` container
     per range, all ranges of a K/V or latent cache from one
     serialization pass;
  5. decodes the response greedily.

A fetched blob that cannot be read (a corrupt or truncated container, a
``ZST`` blob where ``zstandard`` does not import, another model's blob)
is a miss: the request tries the next candidate, then prefills locally,
as after a Bloom false positive. The reference lets that error out of
``infer``.

With ``overlap=True`` a partial hit streams: the blob's chunks arrive
one at a time (``get_chunks``) on a pump thread that checks and decodes
them, and the main thread runs the suffix prefill one layer group at a
time as each group's chunks are in (``InferenceEngine.resume_streamed``).
A v2 blob on the stream is restored whole and resumed as usual.

A model whose cache is recurrent state (an SSM) differs in three ways:
its state is not cut to a prefix, so each shorter range's state is
rebuilt at upload time by prefilling boundary by boundary; every blob it
uploads carries its logits; and a blob without logits is not resumed at
``matched - 1`` (that would run the prefix's last token through the
state twice) but skipped like a miss. A K/V or latent blob without
logits resumes at ``matched - 1``.

Times are wall seconds on this process's clock, with the device
synchronised at each step's end. TTFT runs to the first output token's
logits on the host; TTLT to the last token. Uploads run after the
response, off its latency, as the paper's asynchronous uploads are.
The multi-peer planner, hedging, deadlines, tracing, the decision
ledger, the fetch broker and TCP are later slices of the port.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch import clock
from repro_torch.config import CacheConfig
from repro_torch.core import state_io
from repro_torch.core.catalog import Catalog
from repro_torch.core.keys import PromptKey, model_meta
from repro_torch.core.segments import PromptSegments
from repro_torch.core.server import CacheServer
from repro_torch.core.transport import InProcTransport, StreamCancelled
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
    unreadable_blobs: int = 0      # fetched blobs counted as misses
    streamed: bool = False         # the hit resumed layer group by group
    chunks_down: int = 0           # chunks of a streamed fetch
    timings: Dict[str, float] = field(default_factory=dict)


class _StreamEnded(Exception):
    """The chunk stream stopped before every layer group arrived."""


class EdgeClient:
    def __init__(self, name: str, engine: InferenceEngine,
                 server: CacheServer, cache_cfg: CacheConfig = CacheConfig(),
                 overlap: bool = False):
        self.name = name
        self.engine = engine
        self.transport = InProcTransport(server)
        self.cache_cfg = cache_cfg
        self.overlap = overlap
        self.catalog = Catalog(cache_cfg)
        self.meta = model_meta(engine.model.cfg,
                               dtype_name(engine.cache_dtype))

    def sync_catalog(self) -> None:
        self.catalog.maybe_sync(self.transport, clock.monotonic())

    # ------------------------------------------------------------------
    def infer(self, prompt: PromptSegments, max_new_tokens: int = 16,
              sampler: Callable = greedy, rng=None,
              upload_on_miss: bool = True) -> InferResult:
        """The paper's request. ``timings`` holds wall seconds: ``bloom_s``,
        ``fetch_s`` (transfer on the TTFT path; for a streamed hit what of
        the stream's wall time was not compute), ``restore_s`` (checking,
        decoding and placing the blob; for a streamed hit, partly hidden),
        ``prefill_s`` (compute), ``decode_s``, ``upload_s``; a streamed
        hit adds ``stream_s`` (the whole fetch and resume) and
        ``hidden_s`` (transfer and restore seconds that ran while the
        suffix computed)."""
        t0 = clock.monotonic()
        n = len(prompt.token_ids)
        keys = prompt.keys(self.meta, self.cache_cfg.max_ranges,
                           self.cache_cfg.range_stride)
        tm = {"bloom_s": 0.0, "fetch_s": 0.0, "restore_s": 0.0,
              "prefill_s": 0.0, "decode_s": 0.0, "upload_s": 0.0}
        model = self.engine.model
        recurrent = model.has_recurrent_state

        # Step 2: catalog probe, longest range first
        min_match = self.cache_cfg.min_match_tokens
        candidates = [k for k in keys if k.n_tokens >= min_match
                      and self.catalog.lookup(k.digest)]
        tm["bloom_s"] = clock.monotonic() - t0

        matched, false_pos, down_bytes, state, st = 0, False, 0, None, None
        unreadable, chunks_down = 0, 0
        for cand in candidates:
            if self.overlap and cand.n_tokens < n and \
                    hasattr(self.transport, "request_stream") and \
                    model.supports_layer_stream:
                got = self._fetch_streamed(cand, prompt, tm)
                chunks_down = got["chunks"]
                if got["kind"] == "none":
                    false_pos = True
                    continue
                if got["kind"] in ("unreadable", "skip"):
                    unreadable += got["kind"] == "unreadable"
                    continue
                st, state = got.get("st"), got.get("state")
                matched, down_bytes = cand.n_tokens, got["nbytes"]
                break
            resp, dt, _ = self.transport.request("get", {"key": cand.digest})
            tm["fetch_s"] += dt
            if not (resp.get("ok") and resp.get("blob")):
                false_pos = True       # §3.3: try the next range
                continue
            blob = resp["blob"]
            tr = clock.monotonic()
            try:
                payload = state_io.parse_state(blob, self.meta)
                if recurrent and not payload.get("logits"):
                    continue           # a state cannot re-run its last token
                state = state_io.restore_state(payload,
                                               self.engine.new_cache())
            except ValueError:         # ChunkError too: a miss
                unreadable += 1
                continue
            finally:
                tm["restore_s"] += clock.monotonic() - tr
            matched, down_bytes = cand.n_tokens, len(blob)
            break

        # Step 3: adopt / resume / full local prefill
        streamed = st is not None
        if matched == n and state[2] is not None:
            cache, _, logits = state
            st = self.engine.adopt(cache, n, logits)
        elif streamed:
            tm["prefill_s"] = st.timings["prefill_wall"]
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
            unreadable_blobs=unreadable, streamed=streamed,
            chunks_down=chunks_down, timings=tm)

    # ------------------------------------------------------------------
    def _fetch_streamed(self, cand: PromptKey, prompt: PromptSegments,
                        tm: Dict[str, float]) -> dict:
        """A partial hit fetched as a chunk stream, its suffix prefill run
        one layer group at a time as the chunks land.

        A pump thread takes the chunks from the transport and feeds them
        to a :class:`~repro_torch.core.state_io.ChunkedRestorer` (digest,
        inflate, decode), queueing each completed layer group; this thread
        writes each group into the template and runs its layers. The pump
        always ends the queue, so a bad stream never blocks the consumer.
        Returns ``{"kind": ..., "chunks": n, ...}``: ``hit`` with ``st``
        (the resumed state) or, for a v2 blob, ``state`` (restored whole,
        for the ordinary resume) and ``nbytes``; ``none`` (the server
        holds no blob); ``unreadable`` (a corrupt, truncated or
        undecodable stream, or a cancelled one); ``skip`` (a recurrent
        state without logits). Adds its seconds to ``tm``."""
        recurrent = self.engine.model.has_recurrent_state
        restorer = state_io.ChunkedRestorer(self.meta)
        events: "queue.Queue" = queue.Queue()
        cancel = threading.Event()
        info = {"chunks": 0, "feed_s": 0.0, "seconds": 0.0, "hdr": None,
                "err": None}

        def on_chunk(chunk, dt, nb):
            info["chunks"] += 1
            tf = clock.monotonic()
            done = restorer.feed(chunk)
            info["feed_s"] += clock.monotonic() - tf
            if info["chunks"] == 1:
                events.put("header")
            for gid in done:
                events.put(gid)

        def pump():
            try:
                info["hdr"], info["seconds"], _ = \
                    self.transport.request_stream(
                        "get_chunks", {"key": cand.digest}, on_chunk,
                        cancel=cancel)
            except BaseException as e:  # re-raised below unless the
                info["err"] = e        # stream was bad or cancelled
            finally:
                events.put(None)       # always unblock the consumer

        t0 = clock.monotonic()
        worker = threading.Thread(target=pump, daemon=True)
        worker.start()
        template = self.engine.new_cache()      # overlaps the first chunks
        matched = cand.n_tokens
        st, state, kind = None, None, "unreadable"

        def drain():                   # stop the pump; wait for its end
            cancel.set()
            while events.get() is not None:
                pass

        ended = []                     # the consumer has seen the end
        first = events.get()
        if first is None:
            pass                       # no blob, or a broken stream
        elif restorer.v2_payload is not None:
            drain()
            if info["err"] is None:
                try:
                    state = restorer.result(template)
                    kind = "hit"
                except ValueError:
                    pass
        elif recurrent and not restorer.header.get("logits"):
            drain()
            kind = "skip"
        else:
            resume_from = matched if restorer.header.get("logits") \
                else matched - 1
            suffix = np.asarray(prompt.token_ids[resume_from:],
                                np.int32)[None]

            def groups():
                while True:
                    gid = events.get()
                    if gid is None:
                        ended.append(True)
                        if restorer.complete:
                            return
                        raise _StreamEnded()
                    yield (state_io.segment_index(gid[0]), gid[1], gid[2],
                           restorer.group_tree(gid, template))

            try:
                st = self.engine.resume_streamed(
                    {"tokens": suffix}, resume_from, groups(), template)
                kind = "hit"
            except (_StreamEnded, ValueError):
                if not ended:
                    drain()
        worker.join()
        err = info["err"]
        if err is not None and not isinstance(err, (StreamCancelled,
                                                    ValueError)):
            raise err
        if kind == "hit" and err is not None:
            st, state, kind = None, None, "unreadable"
        wall = clock.monotonic() - t0
        restore = info["feed_s"] + restorer.phase_s["place"]
        compute = st.timings["prefill_wall"] if st is not None else 0.0
        tm["fetch_s"] += max(wall - compute - (restore if st is None
                                                 else 0.0), 0.0)
        tm["restore_s"] += restore
        if st is not None:
            tm["stream_s"] = wall
            tm["hidden_s"] = max(info["seconds"] + restore + compute - wall,
                                 0.0)
        if first is None and isinstance(info["hdr"], dict) and \
                not info["hdr"].get("error"):
            kind = "none"
        return {"kind": kind, "st": st, "state": state,
                "chunks": info["chunks"], "nbytes": restorer.bytes_fed}

    # ------------------------------------------------------------------
    def _range_states(self, prompt: PromptSegments, keys: List[PromptKey],
                      cache, logits: np.ndarray):
        """(key, cache, logits) of every prefix range of a recurrent state.
        Such a state is not cut to a prefix, so each shorter range's state
        is rebuilt by prefilling the prompt boundary by boundary on a
        fresh cache, each piece resuming from the last, and carries its
        own logits. Each cache is reused by the next range: serialize it
        before asking for the next."""
        n = len(prompt.token_ids)
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
        """Register every prefix range of the prompt (paper Fig. 3), one
        ``PC3`` container per range. A K/V or latent cache takes one
        serialization pass for all ranges (shorter ranges are header
        rewrites), logits on the full prompt's range only. A recurrent
        state takes one pass per range, each range's own state and
        logits: cutting every range from the final state, as the
        reference does, would give each the whole prompt's state."""
        model = self.engine.model
        cc = self.cache_cfg
        kw = dict(compress=cc.compress, level=cc.compress_level,
                  quantize=cc.quantize, codec=cc.compress_codec,
                  chunk_layers=cc.chunk_layers)
        blobs = []
        if model.has_recurrent_state:
            for k, range_cache, range_logits in self._range_states(
                    prompt, keys, cache, logits):
                blobs.append((k, state_io.pack_container(
                    state_io.extract_state_chunks(
                        range_cache, model.cache_len(k.n_tokens), self.meta,
                        logits=range_logits, **kw))))
        else:
            n = len(prompt.token_ids)
            per_key = {k.digest: model.cache_len(k.n_tokens) for k in keys}
            lists = state_io.extract_state_ranges(
                cache, sorted(set(per_key.values())), self.meta,
                logits=logits if any(k.n_tokens == n for k in keys)
                else None, **kw)
            blobs = [(k, state_io.pack_container(lists[per_key[k.digest]]))
                     for k in keys]
        total = 0
        for k, blob in blobs:
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
