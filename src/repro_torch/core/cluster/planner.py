"""Link-aware fetch planning over the peer fabric.

A copy of ``repro.core.cluster.planner`` without its decision ledger.
Given a prompt's ranges, longest first, the planner prices every (peer,
range) candidate:

    est_total(peer, range) = est_fetch(peer, blob bytes)
                           + t_prefill(n_prompt - range)

(with ``overlap``: ``max(fetch, suffix + fetch / chunks)``, the
layer-streamed pipeline) and returns the attempts sorted by it. With a
device perf model, an attempt estimated slower than a local prefill of
the whole prompt is dropped. Without one there is no compute to weigh,
so the plan keeps the paper's longest-first order and the link only
breaks ties. With a remaining deadline budget, an attempt whose
estimated total cannot finish within it is dropped too. ``est_fetch`` is
the directory's adaptive link estimate.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

from repro_torch.core.keys import PromptKey
from repro_torch.core.sizing import state_bytes, stream_chunk_count


@dataclass(frozen=True)
class FetchAttempt:
    peer_id: Optional[str]         # None: the single-transport client
    key: PromptKey
    est_fetch_s: float = 0.0
    est_total_s: float = 0.0       # fetch + estimated suffix prefill
    # the peer's place in the key's ring order (0: the primary): ties
    # between equal links go to the primary, so the order is the same
    # whatever the peers' enumeration
    ring_rank: int = 0


class FetchPlanner:
    def __init__(self, directory, perf_cfg, perf=None,
                 dtype_bytes: int = 2, overlap: bool = False,
                 chunk_layers: int = 1):
        self.directory = directory
        self.perf_cfg = perf_cfg   # sizing and compute config
        self.perf = perf           # a DevicePerfModel or None
        self.dtype_bytes = dtype_bytes     # bytes an element of the blob
        self.overlap = overlap
        self.chunk_layers = chunk_layers

    def plan(self, keys: Sequence[PromptKey], n_tokens: int,
             min_match: int = 0,
             use_catalog: bool = True,
             deadline_s: Optional[float] = None) -> List[FetchAttempt]:
        """The attempts worth making, best first. ``use_catalog=False``
        (the §5.2.3 ablation) asks every usable peer for every range.
        ``deadline_s`` is the request's remaining budget: an attempt
        estimated to take longer is never worth starting."""
        cfg, perf, d = self.perf_cfg, self.perf, self.directory
        attempts: List[FetchAttempt] = []
        for k in keys:
            if k.n_tokens < min_match:
                continue
            pids = d.lookup(k.digest) if use_catalog else d.usable_ids()
            if not pids:
                continue
            nb = state_bytes(cfg, k.n_tokens, dtype_bytes=self.dtype_bytes,
                             with_logits=k.n_tokens == n_tokens)
            suffix_s = (perf.time_prefill(cfg, n_tokens - k.n_tokens)
                        if perf else 0.0)
            rank = {pid: i for i, pid
                    in enumerate(d.placement.ring_order(k.digest))}
            if self.overlap and suffix_s > 0:
                kk = stream_chunk_count(cfg, self.chunk_layers)

                def total(est):        # compute trails the stream a chunk
                    return max(est, suffix_s + est / kk)
            else:
                def total(est):
                    return est + suffix_s
            for pid in pids:
                est = d.est_fetch_s(pid, nb)
                attempts.append(FetchAttempt(pid, k, est, total(est),
                                             rank.get(pid, 0)))
        if perf is not None:
            local_s = perf.time_prefill(cfg, n_tokens)
            kept = [a for a in attempts if a.est_total_s < local_s]
            kept.sort(key=lambda a: (a.est_total_s, a.est_fetch_s,
                                     a.ring_rank))
        else:
            kept = sorted(attempts, key=lambda a: (-a.key.n_tokens,
                                                   a.est_fetch_s,
                                                   a.ring_rank))
        if deadline_s is not None:
            kept = [a for a in kept if a.est_total_s < deadline_s]
        return kept
