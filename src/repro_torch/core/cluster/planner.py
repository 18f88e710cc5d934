"""Link-aware fetch planning over the peer fabric.

The port's copy of ``repro.core.cluster.planner``. Given a prompt's
ranges, longest first, the planner prices every (peer, range) candidate:

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

Decision ledger record — STABLE CONTRACT
----------------------------------------
Every ``plan()`` call opens a record in the process-wide
:data:`repro_torch.obs.ledger.LEDGER` (kept on ``self.last_decision`` for
the caller that walks the plan to close). The record schema below is
the stable contract served by the gateway's
``GET /v1/decisions/<request-id>`` and spilled to JSONL; fields may be
*added* but never renamed or removed::

    {"id": "dec-<n>",             # ledger record id
     "trace_id": "...",           # ambient trace at plan time ("" none)
     "client": "...",             # planner owner (client / gateway id)
     "t_open": <monotonic s>,
     "prompt_tokens": <int>,
     "local_est_s": <float|null>, # perf-model local-prefill baseline
     "deadline_s": <float|null>,  # remaining budget the plan priced
                                  # against (null = none carried)
     "candidates": [              # FULL priced set, pre-prune
        {"peer": "peer0", "range_tokens": <int>,
         "est_fetch_s": <float>, "est_total_s": <float>,
         "ring_rank": <int>,
         "pruned": <bool>},       # true = estimated worse than local
        ...],
     "attempts": [                # walked by the caller, in order
        {"peer": "peer0", "range_tokens": <int>,
         "result": "hit|miss|dead|corrupt|deadline|cancelled",
         "est_fetch_s": <float>, "actual_s": <float>,
         "shared": <bool>},       # true = served from the dedup broker
        ...],
     "outcome": {                 # null until the caller commits
        "chosen": "peer0"|null, "result": "hit|partial|local",
        "fallthroughs": {"miss": n, "dead": n, "corrupt": n},
        "fetch_s": <float>, "suffix_s": <float>,
        "local_prefill_s": <float>,
        "baseline_s": <float|null>,     # cache-off counterfactual
        "realized_total_s": <float>,
        "best_hindsight_s": <float>,
        "regret_s": <float>,            # realized - best-in-hindsight
        "savings_vs_local_s": <float|null>,
        "dedup_of": "dec-<m>"|null,     # broker leader's record
        "t_close": <monotonic s>}}      # (+ late fields, e.g. ttft_s)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

from repro_torch.core.keys import PromptKey
from repro_torch.core.sizing import state_bytes, stream_chunk_count
from repro_torch.obs.ledger import LEDGER
from repro_torch.obs.trace import current_span


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
        # the ledger record the last plan() opened, for the caller that
        # walks the plan to close (one planner a thread); ``owner``
        # labels the records
        self.owner = ""
        self.last_decision = None

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
        local_s: Optional[float] = None
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
        self._open_decision(attempts, kept, local_s, n_tokens, deadline_s)
        return kept

    def _open_decision(self, priced: List[FetchAttempt],
                       kept: List[FetchAttempt], local_s: Optional[float],
                       n_tokens: int, deadline_s: Optional[float]) -> None:
        """Open this plan's ledger record (the schema above)."""
        keep = {id(a) for a in kept}
        sp = current_span()
        self.last_decision = LEDGER.open(
            client=self.owner, prompt_tokens=n_tokens,
            trace_id=sp.trace_id if sp is not None else "",
            candidates=[{"peer": a.peer_id, "range_tokens": a.key.n_tokens,
                         "est_fetch_s": a.est_fetch_s,
                         "est_total_s": a.est_total_s,
                         "ring_rank": a.ring_rank,
                         "pruned": id(a) not in keep} for a in priced],
            local_est_s=local_s, deadline_s=deadline_s)
