"""Planner decision ledger: regret accounting for fetch-vs-recompute.

The port's copy of ``repro.obs.ledger``. Every ``FetchPlanner.plan``
call opens a **record**: the whole candidate set the cost model priced
(pruned ones flagged), the local-prefill baseline, the trace id of the
request. The caller that walks the plan (``EdgeClient``, the gateway's
``PrefixFetcher``) notes every attempt it made and *commits* the record
with the realized outcome. A closed record gives

* **regret** — the realized total less the best decision in hindsight
  (the cheaper of the local baseline and the winning fetch's own cost):
  what the planner's estimate errors cost this request;
* **counterfactual savings** — the local baseline less the realized
  total: what the cache fabric bought (negative when the plan lost).

The baseline is the perf model's ``time_prefill`` where the planner has
one. Without one (wall-clock runs, the gateway) the ledger *learns* a
seconds-a-token prefill rate from observed full prefills
(:meth:`DecisionLedger.note_prefill`, an EWMA); the client's stream
watchdog reads it too.

Records ride the broker as the trace context rides a payload: the dedup
leader stamps its record id into the shared reply under
:data:`LEDGER_KEY`, and a sibling that adopted the shared blob closes
its record with ``dedup_of`` pointing there. The process-wide
:data:`LEDGER` is bounded (FIFO) and resolves a record by its id, its
trace id or an alias (the gateway's ``cmpl-N``). The record schema is
stated in :mod:`repro_torch.core.cluster.planner`.
"""
from __future__ import annotations

import itertools
import threading
from collections import OrderedDict
from typing import Dict, List, Optional

from repro_torch import clock

# response-envelope key carrying the dedup leader's record id through
# the broker (the `_trace` of decision records)
LEDGER_KEY = "_ledger"
# records kept (FIFO; aliases up to four times as many), and the EWMA
# weight of each observed full prefill in the learned baseline rate
MAX_RECORDS = 2048
PREFILL_ALPHA = 0.3


class DecisionLedger:
    """Bounded store of planner decision records + regret totals."""

    def __init__(self):
        self._lock = threading.Lock()
        self._records: "OrderedDict[str, dict]" = OrderedDict()
        self._aliases: "OrderedDict[str, str]" = OrderedDict()
        self._ids = itertools.count()
        # learned wall-clock prefill rate (EWMA seconds/token) from
        # observed full prefills — the counterfactual baseline when the
        # planner has no device perf model
        self._prefill_s_per_tok: Optional[float] = None
        self._totals = {"decisions": 0, "commits": 0, "regret_s": 0.0,
                        "savings_s": 0.0, "fallthrough_miss": 0,
                        "fallthrough_dead": 0, "fallthrough_corrupt": 0,
                        "dedup_shared": 0, "wins": 0, "locals": 0}

    # -- record lifecycle ----------------------------------------------
    def open(self, *, client: str = "", prompt_tokens: int = 0,
             trace_id: str = "", candidates=(),
             local_est_s: Optional[float] = None,
             deadline_s: Optional[float] = None) -> dict:
        """Open a record at plan time. ``candidates`` is the full
        priced set (pruned ones included, flagged); see planner.py for
        the schema. ``deadline_s`` is the remaining latency budget the
        plan was priced under (additive field; null when the request
        carried none)."""
        rec = {"id": f"dec-{next(self._ids)}",
               "trace_id": trace_id, "client": client,
               "t_open": clock.monotonic(),
               "prompt_tokens": int(prompt_tokens),
               "local_est_s": local_est_s,
               "deadline_s": deadline_s,
               "candidates": list(candidates),
               "attempts": [], "outcome": None}
        with self._lock:
            self._records[rec["id"]] = rec
            if trace_id:
                self._aliases[trace_id] = rec["id"]
            self._totals["decisions"] += 1
            while len(self._records) > MAX_RECORDS:
                old, _ = self._records.popitem(last=False)
                for alias, rid in list(self._aliases.items()):
                    if rid == old:
                        del self._aliases[alias]
        return rec

    def alias(self, name: str, rec_id: str) -> None:
        """Register a secondary lookup key (gateway request id,
        trace id) for a record."""
        if not name:
            return
        with self._lock:
            self._aliases[name] = rec_id
            while len(self._aliases) > 4 * MAX_RECORDS:
                self._aliases.popitem(last=False)

    def note_attempt(self, rec: Optional[dict], *, peer: str,
                     range_tokens: int, result: str,
                     est_fetch_s: float = 0.0, actual_s: float = 0.0,
                     shared: bool = False) -> None:
        """Record one walked attempt. ``result`` is one of
        ``hit|miss|dead|corrupt``."""
        if rec is None:
            return
        rec["attempts"].append(
            {"peer": peer, "range_tokens": int(range_tokens),
             "result": result, "est_fetch_s": float(est_fetch_s),
             "actual_s": float(actual_s), "shared": bool(shared)})

    def commit(self, rec: Optional[dict], *, chosen: Optional[str],
               result: str, fetch_s: float = 0.0, suffix_s: float = 0.0,
               local_prefill_s: float = 0.0,
               dedup_of: Optional[str] = None, **extra) -> None:
        """Close a record with the realized outcome and derive regret
        + counterfactual savings. ``result`` is ``hit|partial|local``;
        ``fetch_s`` is the winning attempt's transfer seconds,
        ``suffix_s`` the post-resume prefill, ``local_prefill_s`` the
        full local prefill when the plan lost/was empty."""
        if rec is None or rec.get("outcome") is not None:
            return
        falls = {"miss": 0, "dead": 0, "corrupt": 0}
        wasted_s = 0.0
        for a in rec["attempts"]:
            if a["result"] in falls:
                falls[a["result"]] += 1
                wasted_s += a["actual_s"]
        won = chosen is not None and result in ("hit", "partial")
        realized = wasted_s + (fetch_s + suffix_s if won
                               else local_prefill_s)
        baseline = rec.get("local_est_s")
        if baseline is None:
            baseline = self.baseline_s(rec["prompt_tokens"])
        hind = [baseline] if baseline is not None else []
        if won:
            hind.append(fetch_s + suffix_s)
        elif not hind:
            hind.append(local_prefill_s)
        best_hind = min(hind)
        regret = max(realized - best_hind, 0.0)
        savings = (baseline - realized) if baseline is not None else None
        rec["outcome"] = dict(
            chosen=chosen, result=result, fallthroughs=falls,
            fetch_s=float(fetch_s), suffix_s=float(suffix_s),
            local_prefill_s=float(local_prefill_s),
            baseline_s=baseline, realized_total_s=realized,
            best_hindsight_s=best_hind, regret_s=regret,
            savings_vs_local_s=savings, dedup_of=dedup_of,
            t_close=clock.monotonic(), **extra)
        with self._lock:
            t = self._totals
            t["commits"] += 1
            t["regret_s"] += regret
            if savings is not None:
                t["savings_s"] += savings
            for k, v in falls.items():
                t[f"fallthrough_{k}"] += v
            if dedup_of:
                t["dedup_shared"] += 1
            t["wins" if won else "locals"] += 1

    # -- learned wall-clock baseline -----------------------------------
    def note_prefill(self, n_tokens: int, seconds: float) -> None:
        """Feed one observed *full* local prefill (wall seconds for
        ``n_tokens``) into the learned baseline rate."""
        if n_tokens <= 0 or seconds <= 0:
            return
        rate = seconds / n_tokens
        with self._lock:
            if self._prefill_s_per_tok is None:
                self._prefill_s_per_tok = rate
            else:
                a = PREFILL_ALPHA
                self._prefill_s_per_tok = (
                    a * rate + (1 - a) * self._prefill_s_per_tok)

    def baseline_s(self, n_tokens: int) -> Optional[float]:
        """Estimated full-local-prefill seconds for ``n_tokens`` from
        the learned rate; ``None`` before any observation."""
        with self._lock:
            if self._prefill_s_per_tok is None:
                return None
            return self._prefill_s_per_tok * max(int(n_tokens), 0)

    # -- lookup / export -----------------------------------------------
    def get(self, id_or_alias: str) -> Optional[dict]:
        with self._lock:
            rid = self._aliases.get(id_or_alias, id_or_alias)
            return self._records.get(rid)

    def records(self, n: int = 50) -> List[dict]:
        """The most recent ``n`` records, oldest first."""
        with self._lock:
            recs = list(self._records.values())
        return recs[-n:]

    def totals(self) -> Dict[str, object]:
        with self._lock:
            out = dict(self._totals)
            out["records"] = len(self._records)
            out["prefill_s_per_tok"] = self._prefill_s_per_tok
        return out

    def clear(self) -> None:
        with self._lock:
            self._records.clear()
            self._aliases.clear()
            self._prefill_s_per_tok = None
            for k in self._totals:
                self._totals[k] = 0.0 if isinstance(
                    self._totals[k], float) else 0


# process-wide ledger: planner opens, client/gateway close, the
# gateway's GET /v1/decisions resolves
LEDGER = DecisionLedger()
