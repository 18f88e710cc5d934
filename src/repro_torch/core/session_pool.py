"""Concurrent cache-sharing sessions on one engine and one fabric.

The port's copy of ``repro.core.session_pool``. ``SessionPool`` runs N
``EdgeClient`` sessions (threads) that share one process and device: the
"several apps on one edge node" scenario. Two cross-session savings live
here:

* **in-flight fetch dedup** (:class:`FetchBroker`): when several sessions
  want the same prefix at once, only the first issues the GET; the rest
  join the transfer and adopt the same blob. A small LRU of recently
  fetched blobs extends the sharing to sessions that arrive a moment
  later;
* **download/compute overlap**: while the blob is on the wire the leader
  allocates the restore target's cache (``prep``).

The reference's deprecated spelling ``SessionPool(server, engine)`` (and
``cluster=``) is not ported: nothing in the port calls it. Pass
``engine=`` and a ``fabric=`` from :class:`~repro_torch.core.fabric.Fabric`.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence, Tuple

from repro_torch import clock
from repro_torch.config import CacheConfig
from repro_torch.core.client import EdgeClient, InferResult
from repro_torch.core.fetch_policy import FetchPolicy
from repro_torch.core.metrics import merge_peer_stats
from repro_torch.core.net.estimator import LinkEstimator
from repro_torch.core.transport import TransportError

BLOB_CACHE_ENTRIES = 32            # recent blobs the broker shares


class _Inflight:
    def __init__(self):
        self.event = threading.Event()
        self.result = None             # (resp, dt, nbytes)


class FetchBroker:
    """Deduplicates concurrent blob GETs across sessions.

    ``fetch(key, issue, prep)`` returns ``(resp, dt, nbytes, shared,
    prepped)``:

    * the leader (the first caller for ``key``) runs ``issue()`` on a
      helper thread and ``prep()`` (the restore template) meanwhile, then
      publishes the reply;
    * followers wait on that transfer and share its reply: ``shared`` is
      True, and they paid no seconds and no bytes;
    * a recently fetched blob is served from a small LRU, shared too.

    Failed GETs (Bloom false positives, dead peers) are never cached. A
    ``TransportError`` from ``issue`` publishes ``{"ok": False, "dead":
    True}``, so every waiting follower falls back on its own instead of
    hanging. ``key`` is any hashable: a digest for one server, a
    ``(peer_id, digest)`` pair on the fabric (two peers, two links).

    The published reply is shared by reference, and the decision ledger
    rides it: the leader's client stamps its record id under
    :data:`~repro_torch.obs.ledger.LEDGER_KEY`, and a sibling that adopted
    the reply closes its own record with ``dedup_of`` pointing there, so
    one transfer is not counted twice.
    """

    def __init__(self):
        self.lock = threading.Lock()
        self.inflight = {}
        self.blob_cache: "OrderedDict[object, dict]" = OrderedDict()
        self.stats = {"issued": 0, "joined": 0, "cache_hits": 0}

    def _cache(self, key, resp: dict) -> None:
        """Keep a successful reply (the lock held)."""
        if resp.get("ok") and resp.get("blob"):
            self.blob_cache[key] = resp
            while len(self.blob_cache) > BLOB_CACHE_ENTRIES:
                self.blob_cache.popitem(last=False)

    def fetch(self, key, issue: Callable[[], Tuple[dict, float, int]],
              prep: Optional[Callable[[], object]] = None):
        with self.lock:
            cached = self.blob_cache.get(key)
            if cached is not None:
                self.blob_cache.move_to_end(key)
                self.stats["cache_hits"] += 1
            entry = self.inflight.get(key)
            leader = cached is None and entry is None
            if leader:
                entry = self.inflight[key] = _Inflight()
                self.stats["issued"] += 1
            elif cached is None:
                self.stats["joined"] += 1
        if cached is not None:
            return cached, 0.0, 0, True, (prep() if prep else None)
        if not leader:                 # prep while the leader's GET lands
            prepped = prep() if prep else None
            entry.event.wait()
            return entry.result[0], 0.0, 0, True, prepped
        worker = threading.Thread(target=self._issue, args=(entry, issue),
                                  daemon=True)
        worker.start()
        prepped = prep() if prep else None
        worker.join()
        resp, dt, nb = entry.result
        with self.lock:
            del self.inflight[key]
            self._cache(key, resp)
        return resp, dt, nb, False, prepped

    def lead(self, key):
        """Claim the lead of ``key`` for a transfer the caller drives
        itself (the layer-streamed fetch). Returns the in-flight entry,
        which the caller MUST resolve with :meth:`publish`, or None when
        the blob is cached or another caller leads: then go through
        :meth:`fetch` and share."""
        with self.lock:
            if key in self.blob_cache or key in self.inflight:
                return None
            entry = self.inflight[key] = _Inflight()
            self.stats["issued"] += 1
            return entry

    def publish(self, key, resp: dict, dt: float = 0.0, nb: int = 0) -> None:
        """Resolve a :meth:`lead` claim: wake every follower with
        ``resp`` and cache a successful blob, as :meth:`fetch`'s leader
        does."""
        with self.lock:
            entry = self.inflight.pop(key, None)
            self._cache(key, resp)
        if entry is not None:
            entry.result = (resp, dt, nb)
            entry.event.set()

    @staticmethod
    def _issue(entry: _Inflight, issue) -> None:
        t0 = clock.monotonic()
        try:
            entry.result = issue()
        except TransportError as e:    # a dead peer: one bounded fast fail
            entry.result = ({"ok": False, "dead": True, "error": repr(e)},
                            clock.monotonic() - t0, 0)
        except Exception as e:         # any other failure is a miss
            entry.result = ({"ok": False, "error": repr(e)},
                            clock.monotonic() - t0, 0)
        finally:
            entry.event.set()


class SessionPool:
    """N concurrent cache-sharing sessions over one engine and one
    fabric.

    Every session is a full ``EdgeClient`` (its own catalog and clock)
    sharing the engine, a :class:`FetchBroker`, and the fabric through its
    own ``fabric.directory()`` view. On the multi-peer fabrics all
    sessions share one :class:`~repro_torch.core.net.estimator.LinkEstimator`,
    so a congested link one session finds reprices every session's plan.
    ``run(jobs)`` runs the jobs concurrently (session i takes jobs i,
    i+N, ...) and returns the results in job order.
    """

    def __init__(self, *, engine, fabric, n_sessions: int = 2,
                 cache_cfg: CacheConfig = CacheConfig(), perf=None,
                 perf_cfg=None, overlap: bool = True,
                 policy: Optional[FetchPolicy] = None):
        if engine is None or fabric is None:
            raise ValueError("SessionPool needs engine= and fabric= "
                             "(Fabric.local/.sim/.tcp)")
        self.fabric = fabric
        self.engine = engine
        self.broker = FetchBroker()
        self.estimator = LinkEstimator()
        kw = dict(policy=policy) if policy is not None \
            else dict(overlap=overlap)
        self.sessions: List[EdgeClient] = [
            EdgeClient(f"session{i}", engine,
                       fabric.directory(estimator=self.estimator),
                       cache_cfg, perf=perf, perf_cfg=perf_cfg,
                       broker=self.broker, **kw)
            for i in range(n_sessions)]

    def sync_catalogs(self) -> None:
        for s in self.sessions:
            s.sync_catalog()

    def merged_peer_stats(self):
        """The fleet view across every session's directory (empty on the
        single box)."""
        return merge_peer_stats([s.directory.peer_stats()
                                 for s in self.sessions
                                 if s.directory is not None],
                                estimator=self.estimator)

    def run(self, jobs: Sequence, max_new_tokens: int = 8,
            **infer_kw) -> List[InferResult]:
        """``jobs``: PromptSegments, or (session index, PromptSegments)
        pairs to place them. Returns the results in job order."""
        n = len(self.sessions)
        placed = []
        for j, job in enumerate(jobs):
            if isinstance(job, tuple):
                if not 0 <= job[0] < n:
                    raise ValueError(f"job {j} placed on session {job[0]} "
                                     f"but the pool has {n} sessions")
                placed.append(job)
            else:
                placed.append((j % n, job))
        results: List[Optional[InferResult]] = [None] * len(placed)

        def run_session(si: int):
            for j, (sj, prompt) in enumerate(placed):
                if sj == si:
                    results[j] = self.sessions[si].infer(
                        prompt, max_new_tokens=max_new_tokens, **infer_kw)

        with ThreadPoolExecutor(max_workers=n) as ex:
            list(ex.map(run_session, range(n)))
        return results
