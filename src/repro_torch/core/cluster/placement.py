"""Blob placement on the multi-peer fabric.

A copy of ``repro.core.cluster.placement``. Uploads go to a
consistent-hash primary, so every client agrees where a key lives with
no coordination and peer churn remaps only the departed peer's keys.
The ring hashes with blake2b, never Python's ``hash()``, so both
packages and every process give the same owners for the same digests.
Keys that prove hot at fetch time are replicated to a faster peer
(:class:`HotKeyTracker`).
"""
from __future__ import annotations

import bisect
import hashlib
from typing import Callable, Dict, List, Optional, Sequence


def _ring_hash(data: bytes) -> int:
    return int.from_bytes(hashlib.blake2b(data, digest_size=8).digest(),
                          "big")


VNODES = 32                        # ring points a peer, as the reference


class PlacementPolicy:
    """Consistent-hash ring over peer ids (``VNODES`` points a peer)."""

    def __init__(self, peer_ids: Sequence[str]):
        self.peer_ids = list(peer_ids)
        pts = sorted((_ring_hash(f"{pid}#{v}".encode()), pid)
                     for pid in self.peer_ids for v in range(VNODES))
        self._points = [p for p, _ in pts]
        self._owners = [o for _, o in pts]

    def primary(self, digest: bytes) -> str:
        return self.ring_order(digest)[0]

    def ring_order(self, digest: bytes) -> List[str]:
        """Every peer in ring order from the key's point: the primary,
        then the fallback and replica targets."""
        if not self._points:
            return []
        i = bisect.bisect_right(self._points, _ring_hash(digest))
        order: List[str] = []
        n = len(self._points)
        for step in range(n):
            pid = self._owners[(i + step) % n]
            if pid not in order:
                order.append(pid)
                if len(order) == len(self.peer_ids):
                    break
        return order


class HotKeyTracker:
    """Fetch counts per digest; a key is hot at ``threshold`` fetches.

    With ``decay_every > 0`` every count halves after that many fetches,
    so a key that stops being fetched cools and its extra replica can be
    collected. ``pinned`` digests (those with a live replica) never lose
    their count to the ``max_entries`` eviction: a lost count would make
    the GC delete a replica that is still hot."""

    def __init__(self, threshold: int = 3, max_entries: int = 4096,
                 decay_every: int = 0,
                 pinned: Optional[Callable[[bytes], bool]] = None):
        self.threshold = threshold
        self.max_entries = max_entries
        self.decay_every = decay_every
        self.pinned = pinned or (lambda digest: False)
        self.counts: Dict[bytes, int] = {}
        self._notes_since_decay = 0
        self.decays = 0

    def note(self, digest: bytes) -> int:
        if digest not in self.counts and \
                len(self.counts) >= self.max_entries:
            evictable = [d for d in self.counts if not self.pinned(d)]
            if evictable:              # all pinned: grow past the cap
                del self.counts[min(evictable, key=self.counts.get)]
        self.counts[digest] = self.counts.get(digest, 0) + 1
        if self.decay_every > 0:
            self._notes_since_decay += 1
            if self._notes_since_decay >= self.decay_every:
                self.decay()
        return self.counts.get(digest, 0)

    def decay(self) -> None:
        """Halve every count; counts that reach 0 are dropped."""
        self._notes_since_decay = 0
        self.decays += 1
        self.counts = {d: c // 2 for d, c in self.counts.items()
                       if c // 2 > 0}

    def is_hot(self, digest: bytes) -> bool:
        return self.counts.get(digest, 0) >= self.threshold
