"""Cache server ("cache box") — the paper's Redis-on-Pi-5 middle node.

A copy of ``repro.core.server``: the blob store (key -> state blob)
under an optional LRU byte budget, and the master catalog with
incremental sync. ``handle(op, payload)`` is the single entry point
every transport calls. ``get_chunks`` serves a stored blob as its chunk
sequence, for a streamed fetch.

A put larger than the whole budget is refused (``stored: False``) and
the key enters no catalog. Keys evicted under the budget, or deleted
(replica GC), stay in the Bloom catalogs as tombstones: a later GET is a
§3.3 false positive, never an error. ``sync`` reports their count.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import List, Optional, Tuple

from repro_torch.config import CacheConfig
from repro_torch.core.bloom import BloomFilter
from repro_torch.core.chunkfmt import split_container


class CacheServer:
    def __init__(self, cache_cfg: CacheConfig = CacheConfig()):
        self.cfg = cache_cfg
        self.store: "OrderedDict[bytes, bytes]" = OrderedDict()
        self.stored_bytes = 0
        self.master = BloomFilter(cache_cfg.bloom_capacity,
                                  cache_cfg.bloom_fp_rate)
        self.key_log: List[bytes] = []      # insertion order, for sync
        self.tombstones: set = set()        # evicted or deleted keys
        self.lock = threading.Lock()
        self.stats = {"puts": 0, "gets": 0, "hits": 0, "misses": 0,
                      "bytes_in": 0, "bytes_out": 0, "syncs": 0,
                      "evictions": 0, "tombstones": 0, "deletes": 0,
                      "rejects": 0}

    def put(self, key: bytes, blob: bytes) -> Tuple[int, bool]:
        """Store one blob. Returns ``(catalog_version, stored)``;
        ``stored=False`` means the blob is larger than the whole budget:
        nothing is stored and the caller must not register the key."""
        with self.lock:
            budget = self.cfg.max_store_bytes
            if budget and len(blob) > budget:
                self.stats["rejects"] += 1
                return len(self.key_log), False
            fresh = key not in self.store
            if not fresh:
                self.stored_bytes -= len(self.store[key])
            self.store[key] = blob
            self.store.move_to_end(key)
            self.stored_bytes += len(blob)
            if fresh:
                self.master.add(key)
                self.key_log.append(key)
                self.tombstones.discard(key)    # a re-upload heals it
            self.stats["puts"] += 1
            self.stats["bytes_in"] += len(blob)
            while budget and self.stored_bytes > budget \
                    and len(self.store) > 1:
                old_key, old_blob = self.store.popitem(last=False)
                self.stored_bytes -= len(old_blob)
                self.stats["evictions"] += 1
                self.tombstones.add(old_key)
            self.stats["tombstones"] = len(self.tombstones)
            return len(self.key_log), True

    def peek(self, key: bytes) -> Optional[bytes]:
        """The stored blob without GET accounting or an LRU touch (the
        replicator reads its own store for pushes)."""
        with self.lock:
            return self.store.get(key)

    def get(self, key: bytes) -> Optional[bytes]:
        with self.lock:
            blob = self.store.get(key)
            self.stats["gets"] += 1
            if blob is None:
                self.stats["misses"] += 1
            else:
                self.store.move_to_end(key)     # LRU touch
                self.stats["hits"] += 1
                self.stats["bytes_out"] += len(blob)
            return blob

    def delete(self, key: bytes) -> bool:
        """Drop a blob and return its bytes to the budget; the key stays
        in the catalogs as a tombstone."""
        with self.lock:
            blob = self.store.pop(key, None)
            if blob is None:
                return False
            self.stored_bytes -= len(blob)
            self.tombstones.add(key)
            self.stats["deletes"] += 1
            self.stats["tombstones"] = len(self.tombstones)
            return True

    def sync(self, since_version: int) -> Tuple[List[bytes], int]:
        with self.lock:
            self.stats["syncs"] += 1
            return list(self.key_log[since_version:]), len(self.key_log)

    def handle(self, op: str, payload: dict) -> dict:
        if op == "put":
            v, stored = self.put(payload["key"], payload["blob"])
            return {"ok": True, "stored": stored, "version": v}
        if op == "get":
            blob = self.get(payload["key"])
            return {"ok": blob is not None, "blob": blob}
        if op == "get_chunks":
            # a streamed GET: the chunks go out one at a time. A stored
            # v2 blob streams as one chunk; a corrupt container is a miss
            blob = self.get(payload["key"])
            if blob is None:
                return {"ok": False, "chunks": []}
            try:
                chunks = split_container(blob)
            except ValueError as e:
                return {"ok": False, "chunks": [], "error": repr(e)}
            return {"ok": True, "chunks": chunks}
        if op == "del":
            return {"ok": self.delete(payload["key"])}
        if op == "sync":
            keys, v = self.sync(payload.get("since", 0))
            with self.lock:
                n_tomb = self.stats["tombstones"]
            return {"ok": True, "keys": keys, "version": v,
                    "tombstones": n_tomb}
        if op == "stats":
            with self.lock:
                return {"ok": True, "stats": dict(self.stats),
                        "n_entries": len(self.store),
                        "stored_bytes": self.stored_bytes}
        if op == "ping":
            return {"ok": True}
        return {"ok": False, "error": f"unknown op {op!r}"}
