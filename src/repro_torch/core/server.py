"""Cache server ("cache box") — the paper's Redis-on-Pi-5 middle node.

A lean copy of ``repro.core.server``: the blob store (key -> state blob)
and the master catalog, with incremental catalog sync. ``handle(op,
payload)`` is the single entry point the transport calls. Chunked GETs,
eviction and tombstones are not in this port yet.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

from repro_torch.config import CacheConfig
from repro_torch.core.bloom import BloomFilter


class CacheServer:
    def __init__(self, cache_cfg: CacheConfig = CacheConfig()):
        self.cfg = cache_cfg
        self.store: Dict[bytes, bytes] = {}
        self.stored_bytes = 0
        self.master = BloomFilter(cache_cfg.bloom_capacity,
                                  cache_cfg.bloom_fp_rate)
        self.key_log: List[bytes] = []      # insertion order, for sync
        self.lock = threading.Lock()
        self.stats = {"puts": 0, "gets": 0, "hits": 0, "misses": 0,
                      "bytes_in": 0, "bytes_out": 0, "syncs": 0}

    def put(self, key: bytes, blob: bytes) -> Tuple[int, bool]:
        """Store one blob. Returns ``(catalog_version, stored)``."""
        with self.lock:
            old = self.store.get(key)
            if old is not None:
                self.stored_bytes -= len(old)
            else:
                self.master.add(key)
                self.key_log.append(key)
            self.store[key] = blob
            self.stored_bytes += len(blob)
            self.stats["puts"] += 1
            self.stats["bytes_in"] += len(blob)
            return len(self.key_log), True

    def get(self, key: bytes) -> Optional[bytes]:
        with self.lock:
            blob = self.store.get(key)
            self.stats["gets"] += 1
            if blob is None:
                self.stats["misses"] += 1
            else:
                self.stats["hits"] += 1
                self.stats["bytes_out"] += len(blob)
            return blob

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
        if op == "sync":
            keys, v = self.sync(payload.get("since", 0))
            return {"ok": True, "keys": keys, "version": v}
        if op == "stats":
            with self.lock:
                return {"ok": True, "stats": dict(self.stats),
                        "n_entries": len(self.store),
                        "stored_bytes": self.stored_bytes}
        if op == "ping":
            return {"ok": True}
        return {"ok": False, "error": f"unknown op {op!r}"}
