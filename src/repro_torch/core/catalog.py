"""Local catalog: a Bloom filter summarising the server's contents
(paper §3.1). Queried before any remote access and synchronised with
the server's master catalog off the request path."""
from __future__ import annotations

from repro_torch.config import CacheConfig
from repro_torch.core.bloom import BloomFilter


class Catalog:
    def __init__(self, cache_cfg: CacheConfig = CacheConfig()):
        self.cfg = cache_cfg
        self.bloom = BloomFilter(cache_cfg.bloom_capacity,
                                 cache_cfg.bloom_fp_rate)
        self.version = 0            # last master version folded in
        self.last_sync_t: float = -1e18
        self.sync_bytes = 0

    def lookup(self, key_digest: bytes) -> bool:
        return key_digest in self.bloom

    def register(self, key_digest: bytes) -> None:
        """Local update after a successful upload (paper Step 3)."""
        self.bloom.add(key_digest)

    def maybe_sync(self, transport, now: float) -> bool:
        """Pull the key digests the master added since our last version,
        at most once per ``sync_interval_s``."""
        if now - self.last_sync_t < self.cfg.sync_interval_s:
            return False
        self.last_sync_t = now
        resp, _, nbytes = transport.request("sync", {"since": self.version})
        self.sync_bytes += nbytes
        for k in resp.get("keys", []):
            self.bloom.add(k)
        self.version = resp.get("version", self.version)
        return True
