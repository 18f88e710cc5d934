"""Bloom filter — the client's catalog structure (paper §3.1).

A copy of ``repro.core.bloom``: capacity 1M at a 1% target FP ratio
gives m ≈ 9.59e6 bits and k = 7, with Kirsch-Mitzenmacher double
hashing over blake2b(key). The same key sets give the same bits as the
reference.
"""
from __future__ import annotations

import hashlib
import math


class BloomFilter:
    def __init__(self, capacity: int = 1_000_000, fp_rate: float = 0.01):
        if not (0 < fp_rate < 1):
            raise ValueError("fp_rate must be in (0,1)")
        self.capacity = int(capacity)
        self.fp_rate = float(fp_rate)
        ln2 = math.log(2.0)
        self.m = max(64, int(math.ceil(-capacity * math.log(fp_rate) / ln2 ** 2)))
        self.k = max(1, int(round(self.m / capacity * ln2)))
        self.bits = bytearray((self.m + 7) // 8)
        self.n_added = 0

    def _indices(self, key: bytes):
        d = hashlib.blake2b(key, digest_size=16).digest()
        h1 = int.from_bytes(d[:8], "little")
        h2 = int.from_bytes(d[8:], "little") | 1
        return [(h1 + i * h2) % self.m for i in range(self.k)]

    def add(self, key: bytes) -> None:
        for ix in self._indices(key):
            self.bits[ix >> 3] |= 1 << (ix & 7)
        self.n_added += 1

    def __contains__(self, key: bytes) -> bool:
        return all(self.bits[ix >> 3] & (1 << (ix & 7))
                   for ix in self._indices(key))
