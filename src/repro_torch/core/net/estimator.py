"""Per-peer link estimation from observed transfers.

A copy of ``repro.core.net.estimator``. :class:`LinkEstimator` keeps an
EWMA bandwidth and RTT per peer, seeded from the link's nominal
parameters where they are known (so a fresh estimator prices a simulated
link exactly as its ``SimNetwork`` does) and updated from every observed
transfer:

* large transfers update bandwidth: ``bw = bytes * 8 / (t - rtt_est)``
* small ones (failed GETs, pings) update RTT: ``rtt = t - bytes * 8 / bw``

``est_fetch_s`` is what the fetch planner reads through
``PeerDirectory.est_fetch_s``, on the simulated and the TCP fabric
alike. ``save`` / ``warm_start`` / ``load`` persist the beliefs as JSON,
the reference's format: a daemon with ``--state-dir`` and a supervisor's
client directories start from what they learned before a restart, not
from the nominal prior.
"""
from __future__ import annotations

import json
import os
import threading
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

# prior for links with no declared parameters (real TCP peers): the
# paper's measured 2.4 GHz Wi-Fi 4 rate; a fast link proves itself in a
# couple of observations
DEFAULT_BW_BPS = 21e6
DEFAULT_RTT_S = 0.003

_BW_FLOOR, _BW_CEIL = 1e3, 1e12        # clamp degenerate samples


@dataclass
class LinkEstimate:
    bw_bps: float = DEFAULT_BW_BPS
    rtt_s: float = DEFAULT_RTT_S
    n_obs: int = 0                     # transfers folded in (not seeds)

    def est_fetch_s(self, nbytes: int) -> float:
        return self.rtt_s + nbytes * 8.0 / self.bw_bps


class LinkEstimator:
    """EWMA link beliefs for every peer a client talks to; ``alpha`` is
    the newest sample's weight. Thread-safe: several sessions may share
    one estimator."""

    default_bw_bps = DEFAULT_BW_BPS
    default_rtt_s = DEFAULT_RTT_S
    rtt_bytes_max = 4096               # transfers up to this are RTT samples

    def __init__(self, alpha: float = 0.3):
        self.alpha = alpha
        self._lock = threading.Lock()
        self._links: Dict[str, LinkEstimate] = {}

    def _fresh(self) -> LinkEstimate:
        return LinkEstimate(self.default_bw_bps, self.default_rtt_s)

    def seed(self, peer_id: str, bw_bps: Optional[float] = None,
             rtt_s: Optional[float] = None) -> None:
        """Set a peer's prior (its nominal link). A peer that already has
        an estimate keeps it."""
        with self._lock:
            if peer_id not in self._links:
                self._links[peer_id] = LinkEstimate(
                    bw_bps or self.default_bw_bps,
                    rtt_s if rtt_s is not None else self.default_rtt_s)

    def observe(self, peer_id: str, nbytes: int, seconds: float) -> None:
        """Fold one transfer of ``nbytes`` in ``seconds`` into the peer's
        estimate."""
        if seconds <= 0:
            return                      # no wire time to learn from
        a = self.alpha
        with self._lock:
            est = self._links.setdefault(peer_id, self._fresh())
            if nbytes <= self.rtt_bytes_max:
                # a small round trip is nearly pure RTT: strip the
                # transfer part so a sim link recovers its exact rtt
                sample = max(seconds - nbytes * 8.0 / est.bw_bps, 0.0)
                est.rtt_s = (1 - a) * est.rtt_s + a * sample
            else:
                if seconds < est.rtt_s:
                    # the whole exchange beat the believed RTT: the prior
                    # is stale (loopback against a Wi-Fi seed)
                    est.rtt_s = (1 - a) * est.rtt_s + a * seconds
                wire = max(seconds - est.rtt_s, 1e-9)
                sample = min(max(nbytes * 8.0 / wire, _BW_FLOOR), _BW_CEIL)
                est.bw_bps = (1 - a) * est.bw_bps + a * sample
            est.n_obs += 1

    def est_fetch_s(self, peer_id: str, nbytes: int) -> float:
        with self._lock:
            return self._links.get(peer_id, self._fresh()).est_fetch_s(nbytes)

    def snapshot(self, peer_id: str) -> Tuple[float, float, int]:
        """``(bw_bps, rtt_s, n_obs)`` of a peer."""
        with self._lock:
            est = self._links.get(peer_id)
            if est is None:
                return self.default_bw_bps, self.default_rtt_s, 0
            return est.bw_bps, est.rtt_s, est.n_obs

    # -- persistence: beliefs that outlive a restart ---------------------
    def snapshot_all(self) -> Dict[str, Tuple[float, float, int]]:
        with self._lock:
            return {pid: (e.bw_bps, e.rtt_s, e.n_obs)
                    for pid, e in self._links.items()}

    def save(self, path: str) -> None:
        """Write every peer's belief to ``path`` (JSON, replaced
        atomically)."""
        snap = {pid: {"bw_bps": bw, "rtt_s": rtt, "n_obs": n}
                for pid, (bw, rtt, n) in self.snapshot_all().items()}
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"version": 1, "links": snap}, f)
        os.replace(tmp, path)

    def warm_start(self, path: str) -> int:
        """Take a saved snapshot's beliefs as priors for the peers that
        have no estimate yet (a live one always wins). A missing or
        unreadable file is a cold start. Returns the links restored."""
        try:
            with open(path) as f:
                links = json.load(f).get("links", {})
        except (OSError, ValueError, AttributeError):
            return 0
        n = 0
        with self._lock:
            for pid, ent in links.items():
                if pid in self._links:
                    continue
                try:
                    self._links[pid] = LinkEstimate(
                        float(ent["bw_bps"]), float(ent["rtt_s"]),
                        int(ent.get("n_obs", 0)))
                except (KeyError, TypeError, ValueError):
                    continue
                n += 1
        return n

    @classmethod
    def load(cls, path: str, **kw) -> "LinkEstimator":
        est = cls(**kw)
        est.warm_start(path)
        return est
