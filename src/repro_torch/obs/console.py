"""Live fleet console: one terminal view of a running cache fabric.

    python -m repro_torch.obs.console --gateway 127.0.0.1:8080 \
        --peers 127.0.0.1:4001,127.0.0.1:4002

The port's copy of ``repro.obs.console``. It polls the gateway's HTTP
surface (``/metrics.json``, ``/v1/decisions``, ``/v1/flight``) and each
peer daemon's ``health`` op over TCP, and renders: request/TTFT
percentiles, per-peer hit/miss/bytes, the decision ledger's regret and
counterfactual-savings totals, estimator drift flags, Bloom-FP probes,
and the last flight-recorder dumps. Both packages' gateways and daemons
speak the same wire, so either console watches either fleet.

``--once`` renders a single plain-text snapshot to stdout and exits.
Without it, a stdlib-curses loop redraws every ``--interval`` seconds
(``q`` quits).

Torch-free and dependency-free: stdlib ``urllib`` for the gateway,
:class:`~repro_torch.core.net.link.TCPPeerLink` (imported lazily: sockets
only) for the daemons, and the port's one clock. A dead target renders as
``DOWN``; it never crashes the console.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import urllib.error
import urllib.request
from typing import Dict, List, Optional, Tuple

from repro_torch import clock


def _http_json(url: str, timeout: float = 2.0) -> Optional[dict]:
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return json.loads(r.read().decode("utf-8"))
    except (urllib.error.URLError, OSError, ValueError):
        return None


def _fmt_bytes(n) -> str:
    n = float(n or 0)
    for unit in ("B", "KB", "MB", "GB"):
        if n < 1024 or unit == "GB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024
    return f"{n:.1f}GB"


def _ms(s) -> str:
    return f"{float(s or 0) * 1e3:.1f}ms"


class FleetPoller:
    """Collects one consistent snapshot per tick from every target."""

    def __init__(self, gateway: Optional[str] = None,
                 peers: Tuple[Tuple[str, int], ...] = (),
                 timeout_s: float = 2.0):
        self.gateway = gateway
        self.peers = list(peers)
        self.timeout_s = timeout_s
        self._links: Dict[str, object] = {}

    def poll(self) -> dict:
        snap: dict = {"t": clock.wall(), "gateway": None,
                      "decisions": None, "flight": None, "peers": {}}
        if self.gateway:
            base = f"http://{self.gateway}"
            snap["gateway"] = _http_json(base + "/metrics.json",
                                         self.timeout_s)
            snap["decisions"] = _http_json(base + "/v1/decisions",
                                           self.timeout_s)
            snap["flight"] = _http_json(base + "/v1/flight",
                                        self.timeout_s)
        for host, port in self.peers:
            addr = f"{host}:{port}"
            snap["peers"][addr] = self._health(addr, host, port)
        return snap

    def _health(self, addr: str, host: str, port: int) -> dict:
        from repro_torch.core.net.link import TCPPeerLink
        from repro_torch.core.transport import TransportError
        link = self._links.get(addr)
        if link is None:
            link = self._links[addr] = TCPPeerLink(
                addr, host, port, timeout=self.timeout_s)
        try:
            resp, _dt, _nb = link.request("health", {})
            return resp
        except TransportError:
            self._links.pop(addr, None)   # rebuild the socket next tick
            return {"ok": False}


# ----------------------------------------------------------------------
# rendering (shared by --once and the curses loop)
# ----------------------------------------------------------------------
def render_lines(snap: dict, gateway: Optional[str] = None) -> List[str]:
    out: List[str] = []
    ts = time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(snap["t"]))
    out.append(f"repro fleet console        {ts}")
    out.append("=" * 64)

    gw = snap.get("gateway")
    if gateway:
        out.append(f"gateway http://{gateway}")
        if gw is None:
            out.append("  DOWN (no response)")
        else:
            rep = gw.get("report") or {}
            http = gw.get("http") or {}
            out.append(
                f"  requests {rep.get('n_requests', 0)}"
                f"  shed {rep.get('shed_requests', 0)}"
                f"  throughput {rep.get('throughput_tok_s', 0.0):.1f}"
                " tok/s"
                f"  http 5xx {http.get('errors_5xx', 0)}")
            out.append(
                f"  ttft p50/p90/p99 {_ms(rep.get('ttft_p50'))}/"
                f"{_ms(rep.get('ttft_p90'))}/{_ms(rep.get('ttft_p99'))}"
                f"   latency p50/p99 {_ms(rep.get('latency_p50'))}/"
                f"{_ms(rep.get('latency_p99'))}"
                f"   queue p50 {_ms(rep.get('queue_wait_p50'))}")
            f = gw.get("fetcher")
            if f:
                out.append(
                    f"  fetcher resolves {f.get('resolves', 0)}"
                    f"  hits {f.get('hits', 0)}"
                    f" (full {f.get('full_hits', 0)})"
                    f"  stale-fp {f.get('false_positives', 0)}"
                    f"  down {_fmt_bytes(f.get('bytes_down'))}"
                    f"  up {_fmt_bytes(f.get('bytes_up'))}")
            for pid, st in sorted((rep.get("per_peer") or {}).items()):
                out.append(
                    f"    {pid:<10} gets {st.get('gets', 0):<5}"
                    f" hits {st.get('hits', 0):<5}"
                    f" misses {st.get('misses', 0):<4}"
                    f" down {_fmt_bytes(st.get('bytes_down')):>9}"
                    f" up {_fmt_bytes(st.get('bytes_up')):>9}")

    dec = snap.get("decisions")
    if dec is not None:
        t = dec.get("totals") or {}
        out.append(
            f"ledger decisions {t.get('decisions', 0)}"
            f"  commits {t.get('commits', 0)}"
            f"  wins {t.get('wins', 0)}  locals {t.get('locals', 0)}"
            f"  dedup {t.get('dedup_shared', 0)}")
        out.append(
            f"  regret {t.get('regret_s', 0.0):.3f}s"
            f"  savings {t.get('savings_s', 0.0):.3f}s"
            "  fallthrough miss/dead/corrupt "
            f"{t.get('fallthrough_miss', 0)}/"
            f"{t.get('fallthrough_dead', 0)}/"
            f"{t.get('fallthrough_corrupt', 0)}")

    cal = (gw or {}).get("calibration") or {}
    if cal:
        out.append("calibration (est vs actual, per peer):")
        for pid, c in sorted(cal.items()):
            flag = "DRIFT" if c.get("drift") else "ok"
            out.append(
                f"  {pid:<10} n {c.get('n', 0):<4}"
                f" ewma {c.get('ewma_rel_err', 0.0):+6.2f}"
                f" |err| {c.get('mean_abs_err', 0.0):6.3f}s"
                f"  {flag}"
                + (f" (x{c.get('drift_events', 0)})"
                   if c.get("drift_events") else ""))

    if snap.get("peers"):
        out.append("peers:")
        for addr, h in sorted(snap["peers"].items()):
            if not h or not h.get("ok"):
                out.append(f"  {addr:<22} DOWN")
                continue
            fp = h.get("catalog_fp") or {}
            thr = h.get("throttle_bps")
            out.append(
                f"  {h.get('peer', '?'):<8} {addr:<22}"
                f" entries {h.get('n_entries', 0):<5}"
                f" {_fmt_bytes(h.get('stored_bytes')):>9}"
                f"  fp pred {fp.get('predicted', 0.0):.3f}"
                f" real {fp.get('realized', 0.0):.3f}"
                f"  throttle "
                + (f"{thr / 1e6:.1f}Mbps" if thr else "-"))

    fl = snap.get("flight")
    if fl is not None:
        dumps = fl.get("dumps") or []
        ring = fl.get("snapshot") or {}
        # a recorder's snapshot counts its ring in "events" (an int); the
        # reference calls len() on it and fails once the ring holds any
        events = ring.get("events")
        n_ev = ring.get("n_events", events if isinstance(events, int)
                        else len(events or []))
        out.append(f"flight: {n_ev} ring events, {len(dumps)} dump(s)")
        for d in dumps[-3:]:
            ctx = d.get("context") or {}
            peer = ctx.get("peer", "")
            out.append(
                f"  dump {d.get('reason', '?')}"
                + (f" peer={peer}" if peer else "")
                + f"  ({len(d.get('events') or [])} events)")
    return out


def render_once(poller: FleetPoller) -> str:
    return "\n".join(render_lines(poller.poll(), poller.gateway))


def _curses_loop(poller: FleetPoller, interval_s: float) -> None:
    import curses

    def loop(stdscr):
        curses.curs_set(0)
        stdscr.timeout(max(int(interval_s * 1000), 100))
        while True:
            lines = render_lines(poller.poll(), poller.gateway)
            stdscr.erase()
            maxy, maxx = stdscr.getmaxyx()
            for i, line in enumerate(lines[:maxy - 1]):
                try:
                    stdscr.addnstr(i, 0, line, maxx - 1)
                except curses.error:
                    pass               # terminal shrank mid-draw
            try:
                stdscr.addnstr(maxy - 1, 0, "q to quit", maxx - 1,
                               curses.A_REVERSE)
            except curses.error:
                pass
            stdscr.refresh()
            ch = stdscr.getch()        # doubles as the interval sleep
            if ch in (ord("q"), ord("Q"), 27):
                return

    curses.wrapper(loop)


def _parse_addr(s: str) -> Tuple[str, int]:
    host, _, port = s.rpartition(":")
    return host or "127.0.0.1", int(port)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gateway", default=None,
                    help="gateway host:port (polls /metrics.json, "
                         "/v1/decisions, /v1/flight)")
    ap.add_argument("--peers", default="",
                    help="comma-separated daemon host:port list "
                         "(polled via the TCP health op)")
    ap.add_argument("--interval", type=float, default=1.0)
    ap.add_argument("--timeout", type=float, default=2.0)
    ap.add_argument("--once", action="store_true",
                    help="print one plain-text snapshot and exit")
    args = ap.parse_args(argv)

    peers = tuple(_parse_addr(p) for p in args.peers.split(",") if p)
    if not args.gateway and not peers:
        ap.error("nothing to watch: pass --gateway and/or --peers")
    poller = FleetPoller(args.gateway, peers, timeout_s=args.timeout)
    if args.once:
        print(render_once(poller))
        return 0
    try:
        _curses_loop(poller, args.interval)
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
