"""The port's fleet console (``repro_torch.obs.console``).

``render_lines`` gives the reference's lines on the same snapshot;
``--once`` against a port ``Gateway`` over 2 port daemons prints the
gateway block and a row a daemon, as the reference's console does on the
same fleet (both read the same wire) while the gateway's flight ring is
empty, and the port's alone once it holds an event (the reference's then
fails); a dead gateway and a dead daemon print ``DOWN`` and the console
still exits 0. Every subprocess wait is bounded.
"""
import http.client
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

from repro.obs import console as jax_console
from repro_torch.configs import get_config
from repro_torch.core.fabric import Fabric
from repro_torch.gateway import Gateway
from repro_torch.models.model import Model
from repro_torch.obs import console
from repro_torch.obs.flight import FLIGHT

SRC = str(Path(__file__).resolve().parents[1] / "src")
WAIT_S = 60

SNAPSHOT = {
    "t": 1_700_000_000.0,
    "gateway": {
        "report": {"n_requests": 12, "shed_requests": 1,
                   "throughput_tok_s": 41.25, "ttft_p50": 0.0123,
                   "ttft_p90": 0.05, "ttft_p99": 0.2, "latency_p50": 0.3,
                   "latency_p99": 0.9, "queue_wait_p50": 0.001,
                   "per_peer": {"peer1": {"gets": 3, "hits": 2, "misses": 1,
                                          "bytes_down": 2_500_000,
                                          "bytes_up": 0},
                                "peer0": {"gets": 1, "hits": 1,
                                          "bytes_down": 900}}},
        "http": {"errors_5xx": 2},
        "fetcher": {"resolves": 9, "hits": 4, "full_hits": 1,
                    "false_positives": 1, "bytes_down": 3 * 2 ** 20,
                    "bytes_up": 5 * 2 ** 30},
        "calibration": {"peer0": {"n": 5, "ewma_rel_err": -0.25,
                                  "mean_abs_err": 0.0042, "drift": True,
                                  "drift_events": 2},
                        "peer1": {"n": 1}},
    },
    "decisions": {"totals": {"decisions": 7, "commits": 6, "wins": 3,
                             "locals": 2, "dedup_shared": 1,
                             "regret_s": 0.125, "savings_s": 1.5,
                             "fallthrough_miss": 1, "fallthrough_dead": 0,
                             "fallthrough_corrupt": 2}},
    "flight": {"dumps": [{"reason": "shed", "events": [1, 2]},
                         {"reason": "peer_death",
                          "context": {"peer": "peer1"}, "events": [1]}],
               "snapshot": {"n_events": 17}},
    "peers": {"127.0.0.1:4001": {"ok": True, "peer": "peer0",
                                 "n_entries": 4, "stored_bytes": 123456,
                                 "catalog_fp": {"predicted": 0.01,
                                                "realized": 0.02},
                                 "throttle_bps": 2e6},
              "127.0.0.1:4002": {"ok": False}},
}


@pytest.mark.parametrize("snap,gateway", [
    (SNAPSHOT, "127.0.0.1:8080"),
    (dict(SNAPSHOT, gateway=None, decisions=None, flight=None),
     "127.0.0.1:8080"),
    ({"t": 0.0, "gateway": None, "decisions": None, "flight": None,
      "peers": {}}, None),
])
def test_render_lines_equal_the_reference(snap, gateway):
    mine = console.render_lines(snap, gateway)
    assert mine == jax_console.render_lines(snap, gateway)
    if gateway and snap["gateway"] is None:
        assert "  DOWN (no response)" in mine


def test_a_flight_ring_with_events_renders_where_the_reference_fails():
    """A recorder's snapshot counts its ring in ``events`` (an int). The
    reference's console calls ``len()`` on it, so it fails on any gateway
    whose ring holds an event (ROADMAP Queue 3); the port's prints it."""
    snap = dict(SNAPSHOT, flight={"snapshot": {"events": 5, "seq": 9,
                                               "dumps": 0, "capacity": 512},
                                  "dumps": []})
    with pytest.raises(TypeError):
        jax_console.render_lines(snap, "127.0.0.1:8080")
    assert "flight: 5 ring events, 0 dump(s)" in \
        console.render_lines(snap, "127.0.0.1:8080")
    empty = dict(snap, flight={"snapshot": {"events": 0}, "dumps": []})
    assert console.render_lines(empty, "127.0.0.1:8080") == \
        jax_console.render_lines(empty, "127.0.0.1:8080")


def _console(package, *args, ok=True):
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run(
        [sys.executable, "-m", f"{package}.obs.console", "--once",
         "--timeout", "2", *args], env=env, capture_output=True, text=True,
        timeout=WAIT_S)
    assert (proc.returncode == 0) == ok, proc.stderr
    return proc.stdout if ok else proc.stderr


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_once_watches_a_port_gateway_and_its_daemons():
    model = Model(get_config("gemma3-270m").reduced(), device="cpu")
    with Fabric.tcp(n_peers=2) as fabric:
        gw = Gateway(model, fabric=fabric, batch_size=2, max_len=128).start()
        try:
            conn = http.client.HTTPConnection("127.0.0.1", gw.port,
                                              timeout=WAIT_S)
            conn.request("POST", "/v1/completions",
                         json.dumps({"prompt": "watch this fleet",
                                     "max_tokens": 2}),
                         {"Content-Type": "application/json"})
            assert conn.getresponse().status == 200
            conn.close()
            gw.engine.fetcher.flush_uploads()
            addrs = fabric.supervisor.addresses()
            args = ["--gateway", f"127.0.0.1:{gw.port}", "--peers",
                    ",".join(f"{h}:{p}" for h, p in addrs.values())]
            FLIGHT.clear()                 # the reference's console needs it
            outs = {pkg: _console(pkg, *args)
                    for pkg in ("repro_torch", "repro")}
            FLIGHT.record("test.event")
            busy = _console("repro_torch", *args)
            ref_err = _console("repro", *args, ok=False)
        finally:
            gw.stop()
    assert "flight: 1 ring events, 0 dump(s)" in busy.splitlines()
    assert "TypeError" in ref_err
    for pkg, out in outs.items():
        lines = out.splitlines()
        assert lines[0].startswith("repro fleet console"), pkg
        assert f"gateway http://127.0.0.1:{gw.port}" in lines, pkg
        assert any(line.startswith("  requests 1 ") for line in lines), out
        assert "DOWN" not in out, out
        for pid, (host, port) in addrs.items():
            assert any(line.split()[:2] == [pid, f"{host}:{port}"]
                       for line in lines), (pid, out)
        assert any(line.startswith("ledger decisions") for line in lines)
        assert any(line.startswith("flight:") for line in lines)


def test_dead_targets_render_down():
    dead_gw, dead_peer = _free_port(), _free_port()
    out = _console("repro_torch", "--gateway", f"127.0.0.1:{dead_gw}",
                   "--peers", f"127.0.0.1:{dead_peer}")
    lines = out.splitlines()
    assert "  DOWN (no response)" in lines
    assert f"  {'127.0.0.1:' + str(dead_peer):<22} DOWN" in lines


def test_nothing_to_watch_is_a_usage_error():
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-m", "repro_torch.obs.console",
                           "--once"], env=env, capture_output=True,
                          text=True, timeout=WAIT_S)
    assert proc.returncode == 2 and "nothing to watch" in proc.stderr
