"""The port's chaos layer and the daemon's fault surface.

Mirrors the chaos-specific half of ``tests/test_chaos.py`` on the port:
corrupt chunks and an inbound partition injected into a peer server, the
seeded fault schedule (same seed, same events; every kind with its heal;
the JSON round trip) and the ``FaultDriver``'s mapping of each kind onto
one supervisor surface (a dead target recorded and skipped). The
breakers, deadlines, cancel frame and restart-storm guard have their
mirrors in ``tests/test_torch_fabric_runtime.py``. Held against the
reference: ``FaultSchedule.generate`` gives its ``event_order()`` and its
JSON for seeds 0-9. Added: the other injected faults (a stalled stream
cut by the cancel frame, a connection dropped mid-stream, delayed acks,
the outbound throttle), the in-process injectors, the daemon's
``inject`` / ``set_throttle`` / ``health`` through the supervisor with
its fleet views and ``state_dir``, and a short fault schedule replayed
against supervised daemons under a port client whose every answer must
equal a cold run. Every wait is bounded.
"""
import json
import os
import threading
import time

import jax
import numpy as np
import pytest

from repro.chaos import ChaosLink as JaxChaosLink
from repro.chaos import FaultSchedule as JaxSchedule
from repro.core.cluster.peer import CachePeer as JaxPeer
from repro.core.cluster.peer import PeerTransport as JaxPeerTransport
from repro.core.netsim import SimClock as JaxSimClock
from repro_torch.chaos import (ChaosLink, ChaosSimNetwork, FaultDriver,
                               FaultEvent, FaultSchedule)
from repro_torch.config import CacheConfig
from repro_torch.configs import get_config
from repro_torch.core import state_io
from repro_torch.core.client import EdgeClient
from repro_torch.core.cluster.peer import CachePeer, PeerTransport
from repro_torch.core.net.link import TCPPeerLink
from repro_torch.core.net.server import serve_peer_tcp
from repro_torch.core.net.supervisor import PeerSupervisor
from repro_torch.core.netsim import SimClock, SimNetwork
from repro_torch.core.server import CacheServer
from repro_torch.core.transport import StreamCancelled, TransportError
from repro_torch.data.mmlu import MMLUGenerator
from repro_torch.data.tokenizer import WordHashTokenizer
from repro_torch.models.model import Model
from repro_torch.obs.flight import FLIGHT
from repro_torch.obs.ledger import LEDGER
from repro_torch.params import from_jax_params
from repro_torch.serving.engine import InferenceEngine

PEERS = ["peer0", "peer1", "peer2"]


class _Chunky:
    """Streams ``n`` chunks for any op; answers plain ops too."""

    def __init__(self, n=8, size=400):
        self.chunks = [bytes([i]) * size for i in range(n)]

    def handle(self, op, payload):
        if op == "ping":
            return {"ok": True}
        return {"ok": True, "chunks": list(self.chunks)}


# ---------------------------------------------------------------------------
# faults injected into a peer server
# ---------------------------------------------------------------------------

def test_injected_corruption_flips_first_byte_of_next_chunks():
    with serve_peer_tcp(_Chunky(n=4, size=16)) as srv:
        srv.chaos["corrupt_chunks"] = 1
        link = TCPPeerLink("p0", "127.0.0.1", srv.port, timeout=10.0)
        got = []
        link.request_stream("get_chunks", {"key": b"k"},
                            lambda b, dt, nb: got.append(b))
        assert len(got) == 4
        assert got[0][0] == 0x00 ^ 0xFF     # the injected flip
        assert got[1][0] == 0x01            # only the budgeted chunk
        got2 = []                           # budget spent: clean again
        link.request_stream("get_chunks", {"key": b"k"},
                            lambda b, dt, nb: got2.append(b))
        assert got2[0][0] == 0x00
        link.close()


def test_partition_inbound_times_out_but_inject_heals():
    with serve_peer_tcp(_Chunky()) as srv:
        srv.chaos["partition_inbound"] = True
        link = TCPPeerLink("p0", "127.0.0.1", srv.port, timeout=0.5)
        t0 = time.monotonic()
        with pytest.raises(TransportError):
            link.request("ping", {})
        assert time.monotonic() - t0 < 5.0  # bounded, not a hang
        link.close()
        srv.chaos.pop("partition_inbound")
        link2 = TCPPeerLink("p0", "127.0.0.1", srv.port, timeout=5.0)
        assert link2.request("ping", {})[0]["ok"]
        link2.close()


def test_stalled_stream_is_cut_by_the_cancel_frame():
    with serve_peer_tcp(_Chunky()) as srv:
        srv.chaos["stall_chunk_s"] = 0.05
        link = TCPPeerLink("p0", "127.0.0.1", srv.port, timeout=10.0)
        cancel, got = threading.Event(), []

        def on_chunk(b, dt, nb):
            got.append(b)
            if len(got) >= 2:
                cancel.set()

        with pytest.raises(StreamCancelled):
            link.request_stream("get_chunks", {"key": b"k"}, on_chunk,
                                cancel=cancel)
        assert 2 <= len(got) < 8
        assert link.request("ping", {})[0]["ok"]   # the socket stays in sync
        link.close()


def test_close_mid_stream_is_one_bounded_error():
    with serve_peer_tcp(_Chunky(n=6)) as srv:
        srv.chaos["close_mid_stream"] = 2
        link = TCPPeerLink("p0", "127.0.0.1", srv.port, timeout=5.0)
        got = []
        with pytest.raises(TransportError):
            link.request_stream("get_chunks", {"key": b"k"},
                                lambda b, dt, nb: got.append(b))
        assert len(got) == 2
        assert "close_mid_stream" not in srv.chaos     # one shot
        assert link.request("ping", {})[0]["ok"]       # reconnects
        link.close()


def test_delay_ack_and_throttle_slow_the_replies():
    with serve_peer_tcp(_Chunky(n=4, size=25_000)) as srv:
        link = TCPPeerLink("p0", "127.0.0.1", srv.port, timeout=10.0)
        srv.chaos["delay_ack_s"] = 0.2
        t0 = time.monotonic()
        assert link.request("ping", {})[0]["ok"]
        assert time.monotonic() - t0 >= 0.2
        srv.chaos.clear()
        # 100 kB at 2 Mbit/s: ~0.4 s once the 0.2 s burst credit is spent
        srv.throttle_bps = 2e6
        t0 = time.monotonic()
        link.request_stream("get_chunks", {"key": b"k"},
                            lambda b, dt, nb: None)
        assert time.monotonic() - t0 >= 0.15
        srv.throttle_bps = None
        link.close()


# ---------------------------------------------------------------------------
# the schedule: seeded, replayable, self-healing, the reference's events
# ---------------------------------------------------------------------------

def test_schedule_same_seed_same_event_order():
    a = FaultSchedule.generate(seed=42, peers=PEERS)
    b = FaultSchedule.generate(seed=42, peers=PEERS)
    assert a.event_order() == b.event_order()
    c = FaultSchedule.generate(seed=43, peers=PEERS)
    assert a.event_order() != c.event_order()


@pytest.mark.parametrize("seed", range(10))
def test_schedule_equals_the_reference(seed):
    for kw in ({}, {"n_steps": 24, "n_faults": 12}):
        mine = FaultSchedule.generate(seed, PEERS, **kw)
        ref = JaxSchedule.generate(seed, PEERS, **kw)
        assert mine.event_order() == ref.event_order()
        assert mine.to_json() == ref.to_json()
        assert [e.fingerprint() for e in mine.faults()] == \
            [e.fingerprint() for e in ref.faults()]


def test_schedule_covers_all_kinds_and_pairs_heals():
    sched = FaultSchedule.generate(seed=7, peers=["p0", "p1"], n_faults=6,
                                   heal_after=3)
    faults = sched.faults()
    assert len(faults) >= 6
    assert {f.kind for f in faults} == {
        "kill", "partition", "corrupt", "stall", "bandwidth", "delay_ack"}
    heals = [e for e in sched.events if e not in faults]
    for f in faults:
        assert [h for h in heals if h.peer == f.peer
                and h.step == f.step + 3], f.fingerprint()


def test_schedule_json_roundtrip_preserves_order():
    sched = FaultSchedule.generate(seed=5, peers=["p0", "p1"])
    back = FaultSchedule.from_json(sched.to_json())
    assert back.event_order() == sched.event_order()
    assert back.seed == sched.seed
    json.loads(sched.to_json())
    with pytest.raises(ValueError):
        FaultSchedule.generate(seed=0, peers=[])


class _RecordingSup:
    """A supervisor stand-in recording which surface each kind lands on;
    peer 'dead' refuses every op."""

    def __init__(self):
        self.procs = {"p0": None, "dead": None}
        self.calls = []

    def kill(self, pid, hard=False):
        self.calls.append(("kill", pid, hard))

    def restart(self, pid):
        self.calls.append(("restart", pid))

    def set_throttle(self, pid, bps):
        if pid == "dead":
            raise TransportError("connection refused")
        self.calls.append(("throttle", pid, bps))

    def inject_faults(self, pid, chaos=None, reset=False):
        if pid == "dead":
            raise TransportError("connection refused")
        self.calls.append(("inject", pid, chaos, reset))
        return {"ok": True}


def test_driver_maps_kinds_to_control_surfaces():
    events = [FaultEvent(1, "kill", "p0", {}),
              FaultEvent(2, "corrupt", "p0", {"chunks": 3}),
              FaultEvent(3, "stall", "p0", {"seconds": 0.2}),
              FaultEvent(4, "partition", "p0", {}),
              FaultEvent(5, "bandwidth", "p0", {"bps": 1e4}),
              FaultEvent(6, "heal", "p0", {}),
              FaultEvent(7, "revive", "p0", {}),
              FaultEvent(8, "delay_ack", "p0", {"seconds": 0.1})]
    sup = _RecordingSup()
    drv = FaultDriver(sup, FaultSchedule(events, seed=0, n_steps=10))
    assert drv.advance(3) == events[:3]
    assert [c[0] for c in sup.calls] == ["kill", "inject", "inject"]
    assert sup.calls[0] == ("kill", "p0", True)
    assert sup.calls[1][2] == {"corrupt_chunks": 3}
    assert sup.calls[2][2] == {"stall_chunk_s": 0.2}
    drv.finish()
    assert sup.calls[3][2] == {"partition_inbound": True}
    assert sup.calls[4] == ("throttle", "p0", 1e4)
    assert sup.calls[5] == ("inject", "p0", None, True)   # heal
    assert sup.calls[6] == ("restart", "p0")
    assert sup.calls[7][2] == {"delay_ack_s": 0.1}
    assert drv.applied_order() == [e.fingerprint() for e in events]
    drv.heal_all(["p0", "dead"])       # best effort, a dead peer included
    assert sup.calls[-2:] == [("inject", "p0", None, True),
                              ("throttle", "p0", None)]


def test_driver_records_and_skips_dead_target():
    events = [FaultEvent(1, "corrupt", "dead", {"chunks": 1}),
              FaultEvent(2, "kill", "p0", {})]
    sup = _RecordingSup()
    drv = FaultDriver(sup, FaultSchedule(events, seed=0, n_steps=5))
    drv.finish()                       # must not raise
    assert [e.kind for e in drv.skipped] == ["corrupt"]
    assert [e.kind for e in drv.applied] == ["kill"]


# ---------------------------------------------------------------------------
# the in-process injectors
# ---------------------------------------------------------------------------

def test_chaos_link_drops_flaps_and_corrupts():
    peer = CachePeer("p0")
    peer.server.put(b"k" * 32, b"x" * 64)
    link = ChaosLink(PeerTransport(peer, SimClock()))
    assert link.peer_id == "p0"            # a drop-in for the directory
    assert link.request("get", {"key": b"k" * 32})[0]["ok"]
    link.fail_next = 1
    with pytest.raises(TransportError):
        link.request("get", {"key": b"k" * 32})
    assert link.request("get", {"key": b"k" * 32})[0]["ok"]   # flapped back
    link.drop_requests = True
    with pytest.raises(TransportError):
        link.request("csync", {"since": 0})
    link.drop_requests = False
    # a stream through the wrapper: one chunk's first byte flipped, so
    # the client's digests catch it (the reference's wrapper raises
    # AttributeError here: it reads each chunk as a dict)
    peer.server.put(b"s" * 32, state_io.pack_container(
        [b"header", b"\x01chunk", b"\x02chunk"]))
    got = []
    link.corrupt_chunks = 1
    link.request_stream("get_chunks", {"key": b"s" * 32},
                        lambda c, dt, nb: got.append(c))
    assert [c[0] for c in got] == [ord("h") ^ 0xFF, 0x01, 0x02]
    jpeer = JaxPeer("p0")
    jpeer.server.put(b"s" * 32, state_io.pack_container(
        [b"header", b"\x01chunk", b"\x02chunk"]))
    jlink = JaxChaosLink(JaxPeerTransport(jpeer, JaxSimClock()))
    jlink.corrupt_chunks = 1
    with pytest.raises(AttributeError):
        jlink.request_stream("get_chunks", {"key": b"s" * 32},
                             lambda c, dt, nb: None)


def test_chaos_sim_network_degrades_and_heals():
    net = SimNetwork()
    chaos = ChaosSimNetwork(net)
    nominal = net.transfer_time(1 << 20)
    assert chaos.transfer_time(1 << 20) == pytest.approx(nominal)
    chaos.degrade(bw_factor=0.1, rtt_factor=2.0)
    assert chaos.bandwidth_bps == pytest.approx(net.bandwidth_bps * 0.1)
    assert chaos.transfer_time(1 << 20) > 5 * nominal
    chaos.heal()
    assert chaos.transfer_time(1 << 20) == pytest.approx(nominal)


# ---------------------------------------------------------------------------
# the daemon's fault surface, through the supervisor
# ---------------------------------------------------------------------------

def test_supervisor_injects_throttles_and_reports(tmp_path):
    state = str(tmp_path / "state")
    with PeerSupervisor.fleet(2, gossip_interval_s=0.05,
                              state_dir=state) as sup:
        got = sup.inject_faults("peer0", chaos={"delay_ack_s": 0.05,
                                                "corrupt_chunks": 2})
        assert got["chaos"] == {"delay_ack_s": 0.05, "corrupt_chunks": 2}
        assert sup.inject_faults("peer0", chaos={"corrupt_chunks": None}
                                 )["chaos"] == {"delay_ack_s": 0.05}
        assert sup.set_throttle("peer1", 4e6)["throttle_bps"] == 4e6
        cal = sup.fleet_calibration()
        assert cal["peer0"]["alive"] and cal["peer0"]["chaos"] == {
            "delay_ack_s": 0.05}
        assert cal["peer1"]["throttle_bps"] == 4e6
        assert {"predicted", "realized", "gets", "misses",
                "tombstones"} <= set(cal["peer0"]["catalog_fp"])
        # the daemons learn their links from gossip pulls
        deadline = time.monotonic() + 20.0
        while not cal["peer0"]["links"] and time.monotonic() < deadline:
            time.sleep(0.05)
            cal = sup.fleet_calibration()
        assert "peer1" in cal["peer0"]["links"]
        merged = sup.fleet_metrics()
        assert merged["_fleet"] == {"peers": 2, "reporting": 2}
        assert any('peer="peer0"' in k
                   for k in merged.get("peer_ops_total", {}))
        assert sup.inject_faults("peer0", reset=True)["chaos"] == {}
        assert sup.set_throttle("peer1", None)["throttle_bps"] is None
        # a partitioned peer answers inject only, so it can be healed
        sup.inject_faults("peer1", chaos={"partition_inbound": True})
        assert sup.health() == {"peer0": True, "peer1": False}
        sup.inject_faults("peer1", reset=True)
        assert sup.health() == {"peer0": True, "peer1": True}
        d = sup.directory()            # a client's links, saved at stop
        d.estimator.observe("peer0", 1 << 20, 0.01)
        sup.kill("peer1", hard=True)
        assert sup.fleet_calibration()["peer1"]["alive"] is False
    assert all(c in (0, -9) for c in sup.exit_codes().values())
    assert sup.exit_codes()["peer0"] == 0
    files = sorted(os.listdir(state))
    assert "client-links.json" in files and "peer0-links.json" in files
    # a new fleet's clients start from the saved beliefs
    sup2 = PeerSupervisor.fleet(2, state_dir=state)
    warm = sup2.directory()
    assert warm.estimator.snapshot("peer0")[2] >= 1


def test_a_fault_schedule_against_supervised_daemons(tiny_setup):
    """A short schedule (corrupt chunks on every peer, a kill and its
    revive, a partition, a stall, a delayed ack, a throttle) replayed one
    request a step against three supervised daemons: every request is
    answered with a cold run's tokens, the corrupt stream falls through
    (a ``chunk_error`` dump, a ``corrupt`` attempt in the ledger), every
    fault is applied or skipped, and the daemons exit 0."""
    cfg, _, jp = tiny_setup
    model = Model(get_config("gemma3-270m").reduced(), device="cpu")
    model.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jp)))
    engine = InferenceEngine(model, max_len=512)
    gen = MMLUGenerator(WordHashTokenizer(cfg.vocab), n_shot=1)
    pool = [gen.prompt(d, q).segments for d in ("anatomy", "virology")
            for q in range(2)]
    cold = EdgeClient("cold", engine, CacheServer(CacheConfig()),
                      CacheConfig())
    want = [cold.infer(p, max_new_tokens=3, upload_on_miss=False)
            .output_tokens for p in pool]
    n_steps = 12
    # step 1 asks for a partial hit while every holder corrupts its
    # chunks: the stream must fail its digests and fall to local prefill
    events = [FaultEvent(1, "corrupt", pid, {"chunks": 5})
              for pid in PEERS] + [
        FaultEvent(2, "heal", pid, {}) for pid in PEERS] + [
        FaultEvent(4, "kill", "peer1", {}),
        FaultEvent(5, "partition", "peer2", {}),
        FaultEvent(6, "revive", "peer1", {}),
        FaultEvent(7, "heal", "peer2", {}),
        FaultEvent(7, "stall", "peer0", {"seconds": 0.05}),
        FaultEvent(8, "delay_ack", "peer1", {"seconds": 0.05}),
        FaultEvent(9, "bandwidth", "peer2", {"bps": 4e6}),
        FaultEvent(9, "heal", "peer0", {}),
        FaultEvent(10, "heal", "peer1", {}),
        FaultEvent(11, "bandwidth", "peer2", {"bps": None})]
    LEDGER.clear()
    FLIGHT.clear()
    with PeerSupervisor.fleet(3, gossip_interval_s=0.05,
                              request_timeout_s=1.0) as sup:
        d = sup.directory(suspect_cooldown_s=0.5)
        c = EdgeClient("chaos", engine, d, CacheConfig(), overlap=True)
        drv = FaultDriver(sup, FaultSchedule(events, seed=0,
                                             n_steps=n_steps))
        for step in range(n_steps):
            drv.advance(step)
            d.last_sync_t = -1e18
            c.sync_catalog()
            t0 = time.monotonic()
            r = c.infer(pool[step % len(pool)], max_new_tokens=3,
                        deadline_s=10.0)
            assert time.monotonic() - t0 < 15.0
            assert r.output_tokens == want[step % len(pool)], step
        drv.finish()
        drv.heal_all()
        assert len(drv.applied) + len(drv.skipped) == len(events)
        sup.check_and_restart()
        assert all(sup.health().values())
    assert all(v == 0 for v in sup.exit_codes().values())
    assert any(dmp["reason"] == "chunk_error" for dmp in FLIGHT.dumps())
    totals = LEDGER.totals()
    assert totals["commits"] == n_steps
    assert totals["fallthrough_corrupt"] >= 1
    LEDGER.clear()
    FLIGHT.clear()
