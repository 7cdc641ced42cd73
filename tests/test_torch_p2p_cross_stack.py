"""A cross-stack match: port peers (ggrs_tpu_torch sessions on
DeviceRollbackBackend(device="cpu")) and reference peers (ggrs_tpu sessions
on TpuRollbackBackend) play one match on one reference InMemoryNetwork and
one FakeClock, desync detection on(10). The port peers reach the network
through a bridge socket defined here (only tests import both packages):
the port's codec encodes into the network and decodes what it delivers, so
every datagram crosses as wire bytes. A clean match ends with zero
desyncs; a ring slot corrupted in the port peer, which its next rollback
loads, is reported by the reference peer. Also one loopback round trip of
the port's UDP socket. Budget: under 45 s on the CPU."""

import random
import time

import numpy as np

import ggrs_tpu
import ggrs_tpu_torch
from ggrs_tpu.models import ex_game as ref_ex_game
from ggrs_tpu.network.sockets import InMemoryNetwork
from ggrs_tpu.tpu import TpuRollbackBackend
from ggrs_tpu.utils.clock import FakeClock
from ggrs_tpu_torch import DeviceRollbackBackend, ExGame
from ggrs_tpu_torch.network.messages import ChecksumReport, Message, decode_all, encode_message
from ggrs_tpu_torch.network.sockets import UdpNonBlockingSocket, check_datagram_size
from torch_p2p_mesh import event_key

N = 128


class BridgeSocket:
    """A port peer's socket on the reference's InMemoryNetwork."""

    def __init__(self, net, addr):
        self.net = net
        self.addr = addr
        net.queues.setdefault(addr, [])

    def send_to(self, msg, addr):
        self.net._deliver(self.addr, addr, check_datagram_size(encode_message(msg)))

    def receive_all_messages(self):
        return decode_all(self.net._drain_wire(self.addr))


def build(port_peers, players, clock, net):
    """Peer i (local handle i) on the port when i is in `port_peers`, else on
    the reference; returns (sessions, backends, stacks)."""
    addrs = [f"p{i}" for i in range(players)]
    sessions, backends, stacks = [], [], []
    for i in range(players):
        pkg = ggrs_tpu_torch if i in port_peers else ggrs_tpu
        b = (pkg.SessionBuilder(input_size=1).with_num_players(players).with_max_prediction_window(8)
             .with_desync_detection_mode(pkg.DesyncDetection.on(10)).with_clock(clock)
             .with_rng(random.Random(200 + i)))
        for h, addr in enumerate(addrs):
            b = b.add_player(pkg.PlayerType.local() if h == i else pkg.PlayerType.remote(addr), h)
        if pkg is ggrs_tpu_torch:
            sessions.append(b.start_p2p_session(BridgeSocket(net, addrs[i])))
            backends.append(DeviceRollbackBackend(ExGame(players, N), 8, players, device="cpu"))
        else:
            sessions.append(b.start_p2p_session(net.socket(addrs[i])))
            backends.append(TpuRollbackBackend(ref_ex_game.ExGame(players, N), max_prediction=8,
                                               num_players=players))
        stacks.append(pkg)
    return sessions, backends, stacks


def match(port_peers, players, ticks, *, latency=30, jitter=10, loss=0.0, leave=None, corrupt_at=None):
    """Play the mixed match; `leave = (tick, handle)` as in torch_p2p_mesh.play;
    `corrupt_at`: the tick at which peer 0 (a port peer) gets the ring
    slots of every frame its next rollback may load corrupted."""
    clock = FakeClock()
    net = InMemoryNetwork(clock, latency_ms=latency, jitter_ms=jitter, loss=loss, seed=44)
    sessions, backends, stacks = build(port_peers, players, clock, net)
    for _ in range(400):
        for s in sessions:
            s.poll_remote_clients()
            s.events()
        clock.advance(20)
        if all(s.current_state().value == "running" for s in sessions):
            break
    else:
        raise AssertionError("mixed mesh failed to synchronize")
    script = np.random.default_rng(7).integers(0, 16, size=(ticks, players))
    events = [[] for _ in sessions]
    gone, disconnected = None, False
    loads = dead_inputs = 0
    for t in range(ticks):
        if leave is not None and t == leave[0]:
            gone = leave[1]
        if gone is not None and not disconnected:
            sessions[gone].poll_remote_clients()
            last = sessions[gone].local_connect_status[gone].last_frame
            rest = [i for i in range(players) if i != gone]
            if all(sessions[i].local_connect_status[gone].last_frame == last for i in rest):
                for i in rest:
                    sessions[i].disconnect_player(gone)
                disconnected = True
        if t == corrupt_at:
            sess, core = sessions[0], backends[0].core
            first = max(sess.confirmed_frame() + 1, sess.current_frame - 8)
            for f in range(first, sess.current_frame):
                core.carry["ring"][f % core.ring_len, 4, 0] += 7  # the heading plane: never clamped
        for i, sess in enumerate(sessions):
            if i == gone:
                continue
            sess.add_local_input(i, bytes([int(script[t, i])]))
            try:
                requests = sess.advance_frame()
            except stacks[i].PredictionThreshold:
                continue
            loads += sum(type(r).__name__ == "LoadGameState" for r in requests)
            dead_inputs += sum(int(s) == 2 for r in requests if type(r).__name__ == "AdvanceFrame"
                               for _, s in r.inputs)
            backends[i].handle_requests(requests)
            events[i] += [event_key(e) for e in sess.events()]
        clock.advance(16)
    if leave is not None:
        assert disconnected and dead_inputs > 0  # DISCONNECTED inputs reached both stacks' backends
    return sessions, backends, events, loads


def desyncs(events):
    return sum(1 for e in events if e[0] == "DesyncDetected")


def test_two_player_cross_stack_match_has_no_desync():
    sessions, backends, events, loads = match({0}, 2, 150)
    assert loads > 40
    assert [desyncs(e) for e in events] == [0, 0]
    assert min(s.confirmed_frame() for s in sessions) > 100
    # both stacks checksummed the same confirmed frames alike
    port_history, ref_history = (s.local_checksum_history for s in sessions)
    shared = set(port_history) & set(ref_history)
    assert len(shared) >= 3 and all(port_history[f] == ref_history[f] for f in shared)


def test_four_player_cross_stack_match_with_a_disconnect():
    sessions, backends, events, loads = match({0, 2}, 4, 120, loss=0.05, leave=(70, 1))
    assert loads > 40
    assert [desyncs(e) for e in events] == [0, 0, 0, 0]


def test_corrupted_port_ring_is_reported_by_the_reference_peer():
    sessions, backends, events, loads = match({0}, 2, 150, corrupt_at=60)
    assert desyncs(events[1]) > 0  # the reference peer sees the port peer's divergence
    frames = [e for e in events[1] if e[0] == "DesyncDetected"]
    assert all(dict(e[1])["frame"] > 50 for e in frames)


def test_udp_loopback_round_trip():
    a, b = UdpNonBlockingSocket(0), UdpNonBlockingSocket(0)
    try:
        sent = Message(0x1234, ChecksumReport(checksum=(1 << 100) + 9, frame=5))
        a.send_to(sent, ("127.0.0.1", b.local_port))
        deadline = time.monotonic() + 2.0
        got = []
        while not got and time.monotonic() < deadline:
            got = b.receive_all_messages()
            if not got:
                time.sleep(0.005)
        assert len(got) == 1
        addr, msg = got[0]
        assert addr[1] == a.local_port
        assert encode_message(Message(msg.magic, msg.body)) == encode_message(sent)
        assert b.receive_all_messages() == []  # nothing else pending, and no wait
    finally:
        a.close()
        b.close()
