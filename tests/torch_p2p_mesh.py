"""Shared driver of the P2P parity tests: the same seeded match played on
either stack (`REF`: ggrs_tpu, `PORT`: ggrs_tpu_torch), with every tick's
requests and events recorded as plain data that compares across stacks."""

from __future__ import annotations

import random
from types import SimpleNamespace

import numpy as np

import ggrs_tpu
import ggrs_tpu_torch
from ggrs_tpu.network.sockets import InMemoryNetwork as RefInMemoryNetwork
from ggrs_tpu.utils.clock import FakeClock as RefFakeClock
from ggrs_tpu_torch.network.sockets import InMemoryNetwork
from ggrs_tpu_torch.utils.clock import FakeClock


def _stack(pkg, net_cls, clock_cls):
    return SimpleNamespace(
        SessionBuilder=pkg.SessionBuilder, PlayerType=pkg.PlayerType,
        DesyncDetection=pkg.DesyncDetection, SessionState=pkg.SessionState,
        PredictionThreshold=pkg.PredictionThreshold, InMemoryNetwork=net_cls, FakeClock=clock_cls,
    )


REF = _stack(ggrs_tpu, RefInMemoryNetwork, RefFakeClock)
PORT = _stack(ggrs_tpu_torch, InMemoryNetwork, FakeClock)

TICK_MS = 16


class HashGame:
    """A host game for either stack's requests (dispatched by class name):
    an integer state that folds every input in, a checksum that hashes
    frame and state, and the state after each frame it advanced into."""

    def __init__(self):
        self.frame = 0
        self.state = 0
        self.history = {}

    def handle_requests(self, requests):
        for r in requests:
            kind = type(r).__name__
            if kind == "SaveGameState":
                assert r.frame == self.frame
                r.cell.save(r.frame, (self.frame, self.state),
                            (self.frame * 2654435761 + self.state * 40503 + 7) % (1 << 64))
            elif kind == "LoadGameState":
                self.frame, self.state = r.cell.load()
            else:
                self.frame += 1
                for buf, status in r.inputs:
                    step = 13 if int(status) == 2 else buf[0] + 1
                    self.state = (self.state * 31 + step) % (1 << 61)
                self.history[self.frame] = self.state


def describe(requests):
    """A request list as plain data: type, frame, inputs and statuses."""
    out = []
    for r in requests:
        kind = type(r).__name__
        if kind == "AdvanceFrame":
            out.append((kind, tuple((bytes(buf), int(status)) for buf, status in r.inputs)))
        else:
            out.append((kind, r.frame))
    return out


def event_key(event):
    return (type(event).__name__, tuple(sorted(vars(event).items())))


def build_peers(stack, clock, net, players, *, mp=8, delay=0, sparse=False, desync=None,
                spectator=None, input_size=1, seed=100):
    """`players` sessions at "p0".., peer i holding local handle i; peer 0
    also serves a spectator at address `spectator` when given."""
    addrs = [f"p{i}" for i in range(players)]
    sessions = []
    for i in range(players):
        b = (stack.SessionBuilder(input_size=input_size).with_num_players(players)
             .with_max_prediction_window(mp).with_input_delay(delay).with_sparse_saving_mode(sparse)
             .with_clock(clock).with_rng(random.Random(seed + i)))
        if desync:
            b = b.with_desync_detection_mode(stack.DesyncDetection.on(desync))
        for h, addr in enumerate(addrs):
            b = b.add_player(stack.PlayerType.local() if h == i else stack.PlayerType.remote(addr), h)
        if spectator and i == 0:
            b = b.add_player(stack.PlayerType.spectator(spectator), players)
        sessions.append(b.start_p2p_session(net.socket(addrs[i])))
    return sessions


def build_spectator(stack, clock, net, players, addr="spec", host="p0", *, catchup=1, max_behind=10,
                    input_size=1, seed=77):
    b = (stack.SessionBuilder(input_size=input_size).with_num_players(players).with_clock(clock)
         .with_rng(random.Random(seed)).with_max_frames_behind(max_behind).with_catchup_speed(catchup))
    return b.start_spectator_session(host, net.socket(addr))


def synchronize(stack, sessions, clock, log):
    for _ in range(400):
        for s in sessions:
            s.poll_remote_clients()
            log.append([event_key(e) for e in s.events()])
        clock.advance(20)
        if all(s.current_state() == stack.SessionState.RUNNING for s in sessions):
            return
    raise AssertionError("sessions failed to synchronize")


def play(stack, sessions, handlers, clock, ticks, *, seed=5, leave=None, spectator=None,
         spec_handler=None, stall_until=0, log=None, on_advance=None, input_size=1, script=None):
    """Tick every peer `ticks` times, 16 ms of clock a tick. `leave =
    (tick, handle)`: from that tick the peer stops advancing but keeps
    polling, and once every other peer holds its last frame they all call
    disconnect_player(handle) in one tick, so every peer disconnects it at
    the same frame. A spectator (if any) advances from `stall_until` on.
    Returns the log: every tick's request descriptions and events, and
    each PredictionThreshold; `on_advance(peer, requests)` sees each
    request list before its handler. `script[t, i]`: peer i's input bytes
    at tick t (seeded random below 16 when not given)."""
    log = [] if log is None else log
    players = len(sessions)
    if script is None:
        script = np.random.default_rng(seed).integers(0, 16, size=(ticks, players, input_size))
    gone = None
    disconnected_at = None
    for t in range(ticks):
        if leave is not None and t == leave[0]:
            gone = leave[1]
        if gone is not None and disconnected_at is None:
            sessions[gone].poll_remote_clients()
            sessions[gone].events()
            last = sessions[gone].local_connect_status[gone].last_frame
            rest = [i for i in range(players) if i != gone]
            if all(sessions[i].local_connect_status[gone].last_frame == last for i in rest):
                for i in rest:
                    sessions[i].disconnect_player(gone)
                disconnected_at = t
                log.append(("disconnect", gone, t))
        for i, sess in enumerate(sessions):
            if i == gone:
                continue
            sess.add_local_input(i, bytes(int(v) for v in script[t, i]))
            try:
                requests = sess.advance_frame()
            except stack.PredictionThreshold:
                log.append(("prediction_threshold", i))
            else:
                log.append(describe(requests))
                if on_advance is not None:
                    on_advance(i, requests)
                handlers[i].handle_requests(requests)
            log.append([event_key(e) for e in sess.events()])
        if spectator is not None:
            spectator.poll_remote_clients()
            log.append([event_key(e) for e in spectator.events()])
            if t >= stall_until:
                try:
                    requests = spectator.advance_frame()
                except stack.PredictionThreshold:
                    log.append(("prediction_threshold", "spectator"))
                else:
                    log.append(describe(requests))
                    spec_handler.handle_requests(requests)
        clock.advance(TICK_MS)
    if leave is not None:
        assert disconnected_at is not None, "the leaving peer was never disconnected"
    return log


def count(log, kind):
    """Requests or events of `kind` in a log."""
    return sum(1 for entry in log if isinstance(entry, list) for item in entry if item[0] == kind)
