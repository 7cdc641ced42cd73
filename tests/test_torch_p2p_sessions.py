"""The port's P2P and spectator sessions (ggrs_tpu_torch/sessions/) against
the reference's, on identical seeded in-memory networks and input scripts,
on a fake clock: every tick's request list (type, frame, inputs, statuses),
every event and every PredictionThreshold must be equal, with 2 and 4
players, latency, jitter and loss, input delay, sparse saving on and off,
desync detection on, a disconnect and a peer that falls silent. The
reference sessions poll per message (`batched_pump = False`, the path the
port copies); one case runs them as built. Also the builders' and sessions'
validation errors. Budget: under 30 s on the CPU."""

import pytest

from torch_p2p_mesh import (
    PORT,
    REF,
    HashGame,
    build_peers,
    build_spectator,
    count,
    event_key,
    play,
    synchronize,
)


def match(stack, players, ticks=120, *, latency=40, jitter=15, loss=0.05, seed=11, delay=0, sparse=False,
          desync=10, leave=None, batched=False):
    clock = stack.FakeClock()
    net = stack.InMemoryNetwork(clock, latency_ms=latency, jitter_ms=jitter, loss=loss, seed=seed)
    sessions = build_peers(stack, clock, net, players, delay=delay, sparse=sparse, desync=desync)
    if stack is REF:
        for s in sessions:
            s.batched_pump = batched
    log = []
    synchronize(stack, sessions, clock, log)
    games = [HashGame() for _ in sessions]
    play(stack, sessions, games, clock, ticks, leave=leave, log=log)
    return log, games


CASES = {
    "2p": dict(players=2),
    "4p": dict(players=4),
    "2p-delay2-sparse": dict(players=2, delay=2, sparse=True),
    "2p-delay2-dense": dict(players=2, delay=2),
    "4p-sparse": dict(players=4, sparse=True, latency=30, jitter=30),
    "2p-heavy-loss": dict(players=2, loss=0.2, jitter=40),
    "4p-disconnect": dict(players=4, leave=(60, 3)),
    "4p-sparse-disconnect": dict(players=4, sparse=True, delay=2, leave=(50, 2)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_sessions_match_reference(case):
    kw = CASES[case]
    got, port_games = match(PORT, **kw)
    want, ref_games = match(REF, **kw)
    assert got == want
    assert count(got, "LoadGameState") > 20  # latency forces rollbacks
    assert count(got, "DesyncDetected") == 0
    # the replicas that played on agree on every frame beyond the reach of
    # a rollback (the leaving peer's own game stops where it left)
    stayed = [i for i in range(kw["players"]) if i != kw.get("leave", (0, None))[1]]
    games = [port_games[i] for i in stayed] + [ref_games[i] for i in stayed]
    settled = min(g.frame for g in games) - 12
    assert settled > 40
    for f in range(1, settled):
        assert len({g.history[f] for g in games}) == 1
    if "leave" in kw:
        assert any(isinstance(e, tuple) and e[0] == "disconnect" for e in got)
        disconnected = [item for entry in got if isinstance(entry, list) for item in entry
                        if item[0] == "AdvanceFrame" and any(s == 2 for _, s in item[1])]
        assert disconnected, "no DISCONNECTED status reached a request"


def test_sessions_match_reference_as_built():
    """The reference with its batched pump on (as SessionBuilder builds it)
    puts the same requests and events out as the port's per-message poll."""
    got, _ = match(PORT, 4, ticks=100, leave=(60, 1))
    want, _ = match(REF, 4, ticks=100, leave=(60, 1), batched=True)
    assert got == want


def test_desync_reports_match_reference():
    """A peer whose game diverges is reported by both stacks alike."""

    class Drifting(HashGame):
        """Every step past frame 30 adds one more: a game that disagrees."""

        def handle_requests(self, requests):
            for r in requests:
                super().handle_requests([r])
                if type(r).__name__ == "AdvanceFrame" and self.frame > 30:
                    self.state += 1

    logs = []
    for stack in (PORT, REF):
        clock = stack.FakeClock()
        net = stack.InMemoryNetwork(clock, latency_ms=20, seed=3)
        sessions = build_peers(stack, clock, net, 2, desync=10)
        if stack is REF:
            for s in sessions:
                s.batched_pump = False
        log = []
        synchronize(stack, sessions, clock, log)
        play(stack, sessions, [HashGame(), Drifting()], clock, 90, log=log)
        logs.append(log)
    assert logs[0] == logs[1]
    assert count(logs[0], "DesyncDetected") > 0


def silent_peer(stack):
    """Peer 1 falls silent at tick 20; peer 0 keeps polling: interruption,
    then a timeout disconnect, then dummy inputs."""
    clock = stack.FakeClock()
    net = stack.InMemoryNetwork(clock, latency_ms=10, seed=4)
    sessions = build_peers(stack, clock, net, 2)
    if stack is REF:
        for s in sessions:
            s.batched_pump = False
    log = []
    synchronize(stack, sessions, clock, log)
    games = [HashGame(), HashGame()]
    play(stack, sessions, games, clock, 20, log=log)
    for _ in range(30):
        sessions[0].poll_remote_clients()
        log.append([event_key(e) for e in sessions[0].events()])
        clock.advance(100)
    play(stack, sessions[:1], games[:1], clock, 10, log=log)
    return log


def test_timeout_disconnect_matches_reference():
    got, want = silent_peer(PORT), silent_peer(REF)
    assert got == want
    assert count(got, "NetworkInterrupted") == 1
    assert count(got, "Disconnected") == 1


def spectator_match(stack, catchup=1, stall_until=0, max_behind=10):
    clock = stack.FakeClock()
    net = stack.InMemoryNetwork(clock, latency_ms=20, jitter_ms=10, loss=0.02, seed=9)
    sessions = build_peers(stack, clock, net, 2, spectator="spec")
    spec = build_spectator(stack, clock, net, 2, catchup=catchup, max_behind=max_behind)
    if stack is REF:
        for s in sessions + [spec]:
            s.batched_pump = False
    log = []
    synchronize(stack, sessions + [spec], clock, log)
    spec_game = HashGame()
    play(stack, sessions, [HashGame(), HashGame()], clock, 80, spectator=spec, spec_handler=spec_game,
         stall_until=stall_until, log=log)
    return log, spec_game


@pytest.mark.parametrize("catchup,stall_until", [(1, 0), (3, 25)])
def test_spectator_matches_reference(catchup, stall_until):
    (got, game), (want, _) = spectator_match(PORT, catchup, stall_until), spectator_match(REF, catchup, stall_until)
    assert got == want
    assert game.frame > 40
    bursts = [len(entry) for entry in got
              if isinstance(entry, list) and entry and all(item[0] == "AdvanceFrame" for item in entry)]
    if catchup > 1:
        assert max(bursts) == catchup  # catch-up bursts after the stall


def misuse_outcomes(stack):
    """Each probe's error type name and message (None when it passes)."""

    def attempt(fn):
        try:
            fn()
        except Exception as exc:  # noqa: BLE001 - the probe records any error
            return type(exc).__name__, str(exc)
        return None

    def builder():
        return stack.SessionBuilder(input_size=1)

    def pair():
        clock = stack.FakeClock()
        net = stack.InMemoryNetwork(clock)
        return build_peers(stack, clock, net, 2)[0]

    def advance_unsynced():
        s = pair()
        s.add_local_input(0, b"\x01")
        s.advance_frame()

    def disconnect_twice():
        s = pair()
        s.disconnect_player(1)
        s.disconnect_player(1)

    local = stack.PlayerType.local()
    return [
        attempt(lambda: builder().add_player(local, 0).add_player(local, 0)),
        attempt(lambda: builder().add_player(local, 2)),
        attempt(lambda: builder().add_player(stack.PlayerType.spectator("s"), 1)),
        attempt(lambda: builder().with_fps(0)),
        attempt(lambda: builder().with_max_frames_behind(0)),
        attempt(lambda: builder().with_max_frames_behind(60)),
        attempt(lambda: builder().with_catchup_speed(0)),
        attempt(lambda: builder().with_catchup_speed(10)),
        attempt(lambda: builder().add_player(local, 0).start_p2p_session(None)),
        attempt(lambda: pair().add_local_input(1, b"\x01")),
        attempt(lambda: pair().add_local_input(0, b"\x01\x02")),
        attempt(advance_unsynced),
        attempt(lambda: pair().disconnect_player(0)),
        attempt(lambda: pair().disconnect_player(5)),
        attempt(disconnect_twice),
        attempt(lambda: pair().network_stats(1)),
        attempt(lambda: builder().with_catchup_speed(9)),
    ]


def test_misuse_raises_the_reference_errors():
    got, want = misuse_outcomes(PORT), misuse_outcomes(REF)
    assert got == want
    assert [o is None for o in got] == [False] * 16 + [True]
