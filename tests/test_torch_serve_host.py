"""The port's SessionHost (`ggrs_tpu_torch.serve`, device="cpu") on the
CPU, tolerance zero: a hosted lane sharing its megabatches with a decoy
against the same session's requests on a solo `DeviceRollbackBackend`
(every save's checksum and the live world; the port's counterpart of
tests/test_serve_host.py::test_hosted_checksums_match_solo_backend,
anchored on the port's solo backend), in both cadences; admission
(HostFull, double hosting, layout and freshness checks, the knobs of what
is not ported), detach and slot reuse, backpressure in arrival order, idle
eviction and disconnect GC on a FakeClock, a spectator lane, the desync
referee catching a tampered slot, `drain` with a checkpoint that the
reference's `MultiSessionDeviceCore.restore` loads bit-exactly (and a
reference host's drain checkpoint restored by the port), the load
generator, and one seeded lossy fleet run on the port's host and on the
reference's host (`batched_pump=False`), depth-routed, full-window and
resident: every session's `local_checksum_history`, the stacked bytes and
the slot checksums equal.
ExGame(2 or 4, 16) as the reference's tests."""

import random

import numpy as np
import pytest

from ggrs_tpu_torch import (
    ConfigError, DesyncDetected, DeviceRollbackBackend, ExGame, HostFull, InvalidRequest, MultiSessionDeviceCore,
    PlayerType, SaveGameState, SessionBuilder, SessionState,
)
from ggrs_tpu_torch.network.sockets import InMemoryNetwork
from ggrs_tpu_torch.serve import SessionHost
from ggrs_tpu_torch.serve.loadgen import run_loadgen
from ggrs_tpu_torch.utils.clock import FakeClock

ENTITIES = 16


def make_host(clock=None, *, max_sessions=4, num_players=2, **kw):
    return SessionHost(ExGame(num_players, ENTITIES), max_prediction=8, num_players=num_players,
                       max_sessions=max_sessions, clock=clock or FakeClock(), device="cpu", **kw)


def solo_session(net, addr, *, players=2):
    """A local-only P2P session (every handle local): RUNNING at once."""
    b = SessionBuilder(input_size=1).with_num_players(players)
    for h in range(players):
        b = b.add_player(PlayerType.local(), h)
    return b.start_p2p_session(net.socket(addr))


def drive_solo(host, key, session, ticks, *, script=lambda t, h: (t * 3 + h) % 16):
    for t in range(ticks):
        for h in session.local_player_handles():
            host.submit_input(key, h, bytes([script(t, h)]))
        host.tick()
        host.clock.advance(16)


def checksum_getters(requests):
    return [(r.frame, r.cell.checksum_getter()) for r in requests if isinstance(r, SaveGameState)]


@pytest.mark.parametrize("resident", [False, True], ids=["dispatch", "resident"])
def test_hosted_checksums_match_solo_backend(resident):
    """The same script through (a) the port's solo backend and (b) a hosted
    lane beside a decoy: every saved frame's checksum and the live world
    equal."""
    clock = FakeClock()
    net = InMemoryNetwork(clock)
    script = lambda t, h: (t * 3 + h) % 16  # noqa: E731
    ticks = 24
    solo = solo_session(net, "ref")
    backend = DeviceRollbackBackend(ExGame(2, ENTITIES), 8, 2, device="cpu")
    want = []
    for t in range(ticks):
        for h in (0, 1):
            solo.add_local_input(h, bytes([script(t, h)]))
        reqs = solo.advance_frame()
        backend.handle_requests(reqs)
        want += checksum_getters(reqs)

    host = make_host(clock, resident=resident, resident_ticks=4)
    sess, decoy = solo_session(net, "a"), solo_session(net, "b")
    key, dkey = host.attach(sess), host.attach(decoy)
    tapped = []
    advance = sess.advance_frame
    sess.advance_frame = lambda: tapped.append(advance()) or tapped[-1]
    got = []
    for t in range(ticks):
        for h in (0, 1):
            host.submit_input(key, h, bytes([script(t, h)]))
            host.submit_input(dkey, h, bytes([(t * 11 + 2 + h) % 16]))
        host.tick()
        clock.advance(16)
        # getters are captured a tick, while each save's cell holds this
        # frame's binding (ring slots are reused every ring_len frames)
        for reqs in tapped:
            got += checksum_getters(reqs)
        tapped.clear()
    assert [(f, g()) for f, g in want] == [(f, g()) for f, g in got]
    solo_state = backend.state_numpy()
    lane_state = host.device.state_numpy(host._lanes[key].slot)
    for k in solo_state:
        np.testing.assert_array_equal(np.asarray(solo_state[k]), np.asarray(lane_state[k]), err_msg=k)
    if resident:
        assert host.device.driver_dispatches > 0 and host.device.megabatches == 0


def test_admission_rejects_at_max_sessions_and_reuses_slots():
    clock = FakeClock()
    net = InMemoryNetwork(clock)
    host = make_host(clock, max_sessions=2)
    k0 = host.attach(solo_session(net, "a"))
    host.attach(solo_session(net, "b"))
    with pytest.raises(HostFull):
        host.attach(solo_session(net, "c"))
    assert host.sessions_rejected == 1
    slot0 = host._lanes[k0].slot
    drive_solo(host, k0, host.session(k0), 5)
    host.detach(k0)
    with pytest.raises(InvalidRequest):
        host.detach(k0)
    k2 = host.attach(solo_session(net, "d"))
    assert host.active_sessions == 2 and host._lanes[k2].slot == slot0
    # the reused slot starts from the initial world
    fresh = MultiSessionDeviceCore(ExGame(2, ENTITIES), 8, 2, 2, device="cpu")
    want, got = fresh.state_numpy(0), host.device.state_numpy(slot0)
    for k in want:
        np.testing.assert_array_equal(want[k], got[k])


def test_attach_rejects_double_hosting_layout_and_stale_sessions():
    clock = FakeClock()
    net = InMemoryNetwork(clock)
    host = make_host(clock)
    sess = solo_session(net, "a")
    host.attach(sess)
    with pytest.raises(InvalidRequest):
        host.attach(sess)  # already hosted
    assert sess.host_key is not None
    narrow = make_host(FakeClock(), num_players=2)
    with pytest.raises(InvalidRequest):
        narrow.attach(solo_session(net, "t", players=3))
    narrow.attach(solo_session(net, "w", players=2))  # exactly at the layout
    fat = SessionBuilder(input_size=2).with_num_players(2)
    for h in range(2):
        fat = fat.add_player(PlayerType.local(), h)
    with pytest.raises(InvalidRequest):
        host.attach(fat.start_p2p_session(net.socket("fat")))
    stale = solo_session(net, "stale")
    stale.add_local_input(0, b"\x01")
    stale.add_local_input(1, b"\x01")
    stale.advance_frame()
    with pytest.raises(InvalidRequest):
        host.attach(stale)
    assert host.active_sessions == 1 and len(host._free_slots) == 3
    for knob in (dict(batched_pump=True), dict(speculation=True), dict(sdc_audit_every=4), dict(journal_dir="j"),
                 dict(mesh=object())):
        with pytest.raises(ConfigError, match="not ported"):
            make_host(FakeClock(), **knob)
    with pytest.raises(InvalidRequest):
        make_host(FakeClock(), resident=True, resident_ticks=0)


def test_backpressure_queues_ready_sessions_in_arrival_order():
    clock = FakeClock()
    net = InMemoryNetwork(clock)
    host = make_host(clock, max_sessions=4, max_inflight_rows=2)
    keys = [host.attach(solo_session(net, f"s{i}")) for i in range(4)]
    for key in keys:
        for h in (0, 1):
            host.submit_input(key, h, b"\x01")
    # pin the device window shut: every ready session queues
    real_poll = host.device.poll_retired
    host.device.poll_retired = lambda: host.max_inflight_rows
    host.tick()
    assert host.queue_depth == 4 and list(host._ready) == keys
    assert all(host._lanes[k].rows for k in keys)
    host.device.poll_retired = real_poll
    host.tick()
    assert host.queue_depth == 0
    assert all(host._lanes[k].current_frame == 1 for k in keys)
    assert host.queue_waits[-4:] == [1, 1, 1, 1]


def test_idle_eviction_under_fake_clock():
    clock = FakeClock()
    net = InMemoryNetwork(clock)
    host = make_host(clock, idle_timeout_ms=1_000)
    busy = host.attach(solo_session(net, "busy"))
    idle = host.attach(solo_session(net, "idle"))
    idle_sess = host.session(idle)
    for _ in range(80):
        for h in (0, 1):
            host.submit_input(busy, h, b"\x02")
        host.tick()
        clock.advance(16)
    assert host.sessions_evicted == 1
    assert idle not in host.keys() and busy in host.keys()
    assert idle_sess.host_key is None  # the detach hook ran
    host.attach(solo_session(net, "fresh"))  # the freed slot is reusable


def test_disconnect_gc_reclaims_dead_matches():
    clock = FakeClock()
    net = InMemoryNetwork(clock)
    host = make_host(clock, idle_timeout_ms=0)

    def peer(addr, other, handle):
        return (SessionBuilder(input_size=1).with_num_players(2).with_clock(clock)
                .with_rng(random.Random(handle + 5)).add_player(PlayerType.local(), handle)
                .add_player(PlayerType.remote(other), 1 - handle).start_p2p_session(net.socket(addr)))

    s0, s1 = peer("a", "b", 0), peer("b", "a", 1)
    k0 = host.attach(s0)
    host.attach(s1)
    for _ in range(200):
        host.tick()
        clock.advance(20)
        if all(host.session(k).current_state() == SessionState.RUNNING for k in host.keys()):
            break
    else:
        raise AssertionError("match failed to synchronize")
    s0.disconnect_player(1)
    for _ in range(300):
        host.tick()
        clock.advance(20)
        if not host.keys():
            break
    assert k0 not in host.keys()
    assert host.sessions_gced >= 1
    assert not host.keys(), f"undead sessions: {host.keys()}"


def test_spectator_lane_advances_on_host():
    clock = FakeClock()
    net = InMemoryNetwork(clock)
    host = make_host(clock, max_sessions=3)
    p2p = (SessionBuilder(input_size=1).with_num_players(2).with_clock(clock).with_rng(random.Random(31))
           .add_player(PlayerType.local(), 0).add_player(PlayerType.local(), 1)
           .add_player(PlayerType.spectator("spec"), 2).start_p2p_session(net.socket("game")))
    spec = (SessionBuilder(input_size=1).with_num_players(2).with_clock(clock).with_rng(random.Random(32))
            .start_spectator_session("game", net.socket("spec")))
    pk, sk = host.attach(p2p), host.attach(spec)
    for t in range(60):
        for h in (0, 1):
            host.submit_input(pk, h, bytes([(t + h) % 16]))
        host.tick()
        clock.advance(16)
    lane = host._lanes[sk]
    assert spec.current_state() == SessionState.RUNNING
    assert lane.current_frame > 10 and lane.kind == "spectator"
    # the spectator's world is the player's at the same frame
    assert host.device.state_numpy(lane.slot)["frame"] <= host.device.state_numpy(host._lanes[pk].slot)["frame"]


def test_tampered_slot_trips_desync_detection():
    """Reset one peer's slot mid-run: the next checksum exchange must
    surface DesyncDetected (the fleet tests' zero-desync referee is real)."""
    rep = run_loadgen(sessions=2, ticks=30, entities=ENTITIES, seed=5, loss=0.0, jitter_ms=0, latency_ms=20,
                      device="cpu", warmup=False)
    assert rep["desyncs"] == 0
    host = rep["_host"]
    keys = host.keys()
    host.device.reset_slot(host._lanes[keys[0]].slot)
    desyncs = 0
    for t in range(80):
        for key in keys:
            for h in host._lanes[key].local_handles:
                host.submit_input(key, h, bytes([(t + h) % 16]))
        desyncs += sum(isinstance(e, DesyncDetected) for evs in host.tick().values() for e in evs)
        host.clock.advance(16)
    assert desyncs > 0, "device-state tamper went undetected"


def test_loadgen_fleet_lossy():
    """16 sessions in 2-4-player matches, lossy wire: zero desyncs backed
    by real comparisons, megabatches coalescing rows, a bounded plan."""
    rep = run_loadgen(sessions=16, ticks=40, entities=ENTITIES, seed=1, loss=0.05, latency_ms=20, jitter_ms=10,
                      device="cpu", warmup=True)
    host = rep.pop("_host")
    assert rep["sessions"] >= 16 and rep["desyncs"] == 0 and rep["checksums_published"] > 0
    assert rep["mean_megabatch_rows"] > 1.0 and rep["max_bucket"] >= 8
    assert rep["min_frame"] >= rep["ticks"] - 8
    assert len(host.device.megabatch_programs()) <= host.device.dispatch_bucket_budget()
    summary = host.drain()
    assert summary["queue_depth"] == 0 and summary["draining"]


def test_drain_checkpoint_restores_on_either_stack(tmp_path):
    """A drain with rows that could not dispatch flushes them, refuses new
    sessions, and writes a checkpoint the reference's core restores bit for
    bit; a reference host's drain checkpoint restores on the port's core."""
    from ggrs_tpu.models.ex_game import ExGame as RefExGame
    from ggrs_tpu.network.sockets import InMemoryNetwork as RefNetwork
    from ggrs_tpu.serve import SessionHost as RefHost
    from ggrs_tpu.sessions.builder import SessionBuilder as RefBuilder
    from ggrs_tpu.tpu.backend import MultiSessionDeviceCore as RefCore
    from ggrs_tpu.types import PlayerType as RefPlayerType
    from ggrs_tpu.utils.clock import FakeClock as RefClock

    def fill(host, net, solo, n):
        keys = [host.attach(solo(net, f"s{i}")) for i in range(n)]
        for t in range(5):
            for key in keys:
                for h in (0, 1):
                    host.submit_input(key, h, bytes([(t * 5 + h + key) % 16]))
            host.tick()
            host.clock.advance(16)
        for key in keys:  # rows that cannot dispatch: the window pinned shut
            for h in (0, 1):
                host.submit_input(key, h, b"\x03")
        real = host.device.poll_retired
        host.device.poll_retired = lambda: host.max_inflight_rows
        host.tick()
        host.device.poll_retired = real
        return keys

    def ref_solo(net, addr):
        b = RefBuilder(input_size=1).with_num_players(2)
        for h in range(2):
            b = b.add_player(RefPlayerType.local(), h)
        return b.start_p2p_session(net.socket(addr))

    host = make_host(max_sessions=3, max_inflight_rows=1)
    fill(host, InMemoryNetwork(host.clock), solo_session, 3)
    assert host.queue_depth > 0
    path = str(tmp_path / "port.npz")
    summary = host.drain(checkpoint_path=path)
    assert host.queue_depth == 0 and summary["queue_depth"] == 0 and summary["checkpoint"] == path
    with pytest.raises(HostFull):
        host.attach(solo_session(InMemoryNetwork(host.clock), "late"))
    restored = RefCore.restore(path, RefExGame(2, ENTITIES))
    for got, want in zip(restored.stacked_canonical(), host.device.stacked_canonical()):
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]), want[k], err_msg=k)

    ref = RefHost(RefExGame(num_players=2, num_entities=ENTITIES), max_prediction=8, num_players=2, max_sessions=3,
                  clock=RefClock(), max_inflight_rows=1, batched_pump=False)
    fill(ref, RefNetwork(ref.clock), ref_solo, 3)
    rpath = str(tmp_path / "ref.npz")
    ref.drain(checkpoint_path=rpath)
    port = MultiSessionDeviceCore.restore(rpath, ExGame(2, ENTITIES), device="cpu")
    for got, want in zip(port.stacked_canonical(), ref.device.stacked_canonical()):
        for k in want:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("mode", [dict(), dict(depth_routing=False), dict(resident=True, resident_ticks=4)],
                         ids=["routed", "full_window", "resident"])
def test_fleet_matches_reference_host(mode):
    """One seeded lossy fleet (12 sessions in 2-4-player matches, rollbacks
    every few ticks) on the port's host and on the reference's host with
    its per-session pump, both in the same mode (depth-routed megabatches,
    one full-window megabatch a pass, or the resident loop): the same
    frames, `local_checksum_history` of every session, stacked bytes, slot
    checksums and dispatch counts."""
    from ggrs_tpu.models.ex_game import ExGame as RefExGame
    from ggrs_tpu.network.sockets import InMemoryNetwork as RefNetwork
    from ggrs_tpu.serve import SessionHost as RefHost
    from ggrs_tpu.serve import loadgen as ref_loadgen
    from ggrs_tpu.utils.clock import FakeClock as RefClock

    def run(host_cls, game, net_cls, clock_cls, lg, **kw):
        clock = clock_cls()
        net = net_cls(clock, latency_ms=20, jitter_ms=8, loss=0.03, seed=13)
        host = host_cls(game, max_prediction=8, num_players=4, max_sessions=16, clock=clock, idle_timeout_ms=0,
                        max_inflight_rows=64, **kw)
        matches = lg.build_matches(host, net, clock, sessions=12, seed=13)
        lg.sync_fleet(host, matches, clock)
        assert not lg.drive_scripted(host, matches, clock, lg.make_scripts(matches, 30, 13), 30)
        host.device.block_until_ready()
        return host, [k for keys in matches for k in keys]

    import ggrs_tpu_torch.serve.loadgen as port_loadgen

    port, pk = run(SessionHost, ExGame(4, ENTITIES), InMemoryNetwork, FakeClock, port_loadgen, device="cpu", **mode)
    ref, rk = run(RefHost, RefExGame(num_players=4, num_entities=ENTITIES), RefNetwork, RefClock, ref_loadgen,
                  batched_pump=False, **mode)
    published = 0
    for a, b in zip(pk, rk):
        sa, sb = port.session(a), ref.session(b)
        assert sa.current_frame == sb.current_frame > 0
        assert sa.local_checksum_history == sb.local_checksum_history
        published += len(sa.local_checksum_history)
    assert published > 0
    for got, want in zip(port.device.stacked_canonical(), ref.device.stacked_canonical()):
        for k in want:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    for got, want in zip(port.device.checksum_slots(), ref.device.checksum_slots()):
        np.testing.assert_array_equal(got, np.asarray(want))
    if mode.get("resident"):
        assert port.device.megabatches == ref.device.megabatches == 0
        assert port.device.driver_dispatches == ref.device.driver_dispatches > 0
        assert port.device.mailbox.overflows == ref.device.mailbox.overflows
    else:
        assert port.device.megabatches == ref.device.megabatches > 0
