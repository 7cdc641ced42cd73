"""The port's async pipeline (`DeviceRollbackBackend(async_dispatch=True,
device="cpu")`: lazy ticks packed into pooled staging behind the in-flight
fence, plan-cached parsing, lazy checksum futures) against the port's eager
backend and the reference's async `TpuRollbackBackend`, tolerance zero, on
the cases of tests/test_async_dispatch.py: SyncTest forced rollbacks,
signature canonicalisation, a P2P disconnect rollback, the pending-report
drain order and a reused slot, desync reports on the right frames, a
checkpoint round trip, and the beam. Also what the pipeline reads: the
ledger's `drain_ready`, the getters' `dispatch_pending`,
`PendingChecksumReport.bind_and_prefetch` and the sessions' deterministic
publish mode (`checksum_publish = "interval"`) against the reference's."""

import random

import numpy as np
import pytest

import ggrs_tpu
import ggrs_tpu_torch
from ggrs_tpu.models.ex_game import ExGame as RefExGame
from ggrs_tpu.tpu import TpuRollbackBackend
from ggrs_tpu_torch import (
    DesyncDetected, DesyncDetection, DeviceRollbackBackend, ExGame, PlayerType, SaveGameState, SessionBuilder,
)
from ggrs_tpu_torch.device.backend import ChecksumLedger, InflightFence, _ChecksumBatch, _FutureChecksumBatch, \
    _LazyChecksum
from ggrs_tpu_torch.network.sockets import InMemoryNetwork
from ggrs_tpu_torch.sync_layer import PendingChecksumReport
from ggrs_tpu_torch.utils.clock import FakeClock
from torch_p2p_mesh import PORT, REF, HashGame, build_peers, play, synchronize

ENTITIES = 64
PLAYERS = 2
_REF = {}


def port_backend(async_dispatch, **kw):
    return DeviceRollbackBackend(ExGame(PLAYERS, ENTITIES), 8, PLAYERS, async_dispatch=async_dispatch,
                                 device="cpu", **kw)


def ref_async():
    """The reference's async backend (built once: its programs compile at
    first use), reset to a fresh session."""
    backend = _REF.get("async")
    if backend is None:
        backend = _REF["async"] = TpuRollbackBackend(RefExGame(PLAYERS, ENTITIES), max_prediction=8,
                                                     num_players=PLAYERS, async_dispatch=True)
    backend.reset()
    return backend


def assert_states_equal(a, b):
    sa, sb = a.state_numpy(), b.state_numpy()
    assert set(sa) == set(sb)
    for k in sa:
        np.testing.assert_array_equal(np.asarray(sa[k]), np.asarray(sb[k]), err_msg=f"state[{k}]")


def drive_synctest(pkg, backend, ticks, check_distance=4):
    """tests/test_async_dispatch.py's SyncTest drive on either stack: every
    save's checksum captured through its getter at save time."""
    sess = (pkg.SessionBuilder(input_size=1).with_num_players(PLAYERS).with_max_prediction_window(8)
            .with_check_distance(check_distance).start_synctest_session())
    getters = []
    for t in range(ticks):
        for h in range(PLAYERS):
            sess.add_local_input(h, bytes([(t * (3 + h) + h) % 16]))
        reqs = sess.advance_frame()
        backend.handle_requests(reqs)
        getters += [(r.frame, r.cell.checksum_getter()) for r in reqs if type(r).__name__ == "SaveGameState"]
    return [(f, g()) for f, g in getters]


def reference_synctest_stream(ticks=30):
    key = ("synctest", ticks)
    if key not in _REF:
        backend = ref_async()
        _REF[key] = (drive_synctest(ggrs_tpu, backend, ticks), backend.state_numpy())
    return _REF[key]


def test_async_bit_parity_through_forced_rollbacks():
    """A forced rollback every tick past check distance 4: the async
    backend's every save checksum and final state equal the eager
    backend's and the reference async backend's."""
    eager, asynch = port_backend(False), port_backend(True)
    se = drive_synctest(ggrs_tpu_torch, eager, 30)
    sa = drive_synctest(ggrs_tpu_torch, asynch, 30)
    assert asynch.lazy_ticks == DeviceRollbackBackend.ASYNC_DEFAULT_LAZY_TICKS == 8
    assert asynch.async_inflight == 4 and eager.lazy_ticks == 0
    ref_stream, ref_state = reference_synctest_stream()
    assert se == sa == ref_stream
    assert_states_equal(eager, asynch)
    got = asynch.state_numpy()
    for k in ref_state:
        np.testing.assert_array_equal(got[k], np.asarray(ref_state[k]), err_msg=k)


def test_async_dispatch_signatures_canonicalize():
    """40 SyncTest ticks coalesce onto a handful of canonical segment
    shapes, the same tally as the reference's."""
    backend = port_backend(True)
    drive_synctest(ggrs_tpu_torch, backend, 40)
    sigs = backend.dispatch_signatures
    assert sum(sigs.values()) >= 40
    assert len(sigs) <= 6, f"signature explosion: {sigs}"
    ref = ref_async()
    drive_synctest(ggrs_tpu, ref, 40)
    assert sigs == ref.dispatch_signatures
    backend.reset()
    assert backend.dispatch_signatures == {}


def run_p2p(stack, backend, frames=60, disconnect_tick=30):
    """tests/test_async_dispatch.py's 2-player P2P run on either stack: a
    40 ms link makes peer 0 mispredict, and a disconnect at tick 30 forces
    the rollback with DISCONNECTED statuses; peer 0 on `backend`, peer 1 a
    host game. The reference's session polls per message
    (`batched_pump = False`), as the port's does."""
    clock = stack.FakeClock()
    net = stack.InMemoryNetwork(clock, latency_ms=40, seed=11)

    def build(my_addr, other_addr, local_handle):
        b = (stack.SessionBuilder(input_size=1).with_num_players(PLAYERS).with_max_prediction_window(8)
             .with_clock(clock))
        b = b.add_player(stack.PlayerType.local(), local_handle)
        b = b.add_player(stack.PlayerType.remote(other_addr), 1 - local_handle)
        sess = b.start_p2p_session(net.socket(my_addr))
        if hasattr(sess, "batched_pump"):
            sess.batched_pump = False
        return sess

    s0, s1 = build("a", "b", 0), build("b", "a", 1)
    synchronize(stack, [s0, s1], clock, [])
    peer = HashGame()
    getters, rolled_back_after = [], False
    for f in range(frames):
        s0.add_local_input(0, bytes([(f * 3 + 1) % 16]))
        reqs = s0.advance_frame()
        backend.handle_requests(reqs)
        getters += [(r.frame, r.cell.checksum_getter()) for r in reqs if type(r).__name__ == "SaveGameState"]
        rolled_back_after |= f > disconnect_tick and any(type(r).__name__ == "LoadGameState" for r in reqs)
        s0.events()
        if f == disconnect_tick:
            s0.disconnect_player(1)
        if f < disconnect_tick:
            s1.add_local_input(1, bytes([(f * 5 + 2) % 16]))
            peer.handle_requests(s1.advance_frame())
            s1.events()
        clock.advance(16)
    assert rolled_back_after
    return [(f, g()) for f, g in getters]


def test_async_parity_through_disconnect_rollback():
    eager, asynch = port_backend(False), port_backend(True)
    eager_stream = run_p2p(PORT, eager)
    async_stream = run_p2p(PORT, asynch)
    ref = ref_async()
    ref_stream = run_p2p(REF, ref)
    assert eager_stream == async_stream == ref_stream
    assert_states_equal(eager, asynch)
    got, want = asynch.state_numpy(), ref.state_numpy()
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


class FakeGetter:
    def __init__(self, value, pending=False):
        self.value = value
        self.ready = False
        self.dispatch_pending = pending
        self.prefetches = 0

    def prefetch(self):
        self.prefetches += 1

    def __call__(self):
        return self.value


class FakeCell:
    def __init__(self, frame, getter):
        self.frame = frame
        self._getter = getter

    def checksum_getter(self):
        return self._getter


def test_pending_report_drains_in_frame_order():
    """Reports drain in capture order: a ready report never jumps an
    unready older one, nothing waits until `force`."""
    rep = PendingChecksumReport()
    getters = {f: FakeGetter(f * 1000 + 7) for f in (10, 20, 30)}
    for f in (10, 20, 30):
        rep.capture(f, FakeCell(f, getters[f]))
    emitted = []

    def emit(frame, checksum):
        emitted.append((frame, checksum))

    rep.flush(force=False, emit=emit)
    assert emitted == [] and getters[10].prefetches > 0
    getters[20].ready = True
    rep.flush(force=False, emit=emit)
    assert emitted == []
    getters[10].ready = True
    rep.flush(force=False, emit=emit)
    assert emitted == [(10, 10007), (20, 20007)]
    rep.flush(force=True, emit=emit)
    assert emitted == [(10, 10007), (20, 20007), (30, 30007)] and len(rep) == 0


def test_pending_report_drops_reused_slot():
    rep = PendingChecksumReport()
    stale, live = FakeGetter(1), FakeGetter(2)
    rep.capture(5, FakeCell(99, stale))  # the cell was overwritten before the first read
    rep.capture(6, FakeCell(6, live))
    live.ready = True
    emitted = []
    rep.flush(force=False, emit=lambda f, c: emitted.append((f, c)))
    assert emitted == [(6, 2)]


def test_bind_and_prefetch_emits_nothing_and_spares_undispatched_getters():
    """The deterministic-publish half of flush: getters bound, the first
    unready one prefetched unless its batch is not dispatched yet, nothing
    emitted; the forced flush then emits in order."""
    rep = PendingChecksumReport()
    pending, inflight = FakeGetter(7, pending=True), FakeGetter(8)
    rep.capture(1, FakeCell(1, pending))
    rep.bind_and_prefetch()
    assert pending.prefetches == 0 and len(rep) == 1
    rep2 = PendingChecksumReport()
    rep2.capture(2, FakeCell(2, inflight))
    rep2.capture(3, FakeCell(3, FakeGetter(9)))
    rep2.bind_and_prefetch()
    assert inflight.prefetches == 1 and len(rep2) == 2
    emitted = []
    rep2.flush(force=True, emit=lambda f, c: emitted.append((f, c)))
    assert emitted == [(2, 8), (3, 9)]


def test_getters_dispatch_pending_and_drain_ready():
    """A lazy getter is `dispatch_pending` until its buffer dispatches; the
    ledger's drain_ready stores every ready batch (on the CPU all) and
    keeps nothing pending; the fence holds nothing on the CPU."""
    backend = port_backend(True)
    sess = (SessionBuilder(input_size=1).with_num_players(PLAYERS).with_max_prediction_window(8)
            .with_check_distance(2).start_synctest_session())
    getters = []
    for t in range(3):
        for h in range(PLAYERS):
            sess.add_local_input(h, bytes([t]))
        reqs = sess.advance_frame()
        backend.handle_requests(reqs)
        getters += [r.cell.checksum_getter() for r in reqs if isinstance(r, SaveGameState)]
    assert getters and all(isinstance(g, _LazyChecksum) and g.dispatch_pending and not g.ready for g in getters)
    backend.flush()
    assert not any(g.dispatch_pending for g in getters) and all(g.ready for g in getters)
    assert backend.ledger.drain_ready() == 0 and backend.ledger._pending == []
    assert len(backend.fence) == 0 and backend.fence.poll() == 0
    ledger = ChecksumLedger()
    import torch

    batch = _ChecksumBatch(torch.tensor([1, 2], dtype=torch.int32), torch.tensor([3, 4], dtype=torch.int32), ledger)
    assert ledger.drain_ready() == 0 and batch._np is not None and batch.resolve(1) == (2 << 32) | 4
    future = _FutureChecksumBatch(lambda: None)
    assert future.dispatch_pending and not future.ready
    with pytest.raises(Exception):
        InflightFence(0, torch.device("cpu"))


class RandomChecksumGame(HashGame):
    """A host game whose saves carry seeded random checksums."""

    def __init__(self, seed):
        super().__init__()
        self.rng = random.Random(seed)

    def handle_requests(self, requests):
        super().handle_requests(requests)
        for r in requests:
            if type(r).__name__ == "SaveGameState":
                r.cell.save(r.frame, r.cell.load(), self.rng.getrandbits(64))


@pytest.mark.parametrize("publish", ["ready", "interval"])
def test_desync_reports_surface_on_correct_frames_async(publish):
    """Peer 0 on the async backend, its peer publishing garbage checksums:
    every DesyncDetected names a frame peer 0 reported, with the checksum
    its lazy drain emitted, under either publish mode."""
    clock = FakeClock()
    net = InMemoryNetwork(clock, seed=17)

    def build(my_addr, other_addr, local_handle):
        b = (SessionBuilder(input_size=1).with_num_players(PLAYERS).with_max_prediction_window(8)
             .with_desync_detection_mode(DesyncDetection.on(10)).with_clock(clock))
        b = b.add_player(PlayerType.local(), local_handle)
        b = b.add_player(PlayerType.remote(other_addr), 1 - local_handle)
        sess = b.start_p2p_session(net.socket(my_addr))
        sess.checksum_publish = publish
        return sess

    s0, s1 = build("a", "b", 0), build("b", "a", 1)
    synchronize(PORT, [s0, s1], clock, [])
    backend, peer = port_backend(True), RandomChecksumGame(3)
    events = []
    for _ in range(150):
        s0.add_local_input(0, b"\x01")
        backend.handle_requests(s0.advance_frame())
        s1.add_local_input(1, b"\x01")
        peer.handle_requests(s1.advance_frame())
        events += s0.events() + s1.events()
        clock.advance(16)
    desyncs = [e for e in events if isinstance(e, DesyncDetected)]
    assert desyncs, "random peer checksums must trip desync detection"
    history = s0.local_checksum_history
    for e in [e for e in desyncs if e.addr == "b"]:
        assert e.frame in history and e.local_checksum == history[e.frame]
    # the lazy buffer (8 rows) dispatches within a desync interval (10
    # ticks): no report is resolved before its checksums reached the host
    assert s0.drain_blocked_ticks == 0


def test_interval_publish_matches_reference_sessions():
    """`checksum_publish = "interval"` on every peer of a 2-player match with
    desync detection (latency, jitter and loss), on both stacks with host
    games: the same requests and events tick for tick, and the same
    confirmed checksums."""
    logs, histories = [], []
    for stack in (REF, PORT):
        clock = stack.FakeClock()
        net = stack.InMemoryNetwork(clock, latency_ms=30, jitter_ms=10, loss=0.05, seed=8)
        sessions = build_peers(stack, clock, net, 2, desync=5)
        for s in sessions:
            s.checksum_publish = "interval"
            if hasattr(s, "batched_pump"):
                s.batched_pump = False
        log = []
        synchronize(stack, sessions, clock, log)
        play(stack, sessions, [HashGame(), HashGame()], clock, 90, log=log)
        logs.append(log)
        histories.append([s.local_checksum_history for s in sessions])
    assert logs[0] == logs[1]
    assert histories[0] == histories[1] and all(histories[0])


def test_async_p2p_interval_publish_matches_eager():
    """A 2-player port match with desync detection and deterministic
    publish, every peer eager and then every peer async: the same request
    streams, save checksums and confirmed checksums, no desync; the async
    peers' lazy futures stay undispatched until a buffer fills or a forced
    flush reads them."""
    runs = []
    for async_dispatch in (False, True):
        clock = FakeClock()
        net = InMemoryNetwork(clock, latency_ms=40, jitter_ms=15, loss=0.05, seed=33)
        sessions = build_peers(PORT, clock, net, 2, desync=10)
        for s in sessions:
            s.checksum_publish = "interval"
        backends = [port_backend(async_dispatch) for _ in sessions]
        saves = []

        def record(peer, requests):
            if peer == 0:
                saves.extend((r.frame, r.cell.checksum_getter()) for r in requests if isinstance(r, SaveGameState))

        log = []
        synchronize(PORT, sessions, clock, log)
        play(PORT, sessions, backends, clock, 120, log=log, on_advance=record)
        runs.append((log, [(f, g()) for f, g in saves], [s.local_checksum_history for s in sessions]))
    assert runs[0][0] == runs[1][0] and runs[0][1] == runs[1][1] and runs[0][2] == runs[1][2]
    assert all(runs[1][2]) and "DesyncDetected" not in str(runs[1][0])


def test_async_checkpoint_roundtrip(tmp_path):
    """The async knobs round-trip through checkpoints of either stack."""
    backend = port_backend(True, async_inflight=3)
    drive_synctest(ggrs_tpu_torch, backend, 12)
    path = str(tmp_path / "async.npz")
    backend.save(path)
    restored = DeviceRollbackBackend.restore(path, ExGame(PLAYERS, ENTITIES), device="cpu")
    assert restored.async_dispatch and restored.lazy_ticks == backend.lazy_ticks == 8
    assert restored.async_inflight == 3
    assert_states_equal(restored, backend)
    ref_restored = TpuRollbackBackend.restore(path, RefExGame(PLAYERS, ENTITIES))
    assert ref_restored.async_dispatch and ref_restored.lazy_ticks == 8 and ref_restored.async_inflight == 3
    ref_path = str(tmp_path / "ref.npz")
    ref = ref_async()
    drive_synctest(ggrs_tpu, ref, 12)
    ref.save(ref_path)
    from_ref = DeviceRollbackBackend.restore(ref_path, ExGame(PLAYERS, ENTITIES), device="cpu")
    assert from_ref.async_dispatch and from_ref.lazy_ticks == 8 and from_ref.async_inflight == 4
    assert_states_equal(from_ref, backend)


def test_async_composes_with_beam():
    """Adoption flushes the pending buffer before it reads the ring: the
    async beam backend equals the eager beam-off one and the reference."""
    asynch = port_backend(True, beam_width=8)
    eager = port_backend(False)
    se = drive_synctest(ggrs_tpu_torch, eager, 30)
    sa = drive_synctest(ggrs_tpu_torch, asynch, 30)
    assert se == sa == reference_synctest_stream()[0]
    assert_states_equal(eager, asynch)
    assert asynch.beam_hits + asynch.beam_partial_hits + asynch.beam_misses > 0
