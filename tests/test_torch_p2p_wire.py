"""The port's network stack against the reference's, byte for byte: every
message kind encodes to the reference's bytes and each stack decodes the
other's; the delta + RLE input codec; garbage dropped alike; the endpoint
counters behind network_stats after a lossy match. Also the checksum
getters' `ready`, which the P2P session reads before it reads a checksum,
on the CPU, and the pending checksum reports' drain order against the
reference's. Budget: under 15 s
on the CPU."""

import numpy as np
import pytest

from ggrs_tpu.network import compression as ref_compression
from ggrs_tpu.network import messages as ref_messages
from ggrs_tpu.sync_layer import ConnectionStatus as RefConnectionStatus
from ggrs_tpu.sync_layer import PendingChecksumReport as RefPendingChecksumReport
from ggrs_tpu_torch import DeviceRollbackBackend, ExGame, InvalidRequest, SessionBuilder
from ggrs_tpu_torch.network import compression, messages
from ggrs_tpu_torch.network.sockets import MAX_DATAGRAM_SIZE, check_datagram_size
from ggrs_tpu_torch.sync_layer import ConnectionStatus, PendingChecksumReport
from torch_p2p_mesh import PORT, REF, HashGame, build_peers, play, synchronize


def bodies(mod, status_cls):
    statuses = [status_cls(False, 41), status_cls(True, -1), status_cls(False, 7)]
    return [
        mod.SyncRequest(random_request=0xDEADBEEF),
        mod.SyncReply(random_reply=17),
        mod.InputMsg(peer_connect_status=statuses, disconnect_requested=True, start_frame=40,
                     ack_frame=38, bytes_=bytes(range(37))),
        mod.InputMsg(),
        mod.InputAck(ack_frame=-1),
        mod.QualityReport(frame_advantage=-5, ping=123456789012),
        mod.QualityReply(pong=2**63 + 5),
        mod.ChecksumReport(checksum=(1 << 127) + 12345, frame=90),
        mod.KeepAlive(),
    ]


def test_every_message_kind_matches_reference_bytes():
    port = [messages.Message(0xBEEF, b) for b in bodies(messages, ConnectionStatus)]
    ref = [ref_messages.Message(0xBEEF, b) for b in bodies(ref_messages, RefConnectionStatus)]
    for p, r in zip(port, ref):
        wire = messages.encode_message(p)
        assert wire == ref_messages.encode_message(r), type(p.body).__name__
        # each stack decodes the other's bytes into its own message
        back = messages.decode_message(ref_messages.encode_message(r))
        assert messages.encode_message(messages.Message(back.magic, back.body)) == wire
        ref_back = ref_messages.decode_message(wire)
        assert ref_messages.encode_message(ref_messages.Message(ref_back.magic, ref_back.body)) == wire
        assert type(back.body).__name__ == type(ref_back.body).__name__ == type(p.body).__name__


def test_garbage_is_dropped_alike():
    good = messages.encode_message(messages.Message(7, messages.InputAck(3)))
    pairs = [("a", b""), ("a", b"\x01"), ("a", good[:3] + b"\xff"), ("a", b"\x00\x00\x63"), ("b", good),
             ("a", good[:-1])]
    port = [(a, messages.encode_message(m)) for a, m in messages.decode_all(pairs)]
    ref = [(a, ref_messages.encode_message(m)) for a, m in ref_messages.decode_all(pairs)]
    assert port == ref == [("b", good)]
    with pytest.raises(messages.DecodeError):
        messages.decode_message(b"\x01")


def test_oversized_input_payload_raises_like_reference():
    msg = messages.Message(1, messages.InputMsg(bytes_=bytes(messages.MAX_INPUT_PAYLOAD + 1)))
    ref = ref_messages.Message(1, ref_messages.InputMsg(bytes_=bytes(ref_messages.MAX_INPUT_PAYLOAD + 1)))
    with pytest.raises(InvalidRequest) as got:
        messages.encode_message(msg)
    with pytest.raises(Exception) as want:
        ref_messages.encode_message(ref)
    assert str(got.value) == str(want.value)
    assert messages.MAX_INPUT_PAYLOAD == ref_messages.MAX_INPUT_PAYLOAD
    with pytest.raises(InvalidRequest):
        check_datagram_size(bytes(MAX_DATAGRAM_SIZE + 1))


@pytest.mark.parametrize("size,frames", [(1, 1), (1, 30), (4, 12), (16, 128)])
def test_input_codec_matches_reference(size, frames):
    rng = np.random.default_rng(size * 1000 + frames)
    reference = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
    pending = []
    row = bytearray(reference)
    for _ in range(frames):  # mostly held inputs, some changes, runs of 0x00 and 0xFF
        if rng.random() < 0.3:
            row[int(rng.integers(0, size))] = int(rng.choice([0, 255, int(rng.integers(0, 256))]))
        pending.append(bytes(row))
    payload = compression.encode(reference, pending)
    assert payload == ref_compression.rle_encode(ref_compression.delta_encode(reference, pending))
    assert compression.decode(reference, payload) == pending
    assert ref_compression.decode(reference, payload) == pending
    raw = bytes(rng.integers(0, 256, 300, dtype=np.uint8))
    assert compression.rle_encode(raw) == ref_compression.rle_encode(raw)
    for bad in (b"\x80", b"\x0c\x01", b"\x03", b"\xff\xff\xff\xff\xff\x01"):
        with pytest.raises(ValueError):
            compression.rle_decode(bad)


def lossy_pair(stack):
    clock = stack.FakeClock()
    net = stack.InMemoryNetwork(clock, latency_ms=35, jitter_ms=25, loss=0.15, duplicate=0.05, seed=21)
    sessions = build_peers(stack, clock, net, 2, desync=10)
    if stack is REF:
        for s in sessions:
            s.batched_pump = False
    synchronize(stack, sessions, clock, [])
    play(stack, sessions, [HashGame(), HashGame()], clock, 150)
    return [s.network_stats(1 - i) for i, s in enumerate(sessions)]


def test_network_stats_match_reference():
    """Byte and packet counts, ping, jitter, loss estimate and frame
    advantages of both endpoints after the same lossy match."""
    got, want = lossy_pair(PORT), lossy_pair(REF)
    assert [vars(s) for s in got] == [vars(s) for s in want]
    assert all(s.kbps_sent > 0 and s.ping_ms > 0 for s in got)


def synctest_saves(lazy):
    """A port SyncTest session on the CPU backend: (backend, every save's
    getter, bound at save time)."""
    sess = (SessionBuilder(input_size=1).with_num_players(2).with_max_prediction_window(8)
            .with_check_distance(2).start_synctest_session())
    backend = DeviceRollbackBackend(ExGame(2, 128), 8, 2, lazy_ticks=lazy, device="cpu")
    getters = []
    for f in range(7):
        for h in range(2):
            sess.add_local_input(h, bytes([f % 5]))
        reqs = sess.advance_frame()
        backend.handle_requests(reqs)
        getters += [(r.frame, r.cell.checksum_getter()) for r in reqs if type(r).__name__ == "SaveGameState"]
    return backend, getters


def test_eager_getters_are_ready_on_the_cpu():
    backend, getters = synctest_saves(0)
    assert all(g.ready for _, g in getters)
    values = [g() for _, g in getters]
    assert all(isinstance(v, int) for v in values)
    assert backend.ledger._pending == []  # the first read moved every batch
    assert all(g.ready for _, g in getters)


def test_lazy_getters_wait_for_their_dispatch():
    backend, getters = synctest_saves(5)
    # 7 ticks at lazy_ticks=5: a full buffer dispatched, the later rows buffered
    assert backend._rows_count
    buffered = [g for _, g in getters if not g.ready]
    assert buffered and len(buffered) < len(getters)
    assert all(g._batch.batch is None for g in buffered)  # not dispatched yet
    buffered[0].prefetch()  # forces the buffer's dispatch
    assert not backend._rows_count
    assert all(g.ready for _, g in getters)
    eager, eager_getters = synctest_saves(0)
    assert [(f, g()) for f, g in getters] == [(f, g()) for f, g in eager_getters]


class FakeGetter:
    def __init__(self, value):
        self.value = value
        self.ready = False
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


def drain_script(report_cls):
    """Captures, readiness flips and flushes, serial guard included; returns
    what was emitted after each step and the prefetch counts."""
    rep = report_cls()
    getters = {f: FakeGetter(f * 1000 + 7) for f in (10, 20, 30, 40)}
    for serial, f in enumerate((10, 20, 30)):
        rep.capture(f, FakeCell(f, getters[f]), serial=serial)
    rep.capture(5, FakeCell(99, FakeGetter(1)), serial=3)  # its slot was reused
    rep.capture(40, FakeCell(40, getters[40]), serial=4)
    emitted, steps = [], []
    emit = lambda frame, checksum: emitted.append((frame, checksum))  # noqa: E731
    for ready, force, max_serial in [((), False, None), ((20,), False, None), ((10,), False, 1),
                                     ((30, 40), False, 2), ((), False, None), ((), True, None)]:
        for f in ready:
            getters[f].ready = True
        blocked = rep.flush(force=force, emit=emit, max_serial=max_serial)
        steps.append((list(emitted), blocked, len(rep)))
    return steps, [g.prefetches for g in getters.values()]


def test_pending_reports_drain_like_reference():
    got, want = drain_script(PendingChecksumReport), drain_script(RefPendingChecksumReport)
    assert got == want
    assert got[0][-1][0] == [(10, 10007), (20, 20007), (30, 30007), (40, 40007)]


def test_endpoint_magics_follow_the_seeded_rng():
    """Endpoints built from the same seeded RNG draw the same magic and
    sync nonces on both stacks, so their first datagrams are equal."""
    wires = []
    for stack in (PORT, REF):
        clock = stack.FakeClock()
        net = stack.InMemoryNetwork(clock)
        build_peers(stack, clock, net, 3, seed=300)
        wires.append(sorted((addr, tuple(w for _, _, (_, w) in q)) for addr, q in net.queues.items()))
    assert wires[0] == wires[1]
