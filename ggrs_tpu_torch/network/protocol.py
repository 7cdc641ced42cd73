"""Per-peer reliability endpoint: the protocol state machine (the
reference's `network/protocol.py` `PeerEndpoint`, copied on its standalone
path: plain attributes where the reference indirects its hot fields for
the batched pump's fleet arrays, and no telemetry counters).

Random-nonce sync handshake with magic-based packet auth, cumulative-ack
input resend of the whole un-acked window with delta+RLE compression, the
200 ms timer family (sync retry, input resend, keep-alive, quality
report), RTT estimation, frame-advantage exchange feeding TimeSync,
disconnect notify/timeout detection, and checksum report intake for
desync detection. Timers run off an injectable Clock so tests drive them
deterministically; the RNG draws (magic, nonces) come in the reference's
order, so a port endpoint built with the same seeded RNG puts the same
bytes on the wire.
"""

from __future__ import annotations

import enum
import random as _random
from collections import deque
from dataclasses import dataclass
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

from ..errors import NotSynchronized, StatsWindowTooYoung
from ..frame_info import PlayerInput
from ..sync_layer import ConnectionStatus
from ..time_sync import TimeSync
from ..types import NULL_FRAME, Frame, PlayerHandle
from ..utils.clock import Clock
from . import compression
from .messages import (
    ChecksumReport,
    InputAck,
    InputMsg,
    KeepAlive,
    Message,
    QualityReply,
    QualityReport,
    SyncReply,
    SyncRequest,
    encode_message,
)
from .network_stats import NetworkStats
from .sockets import NonBlockingSocket

NUM_SYNC_PACKETS = 5
UDP_SHUTDOWN_TIMER_MS = 5000
PENDING_OUTPUT_SIZE = 128
SYNC_RETRY_INTERVAL_MS = 200
RUNNING_RETRY_INTERVAL_MS = 200
KEEP_ALIVE_INTERVAL_MS = 200
QUALITY_REPORT_INTERVAL_MS = 200
MAX_PAYLOAD = 467  # 512 safe UDP payload minus packet overhead
MAX_CHECKSUM_HISTORY_SIZE = 32


class ProtocolState(enum.Enum):
    INITIALIZING = 0
    SYNCHRONIZING = 1
    RUNNING = 2
    DISCONNECTED = 3
    SHUTDOWN = 4


# Endpoint -> session events


@dataclass(frozen=True)
class EvSynchronizing:
    total: int
    count: int


@dataclass(frozen=True)
class EvSynchronized:
    pass


@dataclass(frozen=True)
class EvInput:
    input: PlayerInput
    player: PlayerHandle


@dataclass(frozen=True)
class EvDisconnected:
    pass


@dataclass(frozen=True)
class EvNetworkInterrupted:
    disconnect_timeout_ms: int


@dataclass(frozen=True)
class EvNetworkResumed:
    pass


class PeerEndpoint:
    """One reliability endpoint per unique remote address; multiple player
    handles may share it."""

    def __init__(
        self,
        handles: Sequence[PlayerHandle],
        peer_addr: Any,
        num_players: int,
        local_players: int,
        max_prediction: int,
        disconnect_timeout_ms: int,
        disconnect_notify_start_ms: int,
        fps: int,
        input_size: int,
        clock: Optional[Clock] = None,
        rng: Optional[_random.Random] = None,
    ):
        self.clock = clock or Clock()
        rng = rng or _random.Random()
        magic = 0
        while magic == 0:
            magic = rng.randrange(1, 1 << 16)
        self.magic = magic
        self._rng = rng

        self.handles = sorted(handles)
        self.peer_addr = peer_addr
        self.num_players = num_players
        self.local_players = local_players
        self.max_prediction = max_prediction
        self.input_size = input_size
        self.fps = fps

        self.send_queue: Deque[Message] = deque()
        self.event_queue: Deque[Any] = deque()

        self.state = ProtocolState.INITIALIZING
        self.sync_remaining_roundtrips = NUM_SYNC_PACKETS
        self.sync_random_requests: set[int] = set()
        now = self.clock.now_ms()
        self.running_last_quality_report = now
        self.running_last_input_recv = now
        self.disconnect_notify_sent = False
        self.disconnect_event_sent = False

        self.disconnect_timeout_ms = disconnect_timeout_ms
        self.disconnect_notify_start_ms = disconnect_notify_start_ms
        self.shutdown_timeout = now

        self.remote_magic = 0
        self.peer_connect_status = [ConnectionStatus() for _ in range(num_players)]

        # input transmission: whole un-acked window, frame->bytes
        # (bytes = concatenation of this side's players' inputs for the frame)
        self.pending_output: Deque[Tuple[Frame, bytes]] = deque()
        self.last_acked_input: Tuple[Frame, bytes] = (
            NULL_FRAME,
            bytes(input_size * local_players),
        )
        # received input history for delta decoding; recv_frame is the
        # max(recv_inputs) watermark (maintained at the sole insert site in
        # _on_input)
        self.recv_inputs: Dict[Frame, bytes] = {
            NULL_FRAME: bytes(input_size * len(self.handles))
        }
        self.recv_frame = NULL_FRAME

        self.time_sync = TimeSync()
        self.local_frame_advantage = 0
        self.remote_frame_advantage = 0

        self.stats_start_time = 0
        self.packets_sent = 0
        self.bytes_sent = 0
        self.round_trip_time = 0
        self.last_send_time = now
        self.last_recv_time = now
        self.last_sync_request_time = now

        # receive direction + link-quality estimators (NetworkStats
        # kbps_recv / jitter_ms / packets_lost)
        self.packets_recv = 0
        self.bytes_recv = 0
        # RFC 3550-style interarrival jitter over RTT samples:
        # J += (|D| - J) / 16 per quality reply
        self.jitter_ms = 0.0
        self._last_rtt_sample: Optional[int] = None
        # loss estimate from sequence gaps in the peer's quality-report
        # stream: reports carry the sender's strictly-increasing clock and
        # fire on a fixed 200ms cadence, so a gap of k intervals means
        # k - 1 reports never arrived
        self.packets_lost = 0
        self._last_quality_ping: Optional[int] = None

        self.checksum_history: Dict[Frame, int] = {}
        self.last_added_checksum_frame: Frame = NULL_FRAME

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def synchronize(self) -> None:
        assert self.state == ProtocolState.INITIALIZING
        self.state = ProtocolState.SYNCHRONIZING
        self.sync_remaining_roundtrips = NUM_SYNC_PACKETS
        self.stats_start_time = self.clock.now_ms()
        self._send_sync_request()

    def disconnect(self) -> None:
        if self.state == ProtocolState.SHUTDOWN:
            return
        self.state = ProtocolState.DISCONNECTED
        self.shutdown_timeout = self.clock.now_ms() + UDP_SHUTDOWN_TIMER_MS

    def is_synchronized(self) -> bool:
        return self.state in (
            ProtocolState.RUNNING,
            ProtocolState.DISCONNECTED,
            ProtocolState.SHUTDOWN,
        )

    def is_running(self) -> bool:
        return self.state == ProtocolState.RUNNING

    def is_handling_message(self, addr: Any) -> bool:
        return self.peer_addr == addr

    def average_frame_advantage(self) -> int:
        return self.time_sync.average_frame_advantage()

    # ------------------------------------------------------------------
    # timers
    # ------------------------------------------------------------------

    def poll(
        self, connect_status: Sequence[ConnectionStatus],
        now: Optional[int] = None,
    ) -> List[Any]:
        """`now` lets a session's pump pass read the clock once for all of
        its endpoints."""
        if now is None:
            now = self.clock.now_ms()
        self._poll_timers(connect_status, now)
        events = list(self.event_queue)
        self.event_queue.clear()
        return events

    def _poll_timers(
        self, connect_status: Sequence[ConnectionStatus], now: int
    ) -> None:
        """The timer family."""
        state = self.state
        if state == ProtocolState.SYNCHRONIZING:
            # retries key off the last sync REQUEST, not the last send of
            # anything: a Synchronizing endpoint also answers the running
            # peer's 200ms quality reports, and each QualityReply refreshes
            # last_send_time — keyed off that, handshake retries would
            # starve once the final SyncReply is lost
            if self.last_sync_request_time + SYNC_RETRY_INTERVAL_MS < now:
                self._send_sync_request(now)
        elif state == ProtocolState.RUNNING:
            if self.running_last_input_recv + RUNNING_RETRY_INTERVAL_MS < now:
                self._send_pending_output(connect_status, now)
                self.running_last_input_recv = now
            if self.running_last_quality_report + QUALITY_REPORT_INTERVAL_MS < now:
                self._send_quality_report(now)
            if self.last_send_time + KEEP_ALIVE_INTERVAL_MS < now:
                self._queue_message(KeepAlive(), now)
            if (
                not self.disconnect_notify_sent
                and self.last_recv_time + self.disconnect_notify_start_ms < now
            ):
                remaining = self.disconnect_timeout_ms - self.disconnect_notify_start_ms
                self.event_queue.append(EvNetworkInterrupted(remaining))
                self.disconnect_notify_sent = True
            if (
                not self.disconnect_event_sent
                and self.last_recv_time + self.disconnect_timeout_ms < now
            ):
                self.event_queue.append(EvDisconnected())
                self.disconnect_event_sent = True
        elif state == ProtocolState.DISCONNECTED:
            if self.shutdown_timeout < now:
                self.state = ProtocolState.SHUTDOWN

    # ------------------------------------------------------------------
    # sending
    # ------------------------------------------------------------------

    def send_all_messages(self, socket: NonBlockingSocket) -> None:
        if self.state == ProtocolState.SHUTDOWN:
            self.send_queue.clear()
            return
        while self.send_queue:
            socket.send_to(self.send_queue.popleft(), self.peer_addr)

    def send_input(
        self,
        inputs: Dict[PlayerHandle, PlayerInput],
        connect_status: Sequence[ConnectionStatus],
    ) -> None:
        """Append this frame's local inputs to the un-acked window and send
        the whole window."""
        if self.state != ProtocolState.RUNNING:
            return

        frame, data = self._inputs_to_bytes(inputs)
        self.time_sync.advance_frame(
            frame, self.local_frame_advantage, self.remote_frame_advantage
        )
        self.pending_output.append((frame, data))
        if len(self.pending_output) > PENDING_OUTPUT_SIZE:
            # a spectator that never acks: disconnect it
            self.event_queue.append(EvDisconnected())
        self._send_pending_output(connect_status)

    def _inputs_to_bytes(
        self, inputs: Dict[PlayerHandle, PlayerInput]
    ) -> Tuple[Frame, bytes]:
        """Ascending-handle concatenation."""
        frame = NULL_FRAME
        chunks = []
        for handle in sorted(inputs):
            pi = inputs[handle]
            if pi.frame != NULL_FRAME:
                assert frame in (NULL_FRAME, pi.frame)
                frame = pi.frame
            chunks.append(pi.buf)
        return frame, b"".join(chunks)

    def _send_pending_output(
        self, connect_status: Sequence[ConnectionStatus],
        now: Optional[int] = None,
    ) -> None:
        """Send the longest window *prefix* whose encoding fits MAX_PAYLOAD
        (protocol-legal: the receiver acks the prefix and the rest rides the
        next resend); a single oversized frame is sent anyway (UDP handles
        fragmentation) rather than killing the session."""
        if not self.pending_output:
            return
        first_frame, _ = self.pending_output[0]
        ack_frame, ack_bytes = self.last_acked_input
        assert ack_frame == NULL_FRAME or ack_frame + 1 == first_frame

        count = len(self.pending_output)
        pending = list(self.pending_output)
        payload = compression.encode(ack_bytes, (d for _, d in pending))
        while len(payload) > MAX_PAYLOAD and count > 1:
            count = max(1, count // 2)
            payload = compression.encode(ack_bytes, (d for _, d in pending[:count]))

        body = InputMsg(
            peer_connect_status=[
                ConnectionStatus(s.disconnected, s.last_frame) for s in connect_status
            ],
            disconnect_requested=self.state == ProtocolState.DISCONNECTED,
            start_frame=first_frame,
            ack_frame=self._last_recv_frame(),
            bytes_=payload,
        )
        self._queue_message(body, now)

    def _send_input_ack(self, now: Optional[int] = None) -> None:
        self._queue_message(InputAck(ack_frame=self._last_recv_frame()), now)

    def _send_sync_request(self, now: Optional[int] = None) -> None:
        self.last_sync_request_time = now if now is not None else self.clock.now_ms()
        nonce = self._rng.getrandbits(32)
        self.sync_random_requests.add(nonce)
        self._queue_message(SyncRequest(random_request=nonce), now)

    def _send_quality_report(self, now: Optional[int] = None) -> None:
        if now is None:
            now = self.clock.now_ms()
        self.running_last_quality_report = now
        adv = max(-128, min(127, self.local_frame_advantage))
        self._queue_message(QualityReport(frame_advantage=adv, ping=now), now)

    def send_checksum_report(self, frame_to_send: Frame, checksum: int) -> None:
        self._queue_message(ChecksumReport(checksum=checksum, frame=frame_to_send))

    def _queue_message(self, body: Any, now: Optional[int] = None) -> None:
        msg = Message(magic=self.magic, body=body)
        self.packets_sent += 1
        self.last_send_time = now if now is not None else self.clock.now_ms()
        wire_len = len(encode_message(msg))
        self.bytes_sent += wire_len
        self.send_queue.append(msg)

    # ------------------------------------------------------------------
    # receiving
    # ------------------------------------------------------------------

    def handle_message(self, msg: Message) -> None:
        """Apply one received message: packet auth, receive accounting,
        then the body's handler."""
        if self.state == ProtocolState.SHUTDOWN:
            return
        # packet auth: filter foreign magics once the peer is known
        if self.remote_magic != 0 and msg.magic != self.remote_magic:
            return
        now = self.clock.now_ms()
        self.last_recv_time = now
        self.packets_recv += 1
        # wire-decoded messages carry their bytes (decode_message stamps
        # _wire); hand-built ones pay one cached encode
        self.bytes_recv += len(msg._wire) if msg._wire is not None else len(encode_message(msg))
        if self.disconnect_notify_sent and self.state == ProtocolState.RUNNING:
            self.disconnect_notify_sent = False
            self.event_queue.append(EvNetworkResumed())

        body = msg.body
        if isinstance(body, InputMsg):
            self._on_input(body, now)
        elif isinstance(body, InputAck):
            self._pop_pending_output(body.ack_frame)
        elif isinstance(body, QualityReport):
            self._on_quality_report(body.frame_advantage, body.ping, now)
        elif isinstance(body, QualityReply):
            self._on_quality_reply_pong(body.pong, now)
        elif isinstance(body, SyncRequest):
            self._queue_message(SyncReply(random_reply=body.random_request), now)
        elif isinstance(body, SyncReply):
            self._on_sync_reply_nonce(msg.magic, body.random_reply, now)
        elif isinstance(body, ChecksumReport):
            self._on_checksum_report(body.frame, body.checksum)
        # KeepAlive: nothing beyond the recv-time update

    def _on_sync_reply_nonce(self, magic: int, nonce: int, now: int) -> None:
        if self.state != ProtocolState.SYNCHRONIZING:
            return
        if nonce not in self.sync_random_requests:
            return
        self.sync_random_requests.discard(nonce)
        self.sync_remaining_roundtrips -= 1
        if self.sync_remaining_roundtrips > 0:
            self.event_queue.append(
                EvSynchronizing(
                    total=NUM_SYNC_PACKETS,
                    count=NUM_SYNC_PACKETS - self.sync_remaining_roundtrips,
                )
            )
            self._send_sync_request(now)
        else:
            self.state = ProtocolState.RUNNING
            self.event_queue.append(EvSynchronized())
            self.remote_magic = magic  # peer is now authorized

    def _on_input(self, body: InputMsg, now: int) -> None:
        start_frame = body.start_frame
        self._pop_pending_output(body.ack_frame)

        if body.disconnect_requested:
            if self.state != ProtocolState.DISCONNECTED and not self.disconnect_event_sent:
                self.event_queue.append(EvDisconnected())
                self.disconnect_event_sent = True
        else:
            for mine, theirs in zip(self.peer_connect_status, body.peer_connect_status):
                mine.disconnected = theirs.disconnected or mine.disconnected
                if theirs.last_frame > mine.last_frame:
                    mine.last_frame = theirs.last_frame

        last_recv = self._last_recv_frame()
        # a start_frame beyond last_recv+1 means the peer encoded against an
        # input we never received — unrecoverable for this packet, but the
        # value is network-controlled, so drop it rather than abort
        if last_recv != NULL_FRAME and start_frame > last_recv + 1:
            return
        # before any input arrived, a legitimate first packet starts within
        # the sender's pending window (its first queued frame, bounded by
        # the 128-slot queue); a huge spoofed start_frame would otherwise
        # permanently poison recv_inputs and blackhole all real inputs
        if last_recv == NULL_FRAME and not (
            0 <= start_frame <= PENDING_OUTPUT_SIZE
        ):
            return
        # ...and frame arithmetic must stay inside int32 in either direction
        if not (0 <= start_frame <= (1 << 31) - 1 - 2 * PENDING_OUTPUT_SIZE):
            return

        decode_frame = NULL_FRAME if last_recv == NULL_FRAME else start_frame - 1
        ref = self.recv_inputs.get(decode_frame)
        if ref is None:
            return
        self.running_last_input_recv = now

        # bound the decode at the largest legitimate payload — the sender
        # never has more than PENDING_OUTPUT_SIZE un-acked frames in flight —
        # so a hostile run-length claim can't balloon memory; and a payload
        # that fails to decode is a dropped datagram, not a session crash
        try:
            decoded = compression.decode(
                ref, body.bytes_, max_output=len(ref) * (PENDING_OUTPUT_SIZE + 1)
            )
        except ValueError:
            return
        per_player = self.input_size
        for i, inp_bytes in enumerate(decoded):
            inp_frame = start_frame + i
            if inp_frame <= self.recv_frame:
                continue  # already have it
            self.recv_inputs[inp_frame] = inp_bytes
            self.recv_frame = inp_frame  # watermark: inserts are ascending
            # re-split the endpoint-level bytes into per-player inputs
            assert len(inp_bytes) == per_player * len(self.handles)
            for j, handle in enumerate(self.handles):
                buf = inp_bytes[j * per_player : (j + 1) * per_player]
                self.event_queue.append(
                    EvInput(input=PlayerInput(inp_frame, buf), player=handle)
                )

        self._send_input_ack(now)

        # GC received inputs beyond 2x the prediction window
        horizon = self._last_recv_frame() - 2 * self.max_prediction
        self.recv_inputs = {
            f: b for f, b in self.recv_inputs.items() if f >= horizon or f == NULL_FRAME
        }

    def _pop_pending_output(self, ack_frame: Frame) -> None:
        while self.pending_output and self.pending_output[0][0] <= ack_frame:
            self.last_acked_input = self.pending_output.popleft()

    def _on_quality_report(self, frame_advantage: int, ping: int, now: int) -> None:
        self.remote_frame_advantage = frame_advantage
        # packet-loss estimate from sequence gaps: the peer's reports fire
        # every QUALITY_REPORT_INTERVAL_MS carrying its strictly-increasing
        # clock, so a ping-gap of k intervals means k - 1 reports (and
        # statistically the same fraction of all its traffic) were dropped.
        # ping is network-controlled: ignore non-monotonic values outright.
        if self._last_quality_ping is not None and ping > self._last_quality_ping:
            gap = ping - self._last_quality_ping
            # floor, not round: reports fire on the sender's poll at >=200ms,
            # so a slow-polling peer (e.g. 300ms cadence) stretches gaps to
            # 1.5 intervals with zero real loss — flooring forgives that
            # quantization while a genuinely dropped report (>=2 intervals)
            # still counts
            missed = gap // QUALITY_REPORT_INTERVAL_MS - 1
            if missed > 0:
                self.packets_lost += missed
        self._last_quality_ping = max(self._last_quality_ping or 0, ping)
        self._queue_message(QualityReply(pong=ping), now)

    def _on_quality_reply_pong(self, pong: int, now: int) -> None:
        # network-controlled value: a pong from the future (clock skew or a
        # crafted packet) must not produce a negative RTT or crash the
        # session
        self.round_trip_time = now - pong if now >= pong else 0
        # RFC 3550-style jitter over consecutive RTT samples; the first
        # sample only seeds the baseline (comparing against the initial 0
        # would inject a phantom |RTT|/16 spike on every fresh connection)
        if self._last_rtt_sample is not None:
            self.jitter_ms += (
                abs(self.round_trip_time - self._last_rtt_sample) - self.jitter_ms
            ) / 16.0
        self._last_rtt_sample = self.round_trip_time

    def _on_checksum_report(self, frame: Frame, checksum: int) -> None:
        if self.last_added_checksum_frame < frame:
            if len(self.checksum_history) > MAX_CHECKSUM_HISTORY_SIZE:
                keep_after = self.last_added_checksum_frame - MAX_CHECKSUM_HISTORY_SIZE
                self.checksum_history = {
                    f: c for f, c in self.checksum_history.items() if f > keep_after
                }
            self.last_added_checksum_frame = frame
            self.checksum_history[frame] = checksum

    # ------------------------------------------------------------------
    # frame advantage / stats
    # ------------------------------------------------------------------

    def update_local_frame_advantage(self, local_frame: Frame) -> None:
        """Estimate the remote's current frame from its last input plus
        half-RTT."""
        recv_frame = self.recv_frame
        if local_frame == NULL_FRAME or recv_frame == NULL_FRAME:
            return
        ping = self.round_trip_time // 2
        remote_frame = recv_frame + (ping * self.fps) // 1000
        self.local_frame_advantage = remote_frame - local_frame

    def network_stats(self, now: Optional[int] = None) -> NetworkStats:
        if self.state not in (ProtocolState.SYNCHRONIZING, ProtocolState.RUNNING):
            raise NotSynchronized()
        if now is None:
            now = self.clock.now_ms()
        seconds = (now - self.stats_start_time) // 1000
        if seconds == 0:
            # distinguishable from the unsynchronized case — but only once
            # the endpoint actually IS synchronized: mid-handshake, "not
            # synchronized" stays the truthful (plain) error even though
            # the window is also young
            if self.state == ProtocolState.RUNNING:
                raise StatsWindowTooYoung()
            raise NotSynchronized()
        return NetworkStats.from_endpoint(self, seconds)

    def _last_recv_frame(self) -> Frame:
        return self.recv_frame
