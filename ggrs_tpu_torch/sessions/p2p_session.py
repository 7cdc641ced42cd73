"""The P2P session: per-frame pipeline, rollback driver, message pump (the
reference's `sessions/p2p_session.py`, copied on its per-session poll).

Ordered request generation (save/load/advance), confirmed-frame accounting
as the min over connected peers, disconnect propagation with a forced
rollback to the disconnect frame, sparse-saving mode, spectator input
broadcast, wait recommendations and checksum-exchange desync detection.
The returned request list is the seam where the device backend plugs in: a
whole rollback block (Load + N x Save/Advance) is fused into one dispatch by
`ggrs_tpu_torch.device.backend.DeviceRollbackBackend` (one K3 launch on a
card).

Left out of the reference's session:
- the process-wide batched pump (`GLOBAL_PUMP`) and its fleet plane: the
  session always polls per message (the reference's `_poll_legacy`, what
  it runs with `batched_pump = False`), which puts the same bytes on the
  wire;
- the native wire lane (`handle_wire`) and native input queues;
- serve-host attachment (`on_host_attach`, `host_key`);
- telemetry, tracer spans and desync forensics bundles.

Checksum reports publish as soon as their value is ready (the reference's
default `checksum_publish = "ready"`); `"interval"` is the reference's
deterministic-publish mode: the pump pass only binds getters and starts
background copies (`PendingChecksumReport.bind_and_prefetch`), and every
report is emitted at the interval-forced flush, so the wire bytes do not
depend on when the device values became ready (an async backend's lazy
dispatches). `drain_blocked_ticks` counts the forced flushes that waited
on the card.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Deque, Dict, List

from ..errors import InvalidRequest, NotSynchronized
from ..frame_info import PlayerInput
from ..network.network_stats import NetworkStats
from ..network.protocol import (
    MAX_CHECKSUM_HISTORY_SIZE,
    EvDisconnected,
    EvInput,
    EvNetworkInterrupted,
    EvNetworkResumed,
    EvSynchronized,
    EvSynchronizing,
    PeerEndpoint,
)
from ..sync_layer import ConnectionStatus, PendingChecksumReport, SyncLayer
from ..types import (
    NULL_FRAME,
    AdvanceFrame,
    DesyncDetected,
    DesyncDetection,
    Disconnected,
    Event,
    Frame,
    NetworkInterrupted,
    NetworkResumed,
    PlayerHandle,
    PlayerType,
    PlayerTypeKind,
    Request,
    SessionState,
    Synchronized,
    Synchronizing,
    WaitRecommendation,
)

from .builder import MAX_EVENT_QUEUE_SIZE

RECOMMENDATION_INTERVAL = 60
MIN_RECOMMENDATION = 3


class PlayerRegistry:
    """Every handle's player type, and one endpoint per remote or
    spectator address."""

    def __init__(self, handles: Dict[PlayerHandle, PlayerType]):
        self.handles = handles
        self.remotes: Dict[Any, PeerEndpoint] = {}
        self.spectators: Dict[Any, PeerEndpoint] = {}

    def _handles_of(self, kind: PlayerTypeKind) -> List[PlayerHandle]:
        return sorted(h for h, p in self.handles.items() if p.kind == kind)

    def local_player_handles(self) -> List[PlayerHandle]:
        return self._handles_of(PlayerTypeKind.LOCAL)

    def remote_player_handles(self) -> List[PlayerHandle]:
        return self._handles_of(PlayerTypeKind.REMOTE)

    def spectator_handles(self) -> List[PlayerHandle]:
        return self._handles_of(PlayerTypeKind.SPECTATOR)

    def num_players(self) -> int:
        return sum(
            1
            for p in self.handles.values()
            if p.kind in (PlayerTypeKind.LOCAL, PlayerTypeKind.REMOTE)
        )

    def num_spectators(self) -> int:
        return len(self.spectator_handles())

    def handles_by_address(self, addr: Any) -> List[PlayerHandle]:
        return sorted(
            h
            for h, p in self.handles.items()
            if p.kind != PlayerTypeKind.LOCAL and p.addr == addr
        )


class P2PSession:
    def __init__(
        self,
        num_players: int,
        max_prediction: int,
        socket: Any,
        players: PlayerRegistry,
        sparse_saving: bool,
        desync_detection: DesyncDetection,
        input_delay: int,
        input_size: int,
    ):
        self.num_players = num_players
        self.max_prediction = max_prediction
        self.sparse_saving = sparse_saving
        self.socket = socket
        self.player_reg = players
        self.input_size = input_size
        self.desync_detection = desync_detection

        self.local_connect_status = [ConnectionStatus() for _ in range(num_players)]
        self.sync_layer = SyncLayer(num_players, max_prediction, input_size)
        for handle, ptype in players.handles.items():
            if ptype.kind == PlayerTypeKind.LOCAL:
                self.sync_layer.set_frame_delay(handle, input_delay)

        # no remotes -> no synchronization phase needed
        if not players.remotes and not players.spectators:
            self.state = SessionState.RUNNING
        else:
            self.state = SessionState.SYNCHRONIZING

        self.disconnect_frame: Frame = NULL_FRAME
        self.next_recommended_sleep: Frame = 0
        self.next_spectator_frame: Frame = 0
        self.frames_ahead = 0
        self.event_queue: Deque[Event] = deque()
        self.local_inputs: Dict[PlayerHandle, PlayerInput] = {}
        self.local_checksum_history: Dict[Frame, int] = {}
        self._pending_checksum_report = PendingChecksumReport()
        # monotonic advance counter: stamps checksum-report captures so
        # the pump-side flush stays behind the capture frontier
        self._advance_serial = 0
        # "ready" emits a report on the pump pass once its value is
        # host-ready; "interval" emits only at the interval-forced flush
        self.checksum_publish = "ready"
        # ticks whose forced checksum flush waited on the card
        self.drain_blocked_ticks = 0

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def add_local_input(self, player_handle: PlayerHandle, buf: bytes) -> None:
        if player_handle not in self.player_reg.local_player_handles():
            raise InvalidRequest(
                "The player handle you provided is not referring to a local player."
            )
        if len(buf) != self.input_size:
            raise InvalidRequest(
                f"Input must be exactly {self.input_size} bytes, got {len(buf)}."
            )
        self.local_inputs[player_handle] = PlayerInput(
            self.sync_layer.current_frame, buf
        )

    def advance_frame(self) -> List[Request]:
        """The per-tick pipeline: pump the network, roll back if a remote
        input contradicted a prediction, save, exchange checksums, send
        the local inputs and advance. Host work only: the returned
        requests are the backend's to fulfil, in order."""
        self.poll_remote_clients()
        if self.state != SessionState.RUNNING:
            raise NotSynchronized()
        self._advance_serial += 1

        requests: List[Request] = []

        # --- rollbacks and game state management
        if self.sync_layer.current_frame == 0:
            requests.append(self.sync_layer.save_current_state())

        self._update_player_disconnects()
        confirmed_frame = self.confirmed_frame()

        first_incorrect = self.sync_layer.check_simulation_consistency(
            self.disconnect_frame
        )
        if first_incorrect != NULL_FRAME:
            # a disconnect recorded at exactly the current frame means
            # nothing simulated yet used wrong inputs — no rollback needed
            if first_incorrect < self.sync_layer.current_frame:
                self._adjust_gamestate(first_incorrect, confirmed_frame, requests)
            self.disconnect_frame = NULL_FRAME

        last_saved = self.sync_layer.last_saved_frame
        if self.sparse_saving:
            self._check_last_saved_state(last_saved, confirmed_frame, requests)
        else:
            requests.append(self.sync_layer.save_current_state())

        # --- ship confirmed inputs to spectators, then GC them (reference
        # ordering: broadcast precedes GC with the same watermark, so GC can
        # never discard a frame the spectators haven't been sent)
        self._send_confirmed_inputs_to_spectators(confirmed_frame)
        self.sync_layer.set_last_confirmed_frame(confirmed_frame, self.sparse_saving)

        # --- desync detection
        if self.desync_detection.enabled:
            self._check_checksum_send_interval(confirmed_frame)
            self._compare_local_checksums_against_peers()

        # --- wait recommendation
        self._check_wait_recommendation()

        # --- register local inputs and send them
        for handle in self.player_reg.local_player_handles():
            player_input = self.local_inputs.get(handle)
            if player_input is None:
                raise InvalidRequest(
                    "Missing local input while calling advance_frame()."
                )
            actual_frame = self.sync_layer.add_local_input(handle, player_input)
            assert actual_frame != NULL_FRAME
            # input delay may shift the frame the input lands on
            self.local_inputs[handle] = PlayerInput(actual_frame, player_input.buf)
            self.local_connect_status[handle].last_frame = actual_frame

        for endpoint in self.player_reg.remotes.values():
            endpoint.send_input(self.local_inputs, self.local_connect_status)
            endpoint.send_all_messages(self.socket)
        self.local_inputs.clear()

        # --- second spectator broadcast: the watermark recomputed after the
        # local inputs landed covers the current frame, so a host's spectators
        # see frame f's confirmed input at tick f. Queues are flushed here so
        # the packet leaves this tick; GC stays with the earlier broadcast.
        if self.num_spectators() > 0:
            self._send_confirmed_inputs_to_spectators(self.confirmed_frame())
            for endpoint in self.player_reg.spectators.values():
                endpoint.send_all_messages(self.socket)

        # --- advance
        inputs = self.sync_layer.synchronized_inputs(self.local_connect_status)
        self.sync_layer.advance_frame()
        requests.append(AdvanceFrame(inputs=inputs))
        return requests

    def poll_remote_clients(self) -> None:
        """Message pump: one decode and one handle_message per datagram;
        then, at one clock reading, each running remote's frame advantage,
        every endpoint's timers and events, the checksum drain, and the
        sends."""
        remotes = self.player_reg.remotes
        spectators = self.player_reg.spectators
        for from_addr, msg in self.socket.receive_all_messages():
            endpoint = remotes.get(from_addr)
            if endpoint is not None:
                endpoint.handle_message(msg)
            endpoint = spectators.get(from_addr)
            if endpoint is not None:
                endpoint.handle_message(msg)

        endpoints = list(remotes.values()) + list(spectators.values())
        now = endpoints[0].clock.now_ms() if endpoints else 0
        current = self.sync_layer.current_frame
        for endpoint in remotes.values():
            if endpoint.is_running():
                endpoint.update_local_frame_advantage(current)
        events = []
        for endpoint in endpoints:
            handles = list(endpoint.handles)
            for event in endpoint.poll(self.local_connect_status, now):
                events.append((event, handles, endpoint.peer_addr))
        for event, handles, addr in events:
            self._handle_event(event, handles, addr)
        # resolve desync-detection checksums during the pump, not the tick
        self._pump_checksums()
        for endpoint in endpoints:
            endpoint.send_all_messages(self.socket)

    def _pump_checksums(self) -> None:
        """Opportunistic, non-blocking drain of pending desync-detection
        reports on the pump pass: resolve the host-ready ones, prefetch
        the oldest still-in-flight one, so the interval-forced flush in
        _check_checksum_send_interval finds the bytes already moved when
        the card has caught up (else that flush waits). Entries captured within the last two advances are left
        untouched (max_serial): their frame's correcting rollback may
        still sit in an unfulfilled request list, and binding the getter
        early would publish a mid-correction checksum."""
        pcr = self._pending_checksum_report
        if len(pcr):
            if self.checksum_publish == "interval":
                pcr.bind_and_prefetch(max_serial=self._advance_serial - 2)
            else:
                pcr.flush(
                    force=False,
                    emit=self._emit_checksum_report,
                    max_serial=self._advance_serial - 2,
                )

    def disconnect_player(self, player_handle: PlayerHandle) -> None:
        """Disconnect a remote player (at its last confirmed frame) or a
        spectator."""
        ptype = self.player_reg.handles.get(player_handle)
        if ptype is None:
            raise InvalidRequest("Invalid Player Handle.")
        if ptype.kind == PlayerTypeKind.LOCAL:
            raise InvalidRequest("Local Player cannot be disconnected.")
        if ptype.kind == PlayerTypeKind.REMOTE:
            if self.local_connect_status[player_handle].disconnected:
                raise InvalidRequest("Player already disconnected.")
            last_frame = self.local_connect_status[player_handle].last_frame
            self._disconnect_player_at_frame(player_handle, last_frame)
        else:
            self._disconnect_player_at_frame(player_handle, NULL_FRAME)

    def events(self) -> List[Event]:
        out = list(self.event_queue)
        self.event_queue.clear()
        return out

    def network_stats(self, player_handle: PlayerHandle) -> NetworkStats:
        ptype = self.player_reg.handles.get(player_handle)
        if ptype is None or ptype.kind == PlayerTypeKind.LOCAL:
            raise InvalidRequest(
                "Given player handle not referring to a remote player or spectator"
            )
        reg = (
            self.player_reg.remotes
            if ptype.kind == PlayerTypeKind.REMOTE
            else self.player_reg.spectators
        )
        return reg[ptype.addr].network_stats()

    def confirmed_frame(self) -> Frame:
        """min(last_frame) over connected peers."""
        confirmed = 2**31 - 1
        for status in self.local_connect_status:
            if not status.disconnected:
                confirmed = min(confirmed, status.last_frame)
        assert confirmed < 2**31 - 1
        return confirmed

    @property
    def current_frame(self) -> Frame:
        return self.sync_layer.current_frame

    @property
    def last_saved_frame(self) -> Frame:
        return self.sync_layer.last_saved_frame

    def current_state(self) -> SessionState:
        return self.state

    def local_player_handles(self) -> List[PlayerHandle]:
        return self.player_reg.local_player_handles()

    def remote_player_handles(self) -> List[PlayerHandle]:
        return self.player_reg.remote_player_handles()

    def spectator_handles(self) -> List[PlayerHandle]:
        return self.player_reg.spectator_handles()

    def handles_by_address(self, addr: Any) -> List[PlayerHandle]:
        return self.player_reg.handles_by_address(addr)

    def num_spectators(self) -> int:
        return self.player_reg.num_spectators()

    # ------------------------------------------------------------------
    # internals
    # ------------------------------------------------------------------

    def _disconnect_player_at_frame(self, player_handle: PlayerHandle, last_frame: Frame) -> None:
        ptype = self.player_reg.handles[player_handle]
        if ptype.kind == PlayerTypeKind.REMOTE:
            endpoint = self.player_reg.remotes[ptype.addr]
            for handle in endpoint.handles:
                self.local_connect_status[handle].disconnected = True
            endpoint.disconnect()
            if self.sync_layer.current_frame > last_frame:
                # resimulate from the disconnect so predictions made for the
                # dead player are redone with Disconnected dummy inputs
                self.disconnect_frame = last_frame + 1
        elif ptype.kind == PlayerTypeKind.SPECTATOR:
            self.player_reg.spectators[ptype.addr].disconnect()
        self._check_initial_sync()

    def _check_initial_sync(self) -> None:
        if self.state != SessionState.SYNCHRONIZING:
            return
        for endpoint in list(self.player_reg.remotes.values()) + list(
            self.player_reg.spectators.values()
        ):
            if not endpoint.is_synchronized():
                return
        self.state = SessionState.RUNNING

    def _adjust_gamestate(
        self, first_incorrect: Frame, min_confirmed: Frame, requests: List[Request]
    ) -> None:
        """Rollback driver."""
        current_frame = self.sync_layer.current_frame
        frame_to_load = (
            self.sync_layer.last_saved_frame if self.sparse_saving else first_incorrect
        )
        assert frame_to_load <= first_incorrect
        count = current_frame - frame_to_load

        requests.append(self.sync_layer.load_frame(frame_to_load))
        assert self.sync_layer.current_frame == frame_to_load
        self.sync_layer.reset_prediction()

        for i in range(count):
            inputs = self.sync_layer.synchronized_inputs(self.local_connect_status)
            if self.sparse_saving:
                if self.sync_layer.current_frame == min_confirmed:
                    requests.append(self.sync_layer.save_current_state())
            else:
                if i > 0:
                    requests.append(self.sync_layer.save_current_state())
            self.sync_layer.advance_frame()
            requests.append(AdvanceFrame(inputs=inputs))
        assert self.sync_layer.current_frame == current_frame

    def _check_last_saved_state(
        self, last_saved: Frame, confirmed_frame: Frame, requests: List[Request]
    ) -> None:
        """Sparse-saving keepalive of the snapshot ring."""
        if self.sync_layer.current_frame - last_saved >= self.max_prediction:
            if confirmed_frame >= self.sync_layer.current_frame:
                requests.append(self.sync_layer.save_current_state())
            else:
                self._adjust_gamestate(last_saved, confirmed_frame, requests)
            assert confirmed_frame == NULL_FRAME or self.sync_layer.last_saved_frame == min(
                confirmed_frame, self.sync_layer.current_frame
            )

    def _send_confirmed_inputs_to_spectators(self, confirmed_frame: Frame) -> None:
        if self.num_spectators() == 0:
            return
        while self.next_spectator_frame <= confirmed_frame:
            inputs = self.sync_layer.confirmed_inputs(
                self.next_spectator_frame, self.local_connect_status
            )
            assert len(inputs) == self.num_players
            input_map = {}
            for handle, inp in enumerate(inputs):
                assert inp.frame in (NULL_FRAME, self.next_spectator_frame)
                # disconnected dummies must still carry the right frame so the
                # endpoint-level frame stamp stays consistent
                input_map[handle] = PlayerInput(self.next_spectator_frame, inp.buf)
            for endpoint in self.player_reg.spectators.values():
                if endpoint.is_running():
                    endpoint.send_input(input_map, self.local_connect_status)
            self.next_spectator_frame += 1

    def _update_player_disconnects(self) -> None:
        """Cross-peer disconnect reconciliation."""
        for handle in range(self.num_players):
            queue_connected = True
            queue_min_confirmed = 2**31 - 1
            for endpoint in self.player_reg.remotes.values():
                if not endpoint.is_running():
                    continue
                status = endpoint.peer_connect_status[handle]
                queue_connected = queue_connected and not status.disconnected
                queue_min_confirmed = min(queue_min_confirmed, status.last_frame)

            local_connected = not self.local_connect_status[handle].disconnected
            local_min_confirmed = self.local_connect_status[handle].last_frame
            if local_connected:
                queue_min_confirmed = min(queue_min_confirmed, local_min_confirmed)

            if not queue_connected and (
                local_connected or local_min_confirmed > queue_min_confirmed
            ):
                self._disconnect_player_at_frame(handle, queue_min_confirmed)

    def _max_frame_advantage(self) -> int:
        interval = None
        for endpoint in self.player_reg.remotes.values():
            for handle in endpoint.handles:
                if not self.local_connect_status[handle].disconnected:
                    adv = endpoint.average_frame_advantage()
                    interval = adv if interval is None else max(interval, adv)
        return 0 if interval is None else interval

    def frames_ahead_estimate(self) -> int:
        return self.frames_ahead

    def _check_wait_recommendation(self) -> None:
        self.frames_ahead = self._max_frame_advantage()
        if (
            self.sync_layer.current_frame > self.next_recommended_sleep
            and self.frames_ahead >= MIN_RECOMMENDATION
        ):
            self.next_recommended_sleep = (
                self.sync_layer.current_frame + RECOMMENDATION_INTERVAL
            )
            self._push_event(WaitRecommendation(skip_frames=self.frames_ahead))

    def _handle_event(self, event: Any, player_handles: List[PlayerHandle], addr: Any) -> None:
        if isinstance(event, EvSynchronizing):
            self._push_event(Synchronizing(addr=addr, total=event.total, count=event.count))
        elif isinstance(event, EvNetworkInterrupted):
            self._push_event(
                NetworkInterrupted(addr=addr, disconnect_timeout_ms=event.disconnect_timeout_ms)
            )
        elif isinstance(event, EvNetworkResumed):
            self._push_event(NetworkResumed(addr=addr))
        elif isinstance(event, EvSynchronized):
            self._check_initial_sync()
            self._push_event(Synchronized(addr=addr))
        elif isinstance(event, EvDisconnected):
            for handle in player_handles:
                last_frame = (
                    self.local_connect_status[handle].last_frame
                    if handle < self.num_players
                    else NULL_FRAME  # spectator
                )
                self._disconnect_player_at_frame(handle, last_frame)
            self._push_event(Disconnected(addr=addr))
        elif isinstance(event, EvInput):
            player, inp = event.player, event.input
            assert player < self.num_players
            if not self.local_connect_status[player].disconnected:
                current_remote_frame = self.local_connect_status[player].last_frame
                assert (
                    current_remote_frame == NULL_FRAME
                    or current_remote_frame + 1 == inp.frame
                ), "remote input arrived out of sequence"
                self.local_connect_status[player].last_frame = inp.frame
                self.sync_layer.add_remote_input(player, inp)

    def _push_event(self, event: Event) -> None:
        self.event_queue.append(event)
        while len(self.event_queue) > MAX_EVENT_QUEUE_SIZE:
            self.event_queue.popleft()

    # ------------------------------------------------------------------
    # desync detection
    # ------------------------------------------------------------------

    def _check_checksum_send_interval(self, confirmed_frame: Frame) -> None:
        interval = self.desync_detection.interval
        current = self.sync_layer.current_frame
        # Flush BEFORE capturing this tick's observation: a report captured
        # at tick t covers a frame whose *correcting* rollback may still be
        # in tick t's (unfulfilled) request list — PendingChecksumReport
        # reads the value on a later tick, once the cell is final.
        force = current % interval == interval - 1
        if self.checksum_publish == "interval" and not force:
            # deterministic publish: bind and prefetch only, emission waits
            # for the forced tick
            self._pending_checksum_report.bind_and_prefetch()
        elif self._pending_checksum_report.flush(force=force, emit=self._emit_checksum_report):
            self.drain_blocked_ticks += 1
        # last_saved - 1 can be a *speculative* frame under misprediction,
        # and both peers would checksum half-predicted states and raise
        # false desyncs: only frames <= confirmed_frame are bit-identical
        # across peers by construction, so clamp to that.
        frame_to_send = min(self.sync_layer.last_saved_frame - 1, confirmed_frame)
        if current % interval == 0 and frame_to_send > self.max_prediction:
            cell = self.sync_layer.saved_state_by_frame(frame_to_send)
            # the confirmed frame may have rotated out of the snapshot ring
            if cell is not None:
                self._pending_checksum_report.capture(
                    frame_to_send, cell, serial=self._advance_serial
                )
        if len(self.local_checksum_history) > MAX_CHECKSUM_HISTORY_SIZE:
            keep_after = current - MAX_CHECKSUM_HISTORY_SIZE
            self.local_checksum_history = {
                f: c for f, c in self.local_checksum_history.items() if f > keep_after
            }

    def _emit_checksum_report(self, frame: Frame, checksum: int) -> None:
        for endpoint in self.player_reg.remotes.values():
            endpoint.send_checksum_report(frame, checksum)
        self.local_checksum_history[frame] = checksum

    def _compare_local_checksums_against_peers(self) -> None:
        if self.sync_layer.current_frame % self.desync_detection.interval != 0:
            return
        for endpoint in self.player_reg.remotes.values():
            for remote_frame, remote_checksum in endpoint.checksum_history.items():
                local = self.local_checksum_history.get(remote_frame)
                if local is not None and local != remote_checksum:
                    self._push_event(
                        DesyncDetected(
                            frame=remote_frame,
                            local_checksum=local,
                            remote_checksum=remote_checksum,
                            addr=endpoint.peer_addr,
                        )
                    )
