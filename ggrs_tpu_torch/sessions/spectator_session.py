"""Passive replica session: receives confirmed inputs from a host and
advances, catching up when too far behind (the reference's
`sessions/spectator_session.py`, copied on its per-session poll; left out:
the batched pump, the fleet plane and telemetry). A session attached to a
`serve.SessionHost` skips its own poll in `advance_frame`: the host pumped
it this tick.

A 60-frame input ring, the catch-up policy, PredictionThreshold when input
hasn't arrived and SpectatorTooFarBehind when the ring was overwritten.
Spectators never save, load or roll back: their requests are AdvanceFrame
only, one a tick or `catchup_speed` in a burst.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Deque, List

from ..errors import InvalidRequest, NotSynchronized, PredictionThreshold, SpectatorTooFarBehind
from ..frame_info import PlayerInput
from ..network.network_stats import NetworkStats
from ..network.protocol import (
    EvDisconnected,
    EvInput,
    EvNetworkInterrupted,
    EvNetworkResumed,
    EvSynchronized,
    EvSynchronizing,
    PeerEndpoint,
)
from ..sync_layer import ConnectionStatus
from ..types import (
    NULL_FRAME,
    AdvanceFrame,
    Disconnected,
    Event,
    Frame,
    InputStatus,
    NetworkInterrupted,
    NetworkResumed,
    Request,
    SessionState,
    Synchronized,
    Synchronizing,
)

from .builder import MAX_EVENT_QUEUE_SIZE, SPECTATOR_BUFFER_SIZE

NORMAL_SPEED = 1


class SpectatorSession:
    def __init__(
        self,
        num_players: int,
        socket: Any,
        host: PeerEndpoint,
        max_frames_behind: int,
        catchup_speed: int,
        input_size: int,
    ):
        self.state = SessionState.SYNCHRONIZING
        self.num_players = num_players
        self.input_size = input_size
        self.inputs: List[List[PlayerInput]] = [
            [PlayerInput.blank(NULL_FRAME, input_size) for _ in range(num_players)]
            for _ in range(SPECTATOR_BUFFER_SIZE)
        ]
        self.host_connect_status = [ConnectionStatus() for _ in range(num_players)]
        self.socket = socket
        self.host = host
        self.event_queue: Deque[Event] = deque()
        self.current_frame: Frame = NULL_FRAME
        self.last_recv_frame: Frame = NULL_FRAME
        self.max_frames_behind = max_frames_behind
        self.catchup_speed = catchup_speed
        self._host = None
        self._host_key = None

    def on_host_attach(self, host: Any, key: Any) -> None:
        """SessionHost.attach hook; see P2PSession.on_host_attach."""
        if self._host is not None:
            raise InvalidRequest(f"session already attached to a host (key={self._host_key!r})")
        self._host = host
        self._host_key = key

    def on_host_detach(self) -> None:
        self._host = None
        self._host_key = None

    @property
    def host_key(self) -> Any:
        return self._host_key

    def current_state(self) -> SessionState:
        return self.state

    def frames_behind_host(self) -> int:
        diff = self.last_recv_frame - self.current_frame
        assert diff >= 0
        return diff

    def network_stats(self) -> NetworkStats:
        return self.host.network_stats()

    def events(self) -> List[Event]:
        out = list(self.event_queue)
        self.event_queue.clear()
        return out

    def advance_frame(self) -> List[Request]:
        """One frame, or `catchup_speed` frames when more than
        `max_frames_behind` behind the host. A hosted session skips the
        pump: its host drained the socket this tick."""
        if self._host is None:
            self.poll_remote_clients()
        if self.state != SessionState.RUNNING:
            raise NotSynchronized()

        requests: List[Request] = []
        frames_to_advance = (
            self.catchup_speed
            if self.frames_behind_host() > self.max_frames_behind
            else NORMAL_SPEED
        )
        for _ in range(frames_to_advance):
            frame_to_grab = self.current_frame + 1
            synced_inputs = self._inputs_at_frame(frame_to_grab)
            requests.append(AdvanceFrame(inputs=synced_inputs))
            # only advance if grabbing the inputs succeeded
            self.current_frame += 1
        return requests

    def poll_remote_clients(self) -> None:
        """Message pump: one decode and one handle_message per datagram
        from the host, then the host endpoint's timers, events and sends."""
        for from_addr, msg in self.socket.receive_all_messages():
            if self.host.is_handling_message(from_addr):
                self.host.handle_message(msg)
        addr = self.host.peer_addr
        for event in self.host.poll(self.host_connect_status, self.host.clock.now_ms()):
            self._handle_event(event, addr)
        self.host.send_all_messages(self.socket)

    def _inputs_at_frame(self, frame_to_grab: Frame):
        player_inputs = self.inputs[frame_to_grab % SPECTATOR_BUFFER_SIZE]
        if player_inputs[0].frame < frame_to_grab:
            raise PredictionThreshold()  # host input not here yet; wait
        if player_inputs[0].frame > frame_to_grab:
            raise SpectatorTooFarBehind()  # ring overwritten; unrecoverable

        out = []
        for handle, player_input in enumerate(player_inputs):
            if (
                self.host_connect_status[handle].disconnected
                and self.host_connect_status[handle].last_frame < frame_to_grab
            ):
                out.append((player_input.buf, InputStatus.DISCONNECTED))
            else:
                out.append((player_input.buf, InputStatus.CONFIRMED))
        return out

    def _handle_event(self, event: Any, addr: Any) -> None:
        if isinstance(event, EvSynchronizing):
            self._push_event(Synchronizing(addr=addr, total=event.total, count=event.count))
        elif isinstance(event, EvNetworkInterrupted):
            self._push_event(
                NetworkInterrupted(addr=addr, disconnect_timeout_ms=event.disconnect_timeout_ms)
            )
        elif isinstance(event, EvNetworkResumed):
            self._push_event(NetworkResumed(addr=addr))
        elif isinstance(event, EvSynchronized):
            self.state = SessionState.RUNNING
            self._push_event(Synchronized(addr=addr))
        elif isinstance(event, EvDisconnected):
            self._push_event(Disconnected(addr=addr))
        elif isinstance(event, EvInput):
            inp = event.input
            # a buggy or hostile endpoint must not index out of range or
            # rewind the ring
            if event.player < 0 or event.player >= self.num_players or inp.frame < 0:
                return
            if inp.frame < self.last_recv_frame:
                return
            self.inputs[inp.frame % SPECTATOR_BUFFER_SIZE][event.player] = inp
            self.last_recv_frame = inp.frame
            self.host.update_local_frame_advantage(inp.frame)
            for i in range(self.num_players):
                self.host_connect_status[i] = ConnectionStatus(
                    self.host.peer_connect_status[i].disconnected,
                    self.host.peer_connect_status[i].last_frame,
                )
        self._trim_events()

    def _push_event(self, event: Event) -> None:
        self.event_queue.append(event)
        self._trim_events()

    def _trim_events(self) -> None:
        while len(self.event_queue) > MAX_EVENT_QUEUE_SIZE:
            self.event_queue.popleft()
