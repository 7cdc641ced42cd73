"""Rollback bookkeeping: snapshot ring + per-player input queues, and the
P2P session's deferred desync-detection reports (the reference's
`sync_layer.py`, copied without its telemetry, its native input queues and
the pickling hooks its fleet tickets use).

The snapshot ring holds ``max_prediction + 2`` cells addressed by
``frame % len``; save/load are *requests* fulfilled by the caller, so state
stays opaque — a user object on a host path, or a device ring slot handle
on the device backend (`ggrs_tpu_torch.device.backend`).
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, List, Optional, Sequence, Tuple

from .errors import PredictionThreshold
from .frame_info import GameState, PlayerInput
from .input_queue import InputQueue
from .types import (
    NULL_FRAME,
    Frame,
    InputStatus,
    LoadGameState,
    PlayerHandle,
    Request,
    SaveGameState,
)


class ConnectionStatus:
    """Connection status of one player as seen by one peer."""

    __slots__ = ("disconnected", "last_frame")

    def __init__(self, disconnected: bool = False, last_frame: Frame = NULL_FRAME):
        self.disconnected = disconnected
        self.last_frame = last_frame

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"ConnectionStatus(disconnected={self.disconnected}, last_frame={self.last_frame})"

    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, ConnectionStatus)
            and self.disconnected == other.disconnected
            and self.last_frame == other.last_frame
        )


class GameStateCell:
    """A shared, lockable snapshot slot handed to the user inside
    Save/Load requests."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._state = GameState()
        self._checksum_fn = None

    def save(self, frame: Frame, data: Any, checksum: Optional[int]) -> None:
        assert frame != NULL_FRAME
        with self._lock:
            self._state.frame = frame
            self._state.data = data
            self._state.checksum = checksum
            self._checksum_fn = None

    def save_lazy(self, frame: Frame, data: Any, checksum_fn) -> None:
        """Like save(), but the checksum is produced on demand. Used by the
        device backend so a tick doesn't block on a device->host transfer
        unless someone actually reads the checksum."""
        assert frame != NULL_FRAME
        with self._lock:
            self._state.frame = frame
            self._state.data = data
            self._state.checksum = None
            self._checksum_fn = checksum_fn

    def load(self) -> Any:
        with self._lock:
            return self._state.data

    @property
    def frame(self) -> Frame:
        with self._lock:
            return self._state.frame

    @property
    def checksum(self) -> Optional[int]:
        with self._lock:
            if self._checksum_fn is not None:
                self._state.checksum = self._checksum_fn()
                self._checksum_fn = None
            return self._state.checksum

    def checksum_getter(self):
        """Zero-arg callable producing this save's checksum, stable across
        later overwrites of the cell (ring slots are reused every ring_len
        frames). Lets callers defer the read — on the device backend
        forcing `checksum` waits on a device->host transfer."""
        with self._lock:
            if self._checksum_fn is not None:
                return self._checksum_fn
            value = self._state.checksum
            return lambda: value


class PendingChecksumReport:
    """Deferred desync-detection reports of a P2P session.

    Capture the *cell* at tick t; bind its checksum getter on the first
    flush attempt — one tick later at the earliest, once the capturing
    tick's requests are fulfilled and the cell holds the converged value
    (reading it in the same tick can publish a mid-correction checksum and
    raise false desyncs); then keep the getter, because getters are stable
    across later overwrites of the reused ring slot
    (GameStateCell.checksum_getter) while the cell itself is not.

    Several reports can be outstanding at once (a queue): they drain in
    capture (frame) order, emitting every host-ready value in one pass; a
    not-yet-ready head starts a background prefetch and stops the drain —
    nothing forces a device wait until `force` bounds the delay to one
    desync interval. Reports whose ring slot was reused before the first
    read are dropped."""

    # outstanding-report bound: ~two ring rotations of observations
    MAX_PENDING = 16

    __slots__ = ("_pending",)

    def __init__(self) -> None:
        self._pending = deque()

    def __len__(self) -> int:
        return len(self._pending)

    def capture(self, frame: Frame, cell: GameStateCell, serial: int = 0) -> None:
        """`serial` stamps the capturing tick (a monotonic advance
        counter): non-forced flushes can then skip entries whose
        capturing tick's requests may not be fulfilled yet (see
        `max_serial` below)."""
        self._pending.append([frame, cell, None, serial])
        while len(self._pending) > self.MAX_PENDING:
            self._pending.popleft()

    def _bind(self, max_serial: Optional[int]) -> None:
        """Bind a getter for every queued old-enough report (binding is
        cheap and non-blocking, and a younger report's slot can be
        overwritten while an older value is still in flight), dropping
        entries whose ring slot was reused before the first read."""
        bound = deque()
        for entry in self._pending:
            frame, cell, getter, serial = entry
            if getter is None:
                if max_serial is not None and serial > max_serial:
                    bound.append(entry)  # too fresh to bind yet
                    continue
                if cell.frame != frame:  # ring slot reused before read
                    continue
                entry[2] = cell.checksum_getter()
            bound.append(entry)
        self._pending = bound

    def bind_and_prefetch(self, max_serial: Optional[int] = None) -> None:
        """The resolve-only half of flush(), for the deterministic-publish
        mode (`checksum_publish = "interval"`): bind getters for every
        old-enough entry and start a background copy of the first one not
        ready, so the interval-forced flush finds the bytes moved — but
        emit nothing. A getter whose batch is not dispatched yet
        (`dispatch_pending`: its ticks still sit in a lazy buffer) is left
        alone, since prefetching it would force the dispatch."""
        self._bind(max_serial)
        for _frame, _cell, getter, _serial in self._pending:
            if getter is None:
                return
            if not getattr(getter, "ready", True):
                if not getattr(getter, "dispatch_pending", False):
                    prefetch = getattr(getter, "prefetch", None)
                    if callable(prefetch):
                        prefetch()
                return

    def flush(self, force: bool, emit, max_serial: Optional[int] = None) -> int:
        """emit(frame, checksum) is called at most once per captured report,
        in capture order. Returns the number of reports that were resolved
        while NOT host-ready — forced resolutions that waited on a device
        transfer.

        `max_serial` (pump-side, non-forced drains): only entries whose
        capture serial is <= it are bound/resolved — a report captured at
        tick t covers a frame whose *correcting* rollback may still sit
        in tick t's unfulfilled request list, so an opportunistic mid-run
        flush stays a couple of advances behind the capture frontier; the
        interval-forced flush passes None and drains everything."""
        self._bind(max_serial)
        blocked = 0
        while self._pending:
            frame, _cell, getter, serial = self._pending[0]
            if getter is None:  # still inside the serial guard
                return blocked
            if not getattr(getter, "ready", True):
                if not force:
                    prefetch = getattr(getter, "prefetch", None)
                    if callable(prefetch):
                        prefetch()
                    return blocked
                blocked += 1
            self._pending.popleft()
            checksum = getter()
            if checksum is not None:
                emit(frame, checksum)
        return blocked


class SavedStates:
    """Ring of snapshot cells; capacity max_prediction + 2 so the next frame
    has a slot while the full rollback distance stays loadable."""

    def __init__(self, max_prediction: int):
        self.states: List[GameStateCell] = [GameStateCell() for _ in range(max_prediction + 2)]

    def get_cell(self, frame: Frame) -> GameStateCell:
        assert frame >= 0
        return self.states[frame % len(self.states)]


class SyncLayer:
    def __init__(self, num_players: int, max_prediction: int, input_size: int):
        self.num_players = num_players
        self.max_prediction = max_prediction
        self.input_size = input_size
        self.saved_states = SavedStates(max_prediction)
        self.last_confirmed_frame: Frame = NULL_FRAME
        self._last_saved_frame: Frame = NULL_FRAME
        self.current_frame: Frame = 0
        self.input_queues = [InputQueue(input_size) for _ in range(num_players)]

    def advance_frame(self) -> None:
        self.current_frame += 1

    def save_current_state(self) -> Request:
        self._last_saved_frame = self.current_frame
        cell = self.saved_states.get_cell(self.current_frame)
        return SaveGameState(cell=cell, frame=self.current_frame)

    def set_frame_delay(self, player_handle: PlayerHandle, delay: int) -> None:
        assert player_handle < self.num_players
        self.input_queues[player_handle].set_frame_delay(delay)

    def reset_prediction(self) -> None:
        for q in self.input_queues:
            q.reset_prediction()

    def load_frame(self, frame_to_load: Frame) -> Request:
        assert (
            frame_to_load != NULL_FRAME
            and frame_to_load < self.current_frame
            and frame_to_load >= self.current_frame - self.max_prediction
        ), "tried to load a frame outside the rollback window"
        cell = self.saved_states.get_cell(frame_to_load)
        assert cell.frame == frame_to_load
        self.current_frame = frame_to_load
        return LoadGameState(cell=cell, frame=frame_to_load)

    def add_local_input(self, player_handle: PlayerHandle, inp: PlayerInput) -> Frame:
        """Prediction-threshold gate + queue insert. Raises
        PredictionThreshold when the speculation window is exhausted."""
        frames_ahead = self.current_frame - self.last_confirmed_frame
        if self.current_frame >= self.max_prediction and frames_ahead >= self.max_prediction:
            raise PredictionThreshold()
        assert inp.frame == self.current_frame
        return self.input_queues[player_handle].add_input(inp)

    def add_remote_input(self, player_handle: PlayerHandle, inp: PlayerInput) -> None:
        self.input_queues[player_handle].add_input(inp)

    def synchronized_inputs(
        self, connect_status: Sequence[ConnectionStatus]
    ) -> List[Tuple[bytes, InputStatus]]:
        """Inputs (confirmed or predicted) for the current frame; disconnected
        players yield zeroed dummies."""
        inputs: List[Tuple[bytes, InputStatus]] = []
        for i, status in enumerate(connect_status):
            if status.disconnected and status.last_frame < self.current_frame:
                inputs.append((bytes(self.input_size), InputStatus.DISCONNECTED))
            else:
                inputs.append(self.input_queues[i].input(self.current_frame))
        return inputs

    def confirmed_inputs(
        self, frame: Frame, connect_status: Sequence[ConnectionStatus]
    ) -> List[PlayerInput]:
        inputs: List[PlayerInput] = []
        for i, status in enumerate(connect_status):
            if status.disconnected and status.last_frame < frame:
                inputs.append(PlayerInput.blank(NULL_FRAME, self.input_size))
            else:
                inputs.append(self.input_queues[i].confirmed_input(frame))
        return inputs

    def set_last_confirmed_frame(self, frame: Frame, sparse_saving: bool) -> None:
        """Raise the confirmed watermark and drop inputs before it."""
        first_incorrect = NULL_FRAME
        for q in self.input_queues:
            first_incorrect = max(first_incorrect, q.first_incorrect_frame)

        if sparse_saving:
            frame = min(frame, self._last_saved_frame)

        assert first_incorrect == NULL_FRAME or first_incorrect >= frame, (
            "would discard inputs still needed for rollback"
        )
        self.last_confirmed_frame = frame
        if self.last_confirmed_frame > 0:
            for q in self.input_queues:
                q.discard_confirmed_frames(frame - 1)

    def check_simulation_consistency(self, first_incorrect: Frame) -> Frame:
        """Earliest misprediction across all queues."""
        for q in self.input_queues:
            incorrect = q.first_incorrect_frame
            if incorrect != NULL_FRAME and (
                first_incorrect == NULL_FRAME or incorrect < first_incorrect
            ):
                first_incorrect = incorrect
        return first_incorrect

    def saved_state_by_frame(self, frame: Frame) -> Optional[GameStateCell]:
        cell = self.saved_states.get_cell(frame)
        return cell if cell.frame == frame else None

    @property
    def last_saved_frame(self) -> Frame:
        return self._last_saved_frame
