"""Rollback bookkeeping: snapshot ring + per-player input queues (the
reference's `sync_layer.py`, copied without its telemetry, its native input
queues and the P2P-only pending checksum reports).

The snapshot ring holds ``max_prediction + 2`` cells addressed by
``frame % len``; save/load are *requests* fulfilled by the caller, so state
stays opaque — a user object on a host path, or a device ring slot handle
on the device backend (`ggrs_tpu_torch.device.backend`).
"""

from __future__ import annotations

import threading
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
