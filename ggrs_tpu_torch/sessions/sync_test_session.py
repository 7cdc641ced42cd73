"""Determinism harness: forced rollback + checksum comparison every frame
(the reference's `sessions/sync_test_session.py`, copied without its
telemetry).

Each tick, roll back `check_distance` frames, resimulate, and compare the
resimulated checksums against the first-recorded history. The session emits
Save/Load/Advance requests; a rollback backend such as
`ggrs_tpu_torch.device.backend.DeviceRollbackBackend` fulfils them.
"""

from __future__ import annotations

from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

from ..errors import InvalidRequest, MismatchedChecksum
from ..frame_info import PlayerInput
from ..sync_layer import ConnectionStatus, SyncLayer
from ..types import AdvanceFrame, Frame, PlayerHandle, Request


class DeferredChecks:
    """Deferred checksum observations: capture lazy getters at tick t,
    verify them `lag` ticks later in bursts — one batched device->host
    transfer covering `lag` ticks of observations instead of a per-tick
    stall."""

    __slots__ = ("lag", "_pending")

    def __init__(self, lag: int):
        self.lag = lag
        self._pending: Deque[Tuple[int, Frame, object]] = deque()

    def __len__(self) -> int:
        return len(self._pending)

    def schedule(self, tick: int, frame: Frame, getter) -> None:
        self._pending.append((tick + self.lag, frame, getter))

    def drain_due(self, tick: int, verify) -> None:
        """verify(frame, getter) for every observation due by `tick`, then
        start background device->host copies for the observations due at
        the NEXT burst, so steady-state drains resolve from host memory."""
        while self._pending and self._pending[0][0] <= tick:
            _, frame, getter = self._pending.popleft()
            verify(frame, getter)
        self.prefetch_pending()

    def prefetch_pending(self) -> None:
        for _, _, getter in self._pending:
            prefetch = getattr(getter, "prefetch", None)
            if callable(prefetch):
                prefetch()

    def flush(self, verify) -> None:
        """Force every deferred comparison now (end of run / tests)."""
        while self._pending:
            _, frame, getter = self._pending.popleft()
            verify(frame, getter)


class SyncTestSession:
    def __init__(
        self,
        num_players: int,
        max_prediction: int,
        check_distance: int,
        input_delay: int,
        input_size: int,
        deferred_checksum_lag: int = 0,
        host_verification: bool = True,
    ):
        """`host_verification=False` delegates the checksum comparison
        entirely to the fulfilling backend (DeviceRollbackBackend
        device_verify mode keeps the first-seen history + verdict on the
        device; read it with backend.check()). The session still forces
        the per-tick rollback — only the host-side compare, and with it
        every device->host checksum transfer, is skipped."""
        self.num_players = num_players
        self.max_prediction = max_prediction
        self.check_distance = check_distance
        self.sync_layer = SyncLayer(num_players, max_prediction, input_size)
        for handle in range(num_players):
            self.sync_layer.set_frame_delay(handle, input_delay)
        self.dummy_connect_status = [ConnectionStatus() for _ in range(num_players)]
        # frame -> first recorded checksum (None allowed: user may omit them)
        self.checksum_history: Dict[Frame, Optional[int]] = {}
        self.local_inputs: Dict[PlayerHandle, PlayerInput] = {}
        # Deferred verification: with lag > 0, each tick's checksum
        # observations are captured as lazy getters and compared `lag`
        # ticks later, so a device backend never stalls the tick on a
        # device->host checksum transfer. Mismatches still raise
        # MismatchedChecksum, at most `lag` ticks late.
        self.deferred_checksum_lag = deferred_checksum_lag
        self.host_verification = host_verification
        self._pending_checks = DeferredChecks(deferred_checksum_lag)
        self._tick = 0

    def add_local_input(self, player_handle: PlayerHandle, buf: bytes) -> None:
        """All players are local in a sync test."""
        if player_handle >= self.num_players:
            raise InvalidRequest("The player handle you provided is not valid.")
        self.local_inputs[player_handle] = PlayerInput(self.sync_layer.current_frame, buf)

    def advance_frame(self) -> List[Request]:
        requests: List[Request] = []

        # Once deep enough into the game, compare checksums and force a
        # rollback of check_distance frames.
        self._tick += 1
        if self.check_distance > 0 and self.sync_layer.current_frame > self.check_distance:
            if not self.host_verification:
                pass  # the backend's device-side history is the referee
            elif self.deferred_checksum_lag > 0:
                self._schedule_checks()
                # Drain in bursts (not every tick): one burst = one batched
                # device->host transfer covering `lag` ticks of observations.
                if self._tick % self.deferred_checksum_lag == 0:
                    self._drain_due_checks()
            else:
                for i in range(self.check_distance + 1):
                    frame_to_check = self.sync_layer.current_frame - i
                    if not self._checksums_consistent(frame_to_check):
                        raise MismatchedChecksum(frame_to_check)

            frame_to = self.sync_layer.current_frame - self.check_distance
            self._adjust_gamestate(frame_to, requests)

        if len(self.local_inputs) != self.num_players:
            raise InvalidRequest("Missing local input while calling advance_frame().")
        for handle, inp in self.local_inputs.items():
            self.sync_layer.add_local_input(handle, inp)
        self.local_inputs.clear()

        if self.check_distance > 0:
            requests.append(self.sync_layer.save_current_state())

        inputs = self.sync_layer.synchronized_inputs(self.dummy_connect_status)
        requests.append(AdvanceFrame(inputs=inputs))
        self.sync_layer.advance_frame()

        # Fake confirmation at current - check_distance so the sync layer
        # never hits the prediction threshold.
        safe_frame = self.sync_layer.current_frame - self.check_distance
        self.sync_layer.set_last_confirmed_frame(safe_frame, False)
        for status in self.dummy_connect_status:
            status.last_frame = self.sync_layer.current_frame

        return requests

    # ------------------------------------------------------------------
    # deferred verification path
    # ------------------------------------------------------------------

    def _schedule_checks(self) -> None:
        """Capture this tick's checksum observations (the same cells the
        eager path would compare right now) for later verification."""
        for i in range(self.check_distance + 1):
            frame_to_check = self.sync_layer.current_frame - i
            cell = self.sync_layer.saved_state_by_frame(frame_to_check)
            if cell is None:
                continue
            self._pending_checks.schedule(self._tick, frame_to_check, cell.checksum_getter())

    def _drain_due_checks(self) -> None:
        self._pending_checks.drain_due(self._tick, self._verify_observation)
        # no future observation can reference frames this old
        oldest_live = self.sync_layer.current_frame - (
            self.check_distance + self.deferred_checksum_lag + 1
        )
        if self.checksum_history and min(self.checksum_history) < oldest_live:
            self.checksum_history = {
                f: c for f, c in self.checksum_history.items() if f >= oldest_live
            }

    def _verify_observation(self, frame: Frame, getter) -> None:
        checksum = getter()
        if frame in self.checksum_history:
            if self.checksum_history[frame] != checksum:
                raise MismatchedChecksum(frame)
        else:
            self.checksum_history[frame] = checksum

    def flush_checksum_checks(self) -> None:
        """Force every deferred comparison now (end of run / tests)."""
        if not self.host_verification:
            # a silent no-op here would make a mispaired run (device-verify
            # session + a backend without a device history) report success
            # having verified nothing — fail loudly instead
            raise InvalidRequest(
                "This session delegates verification to the backend "
                "(with_device_checksum_verification): read the verdict with "
                "backend.check(), not flush_checksum_checks()."
            )
        self._pending_checks.flush(self._verify_observation)

    def _checksums_consistent(self, frame_to_check: Frame) -> bool:
        oldest_allowed = self.sync_layer.current_frame - self.check_distance
        self.checksum_history = {
            f: c for f, c in self.checksum_history.items() if f >= oldest_allowed
        }
        cell = self.sync_layer.saved_state_by_frame(frame_to_check)
        if cell is None:
            return True
        if cell.frame in self.checksum_history:
            return self.checksum_history[cell.frame] == cell.checksum
        self.checksum_history[cell.frame] = cell.checksum
        return True

    def _adjust_gamestate(self, frame_to: Frame, requests: List[Request]) -> None:
        start_frame = self.sync_layer.current_frame
        count = start_frame - frame_to

        requests.append(self.sync_layer.load_frame(frame_to))
        self.sync_layer.reset_prediction()
        assert self.sync_layer.current_frame == frame_to

        for i in range(count):
            inputs = self.sync_layer.synchronized_inputs(self.dummy_connect_status)
            if i > 0:
                requests.append(self.sync_layer.save_current_state())
            self.sync_layer.advance_frame()
            requests.append(AdvanceFrame(inputs=inputs))
        assert self.sync_layer.current_frame == start_frame
