"""Fluent session builder, SyncTest part: the reference's
`sessions/builder.py` knobs a SyncTest session reads, with the reference's
defaults and validation errors. The P2P and spectator sessions come with
the port's P2P slice."""

from __future__ import annotations

from ..errors import InvalidRequest
from .sync_test_session import SyncTestSession

DEFAULT_PLAYERS = 2
DEFAULT_INPUT_DELAY = 0
DEFAULT_MAX_PREDICTION_FRAMES = 8
DEFAULT_CHECK_DISTANCE = 2


class SessionBuilder:
    """Builds a SyncTest session. `input_size` is the POD input contract:
    every player's input is exactly this many bytes per frame."""

    def __init__(self, input_size: int = 1):
        if input_size < 1:
            raise InvalidRequest("input_size must be at least 1 byte")
        self.input_size = input_size
        self.num_players = DEFAULT_PLAYERS
        self.max_prediction = DEFAULT_MAX_PREDICTION_FRAMES
        self.input_delay = DEFAULT_INPUT_DELAY
        self.check_distance = DEFAULT_CHECK_DISTANCE
        self.deferred_checksum_lag = 0
        self.device_checksum_verification = False

    def with_num_players(self, num_players: int) -> "SessionBuilder":
        self.num_players = num_players
        return self

    def with_max_prediction_window(self, window: int) -> "SessionBuilder":
        if window == 0:
            raise InvalidRequest("Only prediction windows above 0 are supported.")
        self.max_prediction = window
        return self

    def with_input_delay(self, delay: int) -> "SessionBuilder":
        self.input_delay = delay
        return self

    def with_check_distance(self, check_distance: int) -> "SessionBuilder":
        self.check_distance = check_distance
        return self

    def with_deferred_checksum_verification(self, lag: int) -> "SessionBuilder":
        """Compare checksum observations `lag` ticks late, in bursts of one
        batched device->host transfer. Mismatches still raise, at most
        `lag` ticks later. 0 keeps the eager per-tick compare."""
        if lag < 0:
            raise InvalidRequest("Deferred checksum lag cannot be negative.")
        self.deferred_checksum_lag = lag
        return self

    def with_device_checksum_verification(self, enabled: bool = True) -> "SessionBuilder":
        """Skip the host-side checksum comparison entirely and delegate the
        verdict to the fulfilling backend (DeviceRollbackBackend(
        device_verify=True) keeps the first-seen history and mismatch latch
        on the device; read it with backend.check()). The session's forced
        rollbacks are unchanged."""
        self.device_checksum_verification = enabled
        return self

    def start_synctest_session(self) -> SyncTestSession:
        if self.check_distance >= self.max_prediction:
            raise InvalidRequest("Check distance too big.")
        return SyncTestSession(
            self.num_players,
            self.max_prediction,
            self.check_distance,
            self.input_delay,
            self.input_size,
            deferred_checksum_lag=self.deferred_checksum_lag,
            host_verification=not self.device_checksum_verification,
        )
