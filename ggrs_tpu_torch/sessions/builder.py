"""Fluent session builder holding every runtime knob of the SyncTest, P2P
and spectator sessions, with the reference's defaults and validation
errors (the reference's `sessions/builder.py`; left out: its native
queue, endpoint and session knobs)."""

from __future__ import annotations

from typing import Any, Dict

from ..errors import InvalidRequest
from ..types import DesyncDetection, PlayerHandle, PlayerType, PlayerTypeKind
from .sync_test_session import SyncTestSession

DEFAULT_PLAYERS = 2
DEFAULT_INPUT_DELAY = 0
DEFAULT_DISCONNECT_TIMEOUT_MS = 2000
DEFAULT_DISCONNECT_NOTIFY_START_MS = 500
DEFAULT_FPS = 60
DEFAULT_MAX_PREDICTION_FRAMES = 8
DEFAULT_CHECK_DISTANCE = 2
DEFAULT_MAX_FRAMES_BEHIND = 10
DEFAULT_CATCHUP_SPEED = 1
SPECTATOR_BUFFER_SIZE = 60
MAX_EVENT_QUEUE_SIZE = 100


class SessionBuilder:
    """Builds every session type. `input_size` is the POD input contract:
    every player's input is exactly this many bytes per frame."""

    def __init__(self, input_size: int = 1):
        if input_size < 1:
            raise InvalidRequest("input_size must be at least 1 byte")
        self.input_size = input_size
        self.num_players = DEFAULT_PLAYERS
        self.max_prediction = DEFAULT_MAX_PREDICTION_FRAMES
        self.fps = DEFAULT_FPS
        self.sparse_saving = False
        self.desync_detection = DesyncDetection.off()
        self.disconnect_timeout_ms = DEFAULT_DISCONNECT_TIMEOUT_MS
        self.disconnect_notify_start_ms = DEFAULT_DISCONNECT_NOTIFY_START_MS
        self.input_delay = DEFAULT_INPUT_DELAY
        self.check_distance = DEFAULT_CHECK_DISTANCE
        self.max_frames_behind = DEFAULT_MAX_FRAMES_BEHIND
        self.catchup_speed = DEFAULT_CATCHUP_SPEED
        self.handles: Dict[PlayerHandle, PlayerType] = {}
        self._local_players = 0
        self.clock = None  # optional injected Clock for deterministic runs
        self.rng = None  # optional injected random.Random for endpoint magics
        self.deferred_checksum_lag = 0
        self.device_checksum_verification = False

    # ------------------------------------------------------------------
    # fluent setters
    # ------------------------------------------------------------------

    def add_player(self, player_type: PlayerType, player_handle: PlayerHandle) -> "SessionBuilder":
        if player_handle in self.handles:
            raise InvalidRequest("Player handle already in use.")
        if player_type.kind in (PlayerTypeKind.LOCAL, PlayerTypeKind.REMOTE):
            if player_handle >= self.num_players:
                raise InvalidRequest(
                    "For a player, the handle should be between 0 and num_players."
                )
            if player_type.kind == PlayerTypeKind.LOCAL:
                self._local_players += 1
        else:
            if player_handle < self.num_players:
                raise InvalidRequest(
                    "For a spectator, the handle should be num_players or higher."
                )
        self.handles[player_handle] = player_type
        return self

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

    def with_fps(self, fps: int) -> "SessionBuilder":
        if fps == 0:
            raise InvalidRequest("FPS should be higher than 0.")
        self.fps = fps
        return self

    def with_sparse_saving_mode(self, sparse_saving: bool) -> "SessionBuilder":
        self.sparse_saving = sparse_saving
        return self

    def with_desync_detection_mode(self, mode: DesyncDetection) -> "SessionBuilder":
        self.desync_detection = mode
        return self

    def with_disconnect_timeout(self, timeout_ms: int) -> "SessionBuilder":
        self.disconnect_timeout_ms = timeout_ms
        return self

    def with_disconnect_notify_delay(self, notify_delay_ms: int) -> "SessionBuilder":
        self.disconnect_notify_start_ms = notify_delay_ms
        return self

    def with_check_distance(self, check_distance: int) -> "SessionBuilder":
        self.check_distance = check_distance
        return self

    def with_max_frames_behind(self, max_frames_behind: int) -> "SessionBuilder":
        if max_frames_behind < 1:
            raise InvalidRequest("Max frames behind cannot be smaller than 1.")
        if max_frames_behind >= SPECTATOR_BUFFER_SIZE:
            raise InvalidRequest(
                "Max frames behind cannot be larger or equal than the spectator buffer size."
            )
        self.max_frames_behind = max_frames_behind
        return self

    def with_catchup_speed(self, catchup_speed: int) -> "SessionBuilder":
        if catchup_speed < 1:
            raise InvalidRequest("Catchup speed cannot be smaller than 1.")
        if catchup_speed >= self.max_frames_behind:
            raise InvalidRequest(
                "Catchup speed cannot be larger or equal than the allowed maximum frames behind."
            )
        self.catchup_speed = catchup_speed
        return self

    def with_clock(self, clock) -> "SessionBuilder":
        """Inject a Clock (e.g. FakeClock) driving all endpoint timers."""
        self.clock = clock
        return self

    def with_rng(self, rng) -> "SessionBuilder":
        """Inject a seeded random.Random for endpoint magics/nonces."""
        self.rng = rng
        return self

    def with_deferred_checksum_verification(self, lag: int) -> "SessionBuilder":
        """SyncTest: compare checksum observations `lag` ticks late, in
        bursts of one batched device->host transfer. Mismatches still
        raise, at most `lag` ticks later. 0 keeps the eager per-tick
        compare."""
        if lag < 0:
            raise InvalidRequest("Deferred checksum lag cannot be negative.")
        self.deferred_checksum_lag = lag
        return self

    def with_device_checksum_verification(self, enabled: bool = True) -> "SessionBuilder":
        """SyncTest: skip the host-side checksum comparison entirely and
        delegate the verdict to the fulfilling backend
        (DeviceRollbackBackend(device_verify=True) keeps the first-seen
        history and mismatch latch on the device; read it with
        backend.check()). The session's forced rollbacks are unchanged."""
        self.device_checksum_verification = enabled
        return self

    # ------------------------------------------------------------------
    # session constructors
    # ------------------------------------------------------------------

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

    def start_p2p_session(self, socket: Any):
        """A P2P session over `socket`: one endpoint per remote or spectator
        address, every handle up to num_players registered first."""
        from .p2p_session import P2PSession, PlayerRegistry

        for handle in range(self.num_players):
            if handle not in self.handles:
                raise InvalidRequest(
                    "Not enough players have been added. Keep registering players "
                    "up to the defined player number."
                )

        registry = PlayerRegistry(dict(self.handles))
        # group handles by unique remote address; one endpoint per address
        by_addr: Dict[Any, list] = {}
        spec_by_addr: Dict[Any, list] = {}
        for handle, ptype in self.handles.items():
            if ptype.kind == PlayerTypeKind.REMOTE:
                by_addr.setdefault(ptype.addr, []).append(handle)
            elif ptype.kind == PlayerTypeKind.SPECTATOR:
                spec_by_addr.setdefault(ptype.addr, []).append(handle)

        for addr, handles in by_addr.items():
            registry.remotes[addr] = self._create_endpoint(handles, addr, self._local_players)
        for addr, handles in spec_by_addr.items():
            # the host of a spectator sends inputs for all players
            registry.spectators[addr] = self._create_endpoint(handles, addr, self.num_players)

        return P2PSession(
            num_players=self.num_players,
            max_prediction=self.max_prediction,
            socket=socket,
            players=registry,
            sparse_saving=self.sparse_saving,
            desync_detection=self.desync_detection,
            input_delay=self.input_delay,
            input_size=self.input_size,
        )

    def start_spectator_session(self, host_addr: Any, socket: Any):
        """A spectator of the P2P session at `host_addr`, over `socket`."""
        from .spectator_session import SpectatorSession

        # local_players is irrelevant: spectators never send inputs
        host = self._create_endpoint(list(range(self.num_players)), host_addr, 1)
        return SpectatorSession(
            num_players=self.num_players,
            socket=socket,
            host=host,
            max_frames_behind=self.max_frames_behind,
            catchup_speed=self.catchup_speed,
            input_size=self.input_size,
        )

    def _create_endpoint(self, handles, peer_addr, local_players):
        from ..network.protocol import PeerEndpoint

        endpoint = PeerEndpoint(
            handles=handles,
            peer_addr=peer_addr,
            num_players=self.num_players,
            local_players=local_players,
            max_prediction=self.max_prediction,
            disconnect_timeout_ms=self.disconnect_timeout_ms,
            disconnect_notify_start_ms=self.disconnect_notify_start_ms,
            fps=self.fps,
            input_size=self.input_size,
            clock=self.clock,
            rng=self.rng,
        )
        endpoint.synchronize()
        return endpoint
