"""Core types the port needs, copied from the reference's session layer
(the port keeps its own copies and imports nothing of `ggrs_tpu`): session
states, player types, the desync-detection config, the per-input status
enum, frames and player handles, the events a P2P or spectator session
reports, and the three requests a session emits for its rollback backend
to fulfil in order. Left out: the events' flight-recorder mixin
(`SessionEvent.kind`/`to_dict`), as the port has no telemetry."""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Any, Sequence, Tuple, Union

# -1 represents no frame / an invalid frame.
NULL_FRAME: int = -1

Frame = int
PlayerHandle = int


class SessionState(enum.Enum):
    """State of a session."""

    SYNCHRONIZING = "synchronizing"
    RUNNING = "running"


class InputStatus(enum.IntEnum):
    """Status delivered alongside every player input.

    IntEnum so device code can embed it directly in int32 tensors.
    """

    CONFIRMED = 0
    PREDICTED = 1
    DISCONNECTED = 2


class PlayerTypeKind(enum.Enum):
    LOCAL = "local"
    REMOTE = "remote"
    SPECTATOR = "spectator"


@dataclass(frozen=True)
class PlayerType:
    """Local player, remote player or spectator.

    ``addr`` is the opaque, hashable transport address for remote
    players/spectators; it is None for local players.
    """

    kind: PlayerTypeKind
    addr: Any = None

    @staticmethod
    def local() -> "PlayerType":
        return PlayerType(PlayerTypeKind.LOCAL)

    @staticmethod
    def remote(addr: Any) -> "PlayerType":
        return PlayerType(PlayerTypeKind.REMOTE, addr)

    @staticmethod
    def spectator(addr: Any) -> "PlayerType":
        return PlayerType(PlayerTypeKind.SPECTATOR, addr)


@dataclass(frozen=True)
class DesyncDetection:
    """Checksum-exchange desync detection config."""

    enabled: bool = False
    interval: int = 0

    @staticmethod
    def off() -> "DesyncDetection":
        return DesyncDetection(False, 0)

    @staticmethod
    def on(interval: int) -> "DesyncDetection":
        return DesyncDetection(True, interval)


# ---------------------------------------------------------------------------
# Events a P2P or spectator session reports (read with `session.events()`)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Synchronizing:
    addr: Any
    total: int
    count: int


@dataclass(frozen=True)
class Synchronized:
    addr: Any


@dataclass(frozen=True)
class Disconnected:
    addr: Any


@dataclass(frozen=True)
class NetworkInterrupted:
    addr: Any
    disconnect_timeout_ms: int


@dataclass(frozen=True)
class NetworkResumed:
    addr: Any


@dataclass(frozen=True)
class WaitRecommendation:
    skip_frames: int


@dataclass(frozen=True)
class DesyncDetected:
    frame: Frame
    local_checksum: int
    remote_checksum: int
    addr: Any


Event = Union[
    Synchronizing,
    Synchronized,
    Disconnected,
    NetworkInterrupted,
    NetworkResumed,
    WaitRecommendation,
    DesyncDetected,
]


# ---------------------------------------------------------------------------
# Requests. Sessions never call user code: advance_frame() returns an
# order-sensitive list of requests that the caller (or a rollback backend
# such as ggrs_tpu_torch.device.backend.DeviceRollbackBackend) must fulfil
# in the exact order given.
# ---------------------------------------------------------------------------


@dataclass
class SaveGameState:
    cell: "GameStateCell"  # noqa: F821 - defined in sync_layer
    frame: Frame


@dataclass
class LoadGameState:
    cell: "GameStateCell"  # noqa: F821
    frame: Frame


@dataclass
class AdvanceFrame:
    # one (input_bytes, status) pair per player, ascending handle order
    inputs: Sequence[Tuple[bytes, InputStatus]]


Request = Any  # union of the request dataclasses above
