"""ggrs_tpu_torch: the PyTorch + CUDA port of ggrs_tpu's device path.

Slice 1 holds the fused SyncTest loop for the ex_game family: the
`DeviceSyncTestSession` with its hand-written CUDA kernels (K1 whole-batch,
K2 entity-tiled) and their plain PyTorch versions. Slice 2 holds the
request path: a host `SyncTestSession` (built by `SessionBuilder`) emits
Save/Load/Advance requests, and `DeviceRollbackBackend` fulfils each tick
as one dispatch of `ResimCore`'s packed control-word tick (K3). Slice 3
adds beam speculation (K4). Slice 4 adds the arena family (`Arena`, with a
per-team cross-entity reduction every frame) on the fused SyncTest path:
K1 with grid barriers, and the injected-reduction route of K5 (the
reduction table) and K2; slice 5 puts arena on the request path and in the
beam (K3, K4). Slice 6 adds the third family, `Swarm` (3-D drones with a
battery, seven planes), in K1-K4 on every path, and lifts the arena
kernels' 16-player cap. Slice 7 adds K2's inline whole-world arena route
(`backend="cuda-tiled"` on arena, and "auto" past the reference's
estimate) and durable checkpoints: `DeviceSyncTestSession.save`/`restore`
and `DeviceRollbackBackend.save`/`restore` write and read the reference's
.npz format (`utils/checkpoint.py`), so either stack resumes the other's
files. Slice 12 adds the P2P and spectator sessions with their network
stack (`network/`: the wire codec, UDP and in-memory sockets, the per-peer
protocol endpoint): `SessionBuilder().start_p2p_session(socket)` and
`.start_spectator_session(host_addr, socket)` emit the reference's request
streams and wire bytes, and a `DeviceRollbackBackend` fulfils them (K3 on
every dispatch, K4 with the beam). Slice 13 adds the cross-session
megabatch core, `MultiSessionDeviceCore` (N session worlds stacked on the
card, each megabatch one launch of K3's stacked entry), and the solo
backend's async pipeline (`DeviceRollbackBackend(async_dispatch=True)`:
pooled pinned staging behind a CUDA-event fence, `DispatchPlanCache`,
`InflightFence`). The package imports torch and numpy,
never jax and nothing of `ggrs_tpu`; its entry points run on CUDA unless
the caller passes device="cpu".
"""

from .device.backend import DeviceRollbackBackend, DispatchPlanCache, InflightFence, SnapshotRef
from .device.multi_session import MultiSessionDeviceCore
from .device.resim import ResimCore
from .device.sync_test import DeviceSyncTestSession
from .errors import (
    CheckpointIncompatible,
    ConfigError,
    ContractViolation,
    GGRSError,
    InvalidRequest,
    KernelError,
    MigrationIncompatible,
    MismatchedChecksum,
    NotSynchronized,
    PredictionThreshold,
    RegistryMiss,
    SpectatorTooFarBehind,
    StatsWindowTooYoung,
    TypeContractError,
)
from .frame_info import GameState, PlayerInput
from .models.arena import Arena
from .models.ex_game import ExGame
from .models.swarm import Swarm
from .sessions.builder import SessionBuilder
from .sessions.sync_test_session import SyncTestSession
from .sync_layer import ConnectionStatus, GameStateCell
from .types import (
    NULL_FRAME,
    AdvanceFrame,
    DesyncDetected,
    DesyncDetection,
    Disconnected,
    Frame,
    InputStatus,
    LoadGameState,
    NetworkInterrupted,
    NetworkResumed,
    PlayerHandle,
    PlayerType,
    SaveGameState,
    SessionState,
    Synchronized,
    Synchronizing,
    WaitRecommendation,
)

__all__ = [
    "NULL_FRAME",
    "AdvanceFrame",
    "Arena",
    "CheckpointIncompatible",
    "ConfigError",
    "ConnectionStatus",
    "ContractViolation",
    "DesyncDetected",
    "DesyncDetection",
    "DeviceRollbackBackend",
    "DeviceSyncTestSession",
    "DispatchPlanCache",
    "Disconnected",
    "ExGame",
    "Frame",
    "GGRSError",
    "GameState",
    "GameStateCell",
    "InflightFence",
    "InputStatus",
    "InvalidRequest",
    "KernelError",
    "LoadGameState",
    "MigrationIncompatible",
    "MismatchedChecksum",
    "MultiSessionDeviceCore",
    "NetworkInterrupted",
    "NetworkResumed",
    "NotSynchronized",
    "PlayerHandle",
    "PlayerInput",
    "PlayerType",
    "PredictionThreshold",
    "RegistryMiss",
    "ResimCore",
    "SaveGameState",
    "SessionBuilder",
    "SessionState",
    "SnapshotRef",
    "SpectatorTooFarBehind",
    "StatsWindowTooYoung",
    "Swarm",
    "SyncTestSession",
    "Synchronized",
    "Synchronizing",
    "TypeContractError",
    "WaitRecommendation",
]
