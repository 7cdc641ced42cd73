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
files. The package imports torch and numpy, never jax and nothing of `ggrs_tpu`; its
entry points run on CUDA unless the caller passes device="cpu".
"""

from .device.backend import DeviceRollbackBackend, SnapshotRef
from .device.resim import ResimCore
from .device.sync_test import DeviceSyncTestSession
from .errors import (
    CheckpointIncompatible,
    ConfigError,
    ContractViolation,
    GGRSError,
    InvalidRequest,
    KernelError,
    MismatchedChecksum,
    PredictionThreshold,
    RegistryMiss,
    TypeContractError,
)
from .models.arena import Arena
from .models.ex_game import ExGame
from .models.swarm import Swarm
from .sessions.builder import SessionBuilder
from .sessions.sync_test_session import SyncTestSession
from .types import AdvanceFrame, InputStatus, LoadGameState, SaveGameState

__all__ = [
    "AdvanceFrame",
    "Arena",
    "CheckpointIncompatible",
    "ConfigError",
    "ContractViolation",
    "DeviceRollbackBackend",
    "DeviceSyncTestSession",
    "ExGame",
    "GGRSError",
    "InputStatus",
    "InvalidRequest",
    "KernelError",
    "LoadGameState",
    "MismatchedChecksum",
    "PredictionThreshold",
    "RegistryMiss",
    "ResimCore",
    "SaveGameState",
    "SessionBuilder",
    "SnapshotRef",
    "Swarm",
    "SyncTestSession",
    "TypeContractError",
]
