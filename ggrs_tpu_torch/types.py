"""Core types the port needs, copied from the reference's session layer
(the port keeps its own copies and imports nothing of `ggrs_tpu`): the
per-input status enum, frames and player handles, and the three requests
a session emits for its rollback backend to fulfil in order."""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Any, Sequence, Tuple

# -1 represents no frame / an invalid frame.
NULL_FRAME: int = -1

Frame = int
PlayerHandle = int


class InputStatus(enum.IntEnum):
    """Status delivered alongside every player input.

    IntEnum so device code can embed it directly in int32 tensors.
    """

    CONFIRMED = 0
    PREDICTED = 1
    DISCONNECTED = 2


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
