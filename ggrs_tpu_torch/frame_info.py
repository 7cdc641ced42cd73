"""Per-frame snapshot and input records (the reference's `frame_info.py`,
copied: the port imports nothing of `ggrs_tpu`).

Inputs are fixed-size byte strings. A blank input is all-zero bytes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

from .types import NULL_FRAME, Frame


@dataclass
class GameState:
    """A saved snapshot record. ``data`` is opaque to the framework: a user
    object on a host path, or a device snapshot handle (`SnapshotRef`) on
    the device backend. ``checksum`` is optional and only consumed by
    SyncTest and desync detection."""

    frame: Frame = NULL_FRAME
    data: Any = None
    checksum: Optional[int] = None


@dataclass(frozen=True)
class PlayerInput:
    """One player's input for one frame."""

    frame: Frame
    buf: bytes

    @staticmethod
    def blank(frame: Frame, size: int) -> "PlayerInput":
        return PlayerInput(frame, bytes(size))

    def equal(self, other: "PlayerInput", input_only: bool) -> bool:
        return (input_only or self.frame == other.frame) and self.buf == other.buf
