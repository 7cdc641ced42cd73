"""The typed errors of the port. `GGRSError`, `PredictionThreshold`,
`InvalidRequest`, `MismatchedChecksum`, `NotSynchronized`,
`StatsWindowTooYoung`, `SpectatorTooFarBehind`, `ConfigError`,
`DataFormatError`, `TypeContractError`,
`ContractViolation`, `RegistryMiss`, `CheckpointIncompatible`,
`ModelIncompatible` and `MigrationIncompatible` mirror the reference's classes, each with its stdlib
base kept; `KernelError` is the port's own, for a CUDA kernel that does not
build or whose launch is refused."""

from __future__ import annotations


class GGRSError(Exception):
    """Base class for all session errors."""


class PredictionThreshold(GGRSError):
    """The prediction window is exhausted; cannot accept more local input
    until remote input confirms older frames."""

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return "Prediction threshold is reached, cannot proceed without catching up."


class InvalidRequest(GGRSError):
    """Invalid API usage."""

    def __init__(self, info: str):
        super().__init__(info)
        self.info = info


class MismatchedChecksum(GGRSError):
    """Checksum mismatch during a SyncTest resimulation."""

    def __init__(self, frame: int, local: int | None = None, expected: int | None = None):
        super().__init__(f"Detected checksum mismatch during rollback on frame {frame}.")
        self.frame = frame
        self.local = local
        self.expected = expected


class MigrationIncompatible(InvalidRequest):
    """A slot's exported worlds cannot be imported here: another game
    config (state tree keys, shapes or dtypes), window or ring length. A
    subclass of InvalidRequest so catch-all admission handling keeps
    working, but typed so a router can tell 'pick another host' from
    'this payload is poison'."""


class NotSynchronized(GGRSError):
    """The session has not finished synchronizing with all remotes."""


class StatsWindowTooYoung(NotSynchronized):
    """network_stats() was called before the first full second of the stats
    window elapsed — the kbps figures would divide by zero. A subclass of
    NotSynchronized so catch-all callers keep working, but
    distinguishable: the endpoint IS synchronized, just too fresh to
    report rates."""


class SpectatorTooFarBehind(GGRSError):
    """The spectator fell further behind the host than its input buffer can
    cover; catching up is impossible."""


class ConfigError(GGRSError, ValueError):
    """Invalid configuration or argument value at a construction/setup
    seam (no CUDA device where one is required, an unknown backend, a
    tensor of the wrong device, dtype or shape). The ValueError face keeps
    stdlib-style callers working."""


class DataFormatError(GGRSError, ValueError):
    """Malformed bytes at a decode seam (a truncated varint, a bad RLE
    run). ValueError face preserved."""


class TypeContractError(GGRSError, TypeError):
    """A value of the wrong kind crossed an API seam (a non-request in a
    request list). TypeError face preserved."""


class ContractViolation(GGRSError, AssertionError):
    """An internal invariant a caller cannot trigger through the public
    API failed. AssertionError face preserved."""


class RegistryMiss(GGRSError, KeyError):
    """A name was looked up in a registry (plane adapters) that has no
    such entry. KeyError face preserved."""


class KernelError(GGRSError, RuntimeError):
    """A hand-written CUDA kernel failed to build, failed to load, or its
    launch returned a CUDA error. Never caught on the main path: there is
    no fallback to the plain version on a card."""


class CheckpointIncompatible(GGRSError):
    """A durable checkpoint cannot be restored here: its format version
    is newer than this build understands, its payload manifest does not
    match the file's contents (truncation/corruption), or its meta names
    a different core/game than the restore target. Carries both versions
    so the operator-facing message says which side to upgrade, instead of
    a shape error deep inside the restore."""

    def __init__(self, info: str, *, found=None, expected=None):
        detail = ""
        if found is not None or expected is not None:
            detail = f" (found={found!r}, expected={expected!r})"
        super().__init__(info + detail)
        self.info = info
        self.found = found
        self.expected = expected


class ModelIncompatible(CheckpointIncompatible):
    """An input-model state cannot be loaded here: its kind or its game
    identity (players, input size) differs from the target's. Carries both
    values so the message says which side is which."""
