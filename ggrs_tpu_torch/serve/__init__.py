"""The serving layer: `SessionHost` (many sessions on one shared
`MultiSessionDeviceCore`, dispatch-per-tick megabatches or the
device-resident loop) and its seeded load generator (`loadgen`)."""

from .host import SessionHost

__all__ = ["SessionHost"]
