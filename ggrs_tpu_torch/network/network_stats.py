"""Connection-quality snapshot of one peer endpoint (the reference's
`network/network_stats.py`, copied).

Beyond send queue, ping, send rate and frame advantages it carries the
receive direction and link-quality estimates: `kbps_recv` (received payload
+ UDP header bytes over the stats window), `jitter_ms` (RFC 3550-style EWMA
of RTT variation) and `packets_lost` (estimated from gaps in the peer's
fixed-cadence quality-report stream).
"""

from __future__ import annotations

from dataclasses import dataclass

# IP + UDP header bytes per datagram, for kbps accounting
UDP_HEADER_SIZE = 28


@dataclass
class NetworkStats:
    send_queue_len: int = 0
    ping_ms: int = 0
    kbps_sent: int = 0
    local_frames_behind: int = 0
    remote_frames_behind: int = 0
    kbps_recv: int = 0
    jitter_ms: int = 0
    packets_lost: int = 0

    @classmethod
    def from_endpoint(cls, ep, seconds: int) -> "NetworkStats":
        """Rate the endpoint's counters over a `seconds`-long window.
        Validation (sync state, window age) stays with the caller."""
        total_sent = ep.bytes_sent + ep.packets_sent * UDP_HEADER_SIZE
        total_recv = ep.bytes_recv + ep.packets_recv * UDP_HEADER_SIZE
        return cls(
            send_queue_len=len(ep.pending_output),
            ping_ms=ep.round_trip_time,
            kbps_sent=(total_sent // int(seconds)) // 1024,
            local_frames_behind=ep.local_frame_advantage,
            remote_frames_behind=ep.remote_frame_advantage,
            kbps_recv=(total_recv // int(seconds)) // 1024,
            jitter_ms=int(round(ep.jitter_ms)),
            packets_lost=ep.packets_lost,
        )
