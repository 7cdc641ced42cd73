"""Frame-advantage averaging for client speed throttling (the reference's
`time_sync.py`, copied without its telemetry histogram)."""

from __future__ import annotations

FRAME_WINDOW_SIZE = 30


class TimeSync:
    """Sliding windows of local/remote frame advantage; the average drives
    WaitRecommendation events."""

    def __init__(self) -> None:
        self.local = [0] * FRAME_WINDOW_SIZE
        self.remote = [0] * FRAME_WINDOW_SIZE

    def advance_frame(self, frame: int, local_adv: int, remote_adv: int) -> None:
        self.local[frame % FRAME_WINDOW_SIZE] = local_adv
        self.remote[frame % FRAME_WINDOW_SIZE] = remote_adv

    def average_frame_advantage(self) -> int:
        local_avg = sum(self.local) / FRAME_WINDOW_SIZE
        remote_avg = sum(self.remote) / FRAME_WINDOW_SIZE
        # meet in the middle; truncation toward zero (an `as i32` cast)
        return int((remote_avg - local_avg) / 2.0)
