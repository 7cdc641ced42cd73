"""DeviceMailbox: the feed half of the resident serving loop — the port of
`ggrs_tpu/tpu/mailbox.py` (the drive half is `MultiSessionDeviceCore.
drive_mailbox`, one launch of K3's resident entry).

A fixed [S, K, L] ring of packed tick rows lives on the core's device (S
stack slots, K virtual ticks, L the packed control-word length),
initialised to the pad row. The host's staging pass appends each lane's
rows to a staging list as sessions advance (`stage`), and ONE scatter a
commit chunk (`commit`: `index_put_` from one pinned (idx, vt, rows) pool,
`async_inflight + 1` deep, each buffer sliced to the chunk) moves everything newly
staged onto the device; the core admits each commit to its InflightFence,
so a pool buffer comes round again only after the commit that read it has
retired. A drive consumes the whole ring, walking per-lane watermarks
(`_counts`): lane s's rows are valid for virtual ticks [0, marks[s]), and
rows above a watermark never run, so a fill cycle only executes rows staged
since the last drive. A full lane degrades to an EXTRA drive (the core's
`stage_mailbox_row`: `note_overflow`, then drive), never a dropped row.

Checksums are lazy: each fill cycle owns one `_FutureChecksumBatch`;
staged saves bind lazy checksums against it at flat index j*S*W + phys*W +
window slot (the drive's [K, S, W] output, raveled), and the first read of
any of them forces the drive.

All slot indices here are PHYSICAL stack indices (the core's
`stage_mailbox_row` translates logical slots). Left out: telemetry, and the
reference's power-of-two commit buckets and their warm-up scatters, which
keep XLA from compiling a scatter per row count; `index_put_` takes any
count, so one pool of the largest chunk serves every commit.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..errors import InvariantViolation, MailboxLaneFull
from .backend import StagingPool, _FutureChecksumBatch


class DeviceMailbox:
    """The [S, K, L] device row ring, its host staging and watermarks. Built
    by `MultiSessionDeviceCore.attach_mailbox`."""

    def __init__(self, core, depth: int):
        if depth < 1:
            raise InvariantViolation(f"mailbox depth must be >= 1 (got {depth})", invariant="mailbox_depth")
        self.core = core
        self.depth = depth
        self.stack_slots = core.stack_slots
        self.row_len = core.core.packed_len
        self.window = core.core.window
        self.rows_dev = torch.from_numpy(np.tile(core._pad_row, (self.stack_slots, depth, 1))).to(core.device)
        # per-lane fill watermarks (a host image; the drive uploads a copy)
        self._counts = np.zeros((self.stack_slots,), dtype=np.int32)
        self._staged: List[Tuple[int, int, np.ndarray]] = []  # (phys, vtick, row) since the last commit
        self.pending_rows = 0  # committed + staged: the rows a drive owes
        self._cycle_max_last_active = 0
        self._cycle_all_fast = True
        self._future = None  # the open cycle's _FutureChecksumBatch
        # the largest commit chunk: a host tick stages at most two rows a lane
        self.chunk = max(2 * core.capacity, 1)
        self._pool = StagingPool((self.chunk * (2 + self.row_len),), core.async_inflight + 1,
                                 core.device.type == "cuda")
        self.overflows = 0
        self.commits = 0

    # ------------------------------------------------------------------
    # staging (host side)

    def lane_full(self, phys: int) -> bool:
        return int(self._counts[phys]) >= self.depth

    def max_fill(self) -> int:
        return int(self._counts.max())

    def note_overflow(self) -> None:
        self.overflows += 1

    def stage(self, phys: int, row: np.ndarray, last_active: int, fast: bool):
        """Append one packed tick row to lane `phys`'s fill cycle. Returns
        (checksum batch, base index) for the row's save bindings: the open
        cycle's future, fulfilled at drive time. The row must stay valid
        until the next `commit` (the host's lane row pools guarantee it)."""
        j = int(self._counts[phys])
        if j >= self.depth:
            raise MailboxLaneFull("stage() on a full mailbox lane (caller must drive)", lane=phys, depth=self.depth)
        self._staged.append((phys, j, row))
        self._counts[phys] = j + 1
        self.pending_rows += 1
        self._cycle_max_last_active = max(self._cycle_max_last_active, last_active)
        self._cycle_all_fast = self._cycle_all_fast and fast
        if self._future is None:
            self._future = _FutureChecksumBatch(self.core.drive_mailbox)
        return self._future, j * self.stack_slots * self.window + phys * self.window

    @property
    def staged_count(self) -> int:
        return len(self._staged)

    # ------------------------------------------------------------------
    # commit (the one batched host -> device transfer a host tick)

    def _scatter(self, chunk) -> None:
        """ONE scatter of a chunk of staged (phys, vtick, row) entries into
        the ring, through the next pool buffer: n slot indices, n vticks,
        then n packed rows, contiguous. On the CPU the pool's words are
        copied into the ring, never aliased."""
        n, L = len(chunk), self.row_len
        tensor, words = self._pool.next()
        idx, vt, rows = words[:n], words[n : 2 * n], words[2 * n : n * (2 + L)].reshape(n, L)
        for k, (phys, j, row) in enumerate(chunk):
            idx[k] = phys
            vt[k] = j
            rows[k] = row
        staged = tensor[: n * (2 + L)]
        words = staged if self.core.device.type == "cpu" else staged.to(self.core.device, non_blocking=True)
        self.rows_dev.index_put_((words[:n].long(), words[n : 2 * n].long()), words[2 * n :].view(n, L))
        self.core.plan_cache.note(("mailbox_commit",))
        self.commits += 1

    def commit(self) -> int:
        """Move every row staged since the last commit onto the device, one
        scatter a chunk of at most `chunk` rows (the steady host flow
        commits every tick: one scatter a tick). Returns the scatters made;
        the core's `commit_mailbox` admits each to the fence."""
        made = 0
        while self._staged:
            chunk, self._staged = self._staged[: self.chunk], self._staged[self.chunk :]
            self._scatter(chunk)
            made += 1
        return made

    # ------------------------------------------------------------------
    # drive-side bookkeeping (the core's drive_mailbox consumes these)

    def take_cycle(self):
        """Close the fill cycle for a drive: returns (marks i32[S], n_rows,
        max_last_active, all_fast, future) and resets the bookkeeping.
        `commit` must have landed every staged row first."""
        if self._staged:
            raise InvariantViolation("take_cycle() with uncommitted staged rows",
                                     invariant="mailbox_uncommitted_rows")
        out = (self._counts.copy(), self.pending_rows, self._cycle_max_last_active, self._cycle_all_fast,
               self._future)
        self._counts.fill(0)
        self.pending_rows = 0
        self._cycle_max_last_active = 0
        self._cycle_all_fast = True
        self._future = None
        return out

    def drop_lane(self, phys: int) -> int:
        """Discard every row PHYSICAL lane `phys` still owes this fill cycle:
        staged rows are scrubbed before they commit, and the watermark drops
        to zero, so rows already committed to the ring never run. Other
        lanes and the cycle's routing flags are untouched (a wider depth
        than needed gives the same bits). Returns the rows dropped."""
        n = int(self._counts[phys])
        if n == 0:
            return 0
        if self._staged:
            self._staged = [(p, j, row) for (p, j, row) in self._staged if p != phys]
        self._counts[phys] = 0
        self.pending_rows -= n
        return n
