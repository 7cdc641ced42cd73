"""DeviceRollbackBackend: fulfils a session's ordered request list on the
device — the port of `ggrs_tpu/tpu/backend.py` `TpuRollbackBackend`, eager
and lazy request path.

Sessions (the port's `SyncTestSession`) emit Save/Load/Advance requests;
this backend parses each tick's request grammar

    [Load?] (Save? Advance)* Save?

into ONE packed control-word row and runs it as one device dispatch of
`ResimCore` (on CUDA: one launch of K3). Snapshot data never leaves the
device; cells are filled with lightweight `SnapshotRef` handles and lazy
checksums that only move device bytes to the host when read — and then
every pending batch at once, in one copy (`ChecksumLedger`).

With `lazy_ticks > 0`, ticks (rollbacks included) accumulate as packed rows
on the host and dispatch as ONE multi-row launch when the buffer fills or
when any device result is needed (a checksum read, `state_numpy()`,
`check()`, `flush()`); a partial buffer is padded with no-op rows to the
configured depth.

Left out (still to port, ROADMAP.md): the speculative beam and its adaptive
gate, `async_dispatch` with its in-flight fence, `warmup`, `save`/
`restore`, meshes, the depth routing and the dispatch-signature plan cache
(one kernel covers every depth, so nothing reads them yet), and what only
the P2P session reads (the ledger's non-blocking drain, the checksum
getters' `ready` and `dispatch_pending`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..errors import ConfigError, MismatchedChecksum, TypeContractError
from ..ops.fixed_point import combine_checksum
from ..types import AdvanceFrame, Frame, LoadGameState, Request, SaveGameState
from .resim import ResimCore


@dataclass(frozen=True)
class SnapshotRef:
    """Opaque handle stored in a GameStateCell: the snapshot lives in the
    device ring, addressed by frame (slot = frame % ring_len)."""

    frame: Frame
    ring_slot: int


class _ChecksumBatch:
    """One dispatch's worth of device checksums ([W] for a single tick,
    [T, W] for a lazy multi-tick flush — lazy checksum indices are flat
    row-major either way); fetched to the host at most once, and only if
    some cell's checksum is actually read. Resolution goes through the
    owning ChecksumLedger so every pending batch rides one device->host
    copy."""

    def __init__(self, his: torch.Tensor, los: torch.Tensor, ledger: "ChecksumLedger"):
        self._his = his
        self._los = los
        self._np: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self._host: Optional[torch.Tensor] = None  # pinned copy started by prefetch
        self._event = None
        self._ledger = ledger
        ledger.register(self)

    def prefetch(self) -> None:
        """Start a background device->host copy into pinned memory, with an
        event marking its end. A CPU batch is already on the host."""
        if self._np is not None or self._host is not None or self._his.device.type != "cuda":
            return
        host = torch.empty((2, self._his.numel()), dtype=torch.int32, pin_memory=True)
        host[0].copy_(self._his.reshape(-1), non_blocking=True)
        host[1].copy_(self._los.reshape(-1), non_blocking=True)
        self._event = torch.cuda.Event()
        self._event.record()
        self._host = host

    def resolve(self, idx: int) -> int:
        if self._np is None and self._host is not None:
            # consume the prefetched copy directly
            self._event.synchronize()
            self._store(self._host[0], self._host[1])
        if self._np is None:
            self._ledger.flush()
        if self._np is None:  # evicted from the ledger before this read
            self._store(self._his, self._los)
        return combine_checksum(self._np[0][idx], self._np[1][idx])

    def _store(self, his: torch.Tensor, los: torch.Tensor) -> None:
        # flat row-major: multi-tick [T, W] batches index as j*W + i
        def u32(t):
            return t.detach().cpu().reshape(-1).numpy().view(np.uint32)

        self._np = (u32(his), u32(los))


class ChecksumLedger:
    """Batches checksum transfers across ticks: the first read of ANY lazy
    checksum fetches every pending batch with one `torch.cat` and one
    device->host copy. Bounded so sessions that never read checksums
    don't accumulate stale batches; evicted batches resolve on their own."""

    MAX_PENDING = 128

    def __init__(self):
        self._pending: List[_ChecksumBatch] = []

    def register(self, batch: _ChecksumBatch) -> None:
        self._pending.append(batch)
        if len(self._pending) > self.MAX_PENDING:
            del self._pending[: -self.MAX_PENDING]

    def flush(self) -> None:
        todo = [b for b in self._pending if b._np is None]
        self._pending.clear()
        if not todo:
            return
        parts = [b._his.reshape(-1) for b in todo] + [b._los.reshape(-1) for b in todo]
        packed = torch.cat(parts).cpu()
        counts = [p.numel() for p in parts]
        offsets = np.concatenate([[0], np.cumsum(counts)])
        n = len(todo)
        for i, b in enumerate(todo):
            b._store(packed[offsets[i] : offsets[i + 1]], packed[offsets[n + i] : offsets[n + i + 1]])


class _LazyChecksum:
    """Zero-arg callable stored in a GameStateCell; supports background
    prefetch."""

    __slots__ = ("_batch", "_idx")

    def __init__(self, batch, idx: int):
        self._batch = batch
        self._idx = idx

    def __call__(self) -> int:
        return self._batch.resolve(self._idx)

    def prefetch(self) -> None:
        self._batch.prefetch()


class _FutureChecksumBatch:
    """Checksum-batch stand-in for ticks still sitting in the lazy tick
    buffer (no dispatch has happened, so no device tensors exist yet).
    First touch forces the backend's buffer flush, which installs the real
    batch; every method then delegates."""

    __slots__ = ("_flush", "batch")

    def __init__(self, flush_fn):
        self._flush = flush_fn
        self.batch: Optional[_ChecksumBatch] = None

    def _ensure(self) -> _ChecksumBatch:
        if self.batch is None:
            self._flush()
            assert self.batch is not None, "flush did not materialize batch"
        return self.batch

    def resolve(self, idx: int) -> int:
        return self._ensure().resolve(idx)

    def prefetch(self) -> None:
        # dispatching the buffer is non-blocking, so an early prefetch can
        # force it: the copy then overlaps device execution
        self._ensure().prefetch()


def parse_request_segment(
    requests: List[Request],
    *,
    window: int,
    ring_len: int,
    max_prediction: int,
    current_frame: Frame,
    inputs: np.ndarray,
    statuses: np.ndarray,
    save_slots: np.ndarray,
):
    """One pass over a session's request segment — the grammar
    [Load?] (Save? Advance)* Save? — into caller-owned packed staging
    (inputs u8[W,P,I], statuses i32[W,P], save_slots i32[W], all
    pre-filled with their neutral values).

    Returns (load, start_frame, count, saves): `saves` is
    [(window_slot, SaveGameState)] for lazy-checksum cell binding."""
    load: Optional[LoadGameState] = None
    slots: List[Tuple[Optional[SaveGameState], AdvanceFrame]] = []
    pending_save: Optional[SaveGameState] = None

    for req in requests:
        if isinstance(req, LoadGameState):
            assert load is None and not slots and pending_save is None, (
                "unsupported request pattern: Load must lead a segment"
            )
            load = req
        elif isinstance(req, SaveGameState):
            if pending_save is not None:
                # first-frame double save
                assert pending_save.frame == req.frame
            pending_save = req
        elif isinstance(req, AdvanceFrame):
            slots.append((pending_save, req))
            pending_save = None
        else:
            raise TypeContractError(f"unknown request {req!r}")
    trailing_save = pending_save

    count = len(slots)
    assert count <= max_prediction + 1, "tick exceeds the fused window"
    assert trailing_save is None or count < window

    start_frame = load.frame if load is not None else current_frame
    saves: List[Tuple[int, SaveGameState]] = []

    for i, (save, adv) in enumerate(slots):
        if save is not None:
            assert save.frame == start_frame + i, (
                f"save of frame {save.frame} out of order (expected {start_frame + i})"
            )
            save_slots[i] = save.frame % ring_len
            saves.append((i, save))
        for p, (buf, status) in enumerate(adv.inputs):
            inputs[i, p] = np.frombuffer(buf, dtype=np.uint8)
            statuses[i, p] = int(status)
    if trailing_save is not None:
        assert trailing_save.frame == start_frame + count
        save_slots[count] = trailing_save.frame % ring_len
        saves.append((count, trailing_save))
    return load, start_frame, count, saves


class DeviceRollbackBackend:
    """Request-fulfilling rollback backend over a device game.

    Usage:
        backend = DeviceRollbackBackend(game, max_prediction=8, num_players=2)
        requests = session.advance_frame()
        backend.handle_requests(requests)
    """

    def __init__(self, game, max_prediction: int, num_players: int,
                 device_verify: bool = False, lazy_ticks: int = 0, device="cuda"):
        """`device_verify`: keep the SyncTest first-seen checksum history and
        mismatch verdict ON THE DEVICE (read with check()), so determinism
        runs never move checksums to the host. Only for confirmed-input
        replay (SyncTest): P2P rollbacks legitimately re-save corrected
        frames.

        `lazy_ticks`: > 0 buffers that many ticks' packed rows on the host
        and dispatches them as ONE multi-row launch (see the module
        docstring). The live state lags the session by up to lazy_ticks
        frames between flushes.

        `device`: "cuda" by default, the CPU (plain PyTorch) only when
        asked for; a CUDA request on a host without CUDA raises
        ConfigError."""
        self.core = ResimCore(game, max_prediction, num_players,
                              device_verify=device_verify, device=device)
        self.device = self.core.device
        self.num_players = num_players
        self.current_frame: Frame = 0
        self.ledger = ChecksumLedger()
        if lazy_ticks < 0:
            raise ConfigError(f"lazy_ticks must be >= 0, got {lazy_ticks}")
        self.lazy_ticks = lazy_ticks
        self._tick_rows: List[np.ndarray] = []  # packed rows awaiting dispatch
        self._tick_future: Optional[_FutureChecksumBatch] = None
        core = self.core
        W, P, I = core.window, num_players, game.input_size
        # the parse staging, refilled every segment: packing copies it into
        # the dispatch row, so it never reaches the device itself
        self._stage = (
            np.zeros((W, P, I), dtype=np.uint8),
            np.zeros((W, P), dtype=np.int32),
            np.full((W,), core.scratch_slot, dtype=np.int32),
        )

    # ------------------------------------------------------------------

    def handle_requests(self, requests: List[Request]) -> None:
        """A tick is usually one fused dispatch, but a request list can
        legally hold two rollback blocks (a misprediction rollback and a
        sparse-saving keepalive rollback): split into one segment per
        LoadGameState and fuse each."""
        segment: List[Request] = []
        for req in requests:
            if isinstance(req, LoadGameState) and segment:
                self._run_segment(segment)
                segment = []
            segment.append(req)
        if segment:
            self._run_segment(segment)

    def _parse_segment(self, requests: List[Request]):
        """One pass over a request segment into the packed staging; returns
        (load, start_frame, count, inputs, statuses, save_slots, saves)."""
        core = self.core
        inputs, statuses, save_slots = self._stage
        inputs.fill(0)
        statuses.fill(0)
        save_slots.fill(core.scratch_slot)
        load, start_frame, count, saves = parse_request_segment(
            requests,
            window=core.window,
            ring_len=core.ring_len,
            max_prediction=core.max_prediction,
            current_frame=self.current_frame,
            inputs=inputs,
            statuses=statuses,
            save_slots=save_slots,
        )
        return load, start_frame, count, inputs, statuses, save_slots, saves

    def _run_segment(self, requests: List[Request]) -> None:
        load, start_frame, count, inputs, statuses, save_slots, saves = self._parse_segment(requests)
        core = self.core
        row = core.pack_tick_row(
            do_load=load is not None,
            load_slot=(load.frame % core.ring_len) if load is not None else 0,
            inputs=inputs,
            statuses=statuses,
            save_slots=save_slots,
            advance_count=count,
            start_frame=start_frame,
        )
        base_idx = 0
        if self.lazy_ticks > 0:
            # stage the row; the multi-row dispatch happens at flush()
            if self._tick_future is None:
                self._tick_future = _FutureChecksumBatch(self.flush)
            batch = self._tick_future
            base_idx = len(self._tick_rows) * core.window
            self._tick_rows.append(row)
        else:
            his, los = core.tick_row(row)
            batch = _ChecksumBatch(his, los, self.ledger)
        self.current_frame = start_frame + count

        for idx, save in saves:
            ref = SnapshotRef(save.frame, save.frame % core.ring_len)
            save.cell.save_lazy(save.frame, ref, _LazyChecksum(batch, base_idx + idx))
        if len(self._tick_rows) >= self.lazy_ticks > 0:
            self.flush()

    def flush(self) -> None:
        """Dispatch buffered lazy ticks as ONE multi-row launch (no-op when
        the buffer is empty or lazy_ticks is 0), padded to the configured
        depth with no-op rows; materializes the future checksum batch the
        buffered saves' cells already hold. A single buffered row goes as
        a 1-row dispatch."""
        rows, future = self._tick_rows, self._tick_future
        if not rows:
            return
        self._tick_rows = []
        self._tick_future = None
        core = self.core
        if len(rows) == 1:
            his, los = core.tick_row(rows[0])
        else:
            buf = np.tile(core.pad_tick_row(), (self.lazy_ticks, 1))
            buf[: len(rows)] = rows
            his, los = core.tick_multi(buf)
        future.batch = _ChecksumBatch(his, los, self.ledger)

    def reset(self) -> None:
        """Fresh-session state: the core returns to its initial world and
        ring, every counter clears."""
        # materialize any staged lazy ticks first: cells from the old
        # session already hold this buffer's future checksums
        self.flush()
        self.core.reset()
        self.current_frame = 0
        self.ledger = ChecksumLedger()

    def check(self) -> None:
        """Fetch the device-verify verdict (one small readback); raises
        MismatchedChecksum on the first recorded divergence. Requires
        device_verify=True."""
        self.flush()
        mismatch, frame = self.core.check_device_verdict()
        if mismatch:
            raise MismatchedChecksum(frame)

    def state_numpy(self) -> dict:
        """Host copy of the live game state in the reference's layout."""
        self.flush()
        return self.core.fetch_state()

    def block_until_ready(self) -> None:
        self.flush()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
