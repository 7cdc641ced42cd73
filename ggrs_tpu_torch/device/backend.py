"""DeviceRollbackBackend: fulfils a session's ordered request list on the
device — the port of `ggrs_tpu/tpu/backend.py` `TpuRollbackBackend`, eager,
lazy and async request path.

Sessions (the port's `SyncTestSession`) emit Save/Load/Advance requests;
this backend parses each tick's request grammar

    [Load?] (Save? Advance)* Save?

into ONE packed control-word row and runs it as one device dispatch of
`ResimCore` (on CUDA: one launch of K3). Snapshot data never leaves the
device; cells are filled with lightweight `SnapshotRef` handles and lazy
checksums that only move device bytes to the host when read — and then
every pending batch at once, in one copy (`ChecksumLedger`). Each parsed
segment's canonical shape (has_load, advance_count, last_active,
trailing save) is tallied in a `DispatchPlanCache` (`dispatch_signatures`).

With `lazy_ticks > 0`, ticks (rollbacks included) are packed straight into
a [lazy_ticks, L] host buffer of a `StagingPool` and dispatch as ONE
multi-row launch when the buffer fills or when any device result is needed
(a checksum read, `state_numpy()`, `check()`, `flush()`); a partial buffer
is padded with no-op rows to the configured depth. Without
`async_dispatch` the pool holds one plain buffer, uploaded through a fresh
pinned copy (`launch.stage`), so it can be refilled at once.

With `async_dispatch=True` (the reference's async device-resident
pipeline, bit-identical to the eager path): `lazy_ticks` defaults to
ASYNC_DEFAULT_LAZY_TICKS, the pool holds `async_inflight + 1` pinned
buffers uploaded without waiting, and every dispatch is admitted to an
`InflightFence` — a CUDA event recorded after it — so the host runs up to
`async_inflight` dispatches ahead of the card and waits on the oldest only
past that; a buffer comes round again only once the dispatch that read it
has retired. The eager path records no event per dispatch.

With `beam_width > 0` the backend speculates (north star: the rollback
becomes a select): after each tick it rolls `beam_width` candidate input
futures out of the frame the next rollback is expected to load (one K4
launch, `ResimCore.speculate`), with candidates from
`beam.branching_beam` ranked by the online `InputHistoryModel`; a rollback
whose corrected script a member matches adopts the member's trajectory
(`ResimCore.adopt`: the matched prefix is served as data movement, a
mispredicted suffix runs as one K3 row). States and checksums stay
bit-equal to a beam-off backend. `speculation_gate="adaptive"` chooses the
launch width per tick from the measured idle time, the speculation cost
`warmup()` measures and the trail of frames each launch served.

The P2P session's desync detection asks each checksum getter whether
reading it now would wait on the card (`ready`): True once its batch is on
the host, on the CPU, when its background copy (`prefetch`) has landed,
and on CUDA when the current stream has no work left (a read goes through
the ledger's flush, which copies every pending batch, the ones dispatched
after this getter's too). A getter that is not ready is prefetched and
read on a later pump pass; the report interval forces the read, and then
it may wait. `dispatch_pending` says a getter's batch still sits in the
lazy buffer (the deterministic-publish mode does not prefetch those), and
`ChecksumLedger.drain_ready` stores what is ready without waiting (the
serve host's pump pass calls it).

Left out (still to port, ROADMAP.md): meshes (and the sharded beam), the
per-depth routing of the lazy flush (one kernel covers every depth, so
the `depth_routing` knob is only carried through checkpoints), and
telemetry spans.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..beam import branching_beam, match_beam_longest
from ..errors import CheckpointIncompatible, ConfigError, MismatchedChecksum, TypeContractError
from ..input_model import InputHistoryModel
from ..ops.fixed_point import combine_checksum
from ..types import AdvanceFrame, Frame, InputStatus, LoadGameState, Request, SaveGameState
from ..utils.checkpoint import load_device_checkpoint, save_device_checkpoint
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

    @property
    def ready(self) -> bool:
        """True when resolve() will not wait on the card: the values are on
        the host, the background copy `prefetch` started has landed, or the
        current stream, which every pending batch of the ledger's flush was
        dispatched on, has finished its work."""
        return (
            self._np is not None
            or self._his.device.type != "cuda"
            or (self._event is not None and self._event.query())
            or torch.cuda.current_stream(self._his.device).query()
        )

    def resolve(self, idx: int) -> int:
        if self._np is None and self._host is not None:
            self.take()
        if self._np is None:
            self._ledger.flush()
        if self._np is None:  # evicted from the ledger before this read
            self._store(self._his, self._los)
        return combine_checksum(self._np[0][idx], self._np[1][idx])

    def take(self) -> None:
        """Store the values: the prefetched copy (waiting for it if it is
        still in flight), else a read of the device tensors."""
        if self._host is not None:
            self._event.synchronize()
            self._store(self._host[0], self._host[1])
        else:
            self._store(self._his, self._los)

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

    def drain_ready(self) -> int:
        """Non-blocking drain (the serve host's pump pass): store every
        pending batch that is `ready` — from its landed background copy, or
        read while the stream is idle, so no read waits on the card — and
        start a background copy of the oldest batch still in flight, so a
        later pass or a forced flush finds its bytes moved. Returns the
        number of batches still pending."""
        still: List[_ChecksumBatch] = []
        for b in self._pending:
            if b._np is not None:
                continue
            if b.ready:
                b.take()
            else:
                still.append(b)
        self._pending = still
        if still:
            still[0].prefetch()
        return len(still)

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
    """Zero-arg callable stored in a GameStateCell; supports non-blocking
    readiness checks and background prefetch."""

    __slots__ = ("_batch", "_idx")

    def __init__(self, batch, idx: int):
        self._batch = batch
        self._idx = idx

    def __call__(self) -> int:
        return self._batch.resolve(self._idx)

    def prefetch(self) -> None:
        self._batch.prefetch()

    @property
    def ready(self) -> bool:
        return self._batch.ready

    @property
    def dispatch_pending(self) -> bool:
        """True while the batch's dispatch has not happened yet (its ticks
        still sit in the lazy buffer): prefetching such a getter would
        force the dispatch, which the deterministic-publish binding
        (`PendingChecksumReport.bind_and_prefetch`) avoids."""
        return getattr(self._batch, "dispatch_pending", False)


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

    @property
    def ready(self) -> bool:
        return self.batch is not None and self.batch.ready

    @property
    def dispatch_pending(self) -> bool:
        return self.batch is None


class DispatchPlanCache:
    """Canonical dispatch-signature tally: signature -> dispatch count. A
    DeviceRollbackBackend tallies (has_load, advance_count, last_active,
    trailing save?) per request segment; a MultiSessionDeviceCore tallies
    ("megabatch", row bucket, depth bucket) per megabatch (depth 0 the
    zero-rollback fast dispatch, None the full window). The request
    grammar admits O(window^2) segment shapes, the megabatch grid
    (row buckets x (depth buckets + 1)) programs. The reference's
    telemetry counters are not ported."""

    def __init__(self):
        self.signatures: Dict[tuple, int] = {}

    def note(self, sig) -> None:
        """Tally one dispatch of `sig`."""
        self.signatures[sig] = self.signatures.get(sig, 0) + 1

    def clear(self) -> None:
        self.signatures.clear()


class InflightFence:
    """The in-flight fence of the async pipeline: a CUDA event recorded on
    the current stream after each admitted dispatch, with the dispatch's
    live row count. Once more than `depth` dispatches are outstanding the
    host waits on the OLDEST (a stall when its event has not completed),
    so it runs up to `depth` dispatches ahead of the card instead of
    running unboundedly ahead or draining after every dispatch. `poll`
    drops retired dispatches without waiting (`event.query()`). On the CPU
    a dispatch has finished when its call returns: nothing is held, and
    the counters read as after retirement."""

    def __init__(self, depth: int, device: torch.device):
        if depth < 1:
            raise ConfigError(f"async_inflight must be >= 1, got {depth}")
        self.depth = depth
        self.device = device
        self._held: deque = deque()  # (event, rows), oldest first
        self.rows = 0  # live rows of the held dispatches
        self.stalls = 0  # waits on an event that had not completed
        self.stall_s = 0.0

    def __len__(self) -> int:
        return len(self._held)

    def note(self, rows: int = 0) -> None:
        if self.device.type != "cuda":
            return
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        self._held.append((event, rows))
        self.rows += rows
        while len(self._held) > self.depth:
            oldest, n = self._held.popleft()
            if not oldest.query():
                t0 = time.perf_counter()
                oldest.synchronize()
                self.stalls += 1
                self.stall_s += time.perf_counter() - t0
            self.rows -= n

    def poll(self) -> int:
        """Drop the retired dispatches; returns the rows still in flight."""
        while self._held and self._held[0][0].query():
            _, n = self._held.popleft()
            self.rows -= n
        return self.rows

    def clear(self) -> None:
        """Forget every held dispatch (the caller has synchronized)."""
        self._held.clear()
        self.rows = 0


class StagingPool:
    """`depth` int32 host buffers of one shape, handed out in turn: with
    `pin` page-locked, so an upload with non_blocking=True is a true
    asynchronous copy. A buffer comes round again after depth - 1 others;
    with depth = async_inflight + 1 and every dispatch that reads one
    admitted to an InflightFence of depth async_inflight, the dispatch
    that read it has retired by then."""

    def __init__(self, shape, depth: int, pin: bool, fill: Optional[np.ndarray] = None):
        self.tensors = [torch.empty(shape, dtype=torch.int32, pin_memory=pin) for _ in range(depth)]
        self.arrays = [t.numpy() for t in self.tensors]
        if fill is not None:
            for a in self.arrays:
                a[...] = fill
        self._flip = 0

    def next(self) -> Tuple[torch.Tensor, np.ndarray]:
        """The next buffer, as a tensor and a numpy view of it."""
        self._flip = (self._flip + 1) % len(self.tensors)
        return self.tensors[self._flip], self.arrays[self._flip]


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

    Returns (load, start_frame, count, saves, last_active,
    trailing_save): `saves` is [(window_slot, SaveGameState)] for
    lazy-checksum cell binding, `last_active` the row's 1-based last
    active slot (the advances and the highest real save), which picks a
    megabatch's depth bucket."""
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

    last_active = max(count, 1)
    if saves:
        last_active = max(last_active, saves[-1][0] + 1)
    return load, start_frame, count, saves, last_active, trailing_save


class DeviceRollbackBackend:
    """Request-fulfilling rollback backend over a device game.

    Usage:
        backend = DeviceRollbackBackend(game, max_prediction=8, num_players=2)
        requests = session.advance_frame()
        backend.handle_requests(requests)
    """

    # adaptive-gate value tracking (the reference's class attributes, same
    # values): every rollback that CONSULTS a fresh speculation adds one
    # (branch_frames_served, member0_frames_served, launches_spanned)
    # sample to a trailing window; branch serves justify the full width,
    # member-0 serves the width-1 history-only launch, and below the bar on
    # both the beam stands down except for a probe burst every
    # VALUE_PROBE_INTERVAL value-gated ticks. The soft bar applies when the
    # measured idle covers the measured launch cost.
    VALUE_WINDOW = 32
    MIN_SERVED_PER_LAUNCH = 0.3
    MIN_SERVED_IDLE = 0.02
    VALUE_MIN_SAMPLES = 8
    VALUE_PROBE_INTERVAL = 24
    VALUE_PROBE_BURST = 3
    HISTORY_WIDTH = 1  # the history-only launch: member 0 alone
    # async_dispatch with lazy_ticks unset batches this many ticks a
    # dispatch (the reference's value)
    ASYNC_DEFAULT_LAZY_TICKS = 8

    def __init__(self, game, max_prediction: int, num_players: int,
                 device_verify: bool = False, lazy_ticks: int = 0, beam_width: int = 0,
                 speculation_gate: str = "always", defer_speculation: bool = False,
                 async_dispatch: bool = False, async_inflight: int = 4, device="cuda"):
        """`device_verify`: keep the SyncTest first-seen checksum history and
        mismatch verdict ON THE DEVICE (read with check()), so determinism
        runs never move checksums to the host. Only for confirmed-input
        replay (SyncTest): P2P rollbacks legitimately re-save corrected
        frames.

        `lazy_ticks`: > 0 buffers that many ticks' packed rows on the host
        and dispatches them as ONE multi-row launch (see the module
        docstring). The live state lags the session by up to lazy_ticks
        frames between flushes.

        `beam_width`: > 0 turns on the speculative beam (module
        docstring); the game must declare `statuses_contract =
        "disconnect-only"`, or ConfigError. `speculation_gate`: "always"
        launches the full beam after every tick; "adaptive" picks the
        width per tick (`_launch_width`) and needs `warmup()` to measure
        the speculation cost. `defer_speculation`: handle_requests only
        fulfils requests, and the caller launches the speculation from its
        idle time with launch_pending_speculation().

        `async_dispatch`: the async pipeline (module docstring); with
        `lazy_ticks` 0 it buffers ASYNC_DEFAULT_LAZY_TICKS ticks. The host
        waits on the oldest dispatch once more than `async_inflight` are
        in flight (`fence`: its `stalls` and `stall_s` count the waits).

        `device`: "cuda" by default, the CPU (plain PyTorch) only when
        asked for; a CUDA request on a host without CUDA raises
        ConfigError."""
        if beam_width < 0:
            raise ConfigError(f"beam_width must be >= 0, got {beam_width}")
        if beam_width:
            contract = getattr(game, "statuses_contract", None)
            if contract != "disconnect-only":
                raise ConfigError(
                    "beam speculation adopts trajectories rolled out from candidate "
                    "rows, which is only correct for games whose step reads statuses "
                    "solely to substitute DISCONNECTED players' inputs; declare "
                    "statuses_contract = 'disconnect-only' on the game class to opt in "
                    f"(got {contract!r} on {type(game).__name__})"
                )
        if speculation_gate not in ("always", "adaptive"):
            raise ConfigError(f"speculation_gate must be 'always' or 'adaptive', got {speculation_gate!r}")
        self.core = ResimCore(game, max_prediction, num_players,
                              device_verify=device_verify, device=device)
        self.device = self.core.device
        self.num_players = num_players
        self.current_frame: Frame = 0
        self.ledger = ChecksumLedger()
        if lazy_ticks < 0:
            raise ConfigError(f"lazy_ticks must be >= 0, got {lazy_ticks}")
        self.async_dispatch = async_dispatch
        self.async_inflight = async_inflight
        self.fence = InflightFence(async_inflight, self.device)
        if async_dispatch and lazy_ticks == 0:
            lazy_ticks = self.ASYNC_DEFAULT_LAZY_TICKS
        self.lazy_ticks = lazy_ticks
        self.plan_cache = DispatchPlanCache()
        self._tick_future: Optional[_FutureChecksumBatch] = None
        # lazy rows are packed straight into the active buffer of a pool of
        # [lazy_ticks, L] buffers (_acquire_rows_buf); _rows_count of them
        # await dispatch
        self._rows_pool: Optional[StagingPool] = None
        self._rows_active: Optional[Tuple[torch.Tensor, np.ndarray]] = None
        self._rows_count = 0
        self._pad_row: Optional[np.ndarray] = None
        core = self.core
        W, P, I = core.window, num_players, game.input_size
        # the parse staging, refilled every segment: packing copies it into
        # the dispatch row, so it never reaches the device itself
        self._stage = (
            np.zeros((W, P, I), dtype=np.uint8),
            np.zeros((W, P), dtype=np.int32),
            np.full((W,), core.scratch_slot, dtype=np.int32),
        )

        # the speculative beam
        self.beam_width = beam_width
        self.speculation_gate = speculation_gate
        self.defer_speculation = defer_speculation
        self._spec = None  # (anchor_frame, beam_inputs, Speculation)
        self._last_segment = None  # (load, start_frame, count) of the tick's last segment
        self.beam_hits = 0  # full adoptions (every corrected frame served)
        self.beam_partial_hits = 0  # prefix adoptions (the suffix resimulated)
        self.beam_misses = 0
        # the adoption metric: rollback_frames_adopted / rollback_frames
        self.rollback_frames = 0
        self.rollback_frames_adopted = 0
        self.beam_gated = 0  # ticks where the full-width launch was withheld
        self.beam_history_launches = 0  # width-1 history-only launches
        # each player's last row and previous DISTINCT row (the toggle partner)
        self._last_inputs = np.zeros((P, I), dtype=np.uint8)
        self._prev_inputs = np.zeros((P, I), dtype=np.uint8)
        # (inputs u8[P,I], statuses i32[P]) played per recent frame: the
        # played-prefix check of shift-flexible adoption reads it
        self._played: dict = {}
        # hold/transition statistics learned from FINALIZED rows only
        self.input_model = InputHistoryModel(num_players, I)
        self._finalized_to = -1  # newest frame fed to the model
        # observed rollback depth; the next speculation anchors on it
        self._depth = 2
        self._spec_cost_s: Optional[float] = None  # full width, measured in warmup()
        self._spec_hist_cost_s: Optional[float] = None  # width 1, warmup()
        self._idle_ema_s: Optional[float] = None
        self._last_tick_end: Optional[float] = None
        self._launch_value: deque = deque(maxlen=self.VALUE_WINDOW)
        self._spec_consulted = False
        self._launches_since_consult = 0
        self._value_gated_streak = 0
        # value samples come only from FRESH consults (a spec launched the
        # tick before): a stale spec misses by shift whatever its candidates
        self._tick_index = 0
        self._spec_tick = -10

    # ------------------------------------------------------------------

    def handle_requests(self, requests: List[Request]) -> None:
        """A tick is usually one fused dispatch, but a request list can
        legally hold two rollback blocks (a misprediction rollback and a
        sparse-saving keepalive rollback): split into one segment per
        LoadGameState and fuse each."""
        if self.speculation_gate == "adaptive":
            now = time.perf_counter()
            if self._last_tick_end is not None:
                idle = now - self._last_tick_end
                # an EMA over ~10 ticks, seeded by the first sample
                self._idle_ema_s = idle if self._idle_ema_s is None else 0.9 * self._idle_ema_s + 0.1 * idle
        self._tick_index += 1
        segment: List[Request] = []
        for req in requests:
            if isinstance(req, LoadGameState) and segment:
                self._run_segment(segment)
                segment = []
            segment.append(req)
        if segment:
            self._run_segment(segment)
        # one speculation per tick, from the last segment's frontier (an
        # earlier segment's beam could never be matched)
        if not self.defer_speculation:
            self.launch_pending_speculation()
        if self.speculation_gate == "adaptive":
            self._last_tick_end = time.perf_counter()

    @property
    def dispatch_signatures(self) -> dict:
        """Signature -> dispatch count view of the plan cache."""
        return self.plan_cache.signatures

    def _parse_segment(self, requests: List[Request]):
        """One pass over a request segment into the packed staging, its
        canonical signature tallied in the plan cache; returns (load,
        start_frame, count, inputs, statuses, save_slots, saves)."""
        core = self.core
        inputs, statuses, save_slots = self._stage
        inputs.fill(0)
        statuses.fill(0)
        save_slots.fill(core.scratch_slot)
        load, start_frame, count, saves, last_active, trailing = parse_request_segment(
            requests,
            window=core.window,
            ring_len=core.ring_len,
            max_prediction=core.max_prediction,
            current_frame=self.current_frame,
            inputs=inputs,
            statuses=statuses,
            save_slots=save_slots,
        )
        self.plan_cache.note((load is not None, count, last_active, trailing is not None))
        return load, start_frame, count, inputs, statuses, save_slots, saves

    def _note_inflight(self) -> None:
        """Admit the dispatch just made to the fence (async only: the
        eager path records no event)."""
        if self.async_dispatch:
            self.fence.note()

    def _run_segment(self, requests: List[Request]) -> None:
        load, start_frame, count, inputs, statuses, save_slots, saves = self._parse_segment(requests)
        core = self.core
        his = los = None
        if load is not None:
            self.rollback_frames += count
        if load is not None and self._spec is not None:
            his, los = self._consult(load, inputs, statuses, save_slots, count)
        base_idx = 0
        batch = None
        if his is None:
            fields = dict(
                do_load=load is not None,
                load_slot=(load.frame % core.ring_len) if load is not None else 0,
                inputs=inputs,
                statuses=statuses,
                save_slots=save_slots,
                advance_count=count,
                start_frame=start_frame,
            )
            if self.lazy_ticks > 0:
                # stage the row; the multi-row dispatch happens at flush()
                if self._tick_future is None:
                    self._tick_future = _FutureChecksumBatch(self.flush)
                batch = self._tick_future
                buf = self._acquire_rows_buf()
                base_idx = self._rows_count * core.window
                core.pack_tick_row_into(buf[self._rows_count], **fields)
                self._rows_count += 1
            else:
                his, los = core.tick_row(core.pack_tick_row(**fields))
                self._note_inflight()
        if batch is None:
            batch = _ChecksumBatch(his, los, self.ledger)
        self.current_frame = start_frame + count

        for idx, save in saves:
            ref = SnapshotRef(save.frame, save.frame % core.ring_len)
            save.cell.save_lazy(save.frame, ref, _LazyChecksum(batch, base_idx + idx))
        if self._rows_count >= self.lazy_ticks > 0:
            self.flush()
        if self.beam_width:
            self._record_segment(load, start_frame, count, inputs, statuses)

    # ------------------------------------------------------------------
    # the speculative beam (the reference's backend.py:987-1043, 1114-1447)

    def _consult(self, load, inputs, statuses, save_slots, count):
        """A rollback meets the standing speculation: match, record one
        value sample if the speculation is fresh, and adopt on a match.
        Returns the adoption's (his, los), or (None, None) on a miss."""
        core = self.core
        match = self._match_speculation(load.frame, inputs, statuses, count)
        if not self._spec_consulted and self._tick_index - self._spec_tick <= 1:
            # one sample per FRESH consulted speculation, split by who
            # served: (branch frames, member-0 frames, launches paid since
            # the last consult)
            served = match[2] if match else 0
            is_branch = bool(match) and match[0] != 0
            self._launch_value.append(
                (served if is_branch else 0, 0 if is_branch else served,
                 max(self._launches_since_consult, 1))
            )
            self._launches_since_consult = 0
            self._spec_consulted = True
        if match is None:
            self.beam_misses += 1
            return None, None
        member, shift, matched = match
        if matched == count:
            self.beam_hits += 1
        else:
            self.beam_partial_hits += 1
        self.rollback_frames_adopted += matched
        # adoption reads the ring: buffered ticks must land first
        self.flush()
        his, los = core.adopt(self._spec[2], member, load.frame % core.ring_len, save_slots, count,
                              shift=shift, load_frame=load.frame, inputs=inputs, statuses=statuses,
                              matched=matched)
        self._note_inflight()
        return his, los

    def _record_segment(self, load, start_frame, count, inputs, statuses) -> None:
        """After a segment: drop a speculation this rollback made stale,
        keep the segment's shape for the launch, record the played rows and
        feed newly finalized frames to the input model."""
        core = self.core
        # a rollback at or before the anchor rewrote the anchor snapshot
        if self._spec is not None and load is not None and load.frame <= self._spec[0]:
            self._spec = None
        self._last_segment = (load, start_frame, count)
        if load is not None:
            self._depth = count  # observed rollback depth
        for f in range(count):
            changed = (inputs[f] != self._last_inputs).any(axis=1)
            if changed.any():
                self._prev_inputs[changed] = self._last_inputs[changed]
                self._last_inputs[changed] = inputs[f][changed]
            self._played[start_frame + f] = (inputs[f].copy(), statuses[f].copy())
        # frames beyond rollback reach are what really happened; disconnected
        # cells break the run instead of entering the statistics
        final_horizon = self.current_frame - core.max_prediction
        f = self._finalized_to + 1
        # a gap (history before the beam) can't be learned from: jump past
        # it, severing runs; the same cutoff GCs _played
        horizon = self.current_frame - core.window - core.max_prediction
        if f < horizon:
            f = horizon
            for p in range(self.num_players):
                self.input_model.break_run(p)
        while f < final_horizon:
            rec = self._played.get(f)
            if rec is None:
                for p in range(self.num_players):
                    self.input_model.break_run(p)
            else:
                pin, pst = rec
                for p in range(self.num_players):
                    if pst[p] >= int(InputStatus.DISCONNECTED):
                        self.input_model.break_run(p)
                    else:
                        self.input_model.observe(p, pin[p].tobytes())
            self._finalized_to = f
            f += 1
        for key in [k for k in self._played if k < horizon]:
            del self._played[key]

    def _match_speculation(self, load_frame: Frame, inputs: np.ndarray, statuses: np.ndarray,
                           count: int) -> Optional[Tuple[int, int, int]]:
        """(member, shift, matched) of an adoptable speculation, else None:
        the member's first `shift` rows must be the rows played between
        anchor and load, and `matched` is the longest leading run of the
        corrected script its rows cover, stopping before the first
        disconnect row (those were not speculated as played)."""
        anchor_frame, beam_inputs, _ = self._spec
        shift = load_frame - anchor_frame
        if shift < 0 or shift >= beam_inputs.shape[1]:
            return None
        clean = 0
        while clean < count and (statuses[clean] < int(InputStatus.DISCONNECTED)).all():
            clean += 1
        if clean == 0:
            return None
        prefix_rows = []
        for j in range(shift):
            rec = self._played.get(anchor_frame + j)
            if rec is None:
                return None
            pin, pst = rec
            if (pst >= int(InputStatus.DISCONNECTED)).any():
                return None
            prefix_rows.append(pin)
        prefix = (np.stack(prefix_rows) if prefix_rows
                  else np.zeros((0,) + inputs.shape[1:], dtype=np.uint8))
        matched, member = match_beam_longest(beam_inputs, prefix, inputs[:clean])
        if member is None or matched == 0:
            return None
        return (member, shift, matched)

    def launch_pending_speculation(self) -> None:
        """Launch (or gate) the speculation staged by the last tick. With
        defer_speculation=True, call this from loop idle time after the
        frame's critical path; otherwise handle_requests calls it."""
        if self.beam_width and self._last_segment is not None:
            if self._last_segment[2] == 0:  # no advance: nothing to anchor on
                self._last_segment = None
                return
            width = self._launch_width()
            if width != self.beam_width:
                self.beam_gated += 1
            if width:
                if width != self.beam_width:
                    self.beam_history_launches += 1
                self._launch_speculation(*self._last_segment, width=width)
            self._last_segment = None

    def _launch_width(self) -> int:
        """The adaptive gate (the reference's `_launch_width`, decision for
        decision): the full beam, the width-1 history-only rollout, or 0.
        BUDGET: a width is affordable when the idle EMA covers 80% of its
        measured cost (an unseeded EMA counts as affordable). VALUE: full
        width needs branch-member serves (or, when member-0 serves alone
        miss the bar, their total), width 1 needs member-0 serves; a
        value-gated full width fires a probe burst at the end of every
        VALUE_PROBE_INTERVAL gated ticks."""
        full, hist = self.beam_width, self.HISTORY_WIDTH
        if self.speculation_gate != "adaptive" or self._spec_cost_s is None:
            return full
        idle = self._idle_ema_s
        full_covered = idle is not None and idle >= 0.8 * self._spec_cost_s
        full_affordable = idle is None or full_covered
        # an unmeasured width-1 cost is priced as the full one
        hist_cost = self._spec_hist_cost_s if self._spec_hist_cost_s is not None else self._spec_cost_s
        hist_covered = idle is not None and idle >= 0.8 * hist_cost
        hist_affordable = idle is None or hist_covered
        if len(self._launch_value) >= self.VALUE_MIN_SAMPLES:
            launches = max(sum(n for _, _, n in self._launch_value), 1)
            branch_rate = sum(b for b, _, _ in self._launch_value) / launches
            hist_rate = sum(h for _, h, _ in self._launch_value) / launches
            full_bar = self.MIN_SERVED_IDLE if full_covered else self.MIN_SERVED_PER_LAUNCH
            hist_bar = self.MIN_SERVED_IDLE if hist_covered else self.MIN_SERVED_PER_LAUNCH
            hist_ok = hist_rate >= hist_bar
            branch_ok = branch_rate >= full_bar or (not hist_ok and branch_rate + hist_rate >= full_bar)
        else:
            branch_ok = hist_ok = True
        if branch_ok:
            self._value_gated_streak = 0
            if full_affordable:
                return full
            if hist_ok and hist_affordable:
                return hist
            return 0
        self._value_gated_streak += 1
        probing = ((self._value_gated_streak - 1) % self.VALUE_PROBE_INTERVAL
                   >= self.VALUE_PROBE_INTERVAL - self.VALUE_PROBE_BURST)
        if probing and full_affordable:
            return full
        if hist_ok and hist_affordable:
            return hist
        return 0

    def _ranked_predictions(self, anchor: Frame, rollout: int, width: int):
        """Likelihood-ranked (player, offset, value_row) switch specs for
        branching_beam's prediction stream, from each player's confirmed
        frontier in the played history; the model's share is capped at
        ~2/3 of the branch members."""
        frontiers = []
        for p in range(self.num_players):
            frontier = None
            for f in range(self.current_frame - 1, -1, -1):
                rec = self._played.get(f)
                if rec is None:
                    break
                if rec[1][p] == int(InputStatus.CONFIRMED):
                    frontier = f
                    break
            if frontier is None:
                frontiers.append(None)
                continue
            value = self._played[frontier][0][p].tobytes()
            run = 1
            f = frontier - 1
            while f >= 0:
                rec = self._played.get(f)
                if rec is None or rec[1][p] != int(InputStatus.CONFIRMED) or rec[0][p].tobytes() != value:
                    break
                run += 1
                f -= 1
            frontiers.append((frontier, value, run))
        if all(fr is None for fr in frontiers):
            return None
        preds = self.input_model.rank_branches(frontiers, anchor, rollout,
                                               limit=max((width - 1) * 2 // 3, 1))
        return preds or None

    def _launch_speculation(self, load: Optional[LoadGameState], start_frame: Frame, count: int,
                            width: Optional[int] = None) -> None:
        """Build the candidates (`_candidates`) and roll them out (one K4
        launch)."""
        core = self.core
        if count == 0:
            return
        if width is None:
            width = self.beam_width
        # the rollout anchors on a ring snapshot: buffered ticks must land
        self.flush()
        anchor, beam_inputs = self._candidates(start_frame + count, width)
        beam_statuses = np.zeros(beam_inputs.shape[:3], dtype=np.int32)
        spec = core.speculate(anchor % core.ring_len, beam_inputs, beam_statuses)
        self._spec = (anchor, beam_inputs, spec)
        self._spec_consulted = False
        self._spec_tick = self._tick_index
        self._launches_since_consult += 1

    def _candidates(self, current_after: Frame, width: int) -> Tuple[Frame, np.ndarray]:
        """(anchor frame, candidate scripts u8[width, L, P, I]) for the
        speculation after a tick that ends at `current_after`: anchored one
        frame deeper than the observed rollback depth predicts for the next
        tick (depth jitter of +-1 still lands inside the member window),
        with the played history pinned into every member."""
        core = self.core
        anchor = current_after - self._depth
        anchor = max(anchor, current_after - core.max_prediction, 0)
        anchor = min(anchor, current_after - 1)
        # consecutive depths coalesce to one length (5, 5, 7, 7, ...)
        rollout = min(self._depth + 3 + (self._depth & 1), core.window)
        S = current_after - anchor
        base_rows = np.empty((S,) + self._last_inputs.shape, dtype=np.uint8)
        fixed = np.empty((S, self.num_players), dtype=bool)
        for j in range(S):
            rec = self._played.get(anchor + j)
            if rec is None:  # past the history horizon: nothing to pin
                base_rows = fixed = None
                break
            pin, pst = rec
            base_rows[j] = pin
            fixed[j] = pst != int(InputStatus.PREDICTED)
        beam_inputs = branching_beam(
            self._last_inputs, self._prev_inputs, core.window, width,
            max_offset=rollout, base_rows=base_rows, fixed=fixed,
            # only full-width launches carry branch members
            predictions=(self._ranked_predictions(anchor, rollout, width)
                         if width == self.beam_width else None),
        )
        return anchor, beam_inputs[:, :rollout]

    def flush(self) -> None:
        """Dispatch buffered lazy ticks as ONE multi-row launch (no-op when
        the buffer is empty or lazy_ticks is 0), padded to the configured
        depth with no-op rows; materializes the future checksum batch the
        buffered saves' cells already hold. A single buffered row goes as
        a 1-row dispatch."""
        n, future = self._rows_count, self._tick_future
        if not n:
            return
        staged, buf = self._rows_active
        self._rows_active = None
        self._rows_count = 0
        self._tick_future = None
        core = self.core
        if n == 1:
            his, los = core.tick_row(buf[0])
        else:
            buf[n:] = self._pad_row
            # async: the pinned buffer itself goes up without waiting (the
            # fence makes its reuse safe); eager: through a fresh pinned copy
            his, los = core.tick_multi(staged if self.async_dispatch else buf)
        self._note_inflight()
        future.batch = _ChecksumBatch(his, los, self.ledger)

    def _acquire_rows_buf(self) -> np.ndarray:
        """The active [lazy_ticks, L] buffer lazy rows are packed into,
        taken from the pool at a buffer's first row: async_inflight + 1
        pinned buffers under async dispatch, else one plain buffer. Rows
        past the staged count keep stale words until flush() pads them."""
        if self._rows_active is None:
            if self._rows_pool is None:
                self._pad_row = self.core.pad_tick_row()
                depth = self.async_inflight + 1 if self.async_dispatch else 1
                pin = self.async_dispatch and self.device.type == "cuda"
                self._rows_pool = StagingPool((self.lazy_ticks, self.core.packed_len), depth, pin,
                                              fill=self._pad_row)
            self._rows_active = self._rows_pool.next()
        return self._rows_active[1]

    def reset(self) -> None:
        """Fresh-session state: the core returns to its initial world and
        ring, every counter and speculation artifact clears."""
        # materialize any staged lazy ticks first (cells from the old
        # session already hold this buffer's future checksums), and wait
        # for every dispatch in flight, so the fence forgets none whose
        # pooled buffer could still be read
        self.block_until_ready()
        self.core.reset()
        self.current_frame = 0
        self.ledger = ChecksumLedger()
        self.plan_cache.clear()
        self._spec = None
        self._last_segment = None
        self.beam_hits = self.beam_partial_hits = self.beam_misses = 0
        self.beam_gated = self.beam_history_launches = 0
        self.rollback_frames = self.rollback_frames_adopted = 0
        self._last_inputs[:] = 0
        self._prev_inputs[:] = 0
        self._played.clear()
        # the input model and the measured speculation costs SURVIVE reset
        # (they describe the players and the card, not the session); runs
        # are severed at the discontinuity
        for p in range(self.num_players):
            self.input_model.break_run(p)
        self._finalized_to = -1
        self._depth = 2
        self._idle_ema_s = None
        self._last_tick_end = None
        self._launch_value.clear()
        self._spec_consulted = False
        self._launches_since_consult = 0
        self._value_gated_streak = 0
        self._tick_index = 0
        self._spec_tick = -10

    def warmup(self) -> None:
        """Build and load every kernel this backend can launch and run each
        program once on the core's carry — K3 as a 1-row and, with
        lazy_ticks, a multi-row dispatch; with a beam, K4 and both adoption
        shapes — then measure the speculation cost per launch width for the
        adaptive gate (CUDA events after a synchronize on the card, the
        host clock on the CPU). The carry is restored afterwards, so the
        game state, the ring and the verify history are as they were."""
        core = self.core
        saved = {k: v.clone() for k, v in core.carry.items()}
        W, P, I = core.window, self.num_players, core.game.input_size
        inputs = np.zeros((W, P, I), dtype=np.uint8)
        statuses = np.zeros((W, P), dtype=np.int32)
        scratch = np.full((W,), core.scratch_slot, dtype=np.int32)
        core.tick(False, 0, inputs, statuses, scratch, 0)
        if self.lazy_ticks > 1:
            core.tick_multi(np.tile(core.pad_tick_row(), (self.lazy_ticks, 1)))
        if self.beam_width:
            # only the adaptive gate launches the history width
            widths = (sorted({self.beam_width, self.HISTORY_WIDTH})
                      if self.speculation_gate == "adaptive" else [self.beam_width])
            # one kernel covers every rollout length: time the middle one of
            # the lengths depth coalescing yields
            rollouts = sorted({min(d + 3 + (d & 1), W) for d in range(1, W + 1)})
            rollout = rollouts[len(rollouts) // 2]
            costs = {}
            for width in widths:
                beam = branching_beam(inputs[0], inputs[0], W, width)[:, :rollout]
                beam_statuses = np.zeros((width, rollout, P), dtype=np.int32)
                spec = core.speculate(0, beam, beam_statuses)
                core.adopt(spec, 0, 0, scratch, 1)
                core.adopt(spec, 0, 0, scratch, 2, inputs=inputs, statuses=statuses, matched=1)
                costs[width] = self._time_speculation(beam, beam_statuses)
            self._spec_cost_s = costs[self.beam_width]
            self._spec_hist_cost_s = costs.get(self.HISTORY_WIDTH)
        for k, v in saved.items():
            core.carry[k].copy_(v)
        self.block_until_ready()

    def _time_speculation(self, beam_inputs: np.ndarray, beam_statuses: np.ndarray,
                          reps: int = 10) -> float:
        """Seconds per speculation launch, `reps` back to back."""
        core = self.core
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                core.speculate(0, beam_inputs, beam_statuses)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / reps / 1e3
        t0 = time.perf_counter()
        for _ in range(reps):
            core.speculate(0, beam_inputs, beam_statuses)
        return (time.perf_counter() - t0) / reps

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
        self.fence.clear()  # everything dispatched has retired

    # ------------------------------------------------------------------
    # durable checkpoint/resume, in the reference's file format
    # ------------------------------------------------------------------

    def save(self, path: str) -> None:
        """Write the backend to `path` (".npz" appended when missing) as the
        reference's `TpuRollbackBackend.save` writes it (backend.py:
        1675-1712): buffered lazy ticks flushed first, then the core's ring,
        state and, with device verification, its history, and the
        reference's meta, the async knobs included. The knobs the port does
        not have are written as a reference backend built with its defaults
        writes them, its kernel choices as "auto"."""
        self.flush()
        save_device_checkpoint(
            path,
            self.core.checkpoint_tree(),
            {
                "kind": "TpuRollbackBackend",
                "current_frame": self.current_frame,
                "max_prediction": self.core.max_prediction,
                "num_players": self.num_players,
                "beam_width": self.beam_width,
                "device_verify": self.core.device_verify,
                "lazy_ticks": self.lazy_ticks,
                "async_dispatch": self.async_dispatch,
                "async_inflight": self.async_inflight,
                "depth_routing": True,
                "speculation_gate": self.speculation_gate,
                "defer_speculation": self.defer_speculation,
                "spec_backend": "auto",
                "tick_backend": "auto",
            },
        )

    @classmethod
    def restore(cls, path: str, game, device="cuda") -> "DeviceRollbackBackend":
        """A backend resumed from a checkpoint of either stack, with the
        saved knobs (the reference's defaults where a file predates them).
        The port's kernels serve whatever backend names the file holds: a
        file that says "xla" still runs K3 on a card."""
        tree, meta = load_device_checkpoint(path)
        if meta.get("kind") != "TpuRollbackBackend":
            raise CheckpointIncompatible(f"checkpoint {path!r} is not a rollback backend's",
                                         found=meta.get("kind"), expected="TpuRollbackBackend")
        backend = cls(
            game,
            max_prediction=meta["max_prediction"],
            num_players=meta["num_players"],
            device_verify=meta.get("device_verify", False),
            lazy_ticks=meta.get("lazy_ticks", 0),
            beam_width=meta.get("beam_width", 0),
            speculation_gate=meta.get("speculation_gate", "always"),
            defer_speculation=meta.get("defer_speculation", False),
            async_dispatch=meta.get("async_dispatch", False),
            async_inflight=meta.get("async_inflight", 2),
            device=device,
        )
        backend.core.load_checkpoint_tree(tree, f"checkpoint {path!r}")
        backend.current_frame = meta["current_frame"]
        return backend
