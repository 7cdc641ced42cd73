"""SessionHost: N concurrent sessions multiplexed onto ONE shared device core
by cross-session continuous batching — the port of `ggrs_tpu/serve/host.py`
over the port's `MultiSessionDeviceCore`.

The host owns many sessions (P2P and spectator), pumps all of their sockets
every host tick, and coalesces every session whose `advance_frame` produced
work into cross-session megabatches: each session world is one slot of the
core's stacked tensors, each session tick one packed control row. With
depth routing, zero-rollback ticks ride the fast megabatch (2 window slots)
and rollback rows one megabatch per occupied depth bucket; on the card a
megabatch is one launch of K3's stacked entry.

Lifecycle: admission control (`max_sessions`, typed HostFull), idle
eviction and disconnect GC on the injected Clock, and graceful drain (stop
admitting, flush the fence, checkpoint the stacked worlds in the
reference's .npz format). Backpressure: once `max_inflight_rows` rows are
in flight past the fence, ready sessions queue in arrival order
(`queue_depth`).

`resident=True` is the device-resident serving loop: staged rows append to
the core's device mailbox (one scatter a host tick), and a drive — ONE
launch of K3's resident entry — runs every lane's rows every
`resident_ticks` host ticks (or early once a lane is within two rows of the
depth), checksums landing in [K, S, W] output rings read lazily behind the
fence. Bit-identical to the dispatch-per-tick host fed the same traffic.

The sessions poll per message (`batched_pump=False`, the only choice here):
the reference's parity arm (its `host.py:281-286`), bit-identical to its
batched arm by `tests/test_wire_pump.py`. Note the reference defaults to
the batched pump.

Left out (ROADMAP.md queue 1 item 4), and refused with ConfigError where
they are knobs: the batched pump (`batched_pump=True`), drafts and adoption
(`speculation=True`, `_launch_drafts`, `adopt`), the SDC audit lane
(`sdc_audit_every > 0`), journals (`journal_dir`), session meshes (`mesh`),
`attach_env`, input-model installs, `quarantine` / `take_quarantines`, the
invariant monitors and the admission-shed ladder, the device-fault ladders
and their typed faults (a refused launch of a megabatch or a drive raises
KernelError to the caller), telemetry and tracing.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np

from ..device.backend import SnapshotRef, _LazyChecksum, parse_request_segment
from ..device.multi_session import MultiSessionDeviceCore
from ..errors import ConfigError, DrainStalled, GGRSError, HostFull, InvalidRequest, PredictionThreshold
from ..network.protocol import ProtocolState
from ..sessions.p2p_session import P2PSession
from ..sessions.spectator_session import SpectatorSession
from ..types import Event, InputStatus, LoadGameState, PlayerHandle, Request, SessionState
from ..utils.clock import Clock

DEFAULT_IDLE_TIMEOUT_MS = 30_000


class _StagedRow:
    """One parsed request segment awaiting its megabatch (or the mailbox):
    the packed control row plus the SaveGameState requests whose cells get
    their lazy checksums bound at dispatch. `last_active` (the row's 1-based
    last active slot) and `fast` (zero-rollback eligibility) are the
    depth-routing keys, computed once at parse time."""

    __slots__ = ("row", "saves", "start_frame", "count", "last_active", "fast")

    def __init__(self, row, saves, start_frame, count, last_active, fast):
        self.row = row
        self.saves = saves
        self.start_frame = start_frame
        self.count = count
        self.last_active = last_active
        self.fast = fast


class _Lane:
    """Host-side per-session state: device slot, staged rows, scheduling
    and liveness bookkeeping."""

    # a lane stages at most two rows an advance and cannot advance again
    # until they dispatch (or commit to the mailbox), so a 4-deep rotating
    # row pool never hands out a buffer still staged
    ROW_POOL = 4

    __slots__ = ("key", "session", "slot", "kind", "num_players", "local_handles", "max_prediction", "rows",
                 "current_frame", "last_activity_ms", "pending_inputs", "queued_since_tick", "ticks_advanced",
                 "throttled_ticks", "last_error", "failed", "row_pool", "row_flip")

    def __init__(self, key, session, slot, kind, num_players, local_handles, max_prediction, now_ms, packed_len):
        self.key = key
        self.session = session
        self.slot = slot
        self.kind = kind  # "p2p" | "spectator"
        self.num_players = num_players
        self.local_handles = frozenset(local_handles)
        self.max_prediction = max_prediction
        self.rows: deque = deque()
        self.current_frame = 0
        self.last_activity_ms = now_ms
        self.pending_inputs: set = set()
        self.queued_since_tick: Optional[int] = None
        self.ticks_advanced = 0
        self.throttled_ticks = 0
        self.last_error: Optional[str] = None
        self.failed = False  # its request stream failed to parse: it stops advancing
        self.row_pool = [np.empty((packed_len,), dtype=np.int32) for _ in range(self.ROW_POOL)]
        self.row_flip = 0

    def next_row_buf(self) -> np.ndarray:
        self.row_flip = (self.row_flip + 1) % len(self.row_pool)
        return self.row_pool[self.row_flip]


class SessionHost:
    """Own N sessions on one shared device core; see the module docstring.

        host = SessionHost(game, max_prediction=8, num_players=4, max_sessions=64, clock=clock)
        key = host.attach(session)            # raises HostFull past budget
        host.submit_input(key, handle, buf)   # each local player, each tick
        events = host.tick()                  # pump + stage + megabatch (or mailbox)
        host.drain(checkpoint_path="host.npz")

    Every admitted session shares the host's game config: same model, same
    input_size, and a player count <= `num_players` (absent players pad as
    DISCONNECTED, which every peer of a match does alike). `device`: "cuda"
    by default, the CPU (plain PyTorch) only when asked for."""

    def __init__(self, game, *, max_prediction: int = 8, num_players: int = 2, max_sessions: int = 16,
                 max_inflight_rows: Optional[int] = None, clock: Optional[Clock] = None,
                 idle_timeout_ms: int = DEFAULT_IDLE_TIMEOUT_MS, async_inflight: int = 4, warmup: bool = False,
                 depth_routing: bool = True, batched_pump: bool = False, mesh=None, speculation: bool = False,
                 resident: bool = False, resident_ticks: int = 16, sdc_audit_every: int = 0,
                 journal_dir: Optional[str] = None, device="cuda"):
        """`max_inflight_rows`: the rows admitted past the fence before ready
        sessions queue (default two full megabatches). `idle_timeout_ms`:
        sessions with no input or advance for this long are evicted (0
        disables). `warmup=True` builds the kernels and runs every
        megabatch depth once before the first attach. `depth_routing`: the
        fast megabatch and one a depth bucket, else one full-window
        megabatch. `resident` / `resident_ticks`: the device-resident loop
        and its mailbox depth (the drive cadence)."""
        for on, what in ((batched_pump, "batched_pump=True: the batched pump (network/pump.py)"),
                         (mesh is not None, "mesh: ShardedMultiSessionDeviceCore (ROADMAP item 10)"),
                         (speculation, "speculation=True: drafts and adoption (serve/speculation.py)"),
                         (sdc_audit_every > 0, "sdc_audit_every > 0: the SDC audit lane (serve/faults.py)"),
                         (journal_dir is not None, "journal_dir: the input journal (journal/)")):
            if on:
                raise ConfigError(f"{what} is not ported yet (ROADMAP item 4)")
        if resident and resident_ticks < 1:
            raise InvalidRequest(f"resident_ticks must be >= 1 (got {resident_ticks})")
        self.device = MultiSessionDeviceCore.create(game, max_prediction, num_players, max_sessions,
                                                    async_inflight=async_inflight, depth_routing=depth_routing,
                                                    device=device)
        self.game = game
        self.max_sessions = max_sessions
        self.num_players = num_players
        self.max_prediction = max_prediction
        self.max_inflight_rows = max_inflight_rows if max_inflight_rows is not None else 2 * max_sessions
        if self.max_inflight_rows < 1:
            raise InvalidRequest(f"max_inflight_rows must be >= 1 (got {self.max_inflight_rows})")
        core = self.device.core
        self._parse_bufs = (np.zeros((core.window, num_players, game.input_size), dtype=np.uint8),
                            np.zeros((core.window, num_players), dtype=np.int32),
                            np.full((core.window,), core.scratch_slot, dtype=np.int32))
        self.clock = clock or Clock()
        self.idle_timeout_ms = idle_timeout_ms
        self._lanes: Dict[Any, _Lane] = {}
        self._free_slots = list(range(max_sessions - 1, -1, -1))
        self._ready: deque = deque()  # keys with staged rows, arrival order (the backpressure queue)
        self._draining = False
        self._drained = False
        self._tick_index = 0
        self._next_key = 0
        self.sessions_admitted = 0
        self.sessions_rejected = 0
        self.sessions_evicted = 0
        self.sessions_gced = 0
        self.desyncs_observed = 0
        # host ticks a session's staged rows waited before dispatch (bounded)
        self.queue_waits: List[int] = []
        self.resident = resident
        self.resident_ticks = resident_ticks
        self._mbox_ticks = 0  # host ticks since the last drive
        # the drive cadence: resident_ticks, tightened as lanes with desync
        # detection attach, so a drive lands before each lane's
        # interval-forced checksum flush
        self._resident_cadence = resident_ticks
        if resident:
            self.device.attach_mailbox(resident_ticks)
        if warmup:
            self.device.warmup()

    # ------------------------------------------------------------------
    # admission / lifecycle

    def _validate_session(self, session):
        """Admission checks: session type, player-layout fit, input size,
        prediction window. Returns (kind, n_players, local_handles,
        max_prediction)."""
        if isinstance(session, P2PSession):
            kind = "p2p"
        elif isinstance(session, SpectatorSession):
            kind = "spectator"
        else:
            raise InvalidRequest(f"only P2PSession/SpectatorSession can be hosted (got {type(session).__name__})")
        n_players = session.num_players
        if n_players > self.num_players:
            raise InvalidRequest(f"session has {n_players} players; host layout is {self.num_players}")
        if session.input_size != self.game.input_size:
            raise InvalidRequest(f"session input_size {session.input_size} != game input_size "
                                 f"{self.game.input_size}")
        if kind == "p2p":
            if session.max_prediction > self.max_prediction:
                raise InvalidRequest(f"session max_prediction {session.max_prediction} exceeds the host window "
                                     f"({self.max_prediction})")
            return kind, n_players, session.local_player_handles(), session.max_prediction
        return kind, n_players, [], self.max_prediction

    def _claim_admission(self, key: Any):
        """Raises HostFull (draining / out of slots), resolves the key and
        claims the free-list head slot."""
        if self._draining:
            self.sessions_rejected += 1
            raise HostFull("host is draining: not admitting sessions")
        if not self._free_slots:
            self.sessions_rejected += 1
            raise HostFull(f"host is at max_sessions={self.max_sessions}")
        if key is None:
            key = self._next_key
            self._next_key += 1
        if key in self._lanes:
            raise InvalidRequest(f"host key {key!r} already in use")
        return key, self._pick_free_slot()

    def _pick_free_slot(self) -> int:
        """Admission's slot: the free-list head (one card, no shard
        affinity)."""
        return self._free_slots.pop()

    def _commit_lane(self, session, key: Any, slot: int, kind: str, n_players: int, local_handles,
                     max_prediction: int, current_frame: int) -> _Lane:
        if kind == "p2p":
            det = session.desync_detection
            if self.resident and det.enabled:
                # keep the drive two ticks inside the lane's desync interval
                self._resident_cadence = max(1, min(self._resident_cadence, det.interval - 2))
            # hosted lanes publish checksum reports at the interval-forced
            # flush only: publish timing is then a function of the frame
            # counter, not of when device values became ready, so a
            # resident host puts the same datagrams on a seeded wire as its
            # dispatch-per-tick twin
            session.checksum_publish = "interval"
        lane = _Lane(key, session, slot, kind, n_players, local_handles, max_prediction, self.clock.now_ms(),
                     self.device.core.packed_len)
        lane.current_frame = current_frame
        self._lanes[key] = lane
        self.sessions_admitted += 1
        return lane

    def attach(self, session, *, key: Any = None) -> Any:
        """Admit a fresh session; returns its host key. Raises HostFull at
        max_sessions or while draining, InvalidRequest when the session is
        incompatible with the host layout, already hosted or not fresh."""
        key, slot = self._claim_admission(key)
        try:
            kind, n_players, local_handles, max_prediction = self._validate_session(session)
            if kind == "p2p" and session.sync_layer.current_frame != 0:
                raise InvalidRequest(f"host requires a fresh session (frame 0); this one is at frame "
                                     f"{session.sync_layer.current_frame}")
            if kind == "spectator" and session.current_frame >= 0:
                raise InvalidRequest(f"host requires a fresh spectator session; this one already advanced to "
                                     f"frame {session.current_frame}")
            session.on_host_attach(self, key)
        except BaseException:
            self._free_slots.append(slot)
            raise
        self.device.reset_slot(slot)
        self._commit_lane(session, key, slot, kind, n_players, local_handles, max_prediction, 0)
        return key

    def detach(self, key: Any) -> None:
        """Remove a session and recycle its device slot. Staged rows that
        never dispatched are dropped with it (the slot is reset at its next
        attach, so no other session observes them)."""
        lane = self._lanes.pop(key, None)
        if lane is None:
            raise InvalidRequest(f"unknown host key {key!r}")
        if lane.queued_since_tick is not None or lane.rows:
            try:
                self._ready.remove(key)
            except ValueError:
                pass
        lane.session.on_host_detach()
        self._free_slots.append(lane.slot)

    def session(self, key: Any):
        return self._lanes[key].session

    def keys(self) -> List[Any]:
        return list(self._lanes)

    @property
    def active_sessions(self) -> int:
        return len(self._lanes)

    @property
    def queue_depth(self) -> int:
        """Ready sessions still waiting on the device-window budget."""
        return len(self._ready)

    # ------------------------------------------------------------------
    # per-tick driving

    def submit_input(self, key: Any, handle: PlayerHandle, buf: bytes) -> None:
        """Queue one local player's input for the session's next advance;
        the session advances on the next host tick once every local handle
        has input."""
        lane = self._lanes[key]
        lane.session.add_local_input(handle, buf)
        lane.pending_inputs.add(handle)
        lane.last_activity_ms = self.clock.now_ms()

    def tick(self) -> Dict[Any, List[Event]]:
        """One host cycle: pump every session's sockets, advance each ready
        session and stage its rows, dispatch megabatches under the
        device-window budget (or commit the mailbox and drive at the
        cadence), then eviction and disconnect GC. Returns the events each
        session surfaced this tick, keyed by host key."""
        self._tick_index += 1
        events: Dict[Any, List[Event]] = {}

        # 1. pump: every session's sockets drain every host tick, even for
        # sessions that will not advance (protocol liveness)
        lanes = list(self._lanes.values())
        for lane in lanes:
            try:
                lane.session.poll_remote_clients()
            except GGRSError as exc:  # keep serving the rest
                lane.last_error = type(exc).__name__
        for lane in lanes:
            evs = lane.session.events()
            if evs:
                events[lane.key] = evs
                lane.last_activity_ms = max(lane.last_activity_ms, self.clock.now_ms())
                self.desyncs_observed += sum(type(ev).__name__ == "DesyncDetected" for ev in evs)

        # 1b. drain pass: store every host-ready checksum batch and retire
        # the fence entries that finished, without waiting
        self.device.ledger.drain_ready()
        self.device.poll_retired()

        # 2. advance ready sessions and stage their rows
        for lane in list(self._lanes.values()):
            if not self._lane_ready(lane):
                continue
            try:
                requests = lane.session.advance_frame()
            except PredictionThreshold:
                # a spectator whose host input has not arrived: benign
                lane.throttled_ticks += 1
                continue
            except GGRSError as exc:
                lane.last_error = type(exc).__name__
                continue
            lane.pending_inputs.clear()
            lane.ticks_advanced += 1
            lane.last_activity_ms = self.clock.now_ms()
            try:
                self._stage(lane, requests)
            except Exception as exc:
                # fleet isolation: a session whose request stream the parser
                # rejects stops advancing (its slot may have missed a tick),
                # never a crash of the whole host tick; its earlier rows go
                # too, or they would pin the lane past eviction and GC
                lane.rows.clear()
                lane.failed = True
                lane.last_error = type(exc).__name__
                continue
            if self.resident:
                self._stage_resident(lane)
            elif lane.rows and lane.queued_since_tick is None:
                lane.queued_since_tick = self._tick_index
                self._ready.append(lane.key)

        # 3. dispatch megabatches under the device-window budget, or feed
        # the mailbox and drive at the cadence
        if self.resident:
            self._resident_pump()
        else:
            self._pump_device()

        # 4. lifecycle: disconnect GC, then idle eviction
        self._run_gc(events)
        return events

    def _stage_resident(self, lane: _Lane) -> None:
        """Move a lane's freshly parsed rows into the mailbox's fill cycle:
        saves bind lazy checksums against the cycle's future batch at their
        [K, S, W] index, so nothing waits."""
        dev = self.device
        while lane.rows:
            staged = lane.rows.popleft()
            batch, base = dev.stage_mailbox_row(lane.slot, staged.row, last_active=staged.last_active,
                                                fast=staged.fast)
            self._bind_saves(staged, batch, base)

    def _resident_pump(self) -> None:
        """The resident scheduler's tail of a host tick: land this tick's
        staged rows on the device in one scatter, then drive every
        `resident_ticks` host ticks (the cadence), or early once a lane is
        within two rows of the mailbox depth, so a two-row tick never
        overflows in steady state."""
        dev = self.device
        mbox = dev.mailbox
        dev.commit_mailbox()
        if not mbox.pending_rows:
            self._mbox_ticks = 0
            return
        self._mbox_ticks += 1
        if self._mbox_ticks >= self._resident_cadence or mbox.max_fill() >= mbox.depth - 2:
            dev.drive_mailbox()  # no recovery ladder: a refused launch raises KernelError
            self._mbox_ticks = 0

    def _lane_ready(self, lane: _Lane) -> bool:
        if lane.failed or lane.rows:  # staged rows dispatch before the next advance
            return False
        s = lane.session
        if s.current_state() != SessionState.RUNNING:
            return False
        if lane.kind == "spectator":
            return True
        if not lane.local_handles <= lane.pending_inputs:
            return False
        # mirror the sync layer's prediction-threshold gate on the FRESH
        # confirmed frame (the min over connected peers advance_frame is
        # about to set), so a throttled session never advances into the
        # PredictionThreshold raise mid-advance
        sl = s.sync_layer
        if sl.current_frame >= lane.max_prediction:
            confirmed = min((st.last_frame for st in s.local_connect_status if not st.disconnected), default=None)
            if confirmed is None or sl.current_frame - confirmed >= lane.max_prediction:
                lane.throttled_ticks += 1
                return False
        return True

    # ------------------------------------------------------------------
    # request staging (parse -> packed rows)

    def _stage(self, lane: _Lane, requests: List[Request]) -> None:
        # a load begins a new segment; steady traffic carries none, so the
        # whole list stages as one segment
        if not requests:
            return
        start = 0
        for i in range(1, len(requests)):
            if isinstance(requests[i], LoadGameState):
                self._stage_segment(lane, requests[start:i])
                start = i
        self._stage_segment(lane, requests if start == 0 else requests[start:])

    def _parse_staging(self):
        """The host-wide pooled parse triple (inputs, statuses, save_slots),
        refilled with neutral values a segment: packing consumes it at
        once, so one triple serves the whole fleet."""
        inputs, statuses, save_slots = self._parse_bufs
        inputs.fill(0)
        statuses.fill(0)
        save_slots.fill(self.device.core.scratch_slot)
        return inputs, statuses, save_slots

    def _stage_segment(self, lane: _Lane, requests: List[Request]) -> None:
        core = self.device.core
        inputs, statuses, save_slots = self._parse_staging()
        if lane.num_players < self.num_players:
            # players beyond the session's count pad as DISCONNECTED: the
            # game substitutes its deterministic dummy input
            statuses[:, lane.num_players:] = int(InputStatus.DISCONNECTED)
        load, start_frame, count, saves, last_active, trailing = parse_request_segment(
            requests, window=core.window, ring_len=core.ring_len, max_prediction=core.max_prediction,
            current_frame=lane.current_frame, inputs=inputs, statuses=statuses, save_slots=save_slots)
        # each row's canonical signature into the shared plan cache
        self.device.plan_cache.note((load is not None, count, last_active, trailing is not None))
        row = core.pack_tick_row_into(lane.next_row_buf(), load is not None,
                                      (load.frame % core.ring_len) if load is not None else 0, inputs, statuses,
                                      save_slots, count, start_frame)
        lane.rows.append(_StagedRow(row, saves, start_frame, count, last_active,
                                    self.device.fast_eligible(row, last_active)))
        lane.current_frame = start_frame + count

    # ------------------------------------------------------------------
    # megabatch scheduling

    def _pump_device(self) -> None:
        """Coalesce the ready queue's head rows into megabatches, oldest
        arrivals first, until the device window is full or the queue is
        empty. One row a session a megabatch keeps each session's requests
        in order; a session with a second staged row keeps its queue
        position. The core's `group` splits each pass's rows into
        megabatches (with depth routing the fast group and one a depth
        bucket). The port has no fault ladder: a refused launch raises
        KernelError."""
        W = self.device.core.window
        while self._ready:
            budget = self.max_inflight_rows - self.device.poll_retired()
            if budget <= 0:
                break
            take = min(budget, len(self._ready), self.device.capacity)
            picked = {}
            for key in self._ready:
                if len(picked) >= take:
                    break
                lane = self._lanes[key]
                picked[lane.slot] = (lane, lane.rows[0])
            groups = self.device.group([(slot, staged.row, staged.last_active)
                                        for slot, (_, staged) in picked.items()])
            for gkey, entries, last_active in groups:
                batch, _ = self.device.dispatch(entries, fast=gkey == "fast", last_active=last_active)
                for k, (slot, _) in enumerate(entries):
                    self._retire_row(*picked[slot], batch, k * W)

    def _bind_saves(self, staged: _StagedRow, batch, base: int) -> None:
        ring_len = self.device.core.ring_len
        for slot_i, save in staged.saves:
            save.cell.save_lazy(save.frame, SnapshotRef(save.frame, save.frame % ring_len),
                                _LazyChecksum(batch, base + slot_i))

    def _retire_row(self, lane: _Lane, staged: _StagedRow, batch, base: int) -> None:
        """After a megabatch: pop the staged row, bind its saves' lazy
        checksums at `base` into the batch, and settle the lane's
        queue-wait accounting when its last row dispatched."""
        lane.rows.popleft()
        self._bind_saves(staged, batch, base)
        if not lane.rows:
            self._ready.remove(lane.key)
            if len(self.queue_waits) < 1 << 16:
                self.queue_waits.append(self._tick_index - lane.queued_since_tick)
            lane.queued_since_tick = None

    # ------------------------------------------------------------------
    # eviction / GC / drain

    def _run_gc(self, events: Dict[Any, List[Event]]) -> None:
        now = self.clock.now_ms()
        for lane in list(self._lanes.values()):
            if lane.rows:
                continue  # its staged work dispatches first
            if self._all_remotes_gone(lane):
                self._evict(lane)
                self.sessions_gced += 1
                continue
            if self.idle_timeout_ms > 0 and now - lane.last_activity_ms >= self.idle_timeout_ms:
                self._evict(lane)

    def _all_remotes_gone(self, lane: _Lane) -> bool:
        """Disconnect GC: a P2P session whose every remote peer (players
        and spectators) has disconnected serves nobody; a spectator whose
        host endpoint died can never advance again."""
        s = lane.session
        if lane.kind == "spectator":
            return s.host.state in (ProtocolState.DISCONNECTED, ProtocolState.SHUTDOWN)
        remotes = s.remote_player_handles()
        if not remotes:
            return False  # a local-only session: nothing to GC on
        if any(not s.local_connect_status[h].disconnected for h in remotes):
            return False
        return not any(ep.is_running() for ep in s.player_reg.spectators.values())

    def _evict(self, lane: _Lane) -> None:
        self.sessions_evicted += 1
        self.detach(lane.key)

    def _flush_ready(self, reason: str, *, max_passes: int = 10_000) -> None:
        """Flush every staged row through the device (the tail of drain and
        checkpoint); a queue that will not empty raises DrainStalled with
        its depth and the fence state. `block_until_ready` drives the
        mailbox too."""
        passes = 0
        while self._ready:
            self.device.block_until_ready()
            self._pump_device()
            passes += 1
            if passes >= max_passes and self._ready:
                raise DrainStalled(f"{reason}: ready queue failed to flush", queue_depth=len(self._ready),
                                   inflight_rows=self.device.inflight_rows, passes=passes)
        self.device.block_until_ready()

    def checkpoint(self, path: str) -> None:
        """Checkpoint the stacked device worlds without draining: flush the
        staged rows, the mailbox and the fence, write the .npz (the
        reference's format), keep serving."""
        self._flush_ready("checkpoint")
        self.device.save(path)

    def drain(self, checkpoint_path: Optional[str] = None) -> dict:
        """Graceful shutdown: stop admitting (attach raises HostFull), flush
        every staged row and the fence, optionally checkpoint, and return a
        summary. Sessions stay attached."""
        self._draining = True
        self._flush_ready("drain")
        if checkpoint_path is not None:
            self.device.save(checkpoint_path)
        self._drained = True
        summary = self._host_section()
        summary["checkpoint"] = checkpoint_path
        return summary

    @property
    def draining(self) -> bool:
        return self._draining

    def _host_section(self) -> dict:
        dev = self.device
        sessions = {}
        for key, lane in self._lanes.items():
            entry = {"kind": lane.kind, "slot": lane.slot, "state": lane.session.current_state().value,
                     "current_frame": lane.current_frame, "staged_rows": len(lane.rows),
                     "ticks_advanced": lane.ticks_advanced, "throttled_ticks": lane.throttled_ticks}
            if lane.last_error:
                entry["last_error"] = lane.last_error
            if lane.failed:
                entry["failed"] = True
            sessions[str(key)] = entry
        out = {
            "active": len(self._lanes), "max_sessions": self.max_sessions, "draining": self._draining,
            "admitted": self.sessions_admitted, "rejected": self.sessions_rejected,
            "evicted": self.sessions_evicted, "disconnect_gced": self.sessions_gced,
            "desyncs_observed": self.desyncs_observed, "queue_depth": len(self._ready),
            "inflight_rows": dev.inflight_rows, "max_inflight_rows": self.max_inflight_rows,
            "megabatches": dev.megabatches, "rows_dispatched": dev.rows_dispatched,
            "mean_megabatch_rows": round(dev.rows_dispatched / dev.megabatches, 3) if dev.megabatches else None,
            "plan_signatures": len(dev.plan_cache.signatures), "buckets": list(dev.buckets),
            "sessions": sessions,
        }
        if self.resident:
            out["resident"] = {
                "depth": self.resident_ticks, "driver_dispatches": dev.driver_dispatches,
                "vticks_executed": dev.vticks_executed,
                "vticks_per_dispatch": (round(dev.vticks_executed / dev.driver_dispatches, 3)
                                        if dev.driver_dispatches else None),
                "mailbox_pending": dev.mailbox.pending_rows, "mailbox_overflows": dev.mailbox.overflows,
            }
        return out
