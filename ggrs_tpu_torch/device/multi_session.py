"""MultiSessionDeviceCore: N independent session worlds stacked on a leading
slot axis, ticked by cross-session megabatches — the port of
`ggrs_tpu/tpu/backend.py:1762` `MultiSessionDeviceCore`, on one card.

Every hosted session keeps the request/cell contract of the solo backend
(packed control-word rows in, lazy checksums out), but instead of one
dispatch per session per tick the host hands each ready session's packed
row to `dispatch` and a megabatch runs them all: on CUDA ONE launch of K3's
stacked entry (`tick_core.StackedTickCore`), whose row r ticks slot idx[r]'s
world in place — no gather and no scatter of ring copies, where the
reference vmaps the single-session tick over gathered worlds — through the
first `nslots` window slots (the depth bucket; the zero-rollback fast rows
at 2: a save of the current frame, one advance, a trailing save). Arena has
no stacked body: its rows run one K3-arena launch each on the slot's views
of the stacked tensors. On the CPU a megabatch runs `plain_megabatch`.

The stack (`stack`, a dict of tensors on the core's device):

    state       i32[S, K, N]         the live worlds (K planes)
    state_frame i32[S]               each world's own frame
    ring        i32[S, R+1, K, N]    each session's snapshot ring (slot R scratch)
    r_frame     i32[S, R+1]          the rings' frame tags

with S = capacity + 1: slot `capacity` is the dummy world that pad rows
would no-op against (`pad_slot`); the port does not launch pad rows, and
their checksums read (0, 0). The slot layout is the identity (`_phys`,
`phys_index`, `shard_of` keep the reference's API for a sharded layout).

Row counts pad to `buckets` and depths to `depth_buckets` as in the
reference, and each megabatch is tallied in the DispatchPlanCache as
("megabatch", row bucket, depth) — 0 the fast dispatch, None the full
window — so `megabatch_programs` reads as the reference's. Megabatches are
fenced: a CUDA event after each (`backend.InflightFence`, the solo
backend's async fence), the host waiting on the oldest once more than
`async_inflight` are in flight; the (idx, rows) staging comes from a
pinned pool per bucket, `async_inflight + 1` deep, uploaded without
waiting. `poll_retired` and `inflight_rows` are the host's backpressure
signals.

The host-wide player layout is `num_players`: a narrower session's rows
pad its absent players as DISCONNECTED, so the game substitutes its
deterministic dummy input (reference `:1795-1799`). Entry k's window slot
i checksum is at flat index k * W + i of the returned batch. Checkpoints
and slot exports are in the reference's layout and `.npz` format, so
either stack resumes the other's.

The resident half (the reference's `backend.py:2694-2953`): `attach_mailbox
(depth)` builds a `DeviceMailbox` (device/mailbox.py), an [S, K, L] ring of
packed rows on the device; `stage_mailbox_row` appends a logical slot's row
to the fill cycle (a full lane, or a fault seam's storm, means one extra
drive first, never a dropped row), `commit_mailbox` lands the staged rows
in one scatter admitted to the fence, and `drive_mailbox` consumes the
cycle in ONE launch of K3's resident entry (`tick_core.ResidentTickCore`;
arena: a K3-arena launch a live lane), the routing decided a cycle at a
time — 2 window slots when every row of the cycle is fast, else the depth
bucket of the cycle's deepest row — where the reference routes each
virtual tick inside its loop (both give the same bits by the depth-routing
contract). Lifecycle events and every read of the worlds drive first:
`reset_slot`, `reset_slots_masked` and `block_until_ready` (hence
`stacked_canonical`, `checksum_slots`, `save`, `export_slot`) see every
staged row. `driver_dispatches`, `vticks_executed` and `rows_dispatched`
count the drives.

Left out (ROADMAP.md): speculative bubble-filling (`draft`, `adopt_slot`)
and the SDC audit lane (`audit_rows`, `inject_slot_bitflip`), whose callers
are `serve/speculation.py` and `serve/faults.py` (item 4),
`ShardedMultiSessionDeviceCore` (item 10), and telemetry and the
sanitizer's `transfer_guard_scope`. `fault_seam` is consulted before every
megabatch and drive, as in the reference.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..convert import planes_to_reference
from ..errors import CheckpointIncompatible, ConfigError, ContractViolation, MigrationIncompatible
from ..ops import fixed_point as fx
from ..utils.checkpoint import load_device_checkpoint, save_device_checkpoint
from .backend import ChecksumLedger, DispatchPlanCache, InflightFence, StagingPool, _ChecksumBatch
from .planes import layout_of, pack_planes, partial_checksum_planes
from .resim import ResimCore
from .tick_core import ResidentTickCore, StackedTickCore, check_rows, windowed_row

def _planes_of(tree: dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reference-layout leaves (any leading dims) -> (packed planes, frames)
    as int32 host tensors."""
    planes = pack_planes(layout_of(keys=tree),
                         {k: torch.from_numpy(np.array(v, dtype=np.int32)) for k, v in tree.items() if k != "frame"})
    return planes, torch.from_numpy(np.array(tree["frame"], dtype=np.int32))


def _leaf_specs(tree: dict) -> dict:
    return {k: (tuple(np.shape(v)), np.asarray(v).dtype) for k, v in tree.items()}


class MultiSessionDeviceCore:
    """N session worlds stacked on one device, ticked by megabatches (the
    module docstring). `device`: "cuda" by default, the CPU (plain
    PyTorch) only when asked for."""

    def __init__(self, game, max_prediction: int, num_players: int, capacity: int, *,
                 async_inflight: int = 4, buckets: Optional[Sequence[int]] = None,
                 depth_buckets: Optional[Sequence[int]] = None,
                 depth_routing: bool = True, device="cuda"):
        """`num_players`: the host-wide player layout. `buckets`: the row
        counts megabatches pad to (default: powers of two up to capacity,
        and capacity). `depth_buckets`: the windowed depths (default:
        powers of two from 2 up to the window, and the window);
        `depth_bucket_for` raises past them. `depth_routing`: `group` sends a
        host tick's rows to the fast dispatch and the depth buckets, else
        to one full-window megabatch, and warmup covers the depths it
        dispatches."""
        if capacity < 1:
            raise ConfigError(f"capacity must be >= 1, got {capacity}")
        # the template core: the packed-row layout, the kernels' context,
        # the init world, and arena's per-row K3 wrapper
        self.core = ResimCore(game, max_prediction, num_players, device=device)
        self.device = self.core.device
        self.capacity = capacity
        self.num_players = num_players
        self.input_size = game.input_size
        self.async_inflight = async_inflight
        self.depth_routing = depth_routing
        self.plan_cache = DispatchPlanCache()
        self.ledger = ChecksumLedger()
        if buckets is None:
            buckets, b = {capacity}, 1
            while b < capacity:
                buckets.add(b)
                b *= 2
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        if self.buckets[-1] < capacity:
            raise ConfigError("the largest bucket must cover a full-capacity megabatch")
        W = self.core.window
        if depth_buckets is None:
            depths, d = {W}, 2
            while d < W:
                depths.add(d)
                d *= 2
        else:
            depths = set(int(d) for d in depth_buckets)
            if not depths or max(depths) > W or min(depths) < 1:
                raise ConfigError(f"depth buckets must lie in 1..{W}, got {sorted(depths)}")
        self.depth_buckets = tuple(sorted(depths))
        self.stack_slots = capacity + 1
        self._init_slot_layout()
        self.tick_core = StackedTickCore(self.core)
        self.fence = InflightFence(async_inflight, self.device)
        self._pad_row = self.core.pad_tick_row()
        self._stage_pools: dict = {}
        self.fault_seam = None  # consulted before every megabatch (serve/faults.py's seam)
        self.megabatches = 0
        self.rows_dispatched = 0
        # the resident loop (attach_mailbox builds the mailbox and the drive)
        self.mailbox = None
        self.resident_core = None
        self.driver_dispatches = 0
        self.vticks_executed = 0
        self._init_stack()

    @classmethod
    def create(cls, game, max_prediction: int, num_players: int, capacity: int, *, mesh=None,
               **kw) -> "MultiSessionDeviceCore":
        """The factory the host, the env and checkpoint restore call. A
        session mesh (the reference's ShardedMultiSessionDeviceCore) is not
        ported."""
        if mesh is not None:
            raise ConfigError("a session mesh (ShardedMultiSessionDeviceCore) is not ported: ROADMAP item 10")
        return cls(game, max_prediction, num_players, capacity, **kw)

    # ------------------------------------------------------------------
    # the stack and its slot layout

    def _init_stack(self) -> None:
        c, S, dev = self.core.carry, self.stack_slots, self.device
        self.stack = {
            "state": c["state"].unsqueeze(0).repeat(S, 1, 1).contiguous(),
            "state_frame": torch.zeros(S, dtype=torch.int32, device=dev),
            "ring": torch.zeros((S,) + tuple(c["ring"].shape), dtype=torch.int32, device=dev),
            "r_frame": torch.zeros((S, self.core.ring_len + 1), dtype=torch.int32, device=dev),
        }
        self._init_state = c["state"].clone()
        # the reference layout of one slot: what import_slot validates
        self._slot_specs = {name: _leaf_specs(tree) for name, tree in self._export_phys(0).items()}

    def _init_slot_layout(self) -> None:
        """The logical slot -> stack index map: the identity on one card,
        the dummy at `capacity`."""
        self._phys = np.arange(self.capacity, dtype=np.int32)
        self.pad_slot = self.capacity

    def shard_of(self, slot: int) -> int:
        """The shard a slot's world lives on: 0 on one card."""
        return 0

    def phys_index(self, slots) -> np.ndarray:
        """Stack indices of logical slots (what a reader of `stack` uses)."""
        return self._phys[np.asarray(slots, dtype=np.int32)]

    # ------------------------------------------------------------------
    # routing

    def bucket_for(self, n: int) -> int:
        """The smallest row bucket covering n rows."""
        for b in self.buckets:
            if b >= n:
                return b
        raise ContractViolation(f"{n} rows exceed the largest bucket")

    def depth_bucket_for(self, last_active: int) -> int:
        """The smallest depth bucket covering a 1-based last active slot."""
        for d in self.depth_buckets:
            if d >= last_active:
                return d
        raise ContractViolation(f"{last_active} slots exceed the depth buckets {self.depth_buckets}")

    def dispatch_bucket_budget(self) -> int:
        """The megabatch grid's size: a program per (row bucket x depth
        bucket) and the fast dispatch per row bucket."""
        return len(self.buckets) * (len(self.depth_buckets) + 1)

    def megabatch_programs(self) -> List[Tuple[int, Optional[int], int]]:
        """(row bucket, depth, dispatch count) per tallied megabatch shape:
        depth 0 the fast dispatch, an int the depth bucket, None the full
        window."""
        return [(sig[1], sig[2], c) for sig, c in self.plan_cache.signatures.items()
                if isinstance(sig, tuple) and sig and sig[0] == "megabatch"]

    def fast_eligible(self, row: np.ndarray, last_active: Optional[int] = None) -> bool:
        """May this row ride the zero-rollback fast dispatch? No load,
        exactly one advance, no active slot past 1."""
        if int(row[0]) != 0 or int(row[2]) != 1:
            return False
        if last_active is None:
            core = self.core
            return bool((np.asarray(row[core.off_save + 2 : core.off_status]) >= core.ring_len).all())
        return last_active <= 2

    def group(self, entries) -> List[Tuple[object, List[Tuple[int, np.ndarray]], Optional[int]]]:
        """One host tick's (slot, packed row, last_active) entries grouped
        into megabatches as the reference host groups them (serve/host.py
        `_pump_device`): with depth routing the fast rows first, then one
        group per occupied depth bucket, shallowest first; without, one
        full-window group. Returns [(key, [(slot, row)], last_active)]:
        key "fast", the depth bucket, or None for the full window (with
        last_active None), each group one `dispatch(group, fast=key ==
        "fast", last_active=last_active)`."""
        if not self.depth_routing:
            return [(None, [(s, r) for s, r, _ in entries], None)]
        groups: dict = {}
        for slot, row, la in entries:
            key = "fast" if self.fast_eligible(row, la) else self.depth_bucket_for(la)
            groups.setdefault(key, []).append((slot, row, la))
        keys = (["fast"] if "fast" in groups else []) + sorted(k for k in groups if k != "fast")
        return [(k, [(s, r) for s, r, _ in groups[k]], max(la for *_, la in groups[k])) for k in keys]

    def group_depth(self, key) -> int:
        """The window slots a megabatch of group key `key` runs: 2 for the
        fast rows (a save, one advance, a trailing save), else the depth
        bucket, or the window for None."""
        return 2 if key == "fast" else self.core.window if key is None else key

    # ------------------------------------------------------------------
    # megabatches

    def _acquire_stage(self, bucket: int, n: int) -> Tuple[torch.Tensor, np.ndarray, np.ndarray]:
        """The next pooled staging buffer of `bucket`: n slot indices, then
        n packed rows, contiguous; returns (the tensor of its first
        n * (1 + L) words, the idx view, the rows view)."""
        pool = self._stage_pools.get(bucket)
        if pool is None:
            pool = self._stage_pools[bucket] = StagingPool(
                (bucket * (1 + self.core.packed_len),), self.async_inflight + 1, self.device.type == "cuda")
        tensor, words = pool.next()
        L = self.core.packed_len
        return tensor[: n * (1 + L)], words[:n], words[n : n * (1 + L)].reshape(n, L)

    def dispatch(self, entries, *, last_active: Optional[int] = None,
                 fast: bool = False) -> Tuple[_ChecksumBatch, int]:
        """Run one megabatch of `entries`, (slot, packed row) pairs with AT
        MOST ONE row per slot (a session's second row rides the next
        megabatch). `fast=True`: every row must be fast_eligible;
        `last_active`: the rows' largest 1-based last active slot, run at
        the depth bucket covering it; neither: the full window. Returns
        (checksum batch, bucket); entry k's window slot i is at flat index
        k * W + i. Does not wait beyond the fence."""
        n = len(entries)
        if not 0 < n <= self.capacity:
            raise ContractViolation(f"a megabatch of {n} rows on {self.capacity} slots")
        slots = [int(slot) for slot, _ in entries]
        if len(set(slots)) != n or min(slots) < 0 or max(slots) >= self.capacity:
            raise ContractViolation(f"one row per live session slot per megabatch, got slots {slots}")
        if self.fault_seam is not None:
            # before anything changes: a raise leaves the worlds untouched
            self.fault_seam.before_dispatch("megabatch", slots)
        bucket = self.bucket_for(n)
        staged, idx, rows = self._acquire_stage(bucket, n)
        idx[:] = self._phys[slots]
        for k, (_, row) in enumerate(entries):
            rows[k] = row
        return self._dispatch_staged(staged, idx, rows, bucket, last_active=last_active, fast=fast)

    def dispatch_rows(self, idx_block: np.ndarray, rows_block: np.ndarray, *,
                      last_active: Optional[int] = None, fast: bool = False) -> Tuple[_ChecksumBatch, int]:
        """dispatch() for a caller that holds a whole [n, L] row block and
        its [n] slot vector (the batched env): two block copies into the
        pooled staging. Same contract as dispatch()."""
        idx_block = np.asarray(idx_block)
        n = int(idx_block.shape[0])
        if not 0 < n <= self.capacity or rows_block.shape[0] != n:
            raise ContractViolation(f"a megabatch of {n} rows ({rows_block.shape[0]} packed) on "
                                    f"{self.capacity} slots")
        if len(np.unique(idx_block)) != n or idx_block.min() < 0 or idx_block.max() >= self.capacity:
            raise ContractViolation(f"one row per live session slot per megabatch, got slots {idx_block.tolist()}")
        if self.fault_seam is not None:
            self.fault_seam.before_dispatch("megabatch_rows", [int(s) for s in idx_block])
        bucket = self.bucket_for(n)
        staged, idx, rows = self._acquire_stage(bucket, n)
        idx[:] = self._phys[idx_block]
        rows[:] = rows_block
        return self._dispatch_staged(staged, idx, rows, bucket, last_active=last_active, fast=fast)

    def _dispatch_staged(self, staged: torch.Tensor, idx: np.ndarray, rows: np.ndarray, bucket: int, *,
                         last_active: Optional[int], fast: bool) -> Tuple[_ChecksumBatch, int]:
        """The common tail: the depth (fast 2, a depth bucket, or the
        window), the row checks, the plan-cache tally, the upload, the
        launch and the fence."""
        core = self.core
        n = idx.shape[0]
        check_rows(rows, core)
        if fast:
            tail = rows[:, core.off_save + 2 : core.off_status]
            if not ((rows[:, 0] == 0).all() and (rows[:, 2] == 1).all() and (tail >= core.ring_len).all()):
                raise ContractViolation("fast dispatch carries a row with a load, a multi-advance or a save "
                                        "past window slot 1")
            nslots, sig_depth = 2, 0
        elif last_active is not None:
            nslots = sig_depth = self.depth_bucket_for(last_active)
        else:
            nslots, sig_depth = core.window, None
        self.plan_cache.note(("megabatch", bucket, sig_depth))
        tc = self.tick_core
        if not tc.stacked and self.device.type == "cuda":
            # arena's per-row launches run the whole window: window the rows here
            for k in range(n):
                rows[k] = windowed_row(rows[k], nslots, core)
        words = staged if self.device.type == "cpu" else staged.to(self.device, non_blocking=True)
        idx_t, rows_t = words[:n], words[n:].view(n, core.packed_len)
        his, los = tc.tick(self.stack, idx_t, rows_t, nslots, bucket, slots=idx.tolist())
        self.megabatches += 1
        self.rows_dispatched += n
        self.fence.note(n)
        return _ChecksumBatch(his, los, self.ledger), bucket

    # ------------------------------------------------------------------
    # the resident loop: the device mailbox and its drive

    def attach_mailbox(self, depth: int):
        """Build the device mailbox of `depth` virtual ticks a lane and its
        drive (K3's resident entry). Call before warmup()."""
        from .mailbox import DeviceMailbox

        if self.mailbox is not None:
            raise ContractViolation("mailbox already attached")
        self.mailbox = DeviceMailbox(self, depth)
        self.resident_core = ResidentTickCore(self.core, self.stack_slots, depth, self.async_inflight + 1)
        return self.mailbox

    def stage_mailbox_row(self, slot: int, row: np.ndarray, *, last_active: int, fast: bool):
        """Append one LOGICAL slot's packed tick row to the fill cycle;
        returns (checksum batch, base index) for the row's save bindings. A
        full lane (the host outran the depth) degrades to an EXTRA drive,
        never a dropped row."""
        mbox = self.mailbox
        phys = int(self._phys[slot])
        storm = self.fault_seam is not None and self.fault_seam.on_stage(phys)
        if mbox.lane_full(phys) or storm:
            mbox.note_overflow()
            self.drive_mailbox()
        return mbox.stage(phys, row, last_active, fast)

    def commit_mailbox(self) -> None:
        """Land every row staged since the last commit on the device, one
        scatter a chunk, each admitted to the fence (the pooled commit
        staging is reused only after it retired)."""
        mbox = self.mailbox
        if mbox is None or mbox.staged_count == 0:
            return
        for _ in range(mbox.commit()):
            self.fence.note(0)

    def drive_mailbox(self):
        """Consume the mailbox with ONE drive: commit what is staged, close
        the cycle, run every live lane's rows (K3's resident entry), and
        fulfil the cycle's future checksum batch with the [K, S, W] output.
        Returns the batch (None for an empty mailbox). Waits no further than
        the fence."""
        mbox = self.mailbox
        if mbox is None or (mbox.pending_rows == 0 and mbox.staged_count == 0):
            return None
        if self.fault_seam is not None:
            # every lane with rows this drive would run (staged rows count
            # too), as logical slots (the layout is the identity), before
            # anything changes: a raise leaves the cycle intact
            live = np.nonzero(mbox._counts)[0].tolist()
            self.fault_seam.before_dispatch("resident_drive", [p for p in live if p < self.capacity])
        self.commit_mailbox()
        marks, n_rows, max_la, all_fast, future = mbox.take_cycle()
        nslots = 2 if all_fast else self.depth_bucket_for(max_la)
        self.plan_cache.note(("resident_drive", 0 if all_fast else nslots))
        his, los = self.resident_core.drive(self.stack, mbox.rows_dev, marks, nslots)
        self.driver_dispatches += 1
        self.vticks_executed += int(marks.max())
        self.rows_dispatched += n_rows
        self.fence.note(n_rows)
        batch = _ChecksumBatch(his, los, self.ledger)
        if future is not None:
            future.batch = batch
        return batch

    def drop_mailbox_lane(self, slot: int) -> int:
        """Discard every row LOGICAL slot `slot` still owes the mailbox: its
        watermark drops to zero, so rows already committed never run.
        Returns the rows dropped."""
        if self.mailbox is None:
            return 0
        return self.mailbox.drop_lane(int(self._phys[slot]))

    def poll_retired(self) -> int:
        """Drop retired megabatches from the fence without waiting; returns
        the rows still in flight (the host's backpressure budget)."""
        return self.fence.poll()

    @property
    def inflight_rows(self) -> int:
        return self.fence.rows

    # ------------------------------------------------------------------
    # slot lifecycle

    def reset_slot(self, slot: int) -> None:
        """Return one slot to its initial world: the init state, frame 0, a
        zeroed ring."""
        if not 0 <= slot < self.capacity:
            raise ContractViolation(f"slot {slot} outside 0..{self.capacity - 1}")
        self.reset_slots_masked(np.arange(self.capacity) == slot)

    def reset_slots_masked(self, mask: np.ndarray) -> None:
        """Return every slot with mask[slot] (bool[capacity]) to its initial
        world in one pass of indexed writes."""
        mask = np.asarray(mask, dtype=bool)
        if mask.shape != (self.capacity,):
            raise ContractViolation(f"reset mask of shape {mask.shape}, expected ({self.capacity},)")
        self.drive_mailbox()  # staged rows run before any lifecycle event
        phys = self._phys[mask]
        if not len(phys):
            return
        st = self.stack
        sel = torch.from_numpy(phys.astype(np.int64)).to(self.device)
        st["state"].index_copy_(0, sel, self._init_state.expand((len(phys),) + tuple(self._init_state.shape)))
        for key in ("state_frame", "ring", "r_frame"):
            st[key].index_fill_(0, sel, 0)

    def state_numpy(self, slot: int) -> dict:
        """Host copy of one slot's live world in the reference's layout."""
        self.block_until_ready()
        return self._export_phys(int(self._phys[slot]))["state"]

    def _export_phys(self, phys: int) -> dict:
        st = self.stack
        return {
            "ring": planes_to_reference(st["ring"][phys], st["r_frame"][phys].cpu().numpy().astype(np.int32)),
            "state": planes_to_reference(st["state"][phys], np.int32(int(st["state_frame"][phys]))),
        }

    def export_slot(self, slot: int) -> dict:
        """Host copy of one slot's whole device residue, live world and
        snapshot ring, as {"ring": tree, "state": tree} of numpy arrays in
        the reference's layout (what a sibling host needs to resume the
        session bit for bit)."""
        if not 0 <= slot < self.capacity:
            raise ContractViolation(f"slot {slot} outside 0..{self.capacity - 1}")
        self.block_until_ready()
        return self._export_phys(int(self._phys[slot]))

    def import_slot(self, slot: int, payload: dict) -> None:
        """Adopt an export_slot() payload of either stack into one slot.
        The payload's keys, shapes and dtypes are checked against this
        core's slot layout first: a mismatch raises MigrationIncompatible
        naming it."""
        if not 0 <= slot < self.capacity:
            raise ContractViolation(f"slot {slot} outside 0..{self.capacity - 1}")
        for name, want in self._slot_specs.items():
            tree = payload.get(name)
            if not isinstance(tree, dict) or set(tree) != set(want):
                got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
                raise MigrationIncompatible(f"slot payload '{name}' holds {got}, this core's slots hold "
                                            f"{sorted(want)} (another game model?)")
            for key, (shape, dtype) in want.items():
                arr = np.asarray(tree[key])
                if arr.shape != shape or arr.dtype != dtype:
                    raise MigrationIncompatible(f"slot payload '{name}/{key}' is {arr.shape}/{arr.dtype}, this "
                                                f"core's slots are {shape}/{dtype}: the hosts run different "
                                                "game configs")
        self.block_until_ready()
        phys = int(self._phys[slot])
        ring, r_frame = _planes_of(payload["ring"])
        state, frame = _planes_of(payload["state"])
        st = self.stack
        st["ring"][phys].copy_(ring)
        st["r_frame"][phys].copy_(r_frame)
        st["state"][phys].copy_(state)
        st["state_frame"][phys].copy_(frame)

    def checksum_slots(self) -> Tuple[np.ndarray, np.ndarray]:
        """(hi, lo) uint32[capacity]: the game's checksum of every live
        slot's world, logical order (a desync spot-check; not a hot
        path)."""
        self.block_until_ready()
        ctx, st = self.core.ctx, self.stack
        parts = torch.stack([torch.stack(partial_checksum_planes(st["state"][p], ctx.weights))
                             for p in self._phys]).cpu().numpy().astype(np.int64)
        frames = st["state_frame"][torch.from_numpy(self._phys.astype(np.int64)).to(self.device)]
        frames = frames.cpu().numpy().astype(np.int64)
        fw = ctx.cs_frame_weight & fx.MASK32
        hi = (parts[:, 0] + frames * fw) & fx.MASK32
        lo = (parts[:, 1] + frames) & fx.MASK32
        return hi.astype(np.uint32), lo.astype(np.uint32)

    # ------------------------------------------------------------------
    # warmup, fence, checkpoints

    def warmup(self) -> None:
        """Build and load the kernels and run each megabatch depth once on
        the dummy slot with the no-op pad row (the fast depth and every
        depth bucket, or the full window without depth routing; arena's
        per-row launch makes its layout), then the masked reset with an
        empty mask and an export -> import round trip of slot 0: the worlds
        are as they were."""
        core = self.core
        depths = ([2] + list(self.depth_buckets)) if self.depth_routing else [core.window]
        pad = torch.from_numpy(self._pad_row[None].copy()).to(self.device)
        idx = torch.tensor([self.pad_slot], dtype=torch.int32, device=self.device)
        for nslots in depths:
            self.tick_core.tick(self.stack, idx, pad, nslots, 1, slots=[self.pad_slot])
        self.reset_slots_masked(np.zeros(self.capacity, dtype=bool))
        self.import_slot(0, self.export_slot(0))
        self.block_until_ready()

    def block_until_ready(self) -> None:
        """Wait for every dispatch; the mailbox drives first, so the worlds
        read afterwards have run every staged row."""
        self.drive_mailbox()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.fence.clear()

    def stacked_canonical(self) -> Tuple[dict, dict]:
        """Host copy of the stacked worlds in the canonical slot layout —
        `capacity` live slots in logical order and one dummy row — as the
        reference's (rings, states) numpy trees: what save() writes and
        load_stacked() adopts."""
        self.block_until_ready()
        st = self.stack
        order = torch.from_numpy(np.append(self._phys, self.pad_slot).astype(np.int64)).to(self.device)
        rings = planes_to_reference(st["ring"][order], st["r_frame"][order].cpu().numpy().astype(np.int32))
        states = planes_to_reference(st["state"][order], st["state_frame"][order].cpu().numpy().astype(np.int32))
        return rings, states

    def save(self, path: str) -> None:
        """Write the stacked worlds as the reference's `save` does (its
        .npz format, kind "MultiSessionDeviceCore")."""
        rings, states = self.stacked_canonical()
        save_device_checkpoint(path, {"rings": rings, "states": states}, {
            "kind": "MultiSessionDeviceCore",
            "capacity": self.capacity,
            "max_prediction": self.core.max_prediction,
            "num_players": self.num_players,
        })

    @classmethod
    def restore(cls, path: str, game, mesh=None, device="cuda") -> "MultiSessionDeviceCore":
        """A core rebuilt from a save() checkpoint of either stack."""
        tree, meta = load_device_checkpoint(path)
        if meta.get("kind") != "MultiSessionDeviceCore":
            raise CheckpointIncompatible(f"checkpoint {path!r} holds a different core kind",
                                         found=meta.get("kind"), expected="MultiSessionDeviceCore")
        core = cls.create(game, meta["max_prediction"], meta["num_players"], meta["capacity"], mesh=mesh,
                          device=device)
        core.load_stacked(tree["rings"], tree["states"])
        return core

    def load_stacked(self, rings: dict, states: dict) -> None:
        """Adopt canonical stacked trees (capacity + 1 slots, the
        reference's layout, either stack's) into this core in place."""
        self.block_until_ready()
        ring, r_frame = _planes_of(rings)
        state, frame = _planes_of(states)
        st = self.stack
        got = {"ring": ring, "r_frame": r_frame, "state": state, "state_frame": frame}
        for key, t in got.items():
            if tuple(t.shape) != tuple(st[key].shape):
                raise CheckpointIncompatible(f"stacked {key} of another shape than this core's "
                                             f"(canonical: capacity + 1 = {self.capacity + 1} slots)",
                                             found=list(t.shape), expected=list(st[key].shape))
        order = torch.from_numpy(np.append(self._phys, self.pad_slot).astype(np.int64)).to(self.device)
        for key, t in got.items():
            st[key].index_copy_(0, order, t.to(self.device))
