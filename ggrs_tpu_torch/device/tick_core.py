"""K3: ResimCore's packed control-word tick kernel and its plain PyTorch
version.

The port's counterpart of `ggrs_tpu/tpu/pallas_resim.py` `PallasTickCore`:
ONE launch runs T packed tick rows (the layout `ResimCore.pack_tick_row`
builds) on a `ResimCore` carry in place and returns the per-slot checksums
his/los [T, W] (int32 tensors holding the uint32 bit patterns, (0, 0) for
skipped saves) — `csrc/resim_tick.cu`, with one body per model, chosen by
`launch.ENTRIES`: ex_game's and swarm's (one template, `resim_tick_launch`
and `resim_tick_swarm_launch`) and arena's (`resim_tick_arena_launch`, a
whole-world reduction and a grid barrier before every advance, on the
persistent grid `arena_tick_plan` lays out). Each body ends in the same
parallel scalar pass, and a dispatch is that one launch: the kernel's
scratch (partial checksums, ticket, arena's barrier and raw rows) is the
wrapper's, zeroed once, and every launch leaves it zero.

`plain_tick_multi` is the same dispatch in plain PyTorch with the
semantics of the reference's `ResimCore._tick_impl` (ggrs_tpu/tpu/resim.py
:762-828) row after row, plus `_verify_update` (:736): the state carries
its own frame, a load takes the slot's frame, each save snapshots the
pre-advance state and checksums it with that frame. It is what a CPU
carry runs, what the tests hold against the reference, and what
`chip_smoke.py` holds the kernel against on the card.

`StackedTickCore` is K3's megabatch entry for `MultiSessionDeviceCore`
(`resim_tick_stacked_launch`, `resim_tick_swarm_stacked_launch`): one launch
ticks B session worlds of the stacked tensors in place, row r on slot
idx[r], through the first `nslots` window slots of each row (the
reference's windowed megabatch program, `_tick_windowed_impl` vmapped over
the rows). Arena has no stacked body: its rows run one K3-arena launch each
on the slot's views. `plain_megabatch` is the same in plain PyTorch:
`plain_tick_multi` row after row on each slot's views, the row windowed
first.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..errors import ConfigError
from ..kernels import build, launch
from ..ops import fixed_point as fx
from .planes import partial_checksum_planes
from .tiled_core import ARENA_STATE_WORDS, INLINE_THREADS, ROW_TEAMS, InlinePlan, block_threads

VERIFY_KEYS = ("h_tag", "h_hi", "h_lo", "flag")
SCALAR_EVENTS = 256  # csrc/resim_tick.cu kScalarEvents: the scalar pass takes rows in chunks of about this many events


def scalar_smem_words(window: int) -> int:
    """The scalar pass's shared memory in words (csrc/resim_tick.cu
    `scalar_smem_words`): a chunk of rows' control words, frames and load
    sources, four words an event, the carried ring-frame tags and history,
    and the chunk's last writes."""
    tc = max(1, SCALAR_EVENTS // window)
    return tc * (4 + window) + 2 * tc + 4 * tc * window + 2 * (window + 1) + 4 * window + 4


def arena_tick_smem_bytes(players: int, window: int, input_size: int, state_cols: int) -> int:
    """The arena tick's dynamic shared memory (csrc/resim_tick.cu, the
    layout above `tick_arena`), in bytes: finalized teams [3P], each warp's
    save sums [2][32][2], team rows [rows][3P] (a row a warp up to
    ROW_TEAMS teams, else one), the staged rows [2][L + 2WP], the pending
    step's pairs [P][2] and `state_cols` entities' states when they stay on
    chip; at least what the scalar pass reuses."""
    warps = INLINE_THREADS // 32
    rows = warps if players <= ROW_TEAMS else 1
    row_len = 4 + window + window * players + window * players * input_size
    words = (3 * players + 4 * warps + rows * 3 * players + 2 * (row_len + 2 * window * players) + 2 * players
             + ARENA_STATE_WORDS * state_cols)
    return 4 * max(words, scalar_smem_words(window))


def arena_tick_plan(n: int, players: int, window: int, input_size: int, sms: int,
                    smem_per_block: int) -> InlinePlan:
    """The arena tick's layout for a world of n entities and `players`
    teams at this window and input size, on a card of `sms` SMs whose
    blocks may take `smem_per_block` bytes of shared memory: one block an
    SM, each owning a contiguous run of entities, with the run's states
    on chip while they fit, else in the carry's state buffer."""
    per_block = -(-n // sms)
    blocks, threads = -(-n // per_block), block_threads(per_block)
    on_chip = arena_tick_smem_bytes(players, window, input_size, per_block)
    if on_chip <= smem_per_block:
        return InlinePlan("grid-shared", blocks, threads, per_block, on_chip)
    return InlinePlan("grid-global", blocks, threads, per_block, arena_tick_smem_bytes(players, window, input_size, 0))


def check_rows(rows: np.ndarray, core) -> None:
    """Reject control words no session emits and the kernel must not index
    with: the row width, a load slot outside the ring, an advance count
    outside 0..W, a negative save slot (slots >= ring_len mean no save)."""
    if rows.ndim != 2 or rows.shape[1] != core.packed_len or rows.dtype != np.int32:
        raise ConfigError(
            f"tick rows must be int32 [T, {core.packed_len}], got {rows.dtype} {rows.shape}"
        )
    loads = rows[:, 0] != 0
    if (loads & ((rows[:, 1] < 0) | (rows[:, 1] > core.ring_len))).any():
        raise ConfigError("a tick row loads a slot outside the ring")
    if ((rows[:, 2] < 0) | (rows[:, 2] > core.window)).any():
        raise ConfigError(f"a tick row advances outside 0..{core.window}")
    if (rows[:, core.off_save : core.off_status] < 0).any():
        raise ConfigError("a tick row saves to a negative slot")


def plain_tick_multi(carry, rows: torch.Tensor, core):
    """T packed tick rows on the carry in place, in plain PyTorch; returns
    (his, los) int32 [T, W]. The entity work runs on the carry's device;
    the frames, ring-frame tags and the history are host integers, and the
    saves' checksum parts come back in one readback at the end."""
    ctx = core.ctx
    W, R, P, I = core.window, core.ring_len, core.num_players, ctx.input_size
    device = carry["state"].device
    rows_l = rows.tolist()
    ring = carry["ring"]
    r_frame = carry["r_frame"].tolist()
    state = carry["state"]
    frame = int(carry["state_frame"])
    saves = []  # (t, i, state frame, verify frame, (hi part, lo part))
    for t, row in enumerate(rows_l):
        do_load, load_slot, advance_count, start_frame = row[:4]
        if do_load:
            state = ring[load_slot].clone()
            frame = r_frame[load_slot]
        for i in range(W):
            slot = row[core.off_save + i]
            if slot < R:
                ring[slot] = state
                r_frame[slot] = frame
                saves.append((t, i, frame, start_frame + i, partial_checksum_planes(state, ctx.weights)))
            if i < advance_count:
                s = core.off_status + i * P
                x = core.off_input + i * P * I
                inputs = torch.tensor(row[x : x + P * I], dtype=torch.int32, device=device)
                statuses = torch.tensor(row[s : s + P], dtype=torch.int32, device=device)
                state = ctx.adapter.step(state, inputs.reshape(P, I), ctx.owner, statuses)
                frame += 1
    carry["state"].copy_(state)
    carry["state_frame"].fill_(frame)
    carry["r_frame"].copy_(torch.tensor(r_frame, dtype=torch.int32))

    m, fw = fx.MASK32, ctx.cs_frame_weight & fx.MASK32
    his = [[0] * W for _ in rows_l]
    los = [[0] * W for _ in rows_l]
    parts = torch.stack([torch.stack(p) for *_, p in saves]).tolist() if saves else []
    hist = None
    if core.device_verify:
        hist = {k: carry[k].tolist() for k in VERIFY_KEYS}
    for (t, i, f, vf, _), (hp, lp) in zip(saves, parts):
        hi, lo = (hp + f * fw) & m, (lp + f) & m
        his[t][i], los[t][i] = fx.to_i32(hi), fx.to_i32(lo)
        if hist is not None:
            verify_update(hist, vf, hi, lo, R)
    if hist is not None:
        for k, v in hist.items():
            carry[k].copy_(torch.tensor(v, dtype=torch.int32))

    def out(v):
        return torch.tensor(v, dtype=torch.int32, device=device)

    return out(his), out(los)


def verify_update(hist, frame: int, hi: int, lo: int, hist_len: int) -> None:
    """The first-seen history record/compare and mismatch latch on host
    lists (h_hi/h_lo as int32 bit patterns; hi/lo as uint32 values)."""
    h = frame % hist_len
    m = fx.MASK32
    seen = hist["h_tag"][h] == frame
    if seen and (hist["h_hi"][h] & m != hi or hist["h_lo"][h] & m != lo):
        if hist["flag"][0] == 0:
            hist["flag"][1] = frame
        hist["flag"][0] = 1
    hist["h_tag"][h] = frame
    if not seen:
        hist["h_hi"][h], hist["h_lo"][h] = fx.to_i32(hi), fx.to_i32(lo)


def windowed_row(row: np.ndarray, nslots: int, core) -> np.ndarray:
    """A copy of a packed row cut to its first `nslots` window slots, as
    the reference's `_tick_windowed_impl` runs it: saves past them go to
    the scratch slot (none), the advance count is clamped to them. Rows
    whose last active slot fits are unchanged."""
    out = np.array(row, dtype=np.int32, copy=True)
    out[2] = min(int(out[2]), nslots)
    out[core.off_save + nslots : core.off_status] = core.scratch_slot
    return out


def slot_carry(stack, slot: int) -> dict:
    """The views of one slot of a MultiSessionDeviceCore's stacked tensors,
    as a ResimCore carry (no verification leaves)."""
    return {k: v[slot] for k, v in stack.items()}


def plain_megabatch(stack, idx, rows, nslots: int, core, b_rows=None):
    """The megabatch in plain PyTorch: row r of `rows` ([n, L]) on the
    world of slot idx[r] of `stack` (the stacked state [S, K, N],
    state_frame [S], ring [S, R+1, K, N], r_frame [S, R+1]) in place,
    windowed to `nslots` (`windowed_row`), by `plain_tick_multi` on the
    slot's views; returns (his, los) int32 [b_rows, W] on the stack's
    device, the pad rows past n (0, 0)."""
    W = core.window
    idx = [int(i) for i in (idx.tolist() if isinstance(idx, torch.Tensor) else idx)]
    rows = rows.cpu().numpy() if isinstance(rows, torch.Tensor) else np.asarray(rows)
    device = stack["state"].device
    b_rows = len(idx) if b_rows is None else b_rows
    his = torch.zeros((b_rows, W), dtype=torch.int32, device=device)
    los = torch.zeros((b_rows, W), dtype=torch.int32, device=device)
    for r, slot in enumerate(idx):
        row = torch.from_numpy(windowed_row(rows[r], nslots, core)[None])
        h, lo = plain_tick_multi(slot_carry(stack, slot), row, core)
        his[r], los[r] = h[0], lo[0]
    return his, los


class StackedTickCore:
    """K3's megabatch wrapper for one MultiSessionDeviceCore (its template
    ResimCore `core` gives the layout); counts its stacked launches in
    `launches`. On a CPU stack it runs `plain_megabatch`; on a CUDA stack
    it launches the model's stacked body, or for arena one K3-arena launch
    a row through the template core's TickCore (counted there), or raises —
    there is no fallback."""

    kernel = "resim_tick"

    def __init__(self, core):
        self.core = core
        self.launches = 0
        # a ticket and parts_hi/lo [W] a row, for up to `_rows` rows: zero
        # when made, and every launch leaves it zero
        self._scratch, self._rows = None, 0

    @property
    def stacked(self) -> bool:
        """Whether the model has a stacked body (ex_game, swarm)."""
        return launch.require_adapter(self.core.ctx, self.kernel).stacked is not None

    def tick(self, stack, idx: torch.Tensor, rows: torch.Tensor, nslots: int, b_rows: int, slots=None):
        """n rows (rows int32 [n, L], idx int32 [n] distinct slots, both on
        the stack's device) through the first `nslots` slots in place;
        returns (his, los) int32 [b_rows, W], the pad rows (0, 0). Arena
        also needs the slots as host ints (`slots`)."""
        core, ctx = self.core, self.core.ctx
        device = stack["state"].device
        if device.type == "cpu":
            return plain_megabatch(stack, idx, rows, nslots, core, b_rows)
        n, W = rows.shape[0], core.window
        if not 1 <= nslots <= W or not 1 <= n <= b_rows:
            raise ConfigError(f"a megabatch of {n} rows in {b_rows} at depth {nslots} (window {W})")
        his = torch.empty((b_rows, W), dtype=torch.int32, device=device)
        los = torch.empty((b_rows, W), dtype=torch.int32, device=device)
        if not self.stacked:
            # arena: one K3-arena launch a row on the slot's views (the
            # rows were windowed on the host)
            for r, slot in enumerate(slots):
                core.tick_core.tick_multi(slot_carry(stack, slot), rows[r : r + 1],
                                          out=(his[r : r + 1], los[r : r + 1]))
            his[n:].zero_()
            los[n:].zero_()
            return his, los
        entry = launch.require_adapter(ctx, self.kernel)
        S, R1, K, N = stack["ring"].shape
        launch.check_tensors(
            device,
            state=(stack["state"], (S, K, N)), state_frame=(stack["state_frame"], (S,)),
            ring=(stack["ring"], (S, core.ring_len + 1, ctx.n_planes, ctx.n)),
            r_frame=(stack["r_frame"], (S, R1)), idx=(idx, (n,)), rows=(rows, (n, core.packed_len)),
        )
        if n > self._rows:
            self._scratch = torch.zeros(n * (1 + 2 * W), dtype=torch.int32, device=device)
            self._rows = n
        lib = build.load(self.kernel)
        P, I = launch.P, launch.I
        extra = launch.model_ints(entry, ctx)
        fn = launch.declare(lib, entry.stacked, [P] * 9 + [I] * (7 + len(extra)) + [P, P, P])
        rc = fn(stack["state"].data_ptr(), stack["state_frame"].data_ptr(), stack["ring"].data_ptr(),
                stack["r_frame"].data_ptr(), idx.data_ptr(), rows.data_ptr(), his.data_ptr(), los.data_ptr(),
                self._scratch.data_ptr(), ctx.n, core.num_players, ctx.input_size, W, n, nslots, b_rows,
                *extra, launch.disconnect_arg(core.disconnect_input), launch.weights_arg(ctx),
                launch.stream_of(device))
        launch.raise_on(rc, "resim_tick_stacked")
        self.launches += 1
        return his, los


class TickCore:
    """K3's wrapper for one ResimCore; counts its launches in `launches`.
    On a CPU carry it runs `plain_tick_multi`; on a CUDA carry it launches
    the kernel or raises — there is no fallback."""

    kernel = "resim_tick"

    def __init__(self, core):
        self.core = core
        self.launches = 0
        self.plan = None  # arena's InlinePlan, made at its first launch
        # the kernel's scratch for up to `_rows` rows: zero when made, and
        # every launch leaves it zero
        self._scratch, self._rows = None, 0

    def _arena_plan(self, lib) -> InlinePlan:
        """Arena's plan, made at its first launch from the card's limits
        (read from the kernel library) by `arena_tick_plan`."""
        if self.plan is None:
            limits = (ctypes.c_int * 2)()
            fn = launch.declare(lib, "resim_tick_arena_limits", [launch.P])
            launch.raise_on(fn(limits), "resim_tick_arena_limits")
            core = self.core
            self.prepare(lib, arena_tick_plan(core.ctx.n, core.num_players, core.window, core.ctx.input_size,
                                              limits[0], limits[1]))
        return self.plan

    def prepare(self, lib, plan: InlinePlan) -> None:
        """The arena plan's one-time set-up (the shared-memory attribute)
        and residency check — `KernelError` when its grid cannot be
        resident; then `plan` is the wrapper's. Measurement code may call
        it before the first launch to time another plan."""
        fn = launch.declare(lib, "resim_tick_arena_prepare", [launch.I] * 4)
        launch.raise_cooperative(fn(int(plan.regime == "grid-shared"), plan.blocks, plan.threads, plan.smem_bytes),
                                 "resim_tick_arena_prepare")
        self.plan = plan

    def _scratch_for(self, t_rows: int, fixed: int, device) -> torch.Tensor:
        """The zeroed scratch: `fixed` words, then parts_hi and parts_lo
        [T, W] for up to the most rows a dispatch has had."""
        if t_rows > self._rows:
            self._scratch = torch.zeros(fixed + 2 * t_rows * self.core.window, dtype=torch.int32, device=device)
            self._rows = t_rows
        return self._scratch

    def tick_multi(self, carry, rows: torch.Tensor, out=None):
        """T rows (int32 [T, L] on the carry's device) in place; returns
        (his, los) int32 [T, W], written into `out` (two such tensors)
        when given."""
        if carry["state"].device.type == "cpu":
            return plain_tick_multi(carry, rows, self.core)
        core, ctx = self.core, self.core.ctx
        entry = launch.require_adapter(ctx, self.kernel)
        device = carry["state"].device
        n, W, t_rows = ctx.n, core.window, rows.shape[0]
        shapes = dict(
            state=(carry["state"], (ctx.n_planes, n)),
            state_frame=(carry["state_frame"], ()),
            ring=(carry["ring"], (core.ring_len + 1, ctx.n_planes, n)),
            r_frame=(carry["r_frame"], (core.ring_len + 1,)),
            rows=(rows, (t_rows, core.packed_len)),
        )
        if core.device_verify:
            shapes.update(
                {k: (carry[k], (core.ring_len,)) for k in ("h_tag", "h_hi", "h_lo")},
                flag=(carry["flag"], (2,)),
            )
        launch.check_tensors(device, **shapes)
        if t_rows < 1:
            raise ConfigError("a tick dispatch needs at least one row")
        lib = build.load(self.kernel)
        P, I = launch.P, launch.I
        if out is None:
            out = (torch.empty((t_rows, W), dtype=torch.int32, device=device),
                   torch.empty((t_rows, W), dtype=torch.int32, device=device))
        his, los = out
        launch.check_tensors(device, his=(his, (t_rows, W)), los=(los, (t_rows, W)))
        verify = [carry[k].data_ptr() if core.device_verify else None for k in VERIFY_KEYS]
        ptrs = (carry["state"].data_ptr(), carry["state_frame"].data_ptr(), carry["ring"].data_ptr(),
                carry["r_frame"].data_ptr(), *verify, rows.data_ptr(), his.data_ptr(), los.data_ptr())
        disconnect = launch.disconnect_arg(core.disconnect_input)
        if entry.reduces:
            plan = self._arena_plan(lib)
            # the grid barrier's u64 counter and three raw rows [3, 3P], the ticket, then the parts
            scratch = self._scratch_for(t_rows, 2 + 3 * ctx.reduce_len + 1, device)
            fn = launch.declare(lib, entry.symbol, [P] * 12 + [I] * 10 + [P, P, P])
            rc = fn(*ptrs, scratch.data_ptr(), n, core.num_players, ctx.input_size, W, t_rows,
                    int(plan.regime == "grid-shared"), plan.blocks, plan.threads, plan.per_block, plan.smem_bytes,
                    disconnect, launch.weights_arg(ctx), launch.stream_of(device))
        else:
            extra = launch.model_ints(entry, ctx)
            scratch = self._scratch_for(t_rows, 1, device)  # the ticket, then the parts
            fn = launch.declare(lib, entry.symbol, [P] * 12 + [I] * (5 + len(extra)) + [P, P, P])
            rc = fn(*ptrs, scratch.data_ptr(), n, core.num_players, ctx.input_size, W, t_rows, *extra,
                    disconnect, launch.weights_arg(ctx), launch.stream_of(device))
        launch.raise_on(rc, self.kernel)
        self.launches += 1
        return his, los
