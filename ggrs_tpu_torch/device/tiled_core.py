"""K2: the entity-tiled SyncTest kernel and its plain PyTorch twin.

The port's counterpart of `ggrs_tpu/tpu/pallas_tiled.py`
`PallasTiledSyncTestCore` (`run_kernel`, `_verdict`, `batch`). A batch is
two steps:

- `run_kernel`: T ticks over every entity, updating state, ring and the
  ring-frame tags in place, replacing the input ring with its evolved copy,
  and returning the per-event partial checksums `parts_hi`/`parts_lo`
  [T, d] (int32 bit patterns, frame term not folded in, zero for events
  that did not happen) in the reference's event layout:
  parts[t, j], j < d-1 is the re-save of frame c-d+1+j (valid iff c > d),
  parts[t, d-1] the save of frame c, for tick frame c = c0 + t;
- `verdict`: the first-seen checksum history and mismatch latch over those
  events, in (t, j) order.

On a CUDA carry each step launches its kernel (`csrc/synctest_tiled.cu`);
on a CPU carry it runs the plain version beside it (`plain_parts`,
`plain_verdict`). The plain versions are also what the tests hold against
the reference and what `chip_smoke.py` holds the kernels against.

A game with a cross-entity reduction (arena) runs here in one of the
reference's two modes:

- inline, the reference's unsharded whole-world tile (pallas_tiled.py:
  94-130, `red_raw` None): any T per launch, and every step reduces from
  the whole world entering it, as the XLA scan does. The kernel runs a
  grid of one block an SM with the states on chip or in global memory, as
  `inline_plan` picks from the world and the card, with a grid barrier
  per step; nothing else selects it. Its plain version is
  `plain_parts` with `red_of` None, what `plain_scan` runs;
- `external_reduce`: one tick per launch (`tick_injected`), with the
  complete raw reduction table `red [d+1, R]` handed in (row i for the
  resim step of frame base+i, row d for the frontier step); the same
  launch writes the next tick's table and runs the verdict in its last
  block. The caller (`injected_core`) keeps the two tables and builds a
  full one with K5 where the route rebuilds; its plain version is
  `plain_injected_tick`.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..errors import ConfigError
from ..kernels import build, launch
from ..ops import fixed_point as fx
from .planes import PlaneContext, partial_checksum_planes
from .reduce_core import plain_reduce_table

# K2's inline arena route (csrc/synctest_tiled.cu, namespace inline_arena)
INLINE_THREADS = 1024  # kThreads: a block's most (one such block an SM)
ROW_TEAMS = 64  # arena::kRowTeams: up to this many teams each warp sums into its own row
ARENA_STATE_WORDS = 6  # int32 planes an entity's state holds


class InlinePlan(NamedTuple):
    """How the inline arena kernel lays a world on the card."""

    regime: str  # "grid-shared" (states on chip) or "grid-global"
    blocks: int  # one an SM
    threads: int  # a block's: a thread an entity, in whole warps (`block_threads`)
    per_block: int  # the contiguous run of entities a block owns
    smem_bytes: int  # dynamic shared memory a block takes


def inline_smem_bytes(players: int, state_cols: int) -> int:
    """The inline kernel's dynamic shared memory (csrc/synctest_tiled.cu
    `inline_arena::Shared`), in bytes: finalized teams [3P], each warp's
    save sums [32][2], team rows [rows][3P] (a row a warp up to ROW_TEAMS
    teams, else one), and `state_cols` entities' states when they stay on
    chip."""
    rows = INLINE_THREADS // 32 if players <= ROW_TEAMS else 1
    words = 3 * players * (1 + rows) + 2 * (INLINE_THREADS // 32) + ARENA_STATE_WORDS * state_cols
    return 4 * words


def on_chip_capacity(players: int, sms: int, smem_per_block: int) -> int:
    """The largest world whose states the grid holds in shared memory, one
    block an SM."""
    cols = (smem_per_block - inline_smem_bytes(players, 0)) // (4 * ARENA_STATE_WORDS)
    return sms * max(cols, 0)


def block_threads(per_block: int) -> int:
    """A thread an entity, in whole warps, up to INLINE_THREADS: a small
    world's step then waits on the warps it needs, not on 32."""
    return min(INLINE_THREADS, 32 * -(-per_block // 32))


def grid_plan(n: int, players: int, sms: int, on_chip: bool) -> InlinePlan:
    """The world on a grid of one block an SM, each owning a contiguous run
    of entities, with the states in shared memory (`on_chip`) or in global
    memory."""
    per_block = -(-n // sms)
    return InlinePlan("grid-shared" if on_chip else "grid-global", -(-n // per_block), block_threads(per_block),
                      per_block, inline_smem_bytes(players, per_block if on_chip else 0))


def inline_plan(n: int, players: int, sms: int, smem_per_block: int) -> InlinePlan:
    """The inline route's layout for a world of n entities and `players`
    teams, on a card of `sms` SMs whose blocks may take `smem_per_block`
    bytes of shared memory (the kernel library's `limits`): the states on
    chip while they fit, else in global memory. The check distance takes
    no shared memory of the kernel's, so it does not enter."""
    plan = grid_plan(n, players, sms, on_chip=True)
    if plan.smem_bytes <= smem_per_block:
        return plan
    return grid_plan(n, players, sms, on_chip=False)


def plain_parts(carry, inputs: torch.Tensor, ctx: PlaneContext, red_of=None, on_frontier=None):
    """T SyncTest ticks on the carry in place (the reference's `_tick`
    without its history compare); returns (parts_hi, parts_lo) [T, d].

    For a game with a reduction: `red_of(f, i)` gives the finalized
    reduction the step of frame f uses (i: the resim step's index, d for
    the frontier step), None to reduce inline from the state entering the
    step; `on_frontier(c, state)` sees each tick's new frontier state (of
    frame c+1)."""
    d, ring_len = ctx.d, ctx.ring_len
    t_ticks = inputs.shape[0]
    c0 = int(carry["meta"][0])
    ring, r_frame, iring = carry["ring"], carry["r_frame"], carry["iring"]
    device = ring.device
    parts_hi = torch.zeros((t_ticks, d), dtype=torch.int32, device=device)
    parts_lo = torch.zeros((t_ticks, d), dtype=torch.int32, device=device)

    def step(state, player_inputs, f, i):
        red = red_of(f, i) if red_of is not None else None
        return ctx.adapter.step(state, player_inputs, ctx.owner, red=red)

    def save(state, frame, t, j):
        slot = frame % ring_len
        ring[slot] = state
        r_frame[slot] = frame
        parts_hi[t, j], parts_lo[t, j] = partial_checksum_planes(state, ctx.weights)

    state = carry["state"]
    for t in range(t_ticks):
        c = c0 + t
        if c > d:  # forced rollback once past check_distance
            base = c - d
            state = ring[base % ring_len]
            for i in range(d):
                f = base + i
                if i > 0:
                    save(state, f, t, i - 1)
                state = step(state, iring[f % (d + 2)], f, i)
        save(state, c, t, d - 1)
        iring[c % (d + 2)] = inputs[t]
        state = step(state, inputs[t], c, d)
        if on_frontier is not None:
            on_frontier(c, state)
    carry["state"].copy_(state)
    return parts_hi, parts_lo


def plain_verdict(carry, parts_hi: torch.Tensor, parts_lo: torch.Tensor, ctx: PlaneContext) -> None:
    """The first-seen history post-pass (the reference's `_verdict`), a
    scalar scan over the batch's T*d events; sets meta to (c0 + T,
    mismatch, mismatch_frame)."""
    d, hist = ctx.d, ctx.hist_len
    m = fx.MASK32
    c0, mismatch, mismatch_frame = carry["meta"].tolist()
    tag = carry["h_tag"].tolist()
    hhi = [v & m for v in carry["h_hi"].tolist()]
    hlo = [v & m for v in carry["h_lo"].tolist()]
    fw = ctx.cs_frame_weight & m
    ph, pl = parts_hi.tolist(), parts_lo.tolist()
    for t in range(len(ph)):
        c = c0 + t
        for j in range(d):
            if j < d - 1 and c <= d:
                continue  # no rollback: the re-saves did not happen
            frame = c - d + 1 + j if j < d - 1 else c
            hi = (ph[t][j] + frame * fw) & m
            lo = (pl[t][j] + frame) & m
            h = frame % hist
            seen = tag[h] == frame
            if seen and (hhi[h] != hi or hlo[h] != lo):
                if not mismatch:
                    mismatch_frame = frame
                mismatch = 1
            tag[h] = frame
            if not seen:
                hhi[h], hlo[h] = hi, lo

    def put(name, values):
        carry[name].copy_(torch.tensor(values, dtype=torch.int32))

    put("h_tag", tag)
    put("h_hi", [fx.to_i32(v) for v in hhi])
    put("h_lo", [fx.to_i32(v) for v in hlo])
    put("meta", [c0 + len(ph), mismatch, mismatch_frame])


def plain_injected_tick(carry, inputs: torch.Tensor, red: torch.Tensor, nxt: torch.Tensor,
                        ctx: PlaneContext) -> None:
    """One tick of the injection route in place, what `tick_injected`
    launches: the tick on the raw table `red` [d+1, R] (`plain_parts` on
    its finalized rows), its verdict (`plain_verdict`), and the next tick's
    table into `nxt`: rows 1..d of `red`, then K5's frontier row, the raw
    sums of the new live state (the reference's `roll`, pallas_tiled.py:
    858-867). `red`'s row d is left zero, as the kernel leaves it."""
    rows = [ctx.adapter.reduce_finalize(r) for r in red]
    parts_hi, parts_lo = plain_parts(carry, inputs, ctx, red_of=lambda f, i: rows[i])
    plain_verdict(carry, parts_hi, parts_lo, ctx)
    d = ctx.d
    nxt[:d] = red[1:]
    nxt[d] = plain_reduce_table(carry["state"][None], ctx)[0]
    red[d] = 0


def check_injected(ctx: PlaneContext, inputs: torch.Tensor, red: torch.Tensor, nxt: torch.Tensor) -> None:
    """A reduction game runs K2 one tick at a time on an injected table (the
    reference asserts the same, pallas_tiled.py:204-209): tick t+1's
    frontier reduction does not exist when tick t launches."""
    if not ctx.reduce_len:
        raise ConfigError(f"{type(ctx.game).__name__} has no cross-entity reduction to inject")
    if inputs.shape[0] != 1:
        raise ConfigError(f"an injected-reduction launch runs one tick, got {inputs.shape[0]}")
    want = (ctx.d + 1, ctx.reduce_len)
    for name, table in (("red", red), ("nxt", nxt)):
        if tuple(table.shape) != want:
            raise ConfigError(f"{name} has shape {tuple(table.shape)}, expected {want}")
    if red.data_ptr() == nxt.data_ptr():
        raise ConfigError("the next table must be another buffer than the tick's")


class TiledSyncTestCore:
    """K2's wrappers for one (game, players, check_distance); counts its
    launches in `launches` (the tiled kernel, or the injection route's
    tick) and `verdict_launches`."""

    kernel = "synctest_tiled"

    def __init__(self, ctx: PlaneContext):
        self.ctx = ctx
        self.launches = 0
        self.verdict_launches = 0
        self.plan = None  # the inline route's InlinePlan, made at its first launch
        self._scratch = None  # its grid barrier and raw rows: zero when made, kept so by the kernel
        self._tick_scratch = None  # the injected tick's parts and ticket: zero when made, left so by each launch

    def _inline_plan(self, lib, device) -> InlinePlan:
        """The inline route's plan, made at its first launch from the card's
        limits (read from the kernel library) by `inline_plan`."""
        if self.plan is None:
            limits = (ctypes.c_int * 2)()
            fn = launch.declare(lib, "synctest_tiled_inline_arena_limits", [launch.P])
            launch.raise_on(fn(limits), "synctest_tiled_inline_arena_limits")
            ctx = self.ctx
            self._prepare_inline(lib, device, inline_plan(ctx.n, ctx.num_players, limits[0], limits[1]))
        return self.plan

    def _prepare_inline(self, lib, device, plan: InlinePlan) -> None:
        """The plan's one-time set-up (the shared-memory attribute) and
        residency check — `KernelError` when its grid cannot be resident —
        and the zeroed scratch (the grid barrier's u64 counter and three raw
        rows [3, R]); then `plan` is the core's. Measurement code may call
        it before the first launch to time another plan."""
        fn = launch.declare(lib, "synctest_tiled_inline_arena_prepare", [launch.I] * 4)
        launch.raise_cooperative(fn(int(plan.regime == "grid-shared"), plan.blocks, plan.threads, plan.smem_bytes),
                                 "synctest_tiled_inline_arena_prepare")
        self._scratch = torch.zeros(2 + 3 * self.ctx.reduce_len, dtype=torch.int32, device=device)
        self.plan = plan

    def run_kernel(self, carry, inputs: torch.Tensor):
        """T ticks in place; returns (parts_hi, parts_lo) [T, d] int32. A
        game with a reduction reduces inline at every step."""
        ctx = self.ctx
        if carry["state"].device.type == "cpu":
            return plain_parts(carry, inputs, ctx)
        inline = bool(ctx.reduce_len)
        entry = launch.require_adapter(ctx, "synctest_tiled_inline" if inline else self.kernel)
        launch.check_carry(carry, ctx, inputs)
        lib = build.load(self.kernel)
        P, I = launch.P, launch.I
        t_ticks = inputs.shape[0]
        device = carry["state"].device
        parts = torch.empty((2, t_ticks, ctx.d), dtype=torch.int32, device=device)
        iring_out = torch.empty_like(carry["iring"])
        ptrs = (carry["state"].data_ptr(), carry["ring"].data_ptr(), carry["r_frame"].data_ptr(),
                carry["iring"].data_ptr(), iring_out.data_ptr(), carry["meta"].data_ptr(),
                inputs.data_ptr())
        if inline:
            plan = self._inline_plan(lib, device)
            fn = launch.declare(lib, entry.symbol, [P] * 9 + [I] * 10 + [P, P])
            rc = fn(*ptrs, parts.data_ptr(), self._scratch.data_ptr(), ctx.n, ctx.num_players, ctx.input_size,
                    ctx.d, t_ticks, int(plan.regime == "grid-shared"), plan.blocks, plan.threads, plan.per_block,
                    plan.smem_bytes, launch.weights_arg(ctx), launch.stream_of(device))
        else:
            extra = launch.model_ints(entry, ctx)
            fn = launch.declare(lib, entry.symbol, [P] * 8 + [I] * (5 + len(extra)) + [P, P])
            rc = fn(*ptrs, parts.data_ptr(), ctx.n, ctx.num_players, ctx.input_size, ctx.d, t_ticks,
                    *extra, launch.weights_arg(ctx), launch.stream_of(device))
        launch.raise_on(rc, self.kernel)
        self.launches += 1
        carry["iring"] = iring_out
        return parts[0], parts[1]

    def tick_injected(self, carry, inputs: torch.Tensor, red: torch.Tensor, nxt: torch.Tensor,
                      later: int = 0) -> None:
        """One tick of the injection route in place, in one launch: the tick
        on the raw table `red` int32 [d+1, R], the next tick's table into
        `nxt` (rows 1..d of `red`, then the new live state's raw sums; its
        row d must be zero on entry), and the verdict; `red`'s row d is
        left zero. `later`: the ticks of the same batch after this one; a
        save that one of them makes again before anything reads it skips
        its ring store, so the ring is whole again only after the batch's
        last tick (with `later` 0 every save is stored). On a CPU carry
        `plain_injected_tick`, which stores every save."""
        ctx = self.ctx
        check_injected(ctx, inputs, red, nxt)
        if carry["state"].device.type == "cpu":
            return plain_injected_tick(carry, inputs, red, nxt, ctx)
        entry = launch.require_adapter(ctx, self.kernel)
        launch.check_carry(carry, ctx, inputs)
        device = carry["state"].device
        want = (ctx.d + 1, ctx.reduce_len)
        launch.check_tensors(device, red=(red, want), nxt=(nxt, want))
        lib = build.load(self.kernel)
        if self._tick_scratch is None:
            self._tick_scratch = torch.zeros(2 * ctx.d + 1, dtype=torch.int32, device=device)
        P, I = launch.P, launch.I
        fn = launch.declare(lib, entry.symbol, [P] * 12 + [I] * 5 + [P, P])
        rc = fn(carry["state"].data_ptr(), carry["ring"].data_ptr(), carry["r_frame"].data_ptr(),
                carry["iring"].data_ptr(), carry["meta"].data_ptr(), inputs.data_ptr(), carry["h_tag"].data_ptr(),
                carry["h_hi"].data_ptr(), carry["h_lo"].data_ptr(), red.data_ptr(), nxt.data_ptr(),
                self._tick_scratch.data_ptr(), ctx.n, ctx.num_players, ctx.input_size, ctx.d, later,
                launch.weights_arg(ctx), launch.stream_of(device))
        launch.raise_on(rc, self.kernel)
        self.launches += 1

    def verdict(self, carry, parts_hi: torch.Tensor, parts_lo: torch.Tensor) -> None:
        """The history post-pass over run_kernel's parts, in place."""
        if carry["state"].device.type == "cpu":
            return plain_verdict(carry, parts_hi, parts_lo, self.ctx)
        ctx = self.ctx
        t_ticks = parts_hi.shape[0]
        device = carry["state"].device
        launch.check_tensors(
            device,
            h_tag=(carry["h_tag"], (ctx.hist_len,)),
            h_hi=(carry["h_hi"], (ctx.hist_len,)),
            h_lo=(carry["h_lo"], (ctx.hist_len,)),
            meta=(carry["meta"], (3,)),
            parts_hi=(parts_hi, (t_ticks, ctx.d)),
            parts_lo=(parts_lo, (t_ticks, ctx.d)),
        )
        lib = build.load(self.kernel)
        P, I = launch.P, launch.I
        launch.declare(lib, "synctest_verdict_launch", [P, P, I, I, I, P, P, P, P, P])
        rc = lib.synctest_verdict_launch(
            parts_hi.data_ptr(), parts_lo.data_ptr(), t_ticks, ctx.d, ctx.cs_frame_weight,
            carry["h_tag"].data_ptr(), carry["h_hi"].data_ptr(), carry["h_lo"].data_ptr(),
            carry["meta"].data_ptr(), launch.stream_of(device),
        )
        launch.raise_on(rc, "synctest_verdict")
        self.verdict_launches += 1

    def batch(self, carry, inputs: torch.Tensor) -> None:
        parts_hi, parts_lo = self.run_kernel(carry, inputs)
        self.verdict(carry, parts_hi, parts_lo)
