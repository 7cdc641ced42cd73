"""K4: the speculative beam rollout kernel and its plain PyTorch version.

The port's counterpart of `ggrs_tpu/tpu/pallas_beam.py`
`PallasBeamRollout` (`_build`, `run_kernel`, `finish`): from ONE anchor
snapshot (a ring slot of a `ResimCore` carry) roll B candidate input
scripts L frames each, and return every member's state after every step
with its checksum, and the anchor's own checksum — one launch of
`csrc/beam_rollout.cu` on CUDA (ex_game's or swarm's body, one template,
or arena's, which reduces each member's world before every step among the
member's own blocks, on the layout `beam_plan` picks; `launch.ENTRIES`
chooses the body), `plain_rollout` on the CPU.

A script is packed into ONE int32 tensor `[B, L, P, 1 + I]` (one upload):
`[..., 0]` is the cell's status, `[..., 1:]` its input bytes. A
DISCONNECTED cell steps with the game's disconnect input, exactly as the
request path's tick (K3) does, so a speculation is defined for any
statuses.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..errors import ConfigError
from ..kernels import build, launch
from ..ops import fixed_point as fx
from .tiled_core import ARENA_STATE_WORDS, INLINE_THREADS, ROW_TEAMS, block_threads

MAX_GROUP = 8  # csrc/beam_rollout.cu beam_arena::kMaxGroup: blocks a member at most


class Speculation(NamedTuple):
    """One beam rollout. The first five fields are the reference's
    speculation tuple (`ResimCore._speculate_impl`); the reference carries
    the anchor's frame inside its trajectory's `frame` leaf, the port
    beside it. hi/lo values are int32 tensors holding uint32 bit patterns."""

    traj: torch.Tensor  # [B, L, K, N] (K planes): member b after step l, frame `frame + 1 + l`
    his: torch.Tensor  # [B, L] checksum of traj[b, l]
    los: torch.Tensor  # [B, L]
    a_hi: torch.Tensor  # [] checksum of the anchor
    a_lo: torch.Tensor  # []
    frame: torch.Tensor  # [] the anchor's frame tag


def plain_rollout(anchor_planes: torch.Tensor, frame, beam_inputs: torch.Tensor,
                  beam_statuses: torch.Tensor, ctx) -> Speculation:
    """B·L steps of the port's plane step and checksum: `anchor_planes`
    int32 [K, N], `frame` the anchor's frame (int or 0-dim tensor),
    `beam_inputs` [B, L, P, I], `beam_statuses` [B, L, P]. The members
    step side by side (one `[K, B, N]` plane stack), each with its own
    inputs (and, for arena, its own world's reduction); the semantics are
    the reference's `_speculate_impl` (ggrs_tpu/tpu/resim.py:925-956)."""
    B, L = beam_inputs.shape[:2]
    n_planes, n = anchor_planes.shape
    device = anchor_planes.device
    frame = torch.as_tensor(frame, dtype=torch.int32, device=device).reshape(())
    inputs = beam_inputs.to(device=device, dtype=torch.int32)
    statuses = beam_statuses.to(device=device, dtype=torch.int32)
    traj = torch.empty((B, L, n_planes, n), dtype=torch.int32, device=device)
    state = anchor_planes.unsqueeze(1).expand(n_planes, B, n)
    for l in range(L):
        state = ctx.adapter.step(state, inputs[:, l], ctx.owner, statuses[:, l])
        traj[:, l] = state.transpose(0, 1)
    # per-(member, step) entity parts, then the frame terms (`finish`)
    words = fx.as_u32(traj)
    parts_hi = fx.mul_mod32(words, ctx.weights).sum(dim=(-2, -1)) & fx.MASK32
    parts_lo = words.sum(dim=(-2, -1)) & fx.MASK32
    fw = ctx.cs_frame_weight & fx.MASK32
    f64 = frame.to(torch.int64)
    steps = f64 + 1 + torch.arange(L, dtype=torch.int64, device=device)
    his = fx.to_i32((parts_hi + steps * fw) & fx.MASK32)
    los = fx.to_i32((parts_lo + steps) & fx.MASK32)
    a_words = fx.as_u32(anchor_planes)
    a_hi = (fx.mul_mod32(a_words, ctx.weights).sum() + f64 * fw) & fx.MASK32
    a_lo = (a_words.sum() + f64) & fx.MASK32
    return Speculation(traj, his, los, fx.to_i32(a_hi), fx.to_i32(a_lo), frame.clone())


class BeamPlan(NamedTuple):
    """How the arena rollout lays B members on the card: one cooperative
    grid of `members` groups of `group` blocks, a group serving members g,
    g + members, ... in turn."""

    group: int  # blocks a member
    members: int  # members in flight: the grid is group * members blocks, at most one an SM
    threads: int  # a block's: a thread an entity, in whole warps
    per_block: int  # the contiguous run of a member's entities a block owns
    on_chip: bool  # the run's states stay in shared memory from step to step
    smem_bytes: int  # dynamic shared memory a block takes


def beam_smem_bytes(players: int, steps: int, state_cols: int) -> int:
    """The arena rollout's dynamic shared memory (csrc/beam_rollout.cu,
    `beam_arena::rollout_kernel`), in bytes: finalized teams [3P], team
    rows [rows][3P] (a row a warp up to ROW_TEAMS teams, else one), the
    member's resolved script [L][P][2], each warp's checksum sums
    [L+1][32][2], and `state_cols` entities' states when they stay on
    chip."""
    warps = INLINE_THREADS // 32
    rows = warps if players <= ROW_TEAMS else 1
    words = 3 * players + rows * 3 * players + 2 * steps * players + 2 * (steps + 1) * warps
    return 4 * (words + ARENA_STATE_WORDS * state_cols)


def beam_plan(n: int, players: int, beam: int, steps: int, sms: int, smem_per_block: int) -> BeamPlan:
    """The arena rollout's layout for B = `beam` members of n entities and
    `players` teams, up to `steps` steps, on a card of `sms` SMs whose
    blocks may take `smem_per_block` bytes of shared memory: a group of
    blocks a member (as many as fill the card, up to MAX_GROUP, and no
    more than the member has warps of entities), each owning a contiguous
    run of the member's entities, their states on chip while they fit; as
    many members in flight as one block an SM allows."""
    group = max(1, min(MAX_GROUP, sms // beam, -(-n // 32)))
    per_block = -(-n // group)
    smem = beam_smem_bytes(players, steps, per_block)
    on_chip = smem <= smem_per_block
    return BeamPlan(group, max(1, min(beam, sms // group)), block_threads(per_block), per_block, on_chip,
                    smem if on_chip else beam_smem_bytes(players, steps, 0))


class BeamRollout:
    """K4's wrapper for one (game, players) plane context; counts its
    launches in `launches`. On CPU tensors it runs `plain_rollout`; on
    CUDA tensors it launches the kernel or raises — there is no fallback."""

    kernel = "beam_rollout"

    def __init__(self, ctx, disconnect_input, max_steps: int):
        self.ctx = ctx
        self.disconnect_input = tuple(disconnect_input)  # the game's row, I ints
        self.max_steps = max_steps  # the deepest rollout a caller may ask for
        self.launches = 0
        self.plans = {}  # arena's BeamPlan by beam width, made at its first launch
        # the kernel's scratch of `_words` words (parts, the ticket, and for
        # arena the members' counters and raw rows): zero when made, and
        # every launch leaves it zero
        self._scratch, self._words = None, 0

    def _zeroed(self, words: int, device) -> torch.Tensor:
        """The scratch, at least `words` words, zero: made again (zeroed)
        only when it must grow."""
        if words > self._words:
            self._scratch, self._words = torch.zeros(words, dtype=torch.int32, device=device), words
        return self._scratch

    def plan(self, lib, beam: int) -> BeamPlan:
        """Arena's plan for `beam` members, made at the first launch of that
        width from the card's limits (read from the kernel library) by
        `beam_plan`."""
        if beam not in self.plans:
            limits = (ctypes.c_int * 2)()
            fn = launch.declare(lib, "beam_rollout_arena_limits", [launch.P])
            launch.raise_on(fn(limits), "beam_rollout_arena_limits")
            ctx = self.ctx
            self.prepare(lib, beam, beam_plan(ctx.n, ctx.num_players, beam, self.max_steps, limits[0], limits[1]))
        return self.plans[beam]

    def prepare(self, lib, beam: int, plan: BeamPlan) -> None:
        """A plan's one-time set-up (the shared-memory attribute) and the
        check that its launch can run — `KernelError` when it cannot; then
        it is the plan for `beam` members. Measurement code may call it
        before the first launch of that width to time another plan."""
        fn = launch.declare(lib, "beam_rollout_arena_prepare", [launch.I] * 5)
        launch.raise_cooperative(fn(int(plan.on_chip), plan.group, plan.group * plan.members, plan.threads,
                                    plan.smem_bytes), "beam_rollout_arena_prepare")
        self.plans[beam] = plan

    def script(self, beam_inputs: np.ndarray, beam_statuses: np.ndarray) -> torch.Tensor:
        """Host candidate rows -> the packed int32 script [B, L, P, 1 + I]
        on the context's device (from pinned memory, asynchronously, on
        CUDA), checked first."""
        ctx = self.ctx
        inputs = np.asarray(beam_inputs)
        statuses = np.asarray(beam_statuses)
        P, I = ctx.num_players, ctx.input_size
        if inputs.ndim != 4 or inputs.shape[2:] != (P, I) or statuses.shape != inputs.shape[:3]:
            raise ConfigError(
                f"beam inputs must be [B, L, {P}, {I}] with statuses [B, L, {P}], "
                f"got {inputs.shape} and {statuses.shape}"
            )
        B, L = inputs.shape[:2]
        if B < 1 or not 1 <= L <= self.max_steps:
            raise ConfigError(f"a beam needs B >= 1 members of 1..{self.max_steps} steps, got {B} x {L}")
        packed = np.empty((B, L, P, 1 + I), dtype=np.int32)
        packed[..., 0] = statuses
        packed[..., 1:] = inputs
        return launch.stage(packed, ctx.device)

    def rollout(self, ring: torch.Tensor, r_frame: torch.Tensor, anchor_slot: int,
                script: torch.Tensor) -> Speculation:
        """Roll the packed script out of `ring[anchor_slot]` (frame tag
        `r_frame[anchor_slot]`)."""
        ctx = self.ctx
        n_slots = ring.shape[0]
        if not 0 <= anchor_slot < n_slots:
            raise ConfigError(f"anchor slot {anchor_slot} outside the ring's {n_slots} slots")
        if ring.device.type == "cpu":
            return plain_rollout(ring[anchor_slot], r_frame[anchor_slot], script[..., 1:],
                                 script[..., 0], ctx)
        B, L = script.shape[:2]
        entry = launch.require_adapter(ctx, self.kernel)
        device = ring.device
        n, P, I = ctx.n, ctx.num_players, ctx.input_size
        launch.check_tensors(
            device,
            ring=(ring, (n_slots, ctx.n_planes, n)),
            r_frame=(r_frame, (n_slots,)),
            script=(script, (B, L, P, 1 + I)),
        )
        if not 1 <= L <= self.max_steps:
            raise ConfigError(f"a rollout of {L} steps is outside 1..{self.max_steps}")
        lib = build.load(self.kernel)
        Pt, It = launch.P, launch.I
        traj = torch.empty((B, L, ctx.n_planes, n), dtype=torch.int32, device=device)
        # his [B*L], los [B*L], then a_hi, a_lo and the anchor's frame
        out = torch.empty(2 * B * L + 3, dtype=torch.int32, device=device)
        ptrs = (ring.data_ptr(), anchor_slot, r_frame.data_ptr(), script.data_ptr(), traj.data_ptr(),
                out.data_ptr())
        disconnect = launch.disconnect_arg(self.disconnect_input)
        if entry.reduces:
            plan = self.plan(lib, B)
            # the members' arrival counters [B] (u64), the ticket, parts_hi and
            # parts_lo [B*L + 1] (the anchor's row last), the members' raw rows [B, L, R]
            scratch = self._zeroed(2 * B + 1 + 2 * (B * L + 1) + B * L * ctx.reduce_len, device)
            fn = launch.declare(lib, entry.symbol, [Pt, It] + [Pt] * 5 + [It] * 11 + [Pt] * 3)
            rc = fn(*ptrs, scratch.data_ptr(), n, P, I, B, L, int(plan.on_chip), plan.group,
                    plan.group * plan.members, plan.threads, plan.per_block, plan.smem_bytes, disconnect,
                    launch.weights_arg(ctx), launch.stream_of(device))
            launch.raise_on(rc, self.kernel)
        else:
            extra = launch.model_ints(entry, ctx)
            fn = launch.declare(lib, entry.symbol, [Pt, It] + [Pt] * 5 + [It] * (5 + len(extra)) + [Pt] * 3)
            # parts_hi [B*L + 1], parts_lo [B*L + 1] (the anchor's row last)
            # and the members' tickets [B]
            scratch = self._zeroed(2 * (B * L + 1) + B, device)
            rc = fn(*ptrs, scratch.data_ptr(), n, P, I, B, L, *extra, disconnect, launch.weights_arg(ctx),
                    launch.stream_of(device))
            launch.raise_on(rc, self.kernel)
        self.launches += 1
        bl = B * L
        return Speculation(traj, out[:bl].view(B, L), out[bl : 2 * bl].view(B, L),
                           out[2 * bl], out[2 * bl + 1], out[2 * bl + 2])

