"""K4: the speculative beam rollout kernel and its plain PyTorch version.

The port's counterpart of `ggrs_tpu/tpu/pallas_beam.py`
`PallasBeamRollout` (`_build`, `run_kernel`, `finish`): from ONE anchor
snapshot (a ring slot of a `ResimCore` carry) roll B candidate input
scripts L frames each, and return every member's state after every step
with its checksum, and the anchor's own checksum — one launch of
`csrc/beam_rollout.cu` on CUDA (ex_game's or swarm's body, one template,
or arena's, which reduces each member's world before every step behind a
grid barrier; `launch.ENTRIES` chooses),
`plain_rollout` on the CPU.

A script is packed into ONE int32 tensor `[B, L, P, 1 + I]` (one upload):
`[..., 0]` is the cell's status, `[..., 1:]` its input bytes. A
DISCONNECTED cell steps with the game's disconnect input, exactly as the
request path's tick (K3) does, so a speculation is defined for any
statuses.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..errors import ConfigError
from ..kernels import build, launch
from ..ops import fixed_point as fx


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
            fn = launch.declare(lib, entry.symbol, [Pt, It] + [Pt] * 5 + [It] * 5 + [Pt] * 3)
            # parts_hi [B*L + 1], parts_lo [B*L + 1] (the anchor's row last),
            # the ticket, the grid barrier [2] and the raw reduction rows:
            # the anchor's, then one [3P] per (step >= 1, member)
            scratch = torch.empty(2 * (B * L + 1) + 3 + (1 + (L - 1) * B) * ctx.reduce_len,
                                  dtype=torch.int32, device=device)
            rc = fn(*ptrs, scratch.data_ptr(), n, P, I, B, L, disconnect, launch.weights_arg(ctx),
                    launch.stream_of(device))
            launch.raise_cooperative(rc, self.kernel)
        else:
            extra = launch.model_ints(entry, ctx)
            fn = launch.declare(lib, entry.symbol, [Pt, It] + [Pt] * 5 + [It] * (5 + len(extra)) + [Pt] * 3)
            # parts_hi [B*L + 1], parts_lo [B*L + 1] (the anchor's row last)
            # and the last-block ticket
            scratch = torch.empty(2 * (B * L + 1) + 1, dtype=torch.int32, device=device)
            rc = fn(*ptrs, scratch.data_ptr(), n, P, I, B, L, *extra, disconnect, launch.weights_arg(ctx),
                    launch.stream_of(device))
            launch.raise_on(rc, self.kernel)
        self.launches += 1
        bl = B * L
        return Speculation(traj, out[:bl].view(B, L), out[bl : 2 * bl].view(B, L),
                           out[2 * bl], out[2 * bl + 1], out[2 * bl + 2])

