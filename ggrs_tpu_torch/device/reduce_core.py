"""K5: the reduction table, and its plain PyTorch version.

The port's counterpart of `ggrs_tpu/tpu/pallas_tiled.py`
`PallasTiledSyncTestCore._build_reduce_table` with its two callers,
`reduce_sources_kernel` (:642) and `frontier_partial_kernel` (:666): raw
int32 `[S, R]` tables of the adapter's `reduce_partial` sums (arena: per
team, the living count, Σ px>>6 and Σ py>>6) over S plane sources in one
launch (`csrc/reduce_table.cu`), which overwrites its output and leaves
the core's scratch (partial rows and tickets, zeroed once) zero. They feed
the injected-reduction route (`injected_core`): its full tables, at the
start of every batch and before frame d.

A source is a ring slot or the live state; the kernel takes their slot
indices (-1 for the state) as a small device array, so a table over d
ring slots and the state reads the planes where they lie. On a CPU carry
every entry point runs `plain_reduce_table`.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..errors import ConfigError
from ..kernels import build, launch
from .planes import ArenaPlanes, PlaneContext

STATE = -1  # the slot index that names the live state


def plain_reduce_table(sources: torch.Tensor, ctx: PlaneContext) -> torch.Tensor:
    """Raw `[S, R]` sums over sources `[S, n_planes, N]`."""
    return ctx.adapter.reduce_partial(sources, ctx.owner)


def source_slots(frame: int, d: int, ring_len: int) -> Tuple[int, ...]:
    """The sources of one tick's table at carry frame c: the ring slots of
    the resim frames base..base+d-1 (base = max(c-d, 0)), then the live
    state. Early in a session they are zero-initialised slots, read only
    by steps that do not happen, as in the reference."""
    base = max(frame - d, 0)
    return tuple((base + i) % ring_len for i in range(d)) + (STATE,)


class ReduceTableCore:
    """K5's wrapper for one (game, players, check_distance); counts its
    launches in `launches`."""

    kernel = "reduce_table"

    def __init__(self, ctx: PlaneContext):
        if not isinstance(ctx.adapter, ArenaPlanes):
            raise ConfigError(f"{self.kernel} reduces arena planes, not {type(ctx.adapter).__name__}")
        self.ctx = ctx
        self.launches = 0
        self._slots: Dict[Tuple[int, ...], torch.Tensor] = {}  # device copies, by slot tuple
        # the kernel's partial rows and tickets for up to `_rows` sources:
        # zero when made, and every launch leaves them zero
        self._scratch, self._rows = None, 0

    def _slot_tensor(self, slots: Tuple[int, ...]) -> torch.Tensor:
        t = self._slots.get(slots)
        if t is None:
            t = launch.stage(np.asarray(slots, dtype=np.int32), self.ctx.device)
            self._slots[slots] = t
        return t

    def gather(self, ring: torch.Tensor, state: torch.Tensor, slots: Tuple[int, ...],
               out: torch.Tensor = None) -> torch.Tensor:
        """Raw `[S, R]` sums over the named sources (ring slots, or STATE
        for `state`), written into `out` when given (a contiguous `[S, R]`
        int32 view; its old contents are overwritten)."""
        ctx = self.ctx
        S = len(slots)
        if out is None:
            out = torch.empty((S, ctx.reduce_len), dtype=torch.int32, device=state.device)
        if state.device.type == "cpu":
            sources = torch.stack([state if s == STATE else ring[s] for s in slots])
            out.copy_(plain_reduce_table(sources, ctx))
            return out
        entry = launch.require_adapter(ctx, self.kernel)
        n_slots = ring.shape[0]
        if any(not -1 <= s < n_slots for s in slots) or S < 1:
            raise ConfigError(f"source slots {slots} outside the ring's {n_slots} slots")
        launch.check_tensors(
            state.device,
            ring=(ring, (n_slots, ctx.n_planes, ctx.n)),
            state=(state, (ctx.n_planes, ctx.n)),
            out=(out, (S, ctx.reduce_len)),
        )
        lib = build.load(self.kernel)
        if S > self._rows:
            self._scratch = torch.zeros(S * (ctx.reduce_len + 1), dtype=torch.int32, device=state.device)
            self._rows = S
        P, I = launch.P, launch.I
        fn = launch.declare(lib, entry.symbol, [P, P, P, I, I, I, I, P, P, P])
        rc = fn(
            ring.data_ptr(), state.data_ptr(), self._slot_tensor(tuple(slots)).data_ptr(), S,
            ctx.n, ctx.n_planes, ctx.num_players, out.data_ptr(), self._scratch.data_ptr(),
            launch.stream_of(state.device),
        )
        launch.raise_on(rc, self.kernel)
        self.launches += 1
        return out

    def table(self, sources: torch.Tensor) -> torch.Tensor:
        """Raw `[S, R]` sums over stacked sources `[S, n_planes, N]`."""
        return self.gather(sources, sources[0], tuple(range(sources.shape[0])))

    def reduce_sources(self, carry, frame: int, out: torch.Tensor = None) -> torch.Tensor:
        """The `[d+1, R]` table of one tick at carry frame `frame`
        (pallas_tiled.py:642-664): rows 0..d-1 from the ring slots of the
        resim frames, row d from the live state; into `out` when given."""
        ctx = self.ctx
        return self.gather(carry["ring"], carry["state"], source_slots(frame, ctx.d, ctx.ring_len), out)

    def frontier(self, carry, out: torch.Tensor = None) -> torch.Tensor:
        """The live state's `[1, R]` row (pallas_tiled.py:666-674)."""
        return self.gather(carry["ring"], carry["state"], (STATE,), out)
