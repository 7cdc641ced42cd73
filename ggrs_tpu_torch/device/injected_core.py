"""The injected-reduction SyncTest route for a game with a cross-entity
reduction (arena): K5 builds a full reduction table where the route
rebuilds one, and K2's injected tick runs each tick in one launch.

The one-device counterpart of `ggrs_tpu/tpu/pallas_tiled.py`
`ShardedPallasTiledCore` in `reduce_mode` (:704-905), with no mesh: a psum
over one shard is the identity (`DeviceSyncTestSession(...,
backend="cuda-tiled-injected")`; "auto" takes it where arena's K1 cannot
hold its grid resident, since its rolled table keeps the sums K1's cache
keeps). It keeps no state of the game between batches: the table is
built from the carry and the frame the caller passes, so a restored
checkpoint resumes on it with nothing to re-arm. Per batch:

- the table of the first tick is built in full by K5 from the carry
  (`reduce_sources`: the ring slots of its resim frames and the live
  state);
- per tick: ONE launch (`TiledSyncTestCore.tick_injected`) runs the tick
  on the table, writes the next tick's table into the other of two
  buffers (rows 1..d of this one moved up, and the new live state's raw
  sums as row d: the reference's `roll`), and runs the verdict. While the
  tick's frame c is below d the rollback base stays pinned at 0 and K5
  rebuilds the next table in full over what the launch wrote (the
  reference's boot `cond`, :884-891). The frame is known on the host, so
  this is a Python branch, not a second program.

The two tables are the core's scratch: the launch sums the next table's
row d into a buffer whose row d is zero, and leaves the row d of the
table it read zero, so alternating the buffers needs no memset and no
copy. Every wrapper takes its plain version on a CPU carry, so on the CPU
this module is the route's plain twin.
"""

from __future__ import annotations

import torch

from .planes import PlaneContext
from .reduce_core import ReduceTableCore
from .tiled_core import TiledSyncTestCore


class InjectedReduceCore:
    """The route's wrappers for one (game, players, check_distance): the
    tiled core (K2's injected tick, with its launch count) and the
    reduction-table core (K5, `reduce.launches`)."""

    def __init__(self, ctx: PlaneContext):
        self.ctx = ctx
        self.tiled = TiledSyncTestCore(ctx)
        self.reduce = ReduceTableCore(ctx)
        # two raw tables [2, d+1, R]: `_cur` the one the next tick reads;
        # the other's row d is zero (made at the first batch)
        self._tables, self._cur = None, 0

    def batch(self, carry, inputs: torch.Tensor, frame: int = None) -> None:
        """T ticks on the carry in place. `frame`: the carry's frame, as the
        caller tracks it on the host (read from the carry when not given)."""
        ctx = self.ctx
        d = ctx.d
        c = int(carry["meta"][0]) if frame is None else frame
        if self._tables is None:
            self._tables = torch.zeros((2, d + 1, ctx.reduce_len), dtype=torch.int32, device=ctx.device)
        red = self.reduce.reduce_sources(carry, c, out=self._tables[self._cur])
        t_ticks = inputs.shape[0]
        for t in range(t_ticks):
            nxt = self._tables[1 - self._cur]
            self.tiled.tick_injected(carry, inputs[t : t + 1], red, nxt, later=t_ticks - 1 - t)
            self._cur, red = 1 - self._cur, nxt
            if c < d and t < t_ticks - 1:  # the base stays pinned at 0: the next table in full
                self.reduce.reduce_sources(carry, c + 1, out=red)
            c += 1
