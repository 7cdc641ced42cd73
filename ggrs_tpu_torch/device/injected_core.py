"""The injected-reduction SyncTest route for a game with a cross-entity
reduction (arena): K5 builds each tick's reduction table, K2 runs the tick
on it, the verdict kernel folds its checksums.

The one-device counterpart of `ggrs_tpu/tpu/pallas_tiled.py`
`ShardedPallasTiledCore` in `reduce_mode` (:704-905), with no mesh: a psum
over one shard is the identity (`DeviceSyncTestSession(...,
backend="cuda-tiled-injected")`; "auto" takes it where arena's K1 cannot
hold its grid resident, since its rolled table keeps the sums K1's cache
keeps). It holds no state of its own between batches: the table is built
from the carry and the frame the caller passes, so a restored checkpoint
resumes on it with nothing to re-arm. Per batch:

- the table of the first tick is built in full by K5 from the carry
  (`reduce_sources`: the ring slots of its resim frames and the live
  state);
- per tick: one K2 launch on the table (`external_reduce`, one tick), the
  verdict over its parts, then the next tick's table: while the tick's
  frame c is below d the rollback base stays pinned at 0 and the table is
  rebuilt in full; from c >= d on it ROLLS — rows 1..d move up one row and
  K5 reduces the new live state into row d (the reference's boot `cond`,
  :884-891). The frame is known on the host, so this is a Python branch,
  not a second program.

Every kernel wrapper takes its plain version on a CPU carry, so on the CPU
this module is the route's plain twin.
"""

from __future__ import annotations

import torch

from .planes import PlaneContext
from .reduce_core import ReduceTableCore
from .tiled_core import TiledSyncTestCore


class InjectedReduceCore:
    """The route's wrappers for one (game, players, check_distance): the
    tiled core (K2 and its verdict, with their launch counts) and the
    reduction-table core (K5, `reduce.launches`)."""

    def __init__(self, ctx: PlaneContext):
        self.ctx = ctx
        self.tiled = TiledSyncTestCore(ctx)
        self.reduce = ReduceTableCore(ctx)

    def batch(self, carry, inputs: torch.Tensor, frame: int = None) -> None:
        """T ticks on the carry in place. `frame`: the carry's frame, as the
        caller tracks it on the host (read from the carry when not given)."""
        d = self.ctx.d
        c = int(carry["meta"][0]) if frame is None else frame
        red = self.reduce.reduce_sources(carry, c)
        t_ticks = inputs.shape[0]
        for t in range(t_ticks):
            parts_hi, parts_lo = self.tiled.run_kernel(carry, inputs[t : t + 1], red_raw=red)
            self.tiled.verdict(carry, parts_hi, parts_lo)
            if t == t_ticks - 1:
                break  # no tick of this batch reads the next table
            if c >= d:  # the next base is base+1: the rows shift
                rolled = torch.empty_like(red)
                rolled[:d] = red[1:]
                self.reduce.frontier(carry, out=rolled[d:])
                red = rolled
            else:
                red = self.reduce.reduce_sources(carry, c + 1)
            c += 1
