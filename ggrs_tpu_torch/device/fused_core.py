"""K1: the whole-batch fused SyncTest kernel and its plain PyTorch version.

The port's counterpart of `ggrs_tpu/tpu/pallas_core.py`
`PallasSyncTestCore`: ONE launch runs a batch of T SyncTest ticks —
rollback load, resimulation with re-saves, the frontier save and step,
the ring-frame tags, the input ring and the first-seen checksum history
with its mismatch latch — updating the carry in place
(`csrc/synctest_fused.cu`).

`plain_batch` is the same batch in plain PyTorch: the reference session's
`_tick` loop (ggrs_tpu/tpu/sync_test.py:261-305), followed by its
`_save_and_check` history compare over the batch's saves in order. It is
what a CPU carry runs under `"cuda-fused"`, and what `chip_smoke.py` holds
the kernel against on the card.

For a game with a cross-entity reduction (arena) it keeps the reference
kernel's per-frame reduction cache (pallas_core.py:789-801, :863-887,
:936-944): when T > 1, slot s of a `[d+2, R]` table starts as the raw
reduction of ring slot s (zero-initialised slots early in a session
included) and the slot of frame c0 as that of the live state; the step of
frame f reads slot f % (d+2), and each tick's new frontier state (frame
c+1) is reduced into slot (c+1) % (d+2). When T == 1 every step reduces
inline from the state entering it, as the reference's XLA scan always
does. Both give the same bits on clean runs; after a corrupted ring slot
they may differ, so each route keeps its own.
"""

from __future__ import annotations

import torch

from ..errors import KernelError
from ..kernels import build, launch
from .planes import PlaneContext
from .tiled_core import plain_parts, plain_verdict

def plain_batch(carry, inputs: torch.Tensor, ctx: PlaneContext) -> None:
    """T SyncTest ticks on the carry in place, in plain PyTorch, with K1's
    reduction semantics (the cache when T > 1)."""
    red_of = on_frontier = None
    if ctx.reduce_len and inputs.shape[0] > 1:
        adapter, ring_len = ctx.adapter, ctx.ring_len
        cache = adapter.reduce_partial(carry["ring"], ctx.owner)  # [d+2, R]
        cache[int(carry["meta"][0]) % ring_len] = adapter.reduce_partial(carry["state"], ctx.owner)

        def red_of(f, i):
            return adapter.reduce_finalize(cache[f % ring_len])

        def on_frontier(c, state):
            cache[(c + 1) % ring_len] = adapter.reduce_partial(state, ctx.owner)

    parts_hi, parts_lo = plain_parts(carry, inputs, ctx, red_of, on_frontier)
    plain_verdict(carry, parts_hi, parts_lo, ctx)


class FusedSyncTestCore:
    """K1's wrapper for one (game, players, check_distance); counts its
    launches in `launches`. Arena's batch is a cooperative launch (its
    grid barriers need every block resident): a grid that cannot be
    resident raises `KernelError`, as does any refused launch."""

    kernel = "synctest_fused"

    def __init__(self, ctx: PlaneContext):
        self.ctx = ctx
        self.launches = 0

    def batch(self, carry, inputs: torch.Tensor) -> None:
        if carry["state"].device.type == "cpu":
            return plain_batch(carry, inputs, self.ctx)
        ctx = self.ctx
        entry = launch.require_adapter(ctx, self.kernel)
        launch.check_carry(carry, ctx, inputs)
        lib = build.load(self.kernel)
        P, I = launch.P, launch.I
        t_ticks = inputs.shape[0]
        device = carry["state"].device
        ptrs = (carry["state"].data_ptr(), carry["ring"].data_ptr(), carry["r_frame"].data_ptr(),
                carry["iring"].data_ptr(), carry["h_tag"].data_ptr(), carry["h_hi"].data_ptr(),
                carry["h_lo"].data_ptr(), carry["meta"].data_ptr(), inputs.data_ptr())
        if entry.reduces:
            launch.declare(lib, "synctest_fused_arena_rows", [I, I])
            fn = launch.declare(lib, entry.symbol, [P] * 10 + [I] * 5 + [P, P])
            rows = lib.synctest_fused_arena_rows(ctx.d, t_ticks)
            # parts_hi [T*d], parts_lo [T*d], ticket, barrier [2], raw table [rows, R]
            scratch = torch.empty(2 * t_ticks * ctx.d + 3 + rows * ctx.reduce_len,
                                  dtype=torch.int32, device=device)
            rc = fn(*ptrs, scratch.data_ptr(), ctx.n, ctx.num_players, ctx.input_size, ctx.d, t_ticks,
                    launch.weights_arg(ctx), launch.stream_of(device))
            if rc == launch.NOT_CO_RESIDENT:
                raise KernelError(
                    f"{self.kernel} (arena): {-(-ctx.n // 128)} blocks of 128 entities cannot all be "
                    "resident on this card for its grid barriers; use backend='cuda-tiled'"
                )
        else:
            extra = launch.model_ints(entry, ctx)
            fn = launch.declare(lib, entry.symbol, [P] * 10 + [I] * (5 + len(extra)) + [P, P])
            # parts_hi [T*d], parts_lo [T*d] and the last-block ticket
            scratch = torch.empty(2 * t_ticks * ctx.d + 1, dtype=torch.int32, device=device)
            rc = fn(*ptrs, scratch.data_ptr(), ctx.n, ctx.num_players, ctx.input_size, ctx.d, t_ticks,
                    *extra, launch.weights_arg(ctx), launch.stream_of(device))
        launch.raise_on(rc, self.kernel)
        self.launches += 1
