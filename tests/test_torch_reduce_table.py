"""K5's plain version (ggrs_tpu_torch/device/reduce_core.py) against the
reference's reduction table, `PallasTiledSyncTestCore(...,
external_reduce=True)` `reduce_sources_kernel` and
`frontier_partial_kernel` in interpret mode, on carries taken from a few
reference ticks, and against the reference adapter's `reduce_partial` on
random planes; and the wrapper's CPU path. Tolerance zero."""

import numpy as np
import pytest
import torch

import jax

from ggrs_tpu.models.arena import Arena as RefArena
from ggrs_tpu.tpu import TpuSyncTestSession
from ggrs_tpu.tpu.pallas_core import KernelCtx, get_adapter as get_ref_adapter
from ggrs_tpu.tpu.pallas_tiled import PallasTiledSyncTestCore
from ggrs_tpu_torch import Arena, ConfigError, ExGame
from ggrs_tpu_torch.convert import carry_from_reference
from ggrs_tpu_torch.device.planes import PlaneContext
from ggrs_tpu_torch.device.reduce_core import (
    STATE, ReduceTableCore, plain_reduce_table, source_slots,
)


def ref_carry(players, n, d, frames, seed):
    """A reference carry after `frames` ticks, with a quarter of the
    entities killed in ring and state (so the sums skip the dead)."""
    rng = np.random.default_rng(seed)
    sess = TpuSyncTestSession(RefArena(players, n), players, d, backend="xla")
    sess.advance_frames(rng.integers(0, 64, size=(frames, players, 1), dtype=np.uint8))
    carry = jax.tree.map(np.array, jax.device_get(sess.carry))
    carry["state"]["hp"][rng.random(n) < 0.25] = 0
    carry["ring"]["hp"][:, rng.random(n) < 0.25] = 0
    return carry


@pytest.mark.parametrize("players,frames", [(2, 3), (3, 11)])
def test_plain_table_matches_reference_kernels(players, frames):
    """Frame 3 < d reads the boot slots (base pinned at 0); frame 11 reads
    wrapped ring slots. Rows and the frontier row equal the reference's."""
    n, d = 512, 4
    carry = ref_carry(players, n, d, frames, seed=players)
    core = PallasTiledSyncTestCore(RefArena(players, n), players, d, interpret=True, external_reduce=True)
    dev = jax.device_put(carry)
    want = np.asarray(core.reduce_sources_kernel(dev))
    want_front = np.asarray(core.frontier_partial_kernel(dev))

    port = carry_from_reference(carry, "cpu")
    ctx = PlaneContext(Arena(players, n), players, d, "cpu")
    slots = source_slots(frames, d, ctx.ring_len)
    sources = torch.stack([port["state"] if s == STATE else port["ring"][s] for s in slots])
    np.testing.assert_array_equal(plain_reduce_table(sources, ctx).numpy(), want)
    np.testing.assert_array_equal(plain_reduce_table(port["state"][None], ctx).numpy()[0], want_front)
    assert (want[:, 0] < n // players).all()  # the dead are not counted


@pytest.mark.parametrize("players", [3, 17, 64])
@pytest.mark.parametrize("num_sources", [1, 9])
def test_plain_table_matches_reference_reduce_partial(players, num_sources):
    """Each row of plain_reduce_table over S sources (1: the frontier row;
    d + 1 = 9: a tick's table) equals the reference ArenaPlanes'
    reduce_partial of that source, on random planes with a quarter of the
    entities dead."""
    n = 2048
    rng = np.random.default_rng(players * 100 + num_sources)
    planes = rng.integers(0, 1 << 18, size=(num_sources, 6, n), dtype=np.int32)
    planes[:, 4] = rng.integers(-2, 6, size=(num_sources, n), dtype=np.int32)  # hp, some dead
    ref = get_ref_adapter(RefArena(players, n))
    gi = jax.numpy.arange(n, dtype=jax.numpy.int32)
    kctx = KernelCtx(gi, gi % players)
    want = np.stack([np.asarray(ref.reduce_partial({"px": p[0], "py": p[1], "hp": p[4]}, kctx), dtype=np.int32)
                     for p in planes])
    ctx = PlaneContext(Arena(players, n), players, 8, "cpu")
    got = plain_reduce_table(torch.from_numpy(planes), ctx).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.shape == (num_sources, 3 * players) and (want[:, 0::3] < n // players + 1).all()


def test_wrapper_takes_cpu_carries():
    """On a CPU carry every entry point runs plain_reduce_table and counts
    no launch; `frontier` writes into the row it is given."""
    players, n, d = 3, 384, 4
    carry = carry_from_reference(ref_carry(players, n, d, 9, seed=4), "cpu")
    ctx = PlaneContext(Arena(players, n), players, d, "cpu")
    core = ReduceTableCore(ctx)
    table = core.reduce_sources(carry, 9)
    slots = source_slots(9, d, ctx.ring_len)
    assert slots == (5 % 6, 0, 1, 2, STATE)
    for row, s in zip(table, slots):
        src = carry["state"] if s == STATE else carry["ring"][s]
        assert torch.equal(row, plain_reduce_table(src[None], ctx)[0])
    out = torch.zeros((2, ctx.reduce_len), dtype=torch.int32)
    core.frontier(carry, out=out[1:])
    assert torch.equal(out[1], table[-1]) and not out[0].any()
    assert torch.equal(core.table(carry["ring"]), plain_reduce_table(carry["ring"], ctx))
    assert core.launches == 0


def test_source_slots_pin_the_base_until_frame_d():
    assert source_slots(0, 4, 6) == (0, 1, 2, 3, STATE)
    assert source_slots(4, 4, 6) == (0, 1, 2, 3, STATE)
    assert source_slots(7, 4, 6) == (3, 4, 5, 0, STATE)


def test_only_arena_planes_are_reduced():
    with pytest.raises(ConfigError):
        ReduceTableCore(PlaneContext(ExGame(2, 256), 2, 4, "cpu"))
