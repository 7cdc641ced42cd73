"""The injection route's one-launch tick (`TiledSyncTestCore.tick_injected`:
the tick on the table, the next table and the verdict) through its plain
twin on the CPU, against the reference's sharded tiled core on a one-device
mesh (`pallas-tiled-interpret`, reduce injection), full carry after every
batch, tolerance zero: batches of 1, 3, d and d+1 ticks across the boot
boundary (frames d-1, d, d+1), a batch that starts past d after a kill
probe, and a checkpoint saved mid-route and restored. Then the tick's next
table against K5's plain frontier row. Interpret mode costs seconds per
batch, so the worlds are small."""

import numpy as np
import pytest
import torch

import jax

from ggrs_tpu.errors import MismatchedChecksum as RefMismatchedChecksum
from ggrs_tpu.models.arena import Arena as RefArena
from ggrs_tpu.parallel.mesh import make_mesh
from ggrs_tpu.tpu import TpuSyncTestSession
from ggrs_tpu_torch import Arena, DeviceSyncTestSession, MismatchedChecksum
from ggrs_tpu_torch.convert import carry_to_reference
from ggrs_tpu_torch.device import sync_test
from ggrs_tpu_torch.device.fused_core import plain_batch
from ggrs_tpu_torch.device.planes import PlaneContext
from ggrs_tpu_torch.device.reduce_core import ReduceTableCore
from ggrs_tpu_torch.device.tiled_core import TiledSyncTestCore, plain_parts, plain_verdict

D = 4
N = 256
KILLED = 64  # entities the probe kills in the slot loaded next


def assert_tree_equal(got, want, path="carry"):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_tree_equal(got[k], want[k], f"{path}/{k}")
        return
    g, w = np.asarray(got), np.asarray(want)
    assert g.dtype == w.dtype, f"{path}: {g.dtype} != {w.dtype}"
    np.testing.assert_array_equal(g, w, err_msg=path)


def script(frames, seed):
    return np.random.default_rng(seed).integers(0, 64, size=(frames, 2, 1), dtype=np.uint8)


def drive(lengths, seed, kill_at=None, save_at=None, tmp_path=None):
    """The reference (one-device mesh) and the port's injection route (its
    plain twin) over batches of `lengths` ticks from frame 0, full carries
    compared after every batch. `kill_at`: the frame before whose batch
    KILLED entities die in the slot that batch loads first; `save_at`: the
    frame at which the port's session is saved, restored and driven on.
    Returns both sessions."""
    sc = script(sum(lengths), seed)
    ref = TpuSyncTestSession(RefArena(2, N), 2, D, backend="pallas-tiled-interpret", mesh=make_mesh(1))
    port = DeviceSyncTestSession(Arena(2, N), 2, D, backend="cuda-tiled-injected", device="cpu")
    start = 0
    for t in lengths:
        if start == kill_at:
            slot = (start - D) % (D + 2)
            ring = dict(ref.carry["ring"])
            ring["hp"] = ring["hp"].at[slot, :KILLED].set(0)
            ref.carry = {**ref.carry, "ring": ring}
            port.carry["ring"][slot, 4, :KILLED] = 0
        if start == save_at:
            path = str(tmp_path / "mid_route.npz")
            port.save(path)
            port = DeviceSyncTestSession.restore(path, Arena(2, N), backend="cuda-tiled-injected", device="cpu")
            assert port.current_frame == start
        ref.advance_frames(sc[start:start + t])
        port.advance_frames(sc[start:start + t])
        start += t
        assert_tree_equal(carry_to_reference(port.carry), jax.device_get(ref.carry), f"frame {start}")
    return ref, port


@pytest.mark.parametrize("length", [1, 3, D, D + 1])
def test_batches_across_the_boot_boundary_match_reference(length):
    """Batches of `length` ticks from frame 0 to past 2d: the boot ticks
    (below d the next table is K5's full rebuild over what the launch
    wrote) and the rolled ones (from d on, rows 1..d and the new live
    state's row) meet inside one batch (3, d, d+1) or across batches (1);
    the ring's skipped re-saves leave the same ring at every batch end."""
    ref, port = drive([length] * -(-(2 * D + 3) // length), seed=length)
    ref.check()
    port.check()
    assert int(port.carry["meta"][0]) > 2 * D + 2


def test_batch_past_d_after_kill_probe_matches_reference():
    """A 3-tick batch that starts past frame d, after 64 entities are
    killed in the slot it loads first: both latch the same frame, with the
    same carry."""
    ref, port = drive([D + 3, 3, 3], seed=7, kill_at=D + 3)
    with pytest.raises(RefMismatchedChecksum) as ref_err:
        ref.check()
    with pytest.raises(MismatchedChecksum) as port_err:
        port.check()
    assert port_err.value.frame == ref_err.value.frame == D + 3 - D + 1


def test_checkpoint_mid_route_restores_and_matches_reference(tmp_path):
    """The port's session saved mid-route (past d, between batches),
    restored on a fresh core (its tables made anew) and driven on equals
    the reference that never stopped."""
    ref, port = drive([3, 3, 3, 2, 3], seed=11, save_at=9, tmp_path=tmp_path)
    ref.check()
    port.check()


def test_tick_next_table_is_k5_frontier_row_beside_rows_1_to_d():
    """On a CPU carry past frame d: the tick's next table is rows 1..d of
    the table it ran on, then K5's plain frontier row of the new live state;
    the tick's table keeps rows 0..d-1 and its row d is left zero; the carry
    equals plain_parts on the finalized table plus plain_verdict."""
    ctx = PlaneContext(Arena(2, N), 2, D, "cpu")
    carry = sync_test.initial_carry(ctx)
    plain_batch(carry, torch.from_numpy(script(D + 3, 5).astype(np.int32)), ctx)
    carry["state"][4, 1::9] = 0  # dead entities in the live state
    twin = {k: v.clone() for k, v in carry.items()}
    inputs = torch.from_numpy(script(1, 6).astype(np.int32))
    k5 = ReduceTableCore(ctx)
    table = k5.reduce_sources(carry, int(carry["meta"][0]))
    red, nxt = table.clone(), torch.full_like(table, 77)
    TiledSyncTestCore(ctx).tick_injected(carry, inputs, red, nxt)

    rows = [ctx.adapter.reduce_finalize(r) for r in table]
    parts = plain_parts(twin, inputs, ctx, red_of=lambda f, i: rows[i])
    plain_verdict(twin, *parts, ctx)
    for k in carry:
        assert torch.equal(carry[k], twin[k]), k
    assert torch.equal(nxt[:D], table[1:])
    assert torch.equal(nxt[D:], k5.frontier(carry))
    assert torch.equal(red[:D], table[:D]) and not red[D].any()
    assert k5.launches == 0
