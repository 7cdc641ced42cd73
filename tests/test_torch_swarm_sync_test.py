"""Swarm on the port's fused SyncTest (ggrs_tpu_torch/device/) against the
reference `TpuSyncTestSession`, full carry after every batch, tolerance
zero. Each port route's CPU plain version is held against the reference
route it ports:

    port backend (CPU plain version)   reference backend
    "torch"                            "xla"
    "cuda-fused" (K1's)                "pallas-interpret" (whole-batch kernel)
    "cuda-tiled" (K2's + the verdict)  "pallas-tiled-interpret" (entity-tiled)

A divergence probe corrupts a POSITION plane of the ring slot the next
rollback loads (a position persists under the torus wrap; a corrupted
charge or velocity may be clamped back) and both sides must latch the
same mismatch frame. Interpret mode costs seconds per batch, so the
worlds are small."""

import numpy as np
import pytest
import torch

import jax

from ggrs_tpu.errors import MismatchedChecksum as RefMismatchedChecksum
from ggrs_tpu.models.swarm import Swarm as RefSwarm
from ggrs_tpu.tpu import TpuSyncTestSession
from ggrs_tpu_torch import DeviceSyncTestSession, MismatchedChecksum, Swarm
from ggrs_tpu_torch.convert import CARRY_KEYS, carry_from_reference, carry_to_reference
from ggrs_tpu_torch.device import sync_test
from ggrs_tpu_torch.device.fused_core import FusedSyncTestCore, plain_batch
from ggrs_tpu_torch.device.planes import PlaneContext
from ggrs_tpu_torch.device.tiled_core import TiledSyncTestCore

MOD = 128  # six axis bits and BOOST


def assert_tree_equal(got, want, path="carry"):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_tree_equal(got[k], want[k], f"{path}/{k}")
        return
    g, w = np.asarray(got), np.asarray(want)
    assert g.dtype == w.dtype, f"{path}: {g.dtype} != {w.dtype}"
    np.testing.assert_array_equal(g, w, err_msg=path)


def script(frames, players, seed):
    return np.random.default_rng(seed).integers(0, MOD, size=(frames, players, 1), dtype=np.uint8)


def run_pair(ref_backend, port_backend, players, n, d, t_ticks, frames, delay=0, probe_at=None):
    """Drive both sessions T frames a batch, comparing full carries after
    every batch; with `probe_at`, corrupt px of entity 0 in the slot the
    next rollback loads at that frame and return both latched frames."""
    sc = script(frames, players, seed=players * 10 + t_ticks + n)
    ref = TpuSyncTestSession(RefSwarm(players, n), players, d, input_delay=delay, backend=ref_backend)
    port = DeviceSyncTestSession(Swarm(players, n), players, d, input_delay=delay, backend=port_backend,
                                 device="cpu")
    for start in range(0, frames, t_ticks):
        if start == probe_at:
            ref.check()
            port.check()
            slot = (start - d) % (d + 2)
            ring = dict(ref.carry["ring"])
            ring["pos"] = ring["pos"].at[slot, 0, 0].add(7)
            ref.carry = {**ref.carry, "ring": ring}
            port.carry["ring"][slot, 0, 0] += 7  # plane px, entity 0: the same word
        ref.advance_frames(sc[start:start + t_ticks])
        port.advance_frames(sc[start:start + t_ticks])
        assert_tree_equal(carry_to_reference(port.carry), jax.device_get(ref.carry), f"frame {start}")
    assert port.current_frame == frames
    if probe_at is None:
        ref.check()
        port.check()
        return None
    with pytest.raises(RefMismatchedChecksum) as ref_err:
        ref.check()
    with pytest.raises(MismatchedChecksum) as port_err:
        port.check()
    return ref_err.value.frame, port_err.value.frame


@pytest.mark.parametrize("players,n,d,delay", [(2, 256, 2, 0), (3, 1024, 5, 2), (4, 384, 8, 1)])
def test_torch_backend_matches_reference_xla(players, n, d, delay):
    run_pair("xla", "torch", players, n, d, 10, 30, delay)


@pytest.mark.parametrize("players,n,d,t_ticks", [(2, 1024, 4, 12), (3, 512, 3, 1)])
def test_fused_twin_matches_reference_whole_batch_kernel(players, n, d, t_ticks):
    """K1's plain version against the reference's whole-batch kernel
    (test_swarm.py:91's pairing), in batches of 12 ticks and of one."""
    run_pair("pallas-interpret", "cuda-fused", players, n, d, t_ticks, 36 if t_ticks > 1 else 8)


@pytest.mark.parametrize("players,n,d", [(2, 1024, 4), (3, 512, 2)])
def test_tiled_twin_matches_reference_tiled_kernel(players, n, d):
    """K2's plain version (parts + verdict) against the reference's
    entity-tiled kernel."""
    run_pair("pallas-tiled-interpret", "cuda-tiled", players, n, d, 12, 36)


@pytest.mark.parametrize("ref_backend,port_backend", [("xla", "torch"), ("pallas-interpret", "cuda-fused"),
                                                      ("pallas-tiled-interpret", "cuda-tiled")])
def test_position_probe_latches_same_frame(ref_backend, port_backend):
    """A corrupted position in the slot the next rollback loads: both sides
    latch the first re-save after that load, and the carries still agree."""
    d, probe_at = 4, 12
    latched = run_pair(ref_backend, port_backend, 2, 256, d, 6, 24, probe_at=probe_at)
    assert latched == (probe_at - d + 1, probe_at - d + 1)


def test_carry_round_trip():
    """A swarm carry (pos/vel [N, 3]) crosses to the port's planes and back
    unchanged, and a run continued on both stacks stays equal."""
    players, n, d = 3, 384, 4
    sc = script(20, players, seed=5)
    ref = TpuSyncTestSession(RefSwarm(players, n), players, d, backend="xla")
    ref.advance_frames(sc[:9])
    x = jax.device_get(ref.carry)
    port_carry = carry_from_reference(x, "cpu")
    assert port_carry["state"].shape == (7, n) and port_carry["ring"].shape == (d + 2, 7, n)
    assert_tree_equal(carry_to_reference(port_carry), x)
    port = DeviceSyncTestSession(Swarm(players, n), players, d, device="cpu")
    port.carry, port.current_frame = port_carry, 9
    ref.advance_frames(sc[9:])
    port.advance_frames(sc[9:])
    assert_tree_equal(carry_to_reference(port.carry), jax.device_get(ref.carry))


def test_wrappers_take_cpu_carries():
    """K1's and K2's wrappers on a swarm CPU carry run their plain versions
    and count no launch; cuda-tiled gives swarm the plain tiled core (no
    reduction table)."""
    ctx = PlaneContext(Swarm(2, 256), 2, 3, "cpu")
    inputs = torch.from_numpy(script(12, 2, seed=3).astype(np.int32))
    want = sync_test.initial_carry(ctx)
    plain_batch(want, inputs, ctx)
    for core in (FusedSyncTestCore(ctx), TiledSyncTestCore(ctx)):
        carry = sync_test.initial_carry(ctx)
        core.batch(carry, inputs)
        for k in CARRY_KEYS:
            assert torch.equal(carry[k], want[k]), k
        assert core.launches == 0
    session = DeviceSyncTestSession(Swarm(2, 256), 2, 3, backend="cuda-tiled", device="cpu")
    assert type(session.core) is TiledSyncTestCore
