"""Arena on the port's fused SyncTest (ggrs_tpu_torch/device/) against the
reference `TpuSyncTestSession`, full carry after every batch, tolerance
zero. Each port route is held against the reference route it ports, on
clean runs and after a divergence probe:

    port backend (CPU plain twin)   reference backend
    "torch"                         "xla" (inline reductions)
    "cuda-fused", T = 10 and T = 1  "pallas-interpret" (cached / inline)
    "cuda-tiled-injected"           "pallas-tiled-interpret" on a
                                    one-device mesh (reduce injection)

("cuda-tiled", K2's inline whole-world route, is held against the
reference's "pallas-tiled-interpret" with no mesh and "xla" in
tests/test_torch_arena_tiled_inline.py.)

The probe kills entities (hp = 0) in the ring slot the next rollback
loads: the routes then disagree with each other (the cache and the
injected table keep the sums of the clean slot), and each port route must
still agree with its reference route and latch the same mismatch frame.
Interpret mode costs seconds per batch, so the worlds are small."""

import numpy as np
import pytest
import torch

import jax

from ggrs_tpu.errors import MismatchedChecksum as RefMismatchedChecksum
from ggrs_tpu.models.arena import Arena as RefArena
from ggrs_tpu.parallel.mesh import make_mesh
from ggrs_tpu.tpu import TpuSyncTestSession
from ggrs_tpu_torch import Arena, ConfigError, DeviceSyncTestSession, MismatchedChecksum
from ggrs_tpu_torch.convert import CARRY_KEYS, carry_from_reference, carry_to_reference
from ggrs_tpu_torch.device import sync_test
from ggrs_tpu_torch.device.fused_core import FusedSyncTestCore, plain_batch
from ggrs_tpu_torch.device.injected_core import InjectedReduceCore
from ggrs_tpu_torch.device.planes import PlaneContext
from ggrs_tpu_torch.device.tiled_core import TiledSyncTestCore

D = 4
KILLED = 48  # entities the probe kills


def assert_tree_equal(got, want, path="carry"):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_tree_equal(got[k], want[k], f"{path}/{k}")
        return
    g, w = np.asarray(got), np.asarray(want)
    assert g.dtype == w.dtype, f"{path}: {g.dtype} != {w.dtype}"
    np.testing.assert_array_equal(g, w, err_msg=path)


def script(frames, players, input_size, seed):
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 64, size=(frames, players, input_size), dtype=np.uint8)
    if input_size == 2:
        raw[..., 1] = rng.integers(0, 16, size=(frames, players))
    return raw


def run_pair(ref_backend, port_backend, players, n, input_size, t_ticks, clean, probe, mesh=None, d=D):
    """Drive both sessions (check distance d) over `clean` clean frames then
    `probe` frames after the kill probe (none when `probe` is 0), T frames
    per batch, comparing full carries after every batch; returns the
    reference carry after the run, which latched the probe's frame on both
    sides."""
    sc = script(clean + probe, players, input_size, seed=players * 10 + t_ticks)
    ref = TpuSyncTestSession(RefArena(players, n, input_size), players, d, backend=ref_backend, mesh=mesh)
    port = DeviceSyncTestSession(Arena(players, n, input_size), players, d, backend=port_backend, device="cpu")
    for start in range(0, clean + probe, t_ticks):
        if start == clean:
            ref.check()
            port.check()
            slot = (start - d) % (d + 2)
            ring = dict(ref.carry["ring"])
            ring["hp"] = ring["hp"].at[slot, :KILLED].set(0)
            ref.carry = {**ref.carry, "ring": ring}
            port.carry["ring"][slot, 4, :KILLED] = 0
        ref.advance_frames(sc[start:start + t_ticks])
        port.advance_frames(sc[start:start + t_ticks])
        assert_tree_equal(carry_to_reference(port.carry), jax.device_get(ref.carry), f"frame {start}")
    if not probe:
        ref.check()
        port.check()
        return jax.device_get(ref.carry)
    with pytest.raises(RefMismatchedChecksum) as ref_err:
        ref.check()
    with pytest.raises(MismatchedChecksum) as port_err:
        port.check()
    assert port_err.value.frame == ref_err.value.frame == clean - d + 1
    return jax.device_get(ref.carry)


def differs(a, b):
    try:
        assert_tree_equal(a, b)
    except AssertionError:
        return True
    return False


@pytest.fixture(scope="module")
def xla_probe_carry():
    """The reference XLA scan's carry after the probe run every route makes
    (Arena(2, 256), T = 10): the routes with cached or injected reductions
    must end elsewhere."""
    return run_pair("xla", "torch", 2, 256, 1, 10, clean=20, probe=20)


@pytest.mark.parametrize("players,input_size", [(3, 2), (4, 1), (17, 1), (32, 2)])
def test_torch_backend_matches_reference_xla(players, input_size):
    run_pair("xla", "torch", players, 384, input_size, 10, clean=20, probe=10)


@pytest.mark.parametrize("players,n,input_size", [(17, 384, 1), (32, 512, 2)])
@pytest.mark.parametrize("port_backend,t_ticks", [("cuda-fused", 10), ("cuda-fused", 1), ("cuda-tiled", 10),
                                                   ("cuda-tiled-injected", 10)])
def test_many_teams_routes_match_reference_xla(port_backend, t_ticks, players, n, input_size):
    """Past 16 teams (the kernels sum teams 16 a pass), every route's plain
    version — K1 with the cache (T = 10) and inline (T = 1), K2's inline
    route, the injection route — equals the reference's XLA scan on a clean
    run across frame d, where all routes give the same bits."""
    run_pair("xla", port_backend, players, n, input_size, t_ticks, clean=20 if t_ticks > 1 else 8, probe=0)


def test_many_teams_fused_twin_matches_reference_kernel():
    """17 teams, T = 10: K1's plain version with the reduction cache equals
    the reference's whole-batch kernel across the kill probe. (The
    reference's interpret-mode kernels take 40-120 s a batch at 17-32
    teams, so this is the one kernel-route probe past 16 teams.)"""
    run_pair("pallas-interpret", "cuda-fused", 17, 384, 1, 10, clean=10, probe=10)


def test_fused_twin_matches_reference_kernel_cached(xla_probe_carry):
    """T = 10: K1's plain twin with the per-frame reduction cache equals the
    reference's whole-batch kernel, which ends apart from the XLA scan."""
    carry = run_pair("pallas-interpret", "cuda-fused", 2, 256, 1, 10, clean=20, probe=20)
    assert differs(carry, xla_probe_carry)


def test_fused_twin_matches_reference_kernel_inline():
    """T = 1: every step reduces inline, in the reference's kernel and the
    twin alike, across frame d and the probe."""
    run_pair("pallas-interpret", "cuda-fused", 3, 384, 2, 1, clean=8, probe=3)


def test_injected_twin_matches_reference_one_device_mesh(xla_probe_carry):
    """The injection route (K5 tables rolled tick by tick from frame d on,
    K2 one tick per launch, the verdict) equals the reference's sharded
    tiled core on a one-device mesh over 40 frames crossing frame d."""
    carry = run_pair("pallas-tiled-interpret", "cuda-tiled-injected", 2, 256, 1, 10, clean=20, probe=20,
                     mesh=make_mesh(1))
    assert differs(carry, xla_probe_carry)


def test_wrappers_take_cpu_carries():
    """K1's, K2's and the injection route's wrappers on a CPU carry run
    their plain twins and count no launch: K2 without a table is the inline
    route, the plain scan's bits; K2's injected tick refuses more than one
    tick."""
    ctx = PlaneContext(Arena(2, 256), 2, D, "cpu")
    inputs = torch.from_numpy(script(12, 2, 1, seed=3).astype(np.int32))
    want = sync_test.initial_carry(ctx)
    plain_batch(want, inputs, ctx)
    fused = FusedSyncTestCore(ctx)
    carry = sync_test.initial_carry(ctx)
    fused.batch(carry, inputs)
    for k in CARRY_KEYS:
        assert torch.equal(carry[k], want[k]), k
    injected = InjectedReduceCore(ctx)
    carry = sync_test.initial_carry(ctx)
    injected.batch(carry, inputs)
    assert torch.equal(carry["state"], want["state"])
    inline = TiledSyncTestCore(ctx)
    carry, scanned = sync_test.initial_carry(ctx), sync_test.initial_carry(ctx)
    inline.batch(carry, inputs)
    sync_test.plain_scan(scanned, inputs, ctx)
    for k in CARRY_KEYS:
        assert torch.equal(carry[k], scanned[k]), k
    assert fused.launches == injected.tiled.launches == injected.reduce.launches == inline.launches == 0
    with pytest.raises(ValueError, match="one tick"):
        TiledSyncTestCore(ctx).tick_injected(carry, inputs[:2], torch.zeros((D + 1, 6), dtype=torch.int32),
                                             torch.zeros((D + 1, 6), dtype=torch.int32))


# (game, check distance, the reference's `_pick_backend` on a TPU with no
# mesh, the port's route for it); an H100 has 132 SMs, arena's K1 keeps 8
# blocks of 128 entities resident on each (1056 blocks)
AUTO_CASES = [
    (RefArena(2, 4096), Arena(2, 4096), 8, "pallas", "cuda-fused"),
    (RefArena(2, 65536), Arena(2, 65536), 8, "pallas", "cuda-fused"),  # 34.6 MB estimate
    # inside the 96 MB estimate, but 1562 blocks: K1 cannot be resident;
    # the injection route keeps the sums K1's cache keeps
    (RefArena(8, 199936), Arena(8, 199936), 1, "pallas", "cuda-tiled-injected"),
    # not 128-aligned: the reference's XLA scan, reducing inline
    (RefArena(8, 200000), Arena(8, 200000), 1, "xla", "cuda-tiled"),
    (RefArena(2, 4000), Arena(2, 4000), 8, "xla", "cuda-tiled"),
    # past the estimate (277 MB): arena is not tileable, so the XLA scan
    (RefArena(16, 1 << 19), Arena(16, 1 << 19), 8, "xla", "cuda-tiled"),
    (RefArena(8, 1 << 18), Arena(8, 1 << 18), 16, "xla", "cuda-tiled"),
]


def test_auto_picks_as_the_reference_does(monkeypatch):
    """auto answers every arena case with the port's route for the
    reference's decision: K1 for "pallas" (the injection route where K1's
    grid cannot be resident), K2's inline route for "xla", whose bits it
    gives (tests/test_torch_arena_tiled_inline.py); the plain version on
    the CPU. The reference's decision is taken from its `_pick_backend` as
    on a TPU and checked against the one written beside each case. A team
    of 2^16 entities is past arena's exact-division envelope: the
    reference's adapter refuses it (so its auto answers "xla"), and so does
    the port's, everywhere."""
    import ggrs_tpu.tpu.sync_test as ref_sync_test

    class Props:
        multi_processor_count = 132

    class Tpu:
        platform = "tpu"

    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device: Props())
    monkeypatch.setattr(ref_sync_test.jax, "devices", lambda *a: [Tpu()])
    cuda = torch.device("cuda")
    for ref_game, game, d, ref_pick, port_pick in AUTO_CASES:
        assert ref_sync_test._pick_backend(ref_game, d, None) == ref_pick, (game.num_entities, d)
        assert sync_test.pick_backend(game, d, cuda) == port_pick, (game.num_entities, d)
    assert ref_sync_test._pick_backend(RefArena(2, 1 << 17), 8, None) == "xla"
    with pytest.raises(ConfigError, match="envelope"):
        sync_test.pick_backend(Arena(2, 1 << 17), 8, cuda)
    monkeypatch.undo()
    assert sync_test.pick_backend(Arena(2, 4096), 8, torch.device("cpu")) == "torch"
    session = DeviceSyncTestSession(Arena(2, 256), 2, D, device="cpu")
    assert session.backend == "torch" and session.core is None
    cores = {b: type(DeviceSyncTestSession(Arena(2, 256), 2, D, backend=b, device="cpu").core)
             for b in ("cuda-fused", "cuda-tiled", "cuda-tiled-injected")}
    assert cores == {"cuda-fused": FusedSyncTestCore, "cuda-tiled": TiledSyncTestCore,
                     "cuda-tiled-injected": InjectedReduceCore}


@pytest.mark.parametrize("input_size", [1, 2])
def test_carry_round_trip(input_size):
    ref = TpuSyncTestSession(RefArena(3, 384, input_size), 3, D, backend="xla")
    ref.advance_frames(script(9, 3, input_size, seed=5))
    x = jax.device_get(ref.carry)
    port = carry_from_reference(x, "cpu")
    assert port["state"].shape == (6, 384) and port["iring"].shape == (D + 2, 3, input_size)
    assert_tree_equal(carry_to_reference(port), x)
