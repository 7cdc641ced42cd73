"""K2's inline whole-world arena route on the port (`backend="cuda-tiled"`
on arena; the plain version on the CPU is `plain_parts` with no table and
`plain_verdict`) against the reference, full carry after every batch,
tolerance zero:

- the reference's unsharded "pallas-tiled-interpret" (its single
  whole-world tile reducing inline, pallas_tiled.py:94-130) and its XLA
  scan, at 2 and 3 teams, T = 10 and T = 1, across frame d, clean and
  across the kill probe (hp = 0 in the slot the next rollback loads: the
  inline route ends with the XLA scan's world, not with the cached or
  injected routes', and latches the same frame);
- 17 teams against the XLA scan across the probe (interpret mode takes
  minutes a batch there);
- "auto" past the reference's whole-batch estimate resolves to this route,
  which then gives the XLA scan's bits across the probe;
- inside the estimate, where the port sends arena to the injection route
  because K1's grid cannot be resident, the injection route's twin equals
  the reference's whole-batch kernel (cached sums) across the probe;
- on a carry that is not on the CPU the wrapper reaches the inline entry
  point and nothing else, and a refused launch raises, never falls back.
"""

import pytest
import torch

from test_torch_arena_sync_test import differs, run_pair
from test_torch_swarm_resim import RecordingLaunch, RecordingLib, meta
from ggrs_tpu_torch import Arena, KernelError
from ggrs_tpu_torch.device import sync_test
from ggrs_tpu_torch.device.planes import PlaneContext
from ggrs_tpu_torch.device.tiled_core import TiledSyncTestCore, inline_plan, inline_smem_bytes, on_chip_capacity
from ggrs_tpu_torch.kernels import build, launch


@pytest.fixture(scope="module")
def cached_probe_carry():
    """The reference whole-batch kernel's carry (cached sums) after the
    probe run of Arena(2, 256), T = 10."""
    return run_pair("pallas-interpret", "cuda-fused", 2, 256, 1, 10, clean=20, probe=20)


@pytest.mark.parametrize("players,n,input_size,t_ticks", [(2, 256, 1, 10), (3, 384, 2, 10), (2, 256, 1, 1),
                                                         (3, 384, 2, 1)])
def test_inline_twin_matches_reference_single_tile(players, n, input_size, t_ticks):
    clean, probe = (20, 20) if t_ticks > 1 else (8, 3)
    run_pair("pallas-tiled-interpret", "cuda-tiled", players, n, input_size, t_ticks, clean=clean, probe=probe)


@pytest.mark.parametrize("players,n,input_size,t_ticks", [(2, 256, 1, 10), (3, 384, 2, 10), (2, 256, 1, 1),
                                                         (3, 384, 2, 1), (17, 384, 1, 10)])
def test_inline_twin_matches_reference_xla(players, n, input_size, t_ticks):
    clean, probe = (20, 20) if t_ticks > 1 else (10, 6)
    run_pair("xla", "cuda-tiled", players, n, input_size, t_ticks, clean=clean, probe=probe)


@pytest.mark.parametrize("players,n,d,t_ticks", [(5, 640, 2, 30), (5, 640, 16, 1), (17, 384, 2, 1),
                                                 (17, 384, 16, 30)])
def test_inline_twin_matches_reference_xla_across_distances(players, n, d, t_ticks):
    """P that divides no block size (5, 17), a short and a long window
    (d = 2, 16), T = 1 and 30, clean and across the kill probe."""
    clean, probe = (60, 30) if t_ticks > 1 else (d + 6, 4)
    run_pair("xla", "cuda-tiled", players, n, 1, t_ticks, clean=clean, probe=probe, d=d)


@pytest.mark.parametrize("players,n,d,t_ticks", [(5, 640, 2, 30), (5, 640, 16, 1)])
def test_inline_twin_matches_reference_single_tile_across_distances(players, n, d, t_ticks):
    clean, probe = (30, 30) if t_ticks > 1 else (d + 2, 2)
    run_pair("pallas-tiled-interpret", "cuda-tiled", players, n, 1, t_ticks, clean=clean, probe=probe, d=d)


H100 = (132, 232448)  # an H100's SMs and the shared memory a block may take (bytes)


def covers(plan, n):
    """The plan's blocks hold the world in contiguous runs, none empty."""
    return plan.blocks * plan.per_block >= n > (plan.blocks - 1) * plan.per_block


@pytest.mark.parametrize("players", [2, 3, 5, 16, 17, 64])
@pytest.mark.parametrize("where,regime", [("one", "grid-shared"), ("sms", "grid-shared"), ("sms+1", "grid-shared"),
                                          ("capacity-1", "grid-shared"), ("capacity", "grid-shared"),
                                          ("capacity+1", "grid-global")])
def test_inline_plan_regimes_at_their_boundaries(players, where, regime):
    """The states on chip from one entity (one block) through one entity
    an SM and the first world of two (every other SM then idle) up to the
    on-chip capacity exactly, one entity past it the states in global
    memory; every plan covers the world, fits the card's shared memory, and
    keeps a block an SM."""
    sms, smem = H100
    cap = on_chip_capacity(players, sms, smem)
    base = {"one": 1, "sms": sms, "capacity": cap}[where.rstrip("+-1")]
    n = base + (1 if where.endswith("+1") else -1 if where.endswith("-1") else 0)
    plan = inline_plan(n, players, sms, smem)
    assert plan.regime == regime
    assert covers(plan, n) and plan.smem_bytes <= smem and plan.blocks <= sms
    assert plan.threads % 32 == 0 and min(plan.per_block, 1024) <= plan.threads <= 1024
    assert plan.smem_bytes == inline_smem_bytes(players, 0 if regime == "grid-global" else plan.per_block)
    assert plan.blocks == {"one": 1, "sms": sms, "sms+1": -(-(sms + 1) // 2)}.get(where, plan.blocks)
    if where == "capacity":  # not one entity more fits a block
        assert inline_smem_bytes(players, plan.per_block + 1) > smem


@pytest.mark.parametrize("n,players,regime,blocks,threads", [
    (256, 2, "grid-shared", 128, 32), (9000, 3, "grid-shared", 131, 96), (20000, 5, "grid-shared", 132, 160),
    (4096, 2, "grid-shared", 128, 32), (4352, 17, "grid-shared", 132, 64), (1 << 19, 16, "grid-shared", 132, 1024),
    (2_000_000, 32, "grid-global", 132, 1024), (40000, 2, "grid-shared", 132, 320)])
def test_inline_plan_of_the_card_shapes(n, players, regime, blocks, threads):
    """The worlds the card runs: the headline arena world and 2^19 entities
    with their states on chip over the SMs, two million in global memory;
    a block has a thread an entity in whole warps, up to 1024, so 9000
    entities of 3 teams and 20000 of 5 take blocks that P divides (a
    thread's team is fixed) with P no power of two."""
    plan = inline_plan(n, players, *H100)
    assert (plan.regime, plan.blocks, plan.threads) == (regime, blocks, threads) and covers(plan, n)


def test_on_chip_capacity_follows_the_teams_and_the_card():
    """The fixed shared memory (teams' sums and the warps' team rows) comes
    out of the states' room; past ROW_TEAMS teams the warps share one row;
    the capacity is what the card's shared memory holds."""
    sms, smem = H100
    fixed = 4 * (3 * 2 + 64 + 32 * 3 * 2)
    assert on_chip_capacity(2, sms, smem) == sms * ((smem - fixed) // 24)
    assert on_chip_capacity(64, sms, smem) < on_chip_capacity(16, sms, smem) < on_chip_capacity(2, sms, smem)
    assert on_chip_capacity(65, sms, smem) > on_chip_capacity(64, sms, smem)  # one shared row
    assert on_chip_capacity(2, sms // 2, smem) == on_chip_capacity(2, sms, smem) // 2
    assert on_chip_capacity(2, sms, smem // 2) < on_chip_capacity(2, sms, smem) // 2


def test_inline_route_parts_ways_with_the_cached_route(cached_probe_carry):
    """Across the probe the inline route ends where the XLA scan does, not
    where the whole-batch kernel's cache does."""
    carry = run_pair("pallas-tiled-interpret", "cuda-tiled", 2, 256, 1, 10, clean=20, probe=20)
    assert differs(carry, cached_probe_carry)


def test_auto_past_the_estimate_gives_the_xla_bits(monkeypatch):
    """Past the reference's whole-batch estimate (here shrunk to 1 KB so
    that a small world is past it) auto answers arena with the inline
    route, and that route's twin equals the XLA scan across the probe."""

    class Props:
        multi_processor_count = 132

    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device: Props())
    monkeypatch.setattr(sync_test, "VMEM_BUDGET_BYTES", 1024)
    backend = sync_test.pick_backend(Arena(2, 256), 4, torch.device("cuda"))
    assert backend == "cuda-tiled"
    monkeypatch.undo()
    run_pair("xla", backend, 2, 256, 1, 10, clean=20, probe=20)


def test_injected_twin_matches_reference_whole_batch_kernel(cached_probe_carry):
    """Inside the estimate the reference runs its whole-batch kernel; where
    the port's K1 cannot hold the grid resident it takes the injection
    route, whose rolled table keeps the sums K1's cache keeps: its twin
    equals the reference kernel carry for carry across the probe."""
    carry = run_pair("pallas-interpret", "cuda-tiled-injected", 2, 256, 1, 10, clean=20, probe=20)
    assert not differs(carry, cached_probe_carry)


class H100Limits(RecordingLaunch):
    """The library's `limits` entry point: an H100's 132 SMs and 227 KB of
    shared memory a block."""

    def __call__(self, out):
        out[0], out[1] = 132, 232448
        return super().__call__(out)


@pytest.mark.parametrize("rc,error", [(0, None), (2, "CUDA error 2"), (launch.NOT_CO_RESIDENT, "resident")])
def test_inline_wrapper_reaches_its_entry_point_and_never_falls_back(monkeypatch, rc, error):
    """K2's wrapper on an arena carry on the `meta` device (no data: only the
    launch path can take it) and no table reaches the inline route's entry
    points alone: at its first launch the card's limits and the plan's
    set-up (`prepare`), then the launch; a CUDA error, or a grid that
    cannot be resident, raises KernelError and counts no launch."""
    lib = RecordingLib(rc)
    lib.fns["synctest_tiled_inline_arena_limits"] = H100Limits(0)
    lib.fns["synctest_tiled_inline_arena_prepare"] = RecordingLaunch(rc)
    monkeypatch.setattr(build, "load", lambda name: lib)
    monkeypatch.setattr(launch, "stream_of", lambda device: 0)
    ctx = PlaneContext(Arena(2, 256), 2, 4, "cpu")
    core = TiledSyncTestCore(ctx)
    inputs = torch.zeros((3, 2, 1), dtype=torch.int32, device="meta")
    inline = {"synctest_tiled_inline_arena_limits", "synctest_tiled_inline_arena_prepare"}
    if error is None:
        core.run_kernel(meta(sync_test.initial_carry(ctx)), inputs)
        core.run_kernel(meta(sync_test.initial_carry(ctx)), inputs)
        inline.add("synctest_tiled_inline_arena_launch")
        assert core.plan == inline_plan(256, 2, 132, 232448) and core.plan.regime == "grid-shared"
        assert lib.fns["synctest_tiled_inline_arena_prepare"].calls == 1  # once a core
    else:
        with pytest.raises(KernelError, match=error):
            core.run_kernel(meta(sync_test.initial_carry(ctx)), inputs)
        assert core.plan is None
    assert {name for name, fn in lib.fns.items() if fn.calls} == inline
    assert core.launches == (2 if error is None else 0)
