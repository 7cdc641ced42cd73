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
from test_torch_swarm_resim import RecordingLib, meta
from ggrs_tpu_torch import Arena, KernelError
from ggrs_tpu_torch.device import sync_test
from ggrs_tpu_torch.device.planes import PlaneContext
from ggrs_tpu_torch.device.tiled_core import TiledSyncTestCore
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


@pytest.mark.parametrize("rc,error", [(0, None), (2, "CUDA error 2"), (launch.NOT_CO_RESIDENT, "resident")])
def test_inline_wrapper_reaches_its_entry_point_and_never_falls_back(monkeypatch, rc, error):
    """K2's wrapper on an arena carry on the `meta` device (no data: only the
    launch path can take it) and no table calls the inline entry point
    alone; a CUDA error, or a grid of which not one block can be resident,
    raises KernelError and counts no launch."""
    lib = RecordingLib(rc)
    monkeypatch.setattr(build, "load", lambda name: lib)
    monkeypatch.setattr(launch, "stream_of", lambda device: 0)
    ctx = PlaneContext(Arena(2, 256), 2, 4, "cpu")
    core = TiledSyncTestCore(ctx)
    inputs = torch.zeros((3, 2, 1), dtype=torch.int32, device="meta")
    if error is None:
        core.run_kernel(meta(sync_test.initial_carry(ctx)), inputs)
    else:
        with pytest.raises(KernelError, match=error):
            core.run_kernel(meta(sync_test.initial_carry(ctx)), inputs)
    assert {name for name, fn in lib.fns.items() if fn.calls} == {"synctest_tiled_inline_arena_launch"}
    assert core.launches == (1 if error is None else 0)
