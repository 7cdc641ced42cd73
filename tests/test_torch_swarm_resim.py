"""Swarm on the port's request path and in its beam, on the CPU, against
the reference, tolerance zero; and the no-fallback rule for swarm on a card.

- `ResimCore(Swarm)` (the plain version of K3's swarm body) against the
  reference `ResimCore` with tick_backend "xla" and "pallas-interpret"
  over seeded session-shaped dispatches (`ggrs_tpu_torch.device.rowgen.random_tick_args`,
  inputs below 128, 15% DISCONNECTED slots), device verification on;
- the request path: the port's `SyncTestSession` driving
  `DeviceRollbackBackend(Swarm)` against the reference's session driving
  `TpuRollbackBackend(Swarm)`, eager and lazy;
- a speculation (the plain version of K4's swarm body) against the
  reference's "xla" and "pallas-interpret" rollouts
  (tests/test_pallas_beam.py:47's pairing);
- a beam backend against its beam-off twin and the reference's beam, with
  adoptions above zero (tests/test_swarm.py:138's pattern);
- on a carry that is not on the CPU, each of K1-K4's wrappers reaches the
  swarm entry point, never ex_game's, and a refused launch raises.
"""

import jax
import numpy as np
import pytest
import torch

from ggrs_tpu import SessionBuilder as RefSessionBuilder
from ggrs_tpu.models.swarm import Swarm as RefSwarm
from ggrs_tpu.tpu import TpuRollbackBackend
from ggrs_tpu.tpu.resim import ResimCore as RefResimCore
from ggrs_tpu_torch import DeviceRollbackBackend, KernelError, ResimCore, SessionBuilder, Swarm
from ggrs_tpu_torch.convert import resim_from_reference, resim_to_reference, speculation_to_reference
from ggrs_tpu_torch.device import sync_test
from ggrs_tpu_torch.device.fused_core import FusedSyncTestCore
from ggrs_tpu_torch.device.planes import PlaneContext
from ggrs_tpu_torch.device.rowgen import random_tick_args
from ggrs_tpu_torch.device.tiled_core import TiledSyncTestCore
from ggrs_tpu_torch.kernels import build, launch
from ggrs_tpu_torch.types import InputStatus

MOD = 128  # six axis bits and BOOST
DISCONNECTED = int(InputStatus.DISCONNECTED)
# (players, entities, max_prediction)
CONFIGS = [(2, 512, 6), (4, 256, 12)]
ROWS_PER_DISPATCH = 4


def assert_tree_equal(got, want, path="core"):
    if isinstance(want, (dict, tuple)):
        keys = list(want) if isinstance(want, dict) else range(len(want))
        assert len(got) == len(want), path
        for k in keys:
            assert_tree_equal(got[k], want[k], f"{path}/{k}")
        return
    g, w = np.asarray(got), np.asarray(want)
    assert g.dtype == w.dtype, f"{path}: {g.dtype} != {w.dtype}"
    np.testing.assert_array_equal(g, w, err_msg=path)


def ref_leaves(core):
    return jax.device_get({"ring": core.ring, "state": core.state, "verify": core.verify})


def rows_for(core, args):
    return np.stack([core.pack_tick_row(*a[:6], start_frame=a[6]) for a in args])


@pytest.mark.parametrize("ref_backend", ["xla", "pallas-interpret"])
@pytest.mark.parametrize("players,n,mp", CONFIGS)
def test_swarm_core_matches_reference(players, n, mp, ref_backend):
    port = ResimCore(Swarm(players, n), mp, players, device_verify=True, device="cpu")
    ref = RefResimCore(RefSwarm(players, n), max_prediction=mp, num_players=players,
                       device_verify=True, tick_backend=ref_backend)
    n_rows = mp + 2 + 3 * ROWS_PER_DISPATCH
    n_rows += -n_rows % ROWS_PER_DISPATCH
    args = random_tick_args(players, mp, n_rows, seed=11 + mp, mod=MOD)
    assert max(a[5] - 1 for a in args if a[0]) >= mp - 2  # the deepest rollbacks ran
    assert any((a[3] == DISCONNECTED).any() for a in args)
    rows = {"port": rows_for(port, args), "ref": rows_for(ref, args)}
    for b in range(0, n_rows, ROWS_PER_DISPATCH):
        his, los = port.tick_multi(rows["port"][b : b + ROWS_PER_DISPATCH])
        r_his, r_los = ref.tick_multi(rows["ref"][b : b + ROWS_PER_DISPATCH])
        np.testing.assert_array_equal(his.numpy().view(np.uint32), np.asarray(r_his), err_msg=f"his {b}")
        np.testing.assert_array_equal(los.numpy().view(np.uint32), np.asarray(r_los), err_msg=f"los {b}")
    assert_tree_equal(resim_to_reference(port), ref_leaves(ref))
    assert port.check_device_verdict() == ref.check_device_verdict()


def test_swarm_resim_carry_round_trip():
    """The reference's swarm core crosses to the port and back unchanged,
    and a run continued on both stacks stays equal."""
    players, n, mp = CONFIGS[1]
    ref = RefResimCore(RefSwarm(players, n), max_prediction=mp, num_players=players,
                       device_verify=True, tick_backend="xla")
    args = random_tick_args(players, mp, mp + 2 + 8, seed=3, mod=MOD)
    ref.tick_multi(rows_for(ref, args[: mp + 6]))
    leaves = ref_leaves(ref)
    port = ResimCore(Swarm(players, n), mp, players, device_verify=True, device="cpu")
    port.carry = resim_from_reference(leaves["ring"], leaves["state"], leaves["verify"])
    assert port.carry["ring"].shape == (mp + 3, 7, n)
    assert_tree_equal(resim_to_reference(port), leaves)
    tail = args[mp + 6 :]
    port.tick_multi(rows_for(port, tail))
    ref.tick_multi(rows_for(ref, tail))
    assert_tree_equal(resim_to_reference(port), ref_leaves(ref))


# -- the request path ---------------------------------------------------------

P, N, MP, CD, FRAMES = 2, 256, 8, 6, 30


def session(builder_cls, device_verify=True):
    return (
        builder_cls(input_size=1)
        .with_num_players(P)
        .with_max_prediction_window(MP)
        .with_check_distance(CD)
        .with_device_checksum_verification(device_verify)
        .start_synctest_session()
    )


def drive(sess, backend, script, ticks):
    saves = []
    for t in range(ticks):
        for h in range(P):
            sess.add_local_input(h, bytes([script(t, h)]))
        reqs = sess.advance_frame()
        backend.handle_requests(reqs)
        # ring cells are reused: bind each save's checksum getter now
        saves += [(r.frame, r.cell.checksum_getter()) for r in reqs if type(r).__name__ == "SaveGameState"]
    return [(f, g()) for f, g in saves]


def random_inputs(seed):
    table = np.random.default_rng(seed).integers(0, MOD, size=(200, P))
    return lambda t, h: int(table[t, h])


@pytest.mark.parametrize("lazy,tick_backend", [(0, "xla"), (8, "xla"), (5, "pallas-interpret")])
def test_swarm_request_path_matches_reference(lazy, tick_backend):
    """The reference's Pallas tick kernel runs only multi-row (lazy) dispatches."""
    port = DeviceRollbackBackend(Swarm(P, N), MP, P, device_verify=True, lazy_ticks=lazy, device="cpu")
    ref = TpuRollbackBackend(RefSwarm(P, N), max_prediction=MP, num_players=P, device_verify=True,
                             lazy_ticks=lazy, tick_backend=tick_backend)
    script = random_inputs(lazy + 1)
    port_saves = drive(session(SessionBuilder), port, script, FRAMES)
    ref_saves = drive(session(RefSessionBuilder), ref, script, FRAMES)
    assert len(port_saves) == len(ref_saves) > FRAMES
    assert port_saves == ref_saves
    assert_tree_equal(port.state_numpy(), jax.device_get(ref.state_numpy()), "state")
    assert port.current_frame == ref.current_frame == FRAMES
    assert_tree_equal(resim_to_reference(port.core), ref_leaves(ref.core))
    port.check()
    ref.check()


# -- the beam ------------------------------------------------------------------


def make_pair(n, players, spec_backend, rng):
    """A port core and a reference core with the same confirmed frames
    ticked in (one save each), so the ring holds real snapshots."""
    port = ResimCore(Swarm(players, n), 6, players, device="cpu")
    ref = RefResimCore(RefSwarm(players, n), max_prediction=6, num_players=players,
                       spec_backend=spec_backend, tick_backend="xla")
    W = port.window
    for f in range(4):
        inputs = np.zeros((W, players, 1), np.uint8)
        inputs[0] = rng.integers(0, MOD, (players, 1))
        statuses = np.zeros((W, players), np.int32)
        slots = np.full((W,), port.scratch_slot, np.int32)
        slots[0] = f % port.ring_len
        for core in (port, ref):
            core.tick(False, 0, inputs, statuses, slots, 1, start_frame=f)
    return port, ref


# spec backend, entities, players, B, L, anchor slot, DISCONNECTED share; the
# first two are tests/test_pallas_beam.py:47's swarm shape
SPEC_CASES = [
    ("xla", 1024, 2, 6, 5, 2, 0.0),
    ("pallas-interpret", 1024, 2, 6, 5, 2, 0.0),
    ("xla", 256, 4, 16, 8, 3, 0.2),
]


@pytest.mark.parametrize("spec_backend,n,players,B,L,slot,off", SPEC_CASES)
def test_swarm_speculate_matches_reference(spec_backend, n, players, B, L, slot, off):
    rng = np.random.default_rng(n + B)
    port, ref = make_pair(n, players, spec_backend, rng)
    beam_inputs = rng.integers(0, MOD, size=(B, L, players, 1), dtype=np.uint8)
    beam_statuses = np.where(rng.random((B, L, players)) < off, DISCONNECTED, 0).astype(np.int32)
    got = speculation_to_reference(port.speculate(slot, beam_inputs, beam_statuses))
    assert got[0]["pos"].shape == (B, L, n, 3)
    want = jax.device_get(ref.speculate(slot, beam_inputs, beam_statuses))
    assert_tree_equal(got, want, "spec")


COUNTERS = ("beam_hits", "beam_partial_hits", "beam_misses", "rollback_frames",
            "rollback_frames_adopted")
SCRIPTS = {
    "constant": lambda t, h: 5 + h,
    "toggle": lambda t, h: (65 if (t // 6) % 2 == 0 else 22) + h,
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_swarm_beam_backend_matches_twin_and_reference(name):
    script, ticks, n = SCRIPTS[name], 30, 64
    port = DeviceRollbackBackend(Swarm(P, n), 6, P, device_verify=True, beam_width=8, device="cpu")
    twin = DeviceRollbackBackend(Swarm(P, n), 6, P, device_verify=True, device="cpu")
    ref = TpuRollbackBackend(RefSwarm(P, n), max_prediction=6, num_players=P, beam_width=8,
                             device_verify=True, spec_backend="xla", tick_backend="xla")

    def sess(builder_cls):
        return (builder_cls(input_size=1).with_num_players(P).with_max_prediction_window(6)
                .with_check_distance(3).with_device_checksum_verification(True).start_synctest_session())

    saves = {
        "port": drive(sess(SessionBuilder), port, script, ticks),
        "twin": drive(sess(SessionBuilder), twin, script, ticks),
        "ref": drive(sess(RefSessionBuilder), ref, script, ticks),
    }
    assert len(saves["port"]) > ticks
    assert saves["port"] == saves["twin"] == saves["ref"]
    for other in (twin.state_numpy(), jax.device_get(ref.state_numpy())):
        assert_tree_equal(port.state_numpy(), other, "state")
    assert {k: getattr(port, k) for k in COUNTERS} == {k: getattr(ref, k) for k in COUNTERS}
    assert port.beam_hits + port.beam_partial_hits > 0 and port.rollback_frames_adopted > 0
    port.check()
    ref.check()


# -- no fallback on a card ------------------------------------------------------


class RecordingLaunch:
    """A kernel-library entry point that returns `rc` and counts its calls."""

    def __init__(self, rc):
        self.argtypes = None
        self.rc = rc
        self.calls = 0

    def __call__(self, *args):
        self.calls += 1
        return self.rc


class RecordingLib:
    """Every K1-K4 entry point, ex_game's and arena's included, so a wrong
    choice would be recorded rather than fail on a missing attribute."""

    def __init__(self, rc):
        self.fns = {}
        for kernel, bodies in launch.ENTRIES.items():
            for entry in bodies.values():
                self.fns[entry.symbol] = RecordingLaunch(rc)
        self.fns["synctest_fused_arena_rows"] = RecordingLaunch(3)

    def __getattr__(self, name):
        return self.fns[name]


def meta(carry):
    return {k: v.to("meta") for k, v in carry.items()}


def launch_all(monkeypatch, rc):
    """Each of K1-K4's wrappers once on a swarm carry on the `meta` device
    (no data, so only the launch path can take it); returns the library
    and the wrappers."""
    lib = RecordingLib(rc)
    monkeypatch.setattr(build, "load", lambda name: lib)
    monkeypatch.setattr(launch, "stream_of", lambda device: 0)
    ctx = PlaneContext(Swarm(2, 256), 2, 4, "cpu")
    fused, tiled = FusedSyncTestCore(ctx), TiledSyncTestCore(ctx)
    inputs = torch.zeros((3, 2, 1), dtype=torch.int32, device="meta")
    core = ResimCore(Swarm(2, 256), 6, 2, device_verify=True, device="cpu")
    core.carry = meta(core.carry)
    rows = torch.from_numpy(np.stack([core.pad_tick_row()] * 2)).to("meta")
    script = torch.zeros((4, 3, 2, 2), dtype=torch.int32, device="meta")
    calls = [
        lambda: fused.batch(meta(sync_test.initial_carry(ctx)), inputs),
        lambda: tiled.run_kernel(meta(sync_test.initial_carry(ctx)), inputs),
        lambda: core.tick_core.tick_multi(core.carry, rows),
        lambda: core.beam_rollout.rollout(core.carry["ring"], core.carry["r_frame"], 0, script),
    ]
    return lib, (fused, tiled, core.tick_core, core.beam_rollout), calls


def test_swarm_wrappers_reach_the_swarm_entry_points(monkeypatch):
    lib, wrappers, calls = launch_all(monkeypatch, 0)
    for call in calls:
        call()
    swarm = {f"{k}_swarm_launch" for k in ("synctest_fused", "synctest_tiled", "resim_tick", "beam_rollout")}
    called = {name for name, fn in lib.fns.items() if fn.calls}
    assert called == swarm
    assert all(lib.fns[name].calls == 1 for name in swarm)
    assert [w.launches for w in wrappers] == [1, 1, 1, 1]
    # the swarm bodies take no substeps: one int fewer than ex_game's entry points
    assert [len(lib.fns[f"{k}_swarm_launch"].argtypes) for k in
            ("synctest_fused", "synctest_tiled", "resim_tick", "beam_rollout")] == [17, 15, 20, 15]


def test_swarm_launch_refusal_raises_not_falls_back(monkeypatch):
    """A CUDA error from any swarm launch is a KernelError, and the plain
    version never runs (it could not, on the `meta` device)."""
    lib, wrappers, calls = launch_all(monkeypatch, 2)
    for call in calls:
        with pytest.raises(KernelError, match="CUDA error 2"):
            call()
    assert all(w.launches == 0 for w in wrappers)
    assert sum(fn.calls for fn in lib.fns.values()) == 4
