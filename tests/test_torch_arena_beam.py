"""Arena in the port's speculative beam, on the CPU, tolerance zero.

- `ArenaPlanes.step` with a member axis (planes `[6, B, N]`, each member
  reducing its own world) against B one-world steps;
- the port's speculation (`ResimCore.speculate`, the plain version of K4's
  arena body) against the reference `ResimCore.speculate` under its "xla"
  and "pallas-interpret" speculation backends: trajectories, per-step
  checksums and the anchor's checksum, leaf for leaf;
- `DeviceRollbackBackend(Arena, beam_width=16, device="cpu")` behind the
  port's SyncTest session against the reference's `TpuRollbackBackend`
  with the same beam and against a beam-off twin: the live state after
  every tick, every save's checksum bound at save time, the beam's
  counters, with adoptions above zero.
"""

import jax
import numpy as np
import pytest
import torch

from ggrs_tpu import SessionBuilder as RefSessionBuilder
from ggrs_tpu.models.arena import Arena as RefArena
from ggrs_tpu.tpu import TpuRollbackBackend
from ggrs_tpu.tpu.resim import ResimCore as RefResimCore
from ggrs_tpu_torch import Arena, DeviceRollbackBackend, ResimCore, SessionBuilder
from ggrs_tpu_torch.convert import speculation_to_reference
from ggrs_tpu_torch.device.planes import PlaneContext, pack_planes
from ggrs_tpu_torch.types import InputStatus

DISCONNECTED = int(InputStatus.DISCONNECTED)


def assert_tree_equal(got, want, path="spec"):
    if isinstance(want, (dict, tuple)):
        keys = list(want) if isinstance(want, dict) else range(len(want))
        assert len(got) == len(want), path
        for k in keys:
            assert_tree_equal(got[k], want[k], f"{path}/{k}")
        return
    g, w = np.asarray(got), np.asarray(want)
    assert g.dtype == w.dtype, f"{path}: {g.dtype} != {w.dtype}"
    np.testing.assert_array_equal(g, w, err_msg=path)


def arena_inputs(rng, shape, input_size):
    """Arena input rows: byte 0 below 64, the throttle byte below 16."""
    inputs = rng.integers(0, 64, size=shape + (input_size,), dtype=np.uint8)
    if input_size > 1:
        inputs[..., 1] = rng.integers(0, 16, size=shape)
    return inputs


@pytest.mark.parametrize("players,input_size", [(2, 1), (4, 2)])
def test_member_axis_step_equals_one_world_steps(players, input_size):
    """Members with different worlds (moved, some teams half dead), inputs
    and DISCONNECTED statuses: the stacked step equals each member's own."""
    n, B = 300, 5
    game = Arena(players, n, input_size)
    ctx = PlaneContext(game, players, 4, "cpu")
    rng = np.random.default_rng(players)
    planes = pack_planes(ctx.adapter, game.init_state("cpu")).unsqueeze(1).repeat(1, B, 1)
    planes[0] = (planes[0] + torch.from_numpy(rng.integers(-900, 900, (B, n)).astype(np.int32))) & ((1 << 18) - 1)
    planes[2] = torch.from_numpy(rng.integers(-300, 300, (B, n)).astype(np.int32))
    planes[4, 1, : n // 2] = 0
    planes[4, 3, ::players] = 0  # team 0 of member 3 extinct
    inputs = torch.from_numpy(arena_inputs(rng, (B, players), input_size).astype(np.int32))
    statuses = torch.from_numpy(np.where(rng.random((B, players)) < 0.3, DISCONNECTED, 0).astype(np.int32))
    stacked = ctx.adapter.step(planes, inputs, ctx.owner, statuses)
    for b in range(B):
        one = ctx.adapter.step(planes[:, b].contiguous(), inputs[b], ctx.owner, statuses[b])
        assert torch.equal(stacked[:, b], one), b


MP = 6


def make_pair(n, players, input_size, spec_backend, rng):
    """A port core and a reference core with the same confirmed frames
    ticked in (one save each), so the ring holds real snapshots."""
    port = ResimCore(Arena(players, n, input_size), MP, players, device="cpu")
    ref = RefResimCore(RefArena(players, n, input_size=input_size), max_prediction=MP, num_players=players,
                       spec_backend=spec_backend, tick_backend="xla")
    W = port.window
    for f in range(4):
        inputs = np.zeros((W, players, input_size), np.uint8)
        inputs[0] = arena_inputs(rng, (players,), input_size)
        statuses = np.zeros((W, players), np.int32)
        slots = np.full((W,), port.scratch_slot, np.int32)
        slots[0] = f % port.ring_len
        for core in (port, ref):
            core.tick(False, 0, inputs, statuses, slots, 1, start_frame=f)
    return port, ref


# entities, players, input_size, B, L, anchor slot, DISCONNECTED share;
# the first is tests/test_pallas_beam.py:47's arena shape (the reference's
# pallas-interpret rollout runs only that one: it unrolls B x L steps)
SPEC_CASES = [
    ("xla", 1024, 2, 1, 6, 5, 2, 0.0),
    ("pallas-interpret", 1024, 2, 1, 6, 5, 2, 0.0),
    ("xla", 256, 4, 2, 16, 8, 3, 0.2),
    ("xla", 200, 3, 1, 1, 1, 1, 0.3),
    ("xla", 384, 17, 1, 4, 3, 2, 0.2),  # past 16 teams
    ("xla", 512, 32, 2, 3, 3, 1, 0.2),
]


@pytest.mark.parametrize("spec_backend,n,players,input_size,B,L,slot,off", SPEC_CASES)
def test_arena_speculate_matches_reference(spec_backend, n, players, input_size, B, L, slot, off):
    rng = np.random.default_rng(n + B)
    port, ref = make_pair(n, players, input_size, spec_backend, rng)
    beam_inputs = arena_inputs(rng, (B, L, players), input_size)
    beam_statuses = np.where(rng.random((B, L, players)) < off, DISCONNECTED, 0).astype(np.int32)
    got = speculation_to_reference(port.speculate(slot, beam_inputs, beam_statuses))
    want = jax.device_get(ref.speculate(slot, beam_inputs, beam_statuses))
    assert_tree_equal(got, want)


# -- the beam behind the request path ------------------------------------------

P, N, CD = 2, 64, 4
COUNTERS = ("beam_hits", "beam_partial_hits", "beam_misses", "rollback_frames",
            "rollback_frames_adopted")
SCRIPTS = {
    "toggle": lambda t, h: (1 if (t // 6) % 2 == 0 else 9) + h,
    "varying": lambda t, h: (t * (h + 3) + h) % 64,
}


def session(builder_cls):
    return (
        builder_cls(input_size=1)
        .with_num_players(P)
        .with_max_prediction_window(MP)
        .with_check_distance(CD)
        .with_device_checksum_verification(True)
        .start_synctest_session()
    )


def drive(sess, backend, script, ticks, states):
    saves = []
    for t in range(ticks):
        for h in range(P):
            sess.add_local_input(h, bytes([script(t, h)]))
        reqs = sess.advance_frame()
        backend.handle_requests(reqs)
        saves += [(r.frame, r.cell.checksum_getter()) for r in reqs if type(r).__name__ == "SaveGameState"]
        states.append({k: np.asarray(v) for k, v in jax.device_get(backend.state_numpy()).items()})
    return [(f, g()) for f, g in saves]


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_arena_beam_backend_matches_reference_and_twin(name):
    script, ticks = SCRIPTS[name], 30
    port = DeviceRollbackBackend(Arena(P, N), MP, P, device_verify=True, beam_width=16, device="cpu")
    twin = DeviceRollbackBackend(Arena(P, N), MP, P, device_verify=True, device="cpu")
    ref = TpuRollbackBackend(RefArena(P, N), max_prediction=MP, num_players=P, beam_width=16,
                             device_verify=True, spec_backend="xla", tick_backend="xla")
    states = {k: [] for k in ("port", "twin", "ref")}
    saves = {
        "port": drive(session(SessionBuilder), port, script, ticks, states["port"]),
        "twin": drive(session(SessionBuilder), twin, script, ticks, states["twin"]),
        "ref": drive(session(RefSessionBuilder), ref, script, ticks, states["ref"]),
    }
    assert len(saves["port"]) > ticks
    assert saves["port"] == saves["twin"] == saves["ref"]
    for other in ("twin", "ref"):
        for t, (x, y) in enumerate(zip(states["port"], states[other])):
            for k in y:
                np.testing.assert_array_equal(x[k], y[k], err_msg=f"{other}: state[{k}] at tick {t}")
    assert {k: getattr(port, k) for k in COUNTERS} == {k: getattr(ref, k) for k in COUNTERS}
    assert port.beam_hits + port.beam_partial_hits > 0 and port.rollback_frames_adopted > 0
    port.check()
    ref.check()


def test_many_teams_beam_backend_matches_twin():
    """17 teams: the beam (each member reducing its own world, teams summed
    16 a pass on a card) adopts and stays equal to its beam-off twin, save
    by save and state by state."""
    players, n, ticks = 17, 384, 24

    runs = []
    for width in (8, 0):
        sess = (SessionBuilder(input_size=1).with_num_players(players).with_max_prediction_window(MP)
                .with_check_distance(CD).with_device_checksum_verification(True).start_synctest_session())
        backend = DeviceRollbackBackend(Arena(players, n), MP, players, device_verify=True, beam_width=width,
                                        device="cpu")
        saves = []
        for t in range(ticks):
            for h in range(players):
                sess.add_local_input(h, bytes([SCRIPTS["toggle"](t, h % 4)]))
            reqs = sess.advance_frame()
            backend.handle_requests(reqs)
            saves += [(r.frame, r.cell.checksum_getter()) for r in reqs if type(r).__name__ == "SaveGameState"]
        backend.check()
        runs.append(([(f, g()) for f, g in saves], backend.state_numpy(), backend))
    assert runs[0][0] == runs[1][0]
    for k, v in runs[1][1].items():
        np.testing.assert_array_equal(runs[0][1][k], v, err_msg=k)
    beam = runs[0][2]
    assert beam.beam_hits + beam.beam_partial_hits > 0 and beam.rollback_frames_adopted > 0
