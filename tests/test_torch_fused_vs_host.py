"""The port's fused SyncTest session (DeviceSyncTestSession) against its
host path (the host SyncTestSession driving DeviceRollbackBackend) on one
input stream, on the CPU — the port's counterpart of the reference's
`test_fused_session_matches_host_path`: ExGame(2/4, 128), Arena(2, 256),
Arena(3, 384, input_size=2) and Swarm(2, 256); input delay 0 and 2;
(check distance, max prediction) of (7, 8), (2, 8) and (1, 3); the host
path eager and with lazy_ticks=5. The final states must be equal and
neither may latch a mismatch. One cell per game also holds both paths'
final state against the reference's fused session (backend "xla", which
the reference's own test holds against its host path), so a defect the
port's two paths share does not pass. Then a corrupted ring slot that the
next rollback loads, which both paths must report as MismatchedChecksum at
the same frame. Budget: under 90 s on the CPU."""

import jax
import numpy as np
import pytest

from ggrs_tpu.models.arena import Arena as RefArena
from ggrs_tpu.models.ex_game import ExGame as RefExGame
from ggrs_tpu.models.swarm import Swarm as RefSwarm
from ggrs_tpu.tpu import TpuSyncTestSession
from ggrs_tpu_torch import Arena, DeviceRollbackBackend, DeviceSyncTestSession, ExGame, MismatchedChecksum, SessionBuilder, Swarm

GAMES = {
    "ex2": (lambda: ExGame(2, 128), 16),
    "ex4": (lambda: ExGame(4, 128), 16),
    "arena2": (lambda: Arena(2, 256), 64),
    "arena3-i2": (lambda: Arena(3, 384, input_size=2), 64),
    "swarm2": (lambda: Swarm(2, 256), 128),
}
REF_GAMES = {
    "ex2": lambda: RefExGame(2, 128),
    "ex4": lambda: RefExGame(4, 128),
    "arena2": lambda: RefArena(2, 256),
    "arena3-i2": lambda: RefArena(3, 384, input_size=2),
    "swarm2": lambda: RefSwarm(2, 256),
}
FRAMES = 40


def script(game, mod, frames=FRAMES, seed=17):
    rng = np.random.default_rng(seed)
    return rng.integers(0, mod, size=(frames, game.num_players, game.input_size), dtype=np.uint8)


def host_path(game, cd, mp, delay, lazy):
    sess = (SessionBuilder(input_size=game.input_size).with_num_players(game.num_players)
            .with_max_prediction_window(mp).with_check_distance(cd).with_input_delay(delay)
            .with_device_checksum_verification(True).start_synctest_session())
    backend = DeviceRollbackBackend(game, mp, game.num_players, device_verify=True, lazy_ticks=lazy,
                                    device="cpu")
    return sess, backend


def host_tick(sess, backend, row):
    for h, inp in enumerate(row):
        sess.add_local_input(h, bytes(inp))
    backend.handle_requests(sess.advance_frame())


def assert_states_equal(a, b, path="state"):
    if isinstance(b, dict):
        assert set(a) == set(b), path
        for key in b:
            assert_states_equal(a[key], b[key], f"{path}/{key}")
        return
    got, want = np.asarray(a), np.asarray(b)
    assert got.dtype == want.dtype, f"{path}: {got.dtype} != {want.dtype}"
    np.testing.assert_array_equal(got, want, err_msg=path)


@pytest.mark.parametrize("lazy", [0, 5])
@pytest.mark.parametrize("cd,mp", [(7, 8), (2, 8), (1, 3)])
@pytest.mark.parametrize("delay", [0, 2])
@pytest.mark.parametrize("name", list(GAMES))
def test_fused_session_matches_host_path(name, delay, cd, mp, lazy):
    make, mod = GAMES[name]
    game = make()
    inputs = script(game, mod)
    sess, backend = host_path(game, cd, mp, delay, lazy)
    for row in inputs:
        host_tick(sess, backend, row)
    fused = DeviceSyncTestSession(make(), game.num_players, cd, input_delay=delay, device="cpu")
    fused.advance_frames(inputs[:15])
    fused.advance_frames(inputs[15:])
    backend.check()
    fused.check()
    assert backend.current_frame == FRAMES
    assert_states_equal(backend.state_numpy(), fused.state_numpy())


@pytest.mark.parametrize("name", list(GAMES))
def test_both_paths_match_reference_fused_session(name):
    """Delay 2, check distance 7, max prediction 8 (the reference test's
    cell), the host path lazy: the port's host path, the port's fused
    session and the reference's fused session end on one state."""
    make, mod = GAMES[name]
    game = make()
    cd, mp, delay = 7, 8, 2
    inputs = script(game, mod)
    sess, backend = host_path(game, cd, mp, delay, 5)
    for row in inputs:
        host_tick(sess, backend, row)
    fused = DeviceSyncTestSession(make(), game.num_players, cd, input_delay=delay, device="cpu")
    fused.advance_frames(inputs)
    ref = TpuSyncTestSession(REF_GAMES[name](), num_players=game.num_players, check_distance=cd,
                             input_delay=delay, backend="xla")
    ref.advance_frames(inputs)
    backend.check()
    fused.check()
    ref.check()
    want = jax.device_get(ref.state_numpy())
    assert_states_equal(fused.state_numpy(), want)
    assert_states_equal(backend.state_numpy(), want)


def corrupt(ring, slot, name):
    """A change the next steps cannot clamp away: ex_game's heading, swarm's
    x, arena's hp of 64 entities (killed)."""
    if name.startswith("arena"):
        ring[slot, 4, :64] = 0
    elif name.startswith("swarm"):
        ring[slot, 0, 0] += 7
    else:
        ring[slot, 4, 0] += 7


@pytest.mark.parametrize("name", list(GAMES))
def test_ring_corruption_reported_by_both_paths(name):
    make, mod = GAMES[name]
    game = make()
    cd, mp = 4, 8
    inputs = script(game, mod, frames=24, seed=3)
    sess, backend = host_path(game, cd, mp, 0, 0)
    fused = DeviceSyncTestSession(make(), game.num_players, cd, device="cpu")
    for row in inputs[:20]:
        host_tick(sess, backend, row)
    fused.advance_frames(inputs[:20])
    backend.check()
    fused.check()
    corrupt(backend.core.carry["ring"], (20 - cd) % backend.core.ring_len, name)
    corrupt(fused.carry["ring"], (20 - cd) % fused.ctx.ring_len, name)
    host_tick(sess, backend, inputs[20])
    fused.advance_frames(inputs[20:21])
    frames = []
    for check in (backend.check, fused.check):
        with pytest.raises(MismatchedChecksum) as exc:
            check()
        frames.append(exc.value.frame)
    assert frames[0] == frames[1] == 20 - cd + 1
