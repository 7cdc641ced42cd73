"""Arena on the port's request path, on the CPU, against the reference,
tolerance zero.

The port's `ResimCore(Arena(P, N), ..., device="cpu")` (the plain version
of K3's arena body: a whole-world reduction before every advance) against
the reference `ResimCore(Arena, tick_backend="xla")` and
`"pallas-interpret"` (its single-tile arena tick kernel) over seeded,
session-shaped multi-row dispatches (`chip_smoke.random_tick_args` with
arena's input range, the throttle byte and DISCONNECTED slots, after a
row that saves the live world into every slot, so no load finds a
never-saved, all-dead world), device verification on: every dispatch's
his/los, then the ring, state and history leaf for leaf. Then the request
path itself — the port's `SyncTestSession` driving
`DeviceRollbackBackend(Arena)` against the reference's session driving
`TpuRollbackBackend(Arena)`, eager and lazy — and an hp-kill divergence
probe in the slot the next rollback loads, which both stacks must latch at
the same frame.
"""

import jax
import numpy as np
import pytest
import torch

from chip_smoke import prime_row, random_tick_args
from ggrs_tpu import SessionBuilder as RefSessionBuilder
from ggrs_tpu.errors import MismatchedChecksum as RefMismatchedChecksum
from ggrs_tpu.models.arena import Arena as RefArena
from ggrs_tpu.tpu import TpuRollbackBackend
from ggrs_tpu.tpu.resim import ResimCore as RefResimCore
from ggrs_tpu_torch import (
    Arena, DeviceRollbackBackend, KernelError, MismatchedChecksum, ResimCore, SessionBuilder,
)
from ggrs_tpu_torch.convert import resim_from_reference, resim_to_reference
from ggrs_tpu_torch.kernels import build, launch

# (players, entities, max_prediction, input_size); the second carries the
# throttle byte, and every stream has 15% DISCONNECTED slots
CONFIGS = [(2, 512, 6, 1), (4, 256, 12, 2)]
ROWS_PER_DISPATCH = 4
ARENA_MOD = 64  # arena's input bits 0-5


def assert_tree_equal(got, want, path="core"):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_tree_equal(got[k], want[k], f"{path}/{k}")
        return
    g, w = np.asarray(got), np.asarray(want)
    assert g.dtype == w.dtype, f"{path}: {g.dtype} != {w.dtype}"
    np.testing.assert_array_equal(g, w, err_msg=path)


def ref_leaves(core):
    return jax.device_get({"ring": core.ring, "state": core.state, "verify": core.verify})


def rows_for(core, args, prime=False):
    rows = [core.pack_tick_row(*a[:6], start_frame=a[6]) for a in args]
    return np.stack(([prime_row(core)] if prime else []) + rows)


@pytest.mark.parametrize("ref_backend", ["xla", "pallas-interpret"])
@pytest.mark.parametrize("players,n,mp,input_size", CONFIGS)
def test_arena_core_matches_reference(players, n, mp, input_size, ref_backend):
    port = ResimCore(Arena(players, n, input_size), mp, players, device_verify=True, device="cpu")
    ref = RefResimCore(RefArena(players, n, input_size=input_size), max_prediction=mp,
                       num_players=players, device_verify=True, tick_backend=ref_backend)
    n_rows = mp + 2 + 3 * ROWS_PER_DISPATCH
    n_rows += -n_rows % ROWS_PER_DISPATCH - 1  # with the priming row, one dispatch shape
    args = random_tick_args(players, mp, n_rows, seed=7 + mp, mod=ARENA_MOD, input_size=input_size)
    assert max(a[5] - 1 for a in args if a[0]) >= mp - 2  # the deepest rollbacks ran
    assert any((a[3] == 2).any() for a in args)  # DISCONNECTED slots
    rows = {"port": rows_for(port, args, prime=True), "ref": rows_for(ref, args, prime=True)}
    for b in range(0, n_rows + 1, ROWS_PER_DISPATCH):
        his, los = port.tick_multi(rows["port"][b : b + ROWS_PER_DISPATCH])
        r_his, r_los = ref.tick_multi(rows["ref"][b : b + ROWS_PER_DISPATCH])
        np.testing.assert_array_equal(his.numpy().view(np.uint32), np.asarray(r_his), err_msg=f"his {b}")
        np.testing.assert_array_equal(los.numpy().view(np.uint32), np.asarray(r_los), err_msg=f"los {b}")
    assert_tree_equal(resim_to_reference(port), ref_leaves(ref))
    assert (port.carry["state"][4] > 0).any()  # a living world all along
    assert port.check_device_verdict() == ref.check_device_verdict()


@pytest.mark.parametrize("players,n,input_size", [(17, 384, 1), (32, 512, 2)])
def test_many_teams_core_matches_reference_xla(players, n, input_size):
    """Past 16 teams (the K3 body sums teams 16 a pass): the plain version
    of K3's arena body against the reference's XLA tick, DISCONNECTED
    slots and the throttle byte included."""
    mp = 6
    port = ResimCore(Arena(players, n, input_size), mp, players, device_verify=True, device="cpu")
    ref = RefResimCore(RefArena(players, n, input_size=input_size), max_prediction=mp,
                       num_players=players, device_verify=True, tick_backend="xla")
    args = random_tick_args(players, mp, 4 * ROWS_PER_DISPATCH - 1, seed=players, mod=ARENA_MOD,
                            input_size=input_size)
    rows = {"port": rows_for(port, args, prime=True), "ref": rows_for(ref, args, prime=True)}
    for b in range(0, len(rows["port"]), ROWS_PER_DISPATCH):
        his, los = port.tick_multi(rows["port"][b : b + ROWS_PER_DISPATCH])
        r_his, r_los = ref.tick_multi(rows["ref"][b : b + ROWS_PER_DISPATCH])
        np.testing.assert_array_equal(his.numpy().view(np.uint32), np.asarray(r_his), err_msg=f"his {b}")
        np.testing.assert_array_equal(los.numpy().view(np.uint32), np.asarray(r_los), err_msg=f"los {b}")
    assert_tree_equal(resim_to_reference(port), ref_leaves(ref))
    assert (port.carry["state"][4] > 0).any()


def test_arena_carry_round_trip():
    """The reference's arena core (hp, energy leaves) crosses to the port
    and back unchanged, and a run continued on both stacks stays equal."""
    players, n, mp, input_size = CONFIGS[1]
    ref = RefResimCore(RefArena(players, n, input_size=input_size), max_prediction=mp,
                       num_players=players, device_verify=True, tick_backend="xla")
    args = random_tick_args(players, mp, mp + 2 + 8, seed=3, mod=ARENA_MOD, input_size=input_size)
    ref.tick_multi(rows_for(ref, args[: mp + 6], prime=True))
    leaves = ref_leaves(ref)
    port = ResimCore(Arena(players, n, input_size), mp, players, device_verify=True, device="cpu")
    port.carry = resim_from_reference(leaves["ring"], leaves["state"], leaves["verify"])
    assert_tree_equal(resim_to_reference(port), leaves)
    tail = args[mp + 6 :]
    port.tick_multi(rows_for(port, tail))
    ref.tick_multi(rows_for(ref, tail))
    assert_tree_equal(resim_to_reference(port), ref_leaves(ref))


# -- the request path ---------------------------------------------------------

P, N, MP, CD, FRAMES = 2, 256, 8, 6, 30


def session(builder_cls, input_size=1, device_verify=True):
    return (
        builder_cls(input_size=input_size)
        .with_num_players(P)
        .with_max_prediction_window(MP)
        .with_check_distance(CD)
        .with_device_checksum_verification(device_verify)
        .start_synctest_session()
    )


def port_stack(lazy, input_size=1):
    backend = DeviceRollbackBackend(Arena(P, N, input_size), MP, P, device_verify=True,
                                    lazy_ticks=lazy, device="cpu")
    return session(SessionBuilder, input_size), backend


def ref_stack(lazy, tick_backend, input_size=1):
    backend = TpuRollbackBackend(RefArena(P, N, input_size=input_size), max_prediction=MP, num_players=P,
                                 device_verify=True, lazy_ticks=lazy, tick_backend=tick_backend)
    return session(RefSessionBuilder, input_size), backend


def tick(sess, backend, rng, saves, input_size=1):
    for h in range(P):
        row = [int(rng.integers(0, ARENA_MOD))] + [int(rng.integers(0, 16)) for _ in range(input_size - 1)]
        sess.add_local_input(h, bytes(row))
    reqs = sess.advance_frame()
    backend.handle_requests(reqs)
    # ring cells are reused: bind each save's checksum getter now
    saves += [(r.frame, r.cell.checksum_getter()) for r in reqs if type(r).__name__ == "SaveGameState"]


def drive(sess, backend, input_size=1, frames=FRAMES, seed=3):
    rng = np.random.default_rng(seed)
    saves = []
    for _ in range(frames):
        tick(sess, backend, rng, saves, input_size)
    return [(f, g()) for f, g in saves]


@pytest.mark.parametrize("players,lazy", [(17, 0), (32, 4)])
def test_many_teams_request_path_matches_reference(players, lazy):
    """The request path with 17 and 32 teams, eager and lazy, against the
    reference's XLA backend: every save's checksum, the state and the core."""
    n = 384 if players == 17 else 512

    def stack(builder_cls, backend):
        sess = (builder_cls(input_size=1).with_num_players(players).with_max_prediction_window(MP)
                .with_check_distance(CD).with_device_checksum_verification(True).start_synctest_session())
        return sess, backend

    ps, pb = stack(SessionBuilder, DeviceRollbackBackend(Arena(players, n), MP, players, device_verify=True,
                                                         lazy_ticks=lazy, device="cpu"))
    rs, rb = stack(RefSessionBuilder, TpuRollbackBackend(RefArena(players, n), max_prediction=MP,
                                                         num_players=players, device_verify=True,
                                                         lazy_ticks=lazy, tick_backend="xla"))
    saves = []
    for sess, backend in ((ps, pb), (rs, rb)):
        rng = np.random.default_rng(players)
        got = []
        for _ in range(16):
            for h in range(players):
                sess.add_local_input(h, bytes([int(rng.integers(0, ARENA_MOD))]))
            reqs = sess.advance_frame()
            backend.handle_requests(reqs)
            got += [(r.frame, r.cell.checksum_getter()) for r in reqs if type(r).__name__ == "SaveGameState"]
        saves.append([(f, g()) for f, g in got])
    assert saves[0] == saves[1] and len(saves[0]) > 16
    assert_tree_equal(resim_to_reference(pb.core), ref_leaves(rb.core))
    pb.check()
    rb.check()


# the reference's Pallas tick kernel runs only multi-row (lazy) dispatches
REQUEST_CASES = [(0, "xla", 1), (5, "xla", 1), (5, "pallas-interpret", 1), (4, "xla", 2)]


@pytest.mark.parametrize("lazy,tick_backend,input_size", REQUEST_CASES)
def test_arena_request_path_matches_reference(lazy, tick_backend, input_size):
    ps, pb = port_stack(lazy, input_size)
    rs, rb = ref_stack(lazy, tick_backend, input_size)
    port_saves, ref_saves = drive(ps, pb, input_size), drive(rs, rb, input_size)
    assert len(port_saves) == len(ref_saves) > FRAMES
    assert port_saves == ref_saves
    assert_tree_equal(pb.state_numpy(), jax.device_get(rb.state_numpy()), "state")
    assert pb.current_frame == rb.current_frame == FRAMES
    got = resim_to_reference(pb.core)
    assert_tree_equal(got, ref_leaves(rb.core))
    pb.check()
    rb.check()


KILLED = 64  # entities the probe kills


def kill_port(backend, slot):
    backend.core.carry["ring"][slot, 4, :KILLED] = 0  # plane 4 is hp


def kill_ref(backend, slot):
    ring = dict(backend.core.ring)
    ring["hp"] = ring["hp"].at[slot, :KILLED].set(0)
    backend.core.ring = ring


def run_probe(sess, backend, kill, mismatch_cls):
    """Drive, kill entities in the ring slot the next rollback loads, then
    tick until backend.check() reports the mismatch; returns its frame."""
    rng = np.random.default_rng(9)
    saves = []
    for _ in range(20):
        tick(sess, backend, rng, saves)
    backend.flush()
    kill(backend, (backend.current_frame - CD) % backend.core.ring_len)
    for _ in range(4):
        try:
            tick(sess, backend, rng, saves)
            backend.check()
        except mismatch_cls as exc:
            return exc.frame
    raise AssertionError("the killed entities were never reported")


@pytest.mark.parametrize("lazy", [0, 5])
def test_arena_kill_probe_latches_the_same_frame(lazy):
    port_frame = run_probe(*port_stack(lazy), kill_port, MismatchedChecksum)
    ref_frame = run_probe(*ref_stack(lazy, "xla"), kill_ref, RefMismatchedChecksum)
    assert port_frame == ref_frame > 0


# -- no fallback on a card ----------------------------------------------------


class RefusingLaunch:
    """A kernel-library entry point that returns `rc` and records its call."""

    def __init__(self, rc):
        self.argtypes = None
        self.rc = rc
        self.calls = 0

    def __call__(self, *args):
        self.calls += 1
        return self.rc


class H100Limits(RefusingLaunch):
    """A `limits` entry point: an H100's 132 SMs and 227 KB of shared memory
    a block."""

    def __call__(self, out):
        out[0], out[1] = 132, 232448
        return super().__call__(out)


class RefusingLib:
    """K3's and K4's arena entry points: the card's limits, each plan's
    one-time set-up, which reports a grid that cannot be resident, and the
    launch, which reports a CUDA error."""

    def __init__(self, rc):
        resident = rc == launch.NOT_CO_RESIDENT
        for kernel in ("resim_tick", "beam_rollout"):
            setattr(self, f"{kernel}_arena_limits", H100Limits(0))
            setattr(self, f"{kernel}_arena_prepare", RefusingLaunch(rc if resident else 0))
            setattr(self, f"{kernel}_arena_launch", RefusingLaunch(0 if resident else rc))


@pytest.mark.parametrize("rc,error", [(launch.NOT_CO_RESIDENT, "resident"), (2, "CUDA error 2")])
def test_arena_kernel_refusal_raises_not_falls_back(monkeypatch, rc, error):
    """On a carry that is not on the CPU the arena wrappers launch their
    kernel or raise: a plan whose grid cannot be resident (reported when the
    wrapper sets its layout up, before any launch), or a launch's CUDA
    error, is a KernelError, and the plain version never runs. (The carry
    sits on the `meta` device, which has no data, so only the launch path
    can take it.)"""
    lib = RefusingLib(rc)
    monkeypatch.setattr(build, "load", lambda name: lib)
    monkeypatch.setattr(launch, "stream_of", lambda device: 0)
    core = ResimCore(Arena(2, 256), 6, 2, device_verify=True, device="cpu")
    core.carry = {k: v.to("meta") for k, v in core.carry.items()}
    rows = torch.from_numpy(np.stack([core.pad_tick_row()] * 2)).to("meta")
    with pytest.raises(KernelError, match=error):
        core.tick_core.tick_multi(core.carry, rows)
    script = torch.zeros((4, 3, 2, 2), dtype=torch.int32, device="meta")
    with pytest.raises(KernelError, match=error):
        core.beam_rollout.rollout(core.carry["ring"], core.carry["r_frame"], 0, script)
    assert lib.resim_tick_arena_prepare.calls == lib.beam_rollout_arena_prepare.calls == 1
    launched = 0 if rc == launch.NOT_CO_RESIDENT else 1
    assert lib.resim_tick_arena_launch.calls == lib.beam_rollout_arena_launch.calls == launched
    assert core.tick_core.launches == core.beam_rollout.launches == 0


def test_arena_kernels_refuse_more_teams_than_they_reduce(monkeypatch):
    """The arena kernels reduce any number of teams (16 a pass through
    their shared scratch), so no player count the reference allows is
    refused: at P = 17 the K3 and K4 wrappers reach their arena launch."""
    lib = RefusingLib(0)
    monkeypatch.setattr(build, "load", lambda name: lib)
    monkeypatch.setattr(launch, "stream_of", lambda device: 0)
    core = ResimCore(Arena(17, 17 * 16), 4, 17, device="cpu")
    core.carry = {k: v.to("meta") for k, v in core.carry.items()}
    rows = torch.from_numpy(core.pad_tick_row()[None]).to("meta")
    core.tick_core.tick_multi(core.carry, rows)
    script = torch.zeros((2, 3, 17, 2), dtype=torch.int32, device="meta")
    core.beam_rollout.rollout(core.carry["ring"], core.carry["r_frame"], 0, script)
    assert lib.resim_tick_arena_launch.calls == lib.beam_rollout_arena_launch.calls == 1
    assert core.tick_core.launches == core.beam_rollout.launches == 1


def test_arena_plans_lay_worlds_out_by_their_shapes():
    """K3-arena's and K4-arena's layouts come from the shapes and the card's
    limits alone (an H100's 132 SMs and 227 KB a block): K3 keeps a block's
    run of states on chip while the world fits, in global memory past
    that; K4 gives each member up to 8 blocks, keeps their states on chip
    while a block's run fits, and holds as many members at once as one
    block an SM allows."""
    from ggrs_tpu_torch.device.beam_core import beam_plan
    from ggrs_tpu_torch.device.tick_core import arena_tick_plan, arena_tick_smem_bytes

    small = arena_tick_plan(4096, 2, 11, 1, 132, 232448)
    assert (small.regime, small.blocks, small.threads, small.per_block) == ("grid-shared", 128, 32, 32)
    assert arena_tick_plan(65536, 2, 11, 1, 132, 232448).regime == "grid-shared"
    big = arena_tick_plan(2_000_000, 32, 11, 1, 132, 232448)
    assert (big.regime, big.blocks, big.threads) == ("grid-global", 132, 1024)
    assert big.smem_bytes == arena_tick_smem_bytes(32, 11, 1, 0)  # no states on chip
    assert beam_plan(4096, 2, 16, 11, 132, 232448)[:5] == (8, 16, 512, 512, True)
    assert beam_plan(65536, 2, 16, 11, 132, 232448)[:5] == (8, 16, 1024, 8192, True)
    assert beam_plan(131072, 4, 16, 11, 132, 232448)[:5] == (8, 16, 1024, 16384, False)
    assert beam_plan(4096, 2, 140, 11, 132, 232448)[:5] == (1, 132, 1024, 4096, True)
    assert beam_plan(100, 3, 16, 11, 132, 232448)[:2] == (4, 16)  # a block has a warp of entities at least
