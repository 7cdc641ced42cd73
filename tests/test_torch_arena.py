"""The port's arena (ggrs_tpu_torch/models/arena.py) and its packed-plane
form (ggrs_tpu_torch/device/planes.py ArenaPlanes) against the reference's
jax Arena, its numpy oracle and its plane adapter, with tolerance zero."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ggrs_tpu.models import arena as ref
from ggrs_tpu.tpu.pallas_core import ArenaPlanes as RefArenaPlanes
from ggrs_tpu.tpu.pallas_core import derive_checksum_weights as ref_derive_weights
from ggrs_tpu_torch import Arena, ConfigError, ExGame
from ggrs_tpu_torch.device import planes
from ggrs_tpu_torch.kernels import launch
from ggrs_tpu_torch.models import arena as port

DISCONNECTED = 2


def to_np(state):
    return {k: v.numpy() for k, v in state.items()}


def assert_state_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)


def checksum_u32(game, state):
    hi, lo = game.checksum(state)
    return int(hi.numpy().view(np.uint32)), int(lo.numpy().view(np.uint32))


def drive(players, input_size, n, inputs, statuses, start=None):
    """The port's step and checksum against jax Arena.step, the reference's
    step_oracle/checksum_oracle and the port's own oracle, every frame."""
    game, jgame = Arena(players, n, input_size), ref.Arena(players, n, input_size)
    state = game.init_state("cpu") if start is None else {k: torch.from_numpy(v.copy()) for k, v in start.items()}
    ostate = ref.init_oracle(players, n) if start is None else {k: v.copy() for k, v in start.items()}
    pstate = {k: v.copy() for k, v in ostate.items()}
    jstate = jax.device_put(ostate)
    for f in range(len(inputs)):
        state = game.step(state, torch.from_numpy(inputs[f]), torch.from_numpy(statuses[f]))
        jstate = jgame.step(jstate, jnp.asarray(inputs[f]), jnp.asarray(statuses[f]))
        ostate = ref.step_oracle(ostate, inputs[f], statuses[f], players, input_size)
        pstate = port.step_oracle(pstate, inputs[f], statuses[f], players, input_size)
        got = to_np(state)
        assert_state_equal(got, jax.device_get(jstate))
        assert_state_equal(got, ostate)
        assert_state_equal(pstate, ostate)
        assert checksum_u32(game, state) == ref.checksum_oracle(ostate) == port.checksum_oracle(pstate)
    return ostate


def random_script(rng, frames, players, input_size, p_disconnect=0.15):
    inputs = rng.integers(0, 64, size=(frames, players, input_size), dtype=np.uint8)
    if input_size == 2:
        inputs[..., 1] = rng.integers(0, 16, size=(frames, players))
    statuses = np.where(rng.random((frames, players)) < p_disconnect, DISCONNECTED, 0).astype(np.int32)
    return inputs, statuses


@pytest.mark.parametrize("n", [256, 1000, 4096])
def test_init_state_matches_reference(n):
    assert_state_equal(to_np(Arena(2, n).init_state("cpu")), ref._init_arrays(n))
    assert_state_equal(port.init_oracle(2, n), ref.init_oracle(2, n))


@pytest.mark.parametrize("players", [2, 3, 4])
@pytest.mark.parametrize("input_size", [1, 2])
def test_step_and_checksum_match_reference(players, input_size):
    """30 seeded frames with DISCONNECTED players: the port's step equals
    jax Arena.step and step_oracle, its checksum checksum_oracle."""
    rng = np.random.default_rng(players * 10 + input_size)
    inputs, statuses = random_script(rng, 30, players, input_size)
    state = drive(players, input_size, 384, inputs, statuses)
    assert state["hp"].min() < ref.HP_INIT  # combat happened
    assert (statuses == DISCONNECTED).any()


@pytest.mark.parametrize("input_size", [1, 2])
def test_speed_clamp_with_negative_numerators(input_size):
    """Overdrive held left/up (throttle 15 on two bytes) drives |v| past
    MAX_SPEED with negative components, so the clamp floors negative
    numerators; then right/down, positive ones."""
    players, frames = 2, 48
    left_up = ref.INPUT_LEFT | ref.INPUT_UP | ref.INPUT_OVERDRIVE
    right_down = ref.INPUT_RIGHT | ref.INPUT_DOWN | ref.INPUT_OVERDRIVE | ref.INPUT_RALLY
    inputs = np.zeros((frames, players, input_size), np.uint8)
    inputs[: frames // 2, :, 0] = left_up
    inputs[frames // 2:, :, 0] = right_down
    if input_size == 2:
        inputs[..., 1] = 15
    statuses = np.zeros((frames, players), np.int32)
    game = Arena(players, 256, input_size)
    state, clamped = game.init_state("cpu"), []
    for f in range(frames // 2):
        state = game.step(state, torch.from_numpy(inputs[f]), torch.from_numpy(statuses[f]))
        clamped.append(int(state["vel"].min()))
    assert min(clamped) < -ref.MAX_SPEED // 2 and min(clamped) >= -ref.MAX_SPEED
    drive(players, input_size, 256, inputs, statuses)


def test_extinct_team_projects_no_force():
    """Team 1 dead from the start: its entities stand still, its centroid
    (of no one) deals no damage, and everything equals the reference."""
    players, n = 3, 384
    start = ref.init_oracle(players, n)
    start["hp"][1::players] = 0
    rng = np.random.default_rng(5)
    inputs, statuses = random_script(rng, 20, players, 1)
    state = drive(players, 1, n, inputs, statuses, start=start)
    assert (state["hp"][1::players] == 0).all()
    assert (state["vel"][1::players] == 0).all()
    assert (state["hp"][0::players] == ref.HP_INIT).all()  # team 0's enemy is extinct


def test_disconnect_input_matches_reference():
    for size in (1, 2):
        assert Arena(2, 128, size).disconnect_input == ref.Arena(2, 128, size).disconnect_input
    assert Arena.checksum_keys == ref.Arena.checksum_keys
    assert Arena.statuses_contract == ref.Arena.statuses_contract


@pytest.mark.parametrize("players,input_size", [(2, 1), (3, 2)])
def test_plane_form_matches_state_form(players, input_size):
    """ArenaPlanes.step inline, and with the finalized reduction handed in
    as red=, equals Arena.step; the plane checksum with the derived weights
    (frame term folded) equals Arena.checksum."""
    n = 512
    game = Arena(players, n, input_size)
    adapter = planes.get_adapter(game)
    ctx = planes.PlaneContext(game, players, 4, "cpu")
    state = game.init_state("cpu")
    rng = np.random.default_rng(players)
    confirmed = torch.zeros(players, dtype=torch.int32)
    for f in range(12):
        inp, _ = random_script(rng, 1, players, input_size, 0.0)
        inp = torch.from_numpy(inp[0])
        packed = planes.pack_planes(adapter, state)
        inline = adapter.step(packed, inp.to(torch.int32), ctx.owner)
        red = adapter.reduce_finalize(adapter.reduce_partial(packed, ctx.owner))
        cached = adapter.step(packed, inp.to(torch.int32), ctx.owner, red=red)
        state = game.step(state, inp, confirmed)
        want = planes.pack_planes(adapter, state)
        assert torch.equal(inline, want) and torch.equal(cached, want)
        hi, lo = planes.partial_checksum_planes(inline, ctx.weights)
        frame = int(state["frame"])
        got = ((int(hi) + frame * ctx.cs_frame_weight) & 0xFFFFFFFF, (int(lo) + frame) & 0xFFFFFFFF)
        assert got == checksum_u32(game, state)


def test_reduction_matches_reference_adapter():
    """reduce_partial / reduce_finalize equal the reference ArenaPlanes'
    on a state with dead entities (raw sums, centroids and counts)."""
    players, n = 3, 1024
    rng = np.random.default_rng(8)
    state = ref.init_oracle(players, n)
    state["hp"][rng.random(n) < 0.3] = 0
    state["pos"] = rng.integers(0, 1 << ref.ARENA_BITS, size=(n, 2)).astype(np.int32)
    game = Arena(players, n)
    adapter = planes.get_adapter(game)
    packed = planes.pack_planes(adapter, {k: torch.from_numpy(v) for k, v in state.items()})
    raw = adapter.reduce_partial(packed, planes.make_gi_owner(n, players, "cpu")[1])

    from ggrs_tpu.tpu.pallas_core import KernelCtx, make_gi_owner

    radapter = RefArenaPlanes(ref.Arena(players, n))
    gi, owner = make_gi_owner(n // 128, players)
    kctx = KernelCtx(gi, owner)
    rplanes = {name: jnp.asarray((state[key] if c is None else state[key][:, c]).reshape(n // 128, 128))
               for name, key, c in RefArenaPlanes.planes}
    want = np.array([int(v) for v in radapter.reduce_partial(rplanes, kctx)], np.int32)
    np.testing.assert_array_equal(raw.numpy(), want)
    cents, counts = radapter.reduce_finalize([jnp.int32(v) for v in want], kctx)
    cx, cy, count = adapter.reduce_finalize(raw)
    np.testing.assert_array_equal(cx.numpy(), [int(c[0]) for c in cents])
    np.testing.assert_array_equal(cy.numpy(), [int(c[1]) for c in cents])
    np.testing.assert_array_equal(count.numpy(), [int(c) for c in counts])


def test_checksum_weights_follow_checksum_keys():
    """The derivation gives the reference's weights for pos, vel, hp, energy."""
    game = Arena(3, 1024)
    entries, frame_weight = planes.derive_checksum_weights(game, planes.get_adapter(game))
    want, want_fw = ref_derive_weights(ref.Arena(3, 1024), RefArenaPlanes(ref.Arena(3, 1024)))
    assert [(n, w, b) for n, w, b in entries] == [(n, int(w), int(b)) for n, w, b in want]
    assert frame_weight == int(want_fw)
    assert len(launch.weights_arg(planes.PlaneContext(game, 3, 2, "cpu"))) == 13


@pytest.mark.parametrize("players,n", [(2, 1 << 17), (4, 1 << 18)])
def test_beyond_exact_division_envelope_is_config_error(players, n):
    """The reference asserts a team's live count < 2^16; the port raises
    ConfigError (a ValueError) for it, at the adapter and at the session."""
    with pytest.raises(ConfigError, match="envelope"):
        planes.get_adapter(Arena(players, n))
    from ggrs_tpu_torch import DeviceSyncTestSession

    with pytest.raises(ValueError):
        DeviceSyncTestSession(Arena(players, n), players, 2, device="cpu")
    planes.get_adapter(Arena(players, n - players))  # just inside


def test_layouts_cross_by_keys_and_plane_count():
    assert planes.layout_of(keys=("frame", "pos", "vel", "hp", "energy")) is planes.ArenaPlanes
    assert planes.layout_of(n_planes=6) is planes.ArenaPlanes
    assert planes.layout_of(keys=("frame", "pos", "vel", "rot")) is planes.ExGamePlanes
    assert planes.layout_of(n_planes=5) is planes.ExGamePlanes


def test_kernels_of_other_models_refuse_arena():
    """Each kernel library picks arena's own body by the adapter (never
    another model's), any player count the reference allows included, and
    a library with no body for a model refuses it (ConfigError) rather than
    run the wrong model. Arena's step takes the beam's member axis (planes
    [6, B, N], each member reducing its own world) rather than refusing
    it."""
    ctx = planes.PlaneContext(Arena(2, 256), 2, 4, "cpu")
    for kernel, bodies in launch.ENTRIES.items():
        entry = launch.require_adapter(ctx, kernel)
        assert entry.reduces and entry.symbol in ("reduce_table_launch", f"{kernel}_arena_launch"), kernel
        assert launch.require_adapter(planes.PlaneContext(Arena(17, 17 * 128), 17, 4, "cpu"), kernel) == entry
    with pytest.raises(ConfigError, match="not ported"):
        launch.require_adapter(planes.PlaneContext(ExGame(2, 256), 2, 4, "cpu"), "reduce_table")
    world = planes.pack_planes(ctx.adapter, Arena(2, 256).init_state("cpu"))
    members = torch.stack([world, world.flip(-1)], dim=1)  # two different worlds
    inputs = torch.tensor([[[9], [17]], [[34], [5]]], dtype=torch.int32)
    stepped = ctx.adapter.step(members, inputs, ctx.owner)
    for b in range(2):
        assert torch.equal(stepped[:, b], ctx.adapter.step(members[:, b].contiguous(), inputs[b], ctx.owner))
