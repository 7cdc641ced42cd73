"""The port's swarm (ggrs_tpu_torch/models/swarm.py) and its packed-plane
form (ggrs_tpu_torch/device/planes.py SwarmPlanes) against the reference's
jax Swarm, its numpy oracle and its plane adapter, with tolerance zero;
and the port's backend="auto" choice for swarm against the reference's."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ggrs_tpu.models import swarm as ref
from ggrs_tpu.tpu.pallas_core import KernelCtx, make_gi_owner
from ggrs_tpu.tpu.pallas_core import PallasSyncTestCore
from ggrs_tpu.tpu.pallas_core import SwarmPlanes as RefSwarmPlanes
from ggrs_tpu.tpu.pallas_core import derive_checksum_weights as ref_derive_weights
from ggrs_tpu_torch import Swarm
from ggrs_tpu_torch.device import planes, sync_test
from ggrs_tpu_torch.kernels import launch
from ggrs_tpu_torch.models import swarm as port

DISCONNECTED = 2
MOD = 128  # six axis bits and BOOST (bench.py:67-70)


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


def drive(players, n, inputs, statuses):
    """The port's step and checksum against jax Swarm.step, the reference's
    step_oracle/checksum_oracle and the port's own oracle, every frame."""
    game, jgame = Swarm(players, n), ref.Swarm(players, n)
    state = game.init_state("cpu")
    ostate = ref.init_oracle(players, n)
    pstate = port.init_oracle(players, n)
    jstate = jax.device_put(ostate)
    for f in range(len(inputs)):
        state = game.step(state, torch.from_numpy(inputs[f]), torch.from_numpy(statuses[f]))
        jstate = jgame.step(jstate, jnp.asarray(inputs[f]), jnp.asarray(statuses[f]))
        ostate = ref.step_oracle(ostate, inputs[f], statuses[f], players)
        pstate = port.step_oracle(pstate, inputs[f], statuses[f], players)
        got = to_np(state)
        assert_state_equal(got, jax.device_get(jstate))
        assert_state_equal(got, ostate)
        assert_state_equal(pstate, ostate)
        assert checksum_u32(game, state) == ref.checksum_oracle(ostate) == port.checksum_oracle(pstate)
    return ostate


def random_script(rng, frames, players, p_disconnect=0.15):
    inputs = rng.integers(0, MOD, size=(frames, players, 1), dtype=np.uint8)
    statuses = np.where(rng.random((frames, players)) < p_disconnect, DISCONNECTED, 0).astype(np.int32)
    return inputs, statuses


@pytest.mark.parametrize("n", [256, 1000, 4096])
def test_init_state_matches_reference(n):
    assert_state_equal(to_np(Swarm(2, n).init_state("cpu")), ref._init_arrays(n))
    assert_state_equal(port.init_oracle(2, n), ref.init_oracle(2, n))


@pytest.mark.parametrize("players", [2, 3, 4])
def test_step_and_checksum_match_reference(players):
    """40 seeded frames below 128 (every axis bit and BOOST) with
    DISCONNECTED players: the port's step equals jax Swarm.step and
    step_oracle, its checksum checksum_oracle."""
    rng = np.random.default_rng(players)
    inputs, statuses = random_script(rng, 40, players)
    state = drive(players, 384, inputs, statuses)
    assert (statuses == DISCONNECTED).any()
    assert state["charge"].min() < ref.CHARGE_MAX  # boosting drained batteries


def test_speed_clamp_with_negative_components():
    """Boost held along -x-y-z, then +x+y+z and mixed: the 3-D clamp engages
    (|v| past MAX_SPEED) with negative and then positive numerators, which
    the port must floor as the reference does."""
    players, frames = 3, 60
    minus = ref.INPUT_XM | ref.INPUT_YM | ref.INPUT_ZM | ref.INPUT_BOOST
    plus = ref.INPUT_XP | ref.INPUT_YP | ref.INPUT_ZP
    mixed = ref.INPUT_XP | ref.INPUT_YM | ref.INPUT_BOOST
    inputs = np.zeros((frames, players, 1), np.uint8)
    inputs[:25, :, 0] = minus
    inputs[25:45, :, 0] = plus
    inputs[45:, :, 0] = mixed
    statuses = np.zeros((frames, players), np.int32)
    statuses[50:, 2] = DISCONNECTED  # player 2's drones sink along -z
    state = drive(players, 300, inputs, statuses)
    assert np.abs(state["vel"]).max() > ref.MAX_SPEED // 2
    m2 = (state["vel"].astype(np.int64) ** 2).sum(axis=1)
    assert m2.max() <= ref.MAX_SPEED ** 2 + 3 * ref.MAX_SPEED  # clamped, not growing


def test_battery_is_live():
    """BOOST doubles acceleration while charge lasts and drains it, on the
    port's step and its oracle alike (the reference's test_swarm.py:69)."""
    game = Swarm(2, 64)
    statuses = torch.zeros(2, dtype=torch.int32)
    plain, boosted = game.init_state("cpu"), game.init_state("cpu")
    oracle = port.init_oracle(2, 64)
    for _ in range(40):
        plain = game.step(plain, torch.full((2, 1), port.INPUT_XP, dtype=torch.uint8), statuses)
        inp = np.full((2, 1), port.INPUT_XP | port.INPUT_BOOST, np.uint8)
        boosted = game.step(boosted, torch.from_numpy(inp), statuses)
        oracle = port.step_oracle(oracle, inp, statuses.numpy(), 2)
    assert not torch.equal(plain["pos"], boosted["pos"])
    assert (boosted["charge"] < plain["charge"]).all()
    assert int(boosted["charge"].min()) == 0  # the battery ran dry
    assert_state_equal(oracle, to_np(boosted))


def test_plane_step_matches_reference_adapter():
    """SwarmPlanes.step on `[7, N]` planes equals the reference's
    SwarmPlanes.step on its (rows, 128) planes, frame after frame."""
    players, n = 3, 512
    game = Swarm(players, n)
    adapter = planes.get_adapter(game)
    assert isinstance(adapter, planes.SwarmPlanes) and adapter.reduce_len == 0
    owner = planes.make_gi_owner(n, players, "cpu")[1]
    packed = planes.pack_planes(adapter, game.init_state("cpu"))
    radapter = RefSwarmPlanes(ref.Swarm(players, n))
    gi, rowner = make_gi_owner(n // 128, players)
    kctx = KernelCtx(gi, rowner)
    rplanes = {name: jnp.asarray(packed[k].numpy().reshape(n // 128, 128))
               for k, (name, _, _) in enumerate(RefSwarmPlanes.planes)}
    rng = np.random.default_rng(5)
    for _ in range(24):
        inp = rng.integers(0, MOD, size=(players, 1)).astype(np.int32)
        packed = adapter.step(packed, torch.from_numpy(inp), owner)
        rplanes = radapter.step(rplanes, [[jnp.int32(b[0])] for b in inp], kctx)
    for k, (name, _, _) in enumerate(RefSwarmPlanes.planes):
        np.testing.assert_array_equal(packed[k].numpy(), np.asarray(rplanes[name]).reshape(n), err_msg=name)


def test_member_axis_step_equals_one_world_steps():
    """Members with different worlds, inputs and DISCONNECTED statuses: the
    stacked `[7, B, N]` step equals each member's own."""
    players, n, B = 3, 200, 5
    game = Swarm(players, n)
    ctx = planes.PlaneContext(game, players, 4, "cpu")
    rng = np.random.default_rng(11)
    world = planes.pack_planes(ctx.adapter, game.init_state("cpu"))
    members = world.unsqueeze(1).repeat(1, B, 1)
    members[3:6] = torch.from_numpy(rng.integers(-1500, 1500, (3, B, n)).astype(np.int32))
    members[6] = torch.from_numpy(rng.integers(0, 193, (B, n)).astype(np.int32))
    inputs = torch.from_numpy(rng.integers(0, MOD, (B, players, 1)).astype(np.int32))
    statuses = torch.from_numpy(np.where(rng.random((B, players)) < 0.3, DISCONNECTED, 0).astype(np.int32))
    stacked = ctx.adapter.step(members, inputs, ctx.owner, statuses)
    for b in range(B):
        one = ctx.adapter.step(members[:, b].contiguous(), inputs[b], ctx.owner, statuses[b])
        assert torch.equal(stacked[:, b], one), b


def test_checksum_weights_follow_checksum_keys():
    """The derivation gives the reference's weights for pos [N,3], vel [N,3]
    and charge: 7 planes, 15 ints for the kernels."""
    game = Swarm(3, 1024)
    entries, frame_weight = planes.derive_checksum_weights(game, planes.get_adapter(game))
    want, want_fw = ref_derive_weights(ref.Swarm(3, 1024), RefSwarmPlanes(ref.Swarm(3, 1024)))
    assert [(n, w, b) for n, w, b in entries] == [(n, int(w), int(b)) for n, w, b in want]
    assert frame_weight == int(want_fw)
    assert len(launch.weights_arg(planes.PlaneContext(game, 3, 2, "cpu"))) == 15


def test_layouts_cross_by_keys_and_plane_count():
    assert planes.layout_of(keys=("frame", "pos", "vel", "charge")) is planes.SwarmPlanes
    assert planes.layout_of(n_planes=7) is planes.SwarmPlanes


def test_every_kernel_picks_the_swarm_body():
    """K1-K4 each choose swarm's own entry point by the adapter, with no
    substeps argument; K5 (reductions only) has no body for swarm."""
    ctx = planes.PlaneContext(Swarm(2, 256), 2, 4, "cpu")
    for kernel in ("synctest_fused", "synctest_tiled", "resim_tick", "beam_rollout"):
        entry = launch.require_adapter(ctx, kernel)
        assert entry.symbol == f"{kernel}_swarm_launch" and not entry.reduces
        assert launch.model_ints(entry, ctx) == ()
    with pytest.raises(ValueError, match="not ported"):
        launch.require_adapter(ctx, "reduce_table")


@pytest.mark.parametrize("n,d", [(4096, 8), (1 << 20, 8), (163328, 8), (163456, 8), (65536, 16)])
def test_auto_picks_as_the_reference_does(n, d):
    """On a card, K1 while the reference's VMEM estimate (7 planes, state
    and ring, in and out) stays within 96 MB, K2 beyond; the plain version
    on the CPU. The reference's own estimate decides the same switch."""
    cuda = torch.device("cuda")
    fits = PallasSyncTestCore.vmem_estimate(ref.Swarm(2, n), d) <= PallasSyncTestCore.VMEM_BUDGET_BYTES
    assert sync_test.pick_backend(Swarm(2, n), d, cuda) == ("cuda-fused" if fits else "cuda-tiled")
    assert sync_test.pick_backend(Swarm(2, n), d, torch.device("cpu")) == "torch"
    assert fits == (n in (4096, 65536, 163328))
