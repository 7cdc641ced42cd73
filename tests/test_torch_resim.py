"""The port's `ResimCore` (ggrs_tpu_torch/device/resim.py, plain version on
the CPU) against the reference `ResimCore` with tick_backend "xla" and
"pallas-interpret": every dispatch's his/los and the ring, state and
device-verify history leaf for leaf, tolerance zero, over session-shaped
random control streams (`chip_smoke.random_tick_args`: rollback depths
up to max_prediction - 1, dense saves with occasional skipped and trailing
saves, 15% DISCONNECTED statuses), as 1-row and multi-row dispatches.
Also the packed row bytes, the carry round trip, and a run continued on
both stacks from a converted mid-run reference carry.

The reference's lone ticks route to its XLA programs on worlds this small,
so its Pallas tick kernel is compared through multi-row dispatches only.
"""

import jax
import numpy as np
import pytest

from chip_smoke import random_tick_args
from ggrs_tpu.models.ex_game import ExGame as RefExGame
from ggrs_tpu.tpu.resim import ResimCore as RefResimCore
from ggrs_tpu_torch import ConfigError, ExGame, ResimCore
from ggrs_tpu_torch.convert import resim_from_reference, resim_to_reference

# (players, entities, max_prediction)
CONFIGS = [(2, 512, 6), (4, 256, 12), (2, 1024, 16)]
ROWS_PER_DISPATCH = 4


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


def u32(t):
    return t.cpu().numpy().view(np.uint32)


def tick_args(players, max_prediction, n_rows, seed):
    """The session-shaped stream (chip_smoke.random_tick_args: spin-up, then
    random rollback depths up to max_prediction - 1, skipped and trailing
    saves, DISCONNECTED slots); it must reach the deepest rollbacks."""
    args = random_tick_args(players, max_prediction, n_rows, seed)
    deepest = max(a[5] - 1 for a in args if a[0])
    assert deepest >= max_prediction - 2, (deepest, max_prediction)
    return args


def make_cores(players, n, mp, ref_backend):
    port = ResimCore(ExGame(players, n), mp, players, device_verify=True, device="cpu")
    ref = RefResimCore(RefExGame(players, n), max_prediction=mp, num_players=players,
                       device_verify=True, tick_backend=ref_backend)
    return port, ref


def dispatch(core, args, single, port):
    """One batch of ticks as one multi-row dispatch of packed rows, or tick
    by tick through `tick()` (pack + a 1-row dispatch) on each stack."""
    if single:
        outs = [core.tick(*a[:6], start_frame=a[6]) for a in args]
        his = [u32(h) if port else np.asarray(h) for h, _ in outs]
        los = [u32(lo) if port else np.asarray(lo) for _, lo in outs]
        return np.stack(his), np.stack(los)
    his, los = core.tick_multi(np.stack([core.pack_tick_row(*a[:6], start_frame=a[6]) for a in args]))
    if port:
        return u32(his), u32(los)
    return np.asarray(his), np.asarray(los)


def drive_pair(port, ref, args, single):
    for b in range(0, len(args), ROWS_PER_DISPATCH):
        batch = args[b : b + ROWS_PER_DISPATCH]
        ph, pl = dispatch(port, batch, single, port=True)
        rh, rl = dispatch(ref, batch, single, port=False)
        np.testing.assert_array_equal(ph, rh, err_msg=f"his, dispatch {b}")
        np.testing.assert_array_equal(pl, rl, err_msg=f"los, dispatch {b}")
    assert_tree_equal(resim_to_reference(port), ref_leaves(ref))


CASES = [
    (cfg, ref_backend, single)
    for cfg in CONFIGS
    for ref_backend, single in (("xla", False), ("xla", True), ("pallas-interpret", False))
]


@pytest.mark.parametrize("cfg,ref_backend,single", CASES)
def test_plain_core_matches_reference(cfg, ref_backend, single):
    players, n, mp = cfg
    port, ref = make_cores(players, n, mp, ref_backend)
    n_rows = mp + 2 + 3 * ROWS_PER_DISPATCH
    n_rows += -n_rows % ROWS_PER_DISPATCH  # one dispatch shape for the reference
    drive_pair(port, ref, tick_args(players, mp, n_rows, seed=7 + mp), single)
    assert port.check_device_verdict() == ref.check_device_verdict()


@pytest.mark.parametrize("players,n,mp", CONFIGS)
def test_packed_rows_equal_reference_bytes(players, n, mp):
    port = ResimCore(ExGame(players, n), mp, players, device="cpu")
    ref = RefResimCore(RefExGame(players, n), max_prediction=mp, num_players=players,
                       tick_backend="xla")
    assert port.packed_len == ref._packed_len
    for a in tick_args(players, mp, mp + 10, seed=3):
        got = port.pack_tick_row(*a[:6], start_frame=a[6])
        want = ref.pack_tick_row(*a[:6], start_frame=a[6])
        assert got.dtype == want.dtype == np.int32
        assert got.tobytes() == want.tobytes()
        into = np.full_like(got, -9)
        assert port.pack_tick_row_into(into, *a[:6], start_frame=a[6]).tobytes() == want.tobytes()
    assert port.pad_tick_row().tobytes() == ref.pad_tick_row().tobytes()


@pytest.mark.parametrize("device_verify", [True, False])
def test_carry_round_trip(device_verify):
    players, n, mp = CONFIGS[0]
    ref = RefResimCore(RefExGame(players, n), max_prediction=mp, num_players=players,
                       device_verify=device_verify, tick_backend="xla")
    args = tick_args(players, mp, mp + 8, seed=5)
    ref.tick_multi(np.stack([ref.pack_tick_row(*a[:6], start_frame=a[6]) for a in args]))
    leaves = ref_leaves(ref)
    port = ResimCore(ExGame(players, n), mp, players, device_verify=device_verify, device="cpu")
    port.carry = resim_from_reference(leaves["ring"], leaves["state"], leaves["verify"])
    assert_tree_equal(resim_to_reference(port), leaves)
    assert_tree_equal(port.fetch_state(), leaves["state"])
    assert_tree_equal(port.fetch_ring_slot(2), {k: v[2] for k, v in leaves["ring"].items()})


@pytest.mark.parametrize("ref_backend", ["xla", "pallas-interpret"])
def test_run_continues_from_converted_reference_carry(ref_backend):
    """Drive the reference mid-run, carry its core across, then run the
    same rows on both stacks: they stay equal."""
    players, n, mp = CONFIGS[1]
    port, ref = make_cores(players, n, mp, ref_backend)
    split = 4 * ROWS_PER_DISPATCH  # past the spin-up: rollbacks have run
    args = tick_args(players, mp, split + 3 * ROWS_PER_DISPATCH, seed=11)
    head, tail = args[:split], args[split:]
    rows = np.stack([ref.pack_tick_row(*a[:6], start_frame=a[6]) for a in head])
    for b in range(0, split, ROWS_PER_DISPATCH):  # one dispatch shape for the reference
        ref.tick_multi(rows[b : b + ROWS_PER_DISPATCH])
    leaves = ref_leaves(ref)
    assert leaves["verify"]["h_tag"].max() > mp
    port.carry = resim_from_reference(leaves["ring"], leaves["state"], leaves["verify"])
    drive_pair(port, ref, tail, single=False)


def test_bad_rows_raise_config_error():
    port = ResimCore(ExGame(2, 256), 4, 2, device="cpu")
    good = port.pad_tick_row()
    for col, value in ((2, port.window + 1), (2, -1), (port.off_save, -1)):
        bad = good.copy()
        bad[col] = value
        with pytest.raises(ConfigError):
            port.tick_row(bad)
    bad = good.copy()
    bad[0], bad[1] = 1, port.ring_len + 1
    with pytest.raises(ConfigError):
        port.tick_row(bad)
    with pytest.raises(ConfigError):
        port.tick_multi(good[None, :-1])
