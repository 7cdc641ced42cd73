"""The port's beam generators and matchers (ggrs_tpu_torch/beam.py, numpy
only) are byte-for-byte the reference's (ggrs_tpu/tpu/beam.py) over seeded
fuzzes of widths, windows, max_offset, pinned history (base_rows/fixed)
and model predictions; and the port's `BeamSpeculator` (the plain K4
rollout on the CPU) equals the reference's vmapped rollout."""

import jax
import numpy as np
import pytest

from ggrs_tpu.models.ex_game import ExGame as RefExGame
from ggrs_tpu.tpu import beam as ref_beam
from ggrs_tpu_torch import ExGame
from ggrs_tpu_torch import beam as port_beam


def random_generator_args(rng):
    """One random branching_beam call, as the reference's invariant fuzz
    draws them (tests/test_beam_backend.py:328), plus predictions."""
    p = int(rng.integers(1, 5))
    i = int(rng.integers(1, 3))
    window = int(rng.integers(2, 12))
    width = int(rng.integers(1, 40))
    last = rng.integers(0, 256, size=(p, i)).astype(np.uint8)
    # toggling players: prev differs from last for some of them
    prev = np.where(rng.random((p, 1)) < 0.6, rng.integers(0, 256, size=(p, i)), last).astype(np.uint8)
    kw = {"max_offset": int(rng.integers(1, window + 1)) if rng.random() < 0.8 else None}
    if rng.random() < 0.5:
        S = int(rng.integers(0, window + 1))
        kw["base_rows"] = rng.integers(0, 256, size=(S, p, i)).astype(np.uint8)
        kw["fixed"] = rng.random(size=(S, p)) < rng.random()
    if rng.random() < 0.5:
        kw["predictions"] = [
            (int(rng.integers(0, p)), int(rng.integers(0, window)),
             rng.integers(0, 256, size=(i,)).astype(np.uint8))
            for _ in range(int(rng.integers(1, 6)))
        ]
    return (last, prev, window, width), kw


@pytest.mark.parametrize("seed", range(40))
def test_branching_beam_equals_reference(seed):
    rng = np.random.default_rng(1000 + seed)
    for _ in range(6):
        args, kw = random_generator_args(rng)
        got = port_beam.branching_beam(*args, **kw)
        want = ref_beam.branching_beam(*args, **kw)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes(), (args[2:], {k: v for k, v in kw.items() if k == "max_offset"})


@pytest.mark.parametrize("p,i,window,width", [
    (1, 1, 1, 1), (2, 1, 8, 16), (4, 1, 11, 16), (2, 2, 6, 40), (3, 3, 5, 300), (2, 1, 14, 12),
])
def test_repeat_last_beam_equals_reference(p, i, window, width):
    last = np.random.default_rng(p * 100 + width).integers(0, 256, size=(p, i)).astype(np.uint8)
    got = port_beam.repeat_last_beam(last, window, width)
    want = ref_beam.repeat_last_beam(last, window, width)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def beam_and_actual(rng, hit):
    B, L, p = int(rng.integers(1, 17)), int(rng.integers(1, 12)), int(rng.integers(1, 5))
    beam = rng.integers(0, 4, size=(B, L, p, 1)).astype(np.uint8)
    k = int(rng.integers(0, L + 1))
    actual = rng.integers(0, 4, size=(k, p, 1)).astype(np.uint8)
    if hit and B:
        actual[:] = beam[int(rng.integers(0, B)), :k]
    return beam, actual


@pytest.mark.parametrize("seed", range(10))
def test_match_beam_equals_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(8):
        beam, actual = beam_and_actual(rng, hit=rng.random() < 0.5)
        assert port_beam.match_beam(beam, actual) == ref_beam.match_beam(beam, actual)


@pytest.mark.parametrize("seed", range(12))
def test_match_beam_longest_equals_reference(seed):
    rng = np.random.default_rng(50 + seed)
    for _ in range(8):
        beam, _ = beam_and_actual(rng, hit=False)
        B, L = beam.shape[:2]
        s = int(rng.integers(0, L + 1))
        member = int(rng.integers(0, B))
        prefix = beam[member, :s].copy() if rng.random() < 0.7 else rng.integers(0, 4, (s,) + beam.shape[2:]).astype(np.uint8)
        k = int(rng.integers(0, L - s + 2))
        actual = rng.integers(0, 4, size=(k,) + beam.shape[2:]).astype(np.uint8)
        m = int(rng.integers(0, k + 1))
        take = min(m, L - s)
        actual[:take] = beam[member, s : s + take]
        got = port_beam.match_beam_longest(beam, prefix, actual)
        assert got == ref_beam.match_beam_longest(beam, prefix, actual)


@pytest.mark.parametrize("players,entities,window,width,status", [
    (2, 128, 8, 16, 1),  # tests/test_beam.py:9's shape, PREDICTED statuses
    (2, 200, 5, 3, 0),
    (4, 96, 6, 5, 2),  # every cell DISCONNECTED: the spin input
])
def test_beam_speculator_equals_reference(players, entities, window, width, status):
    rng = np.random.default_rng(11)
    beam_inputs = rng.integers(0, 16, size=(width, window, players, 1), dtype=np.uint8)
    beam_statuses = np.full((width, window, players), status, np.int32)
    ref = ref_beam.BeamSpeculator(RefExGame(players, entities), window=window, beam_width=width,
                                  num_players=players)
    r_final, r_hi, r_lo = jax.device_get(ref.rollout(RefExGame(players, entities).init_state(),
                                                     beam_inputs, beam_statuses))
    game = ExGame(players, entities)
    port = port_beam.BeamSpeculator(game, window=window, beam_width=width, num_players=players,
                                    device="cpu")
    p_final, p_hi, p_lo = port.rollout(game.init_state("cpu"), beam_inputs, beam_statuses)
    for k in r_final:
        np.testing.assert_array_equal(p_final[k].numpy(), np.asarray(r_final[k]), err_msg=k)
    np.testing.assert_array_equal(p_hi.numpy().view(np.uint32), np.asarray(r_hi))
    np.testing.assert_array_equal(p_lo.numpy().view(np.uint32), np.asarray(r_lo))
    picked = port.select(p_final, width - 1)
    for k in r_final:
        np.testing.assert_array_equal(picked[k].numpy(), np.asarray(r_final[k])[width - 1], err_msg=k)
