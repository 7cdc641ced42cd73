"""The port's online input model (ggrs_tpu_torch/input_model.py, numpy
only) against the reference's (ggrs_tpu/tpu/input_model.py) on the same
seeded hold/toggle streams with severed runs (`break_run`, as a
disconnect does): the learned statistics (`state_dict`), the ranked
branch specs (`rank_branches`) and the drafted scripts (`draft_script`)
are equal, value for value."""

import numpy as np
import pytest

from ggrs_tpu.errors import ModelIncompatible as RefModelIncompatible
from ggrs_tpu.tpu.input_model import InputHistoryModel as RefModel
from ggrs_tpu_torch.errors import ModelIncompatible
from ggrs_tpu_torch.input_model import InputHistoryModel, unit_uniform


def stream(rng, players, input_size, frames):
    """Per player, runs of held values (hold lengths 1..9, values from a
    small vocabulary so transitions repeat), with ~3% of cells a disconnect
    (None: the run is severed)."""
    vocab = rng.integers(0, 256, size=(4, input_size)).astype(np.uint8)
    out = []
    for _ in range(players):
        rows = []
        while len(rows) < frames:
            v = vocab[int(rng.integers(0, len(vocab)))].tobytes()
            rows += [v] * int(rng.integers(1, 10))
        rows = rows[:frames]
        for f in np.nonzero(rng.random(frames) < 0.03)[0]:
            rows[f] = None
        out.append(rows)
    return out


def feed(models, rows_by_player):
    for f in range(len(rows_by_player[0])):
        for p, rows in enumerate(rows_by_player):
            for m in models:
                if rows[f] is None:
                    m.break_run(p)
                else:
                    m.observe(p, rows[f])


def fed_pair(seed, players=2, input_size=1, frames=160):
    rng = np.random.default_rng(seed)
    port, ref = InputHistoryModel(players, input_size), RefModel(players, input_size)
    feed((port, ref), stream(rng, players, input_size, frames))
    return rng, port, ref


def same_specs(a, b):
    return len(a) == len(b) and all(
        pa == pb and oa == ob and np.array_equal(ra, rb) for (pa, oa, ra), (pb, ob, rb) in zip(a, b)
    )


@pytest.mark.parametrize("seed", range(8))
def test_state_dict_equals_reference(seed):
    _, port, ref = fed_pair(seed, players=1 + seed % 4, input_size=1 + seed % 2)
    assert port.state_dict() == ref.state_dict()
    # and it loads across: the reference's statistics drive the port
    fresh = InputHistoryModel(port.num_players, port.input_size)
    fresh.load_state_dict(ref.state_dict())
    assert fresh.state_dict() == ref.state_dict()


@pytest.mark.parametrize("seed", range(10))
def test_rank_branches_equals_reference(seed):
    rng, port, ref = fed_pair(100 + seed, players=1 + seed % 3)
    emitted = 0
    for _ in range(6):
        confirmed = []
        for p in range(port.num_players):
            if rng.random() < 0.2:
                confirmed.append(None)
                continue
            value = port._stats[p].cur_value or bytes([0])
            confirmed.append((int(rng.integers(50, 70)), value, int(rng.integers(1, 10))))
        anchor, rollout, limit = int(rng.integers(45, 70)), int(rng.integers(1, 12)), int(rng.integers(1, 12))
        got = port.rank_branches(confirmed, anchor, rollout, limit)
        want = ref.rank_branches(confirmed, anchor, rollout, limit)
        assert same_specs(got, want)
        emitted += len(got)
    assert emitted > 0


@pytest.mark.parametrize("seed", range(8))
def test_draft_script_equals_reference(seed):
    rng, port, ref = fed_pair(200 + seed, players=2 + seed % 3, input_size=1 + seed % 2)
    P, I = port.num_players, port.input_size
    D = int(rng.integers(1, 14))
    base = rng.integers(0, 256, size=(D, P, I)).astype(np.uint8)
    pinned = rng.random((D, P)) < 0.3
    init_values = rng.integers(0, 256, size=(P, I)).astype(np.uint8)
    init_holds = rng.integers(1, 8, size=(P,))
    kw = dict(anchor_frame=int(rng.integers(0, 1000)), seed=int(rng.integers(0, 2**31)),
              init_values=init_values, init_holds=init_holds)
    got = port.draft_script(base.copy(), pinned, **kw)
    want = ref.draft_script(base.copy(), pinned, **kw)
    assert got.tobytes() == want.tobytes()


def test_unit_uniform_equals_reference():
    from ggrs_tpu.env.opponents import unit_uniform as ref_uniform

    idx = np.arange(64)
    for seed, t in [(0, 0), (7, 123), (2**31 - 1, 2**32 + 5), (0x5EED ^ 99, 17)]:
        np.testing.assert_array_equal(unit_uniform(seed, t, idx), ref_uniform(seed, t, idx))


def test_toggle_hazard_and_ranking_match_reference():
    """The reference suite's worked example (tests/test_input_model.py:62):
    a 6-frame-hold toggle puts the true switch first, in both."""
    port, ref = InputHistoryModel(2, 1), RefModel(2, 1)
    for _ in range(6):
        for v in (5, 9):
            for _ in range(6):
                port.observe(0, bytes([v]))
                ref.observe(0, bytes([v]))
    assert port._stats[0].hazard(6) == ref._stats[0].hazard(6) > 0.7
    confirmed = [(99, bytes([5]), 4), None]
    got = port.rank_branches(confirmed, anchor_frame=98, rollout=8, limit=6)
    assert same_specs(got, ref.rank_branches(confirmed, anchor_frame=98, rollout=8, limit=6))
    assert (got[0][0], got[0][1], int(got[0][2][0])) == (0, 4, 9)


def test_load_state_dict_rejects_another_game_like_reference():
    state = InputHistoryModel(2, 1).state_dict()
    with pytest.raises(ModelIncompatible, match="num_players"):
        InputHistoryModel(3, 1).load_state_dict(state)
    with pytest.raises(RefModelIncompatible, match="num_players"):
        RefModel(3, 1).load_state_dict(state)
