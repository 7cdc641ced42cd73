"""K3's scalar lanes on crafted row streams, on the CPU, against the
reference, tolerance zero.

`chip_smoke.TICK_STREAMS` craft control streams for what K3's scalar pass
computes (the state frames, the ring-frame tags, the first-seen history
and its latch): loads of slots an earlier row of the same dispatch saved,
frames that go back, history keys reused by a later frame, hits, misses
and mismatches (the earlier latching), a latch carried in, verification
off, skipped saves, saves past the last advance, zero-advance rows, and
1, 8 and 16 rows a dispatch at W = 11 and 14. The port's
`plain_tick_multi` (a CPU `ResimCore`) runs each stream beside the
reference's `ResimCore` with tick_backend "pallas-interpret" (its
`PallasTickCore` and `_scalar_pass` in interpret mode for multi-row
dispatches; lone rows take its XLA program at this size), for ex_game and
arena: every dispatch's his/los, then the ring, the state and the history
leaf for leaf, and the latch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from chip_smoke import TICK_STREAMS, tick_stream
from ggrs_tpu.models.arena import Arena as RefArena
from ggrs_tpu.models.ex_game import ExGame as RefExGame
from ggrs_tpu.tpu.resim import ResimCore as RefResimCore
from ggrs_tpu_torch import Arena, ExGame, ResimCore
from ggrs_tpu_torch.convert import resim_to_reference

N = 128
GAMES = {"ex_game": (ExGame, RefExGame, 16), "arena": (Arena, RefArena, 64)}


def assert_tree_equal(got, want, path="core"):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_tree_equal(got[k], want[k], f"{path}/{k}")
        return
    g, w = np.asarray(got), np.asarray(want)
    assert g.dtype == w.dtype, f"{path}: {g.dtype} != {w.dtype}"
    np.testing.assert_array_equal(g, w, err_msg=path)


@pytest.mark.parametrize("game", sorted(GAMES))
@pytest.mark.parametrize("stream", TICK_STREAMS, ids=[s[0] for s in TICK_STREAMS])
def test_plain_tick_matches_reference_on_crafted_stream(stream, game):
    name, players, mp, per, verify, latched, specs = stream
    port_cls, ref_cls, mod = GAMES[game]
    port = ResimCore(port_cls(players, N), mp, players, device_verify=verify, device="cpu")
    ref = RefResimCore(ref_cls(players, N), max_prediction=mp, num_players=players, device_verify=verify,
                       tick_backend="pallas-interpret")
    if latched:
        port.carry["flag"][:] = port.carry["flag"].new_tensor([1, 3])
        ref.verify = dict(ref.verify, flag=jnp.asarray([1, 3], dtype=ref.verify["flag"].dtype))
    rows = tick_stream(port, specs, seed=len(name), mod=mod)
    for b in range(0, len(rows), per):
        batch = rows[b : b + per]
        his, los = port.tick_multi(batch)
        r_his, r_los = ref.tick_multi(batch)
        np.testing.assert_array_equal(his.numpy().view(np.uint32), np.asarray(r_his), err_msg=f"his {b}")
        np.testing.assert_array_equal(los.numpy().view(np.uint32), np.asarray(r_los), err_msg=f"los {b}")
    assert_tree_equal(resim_to_reference(port), jax.device_get({"ring": ref.ring, "state": ref.state,
                                                                "verify": ref.verify}))
    if verify:
        assert port.check_device_verdict() == ref.check_device_verdict()
        assert port.check_device_verdict()[0]  # every stream mismatches somewhere
