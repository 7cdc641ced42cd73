"""The first-seen verdict's plain version (`tiled_core.plain_verdict`, the
serial scan the port's kernels are held against) against the reference's
`PallasTiledSyncTestCore._verdict` on crafted event streams
(`chip_smoke.VERDICT_STREAMS`): check distances 2, 8 and 16, batches of 1,
60 and 240 ticks, a first frame at or below d and one the batch crosses d
from, a history carried from the previous batch or only stale tags,
differences planted at a frame's first event, at a later one and in the
carried history, two mismatches of which the earlier must latch, and a
mismatch latched on entry. History, mismatch latch and frame compared
exactly. The kernel (`synctest_verdict_launch`) against plain_verdict on
the same streams is a card test in test_torch_kernels.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chip_smoke import VERDICT_STREAMS, verdict_stream
from ggrs_tpu.models.ex_game import ExGame as RefExGame
from ggrs_tpu.tpu.pallas_tiled import PallasTiledSyncTestCore
from ggrs_tpu_torch import ExGame
from ggrs_tpu_torch.device.planes import PlaneContext
from ggrs_tpu_torch.device.tiled_core import plain_verdict

PLAYERS, N = 2, 2048


@pytest.mark.parametrize("stream", VERDICT_STREAMS, ids=[s[0] for s in VERDICT_STREAMS])
def test_plain_verdict_matches_reference_on_crafted_streams(stream):
    name, d, t_ticks, c0, carried, plants, latched = stream
    ref = PallasTiledSyncTestCore(RefExGame(PLAYERS, N), PLAYERS, d, interpret=True, tile_rows=8)
    ctx = PlaneContext(ExGame(PLAYERS, N), PLAYERS, d, "cpu")
    assert int(ref._cs_frame_weight) & 0xFFFFFFFF == ctx.cs_frame_weight & 0xFFFFFFFF
    ph, pl, tag, hhi, hlo, meta = verdict_stream(np, d, t_ticks, c0, carried, plants, latched,
                                                 ctx.cs_frame_weight, seed=d * 1000 + t_ticks)

    port = {"h_tag": torch.from_numpy(tag.copy()), "h_hi": torch.from_numpy(hhi.copy()),
            "h_lo": torch.from_numpy(hlo.copy()), "meta": torch.from_numpy(meta.copy())}
    plain_verdict(port, torch.from_numpy(ph), torch.from_numpy(pl), ctx)

    carry = {"h_tag": jnp.asarray(tag), "h_hi": jnp.asarray(hhi.view(np.uint32)),
             "h_lo": jnp.asarray(hlo.view(np.uint32)), "mismatch": jnp.asarray(bool(meta[1])),
             "mismatch_frame": jnp.asarray(meta[2])}
    want = ref._verdict(carry, jnp.asarray(ph), jnp.asarray(pl), jnp.int32(c0), t_ticks)

    np.testing.assert_array_equal(port["h_tag"].numpy(), np.asarray(want["h_tag"]))
    np.testing.assert_array_equal(port["h_hi"].numpy().view(np.uint32), np.asarray(want["h_hi"]))
    np.testing.assert_array_equal(port["h_lo"].numpy().view(np.uint32), np.asarray(want["h_lo"]))
    assert port["meta"].tolist() == [int(want["frame"]), int(bool(want["mismatch"])), int(want["mismatch_frame"])]
    # each stream shows what it was made for: a planted difference latches
    assert port["meta"].tolist()[1] == int(bool(plants) or latched), name
