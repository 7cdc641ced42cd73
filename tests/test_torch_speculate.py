"""The port's speculation (`ResimCore.speculate`, the plain rollout on the
CPU) against the reference `ResimCore`, tolerance zero: the speculation
tuple leaf for leaf (trajectory pytree, per-step checksums, anchor
checksum) under the reference's "xla" and "pallas-interpret" speculation
backends, and with DISCONNECTED cells under "xla". Adoption is in
test_torch_adopt.py."""

import jax
import numpy as np
import pytest

from ggrs_tpu.models.ex_game import ExGame as RefExGame
from ggrs_tpu.tpu.resim import ResimCore as RefResimCore
from ggrs_tpu_torch import ExGame, ResimCore
from ggrs_tpu_torch.convert import speculation_to_reference
from ggrs_tpu_torch.types import InputStatus

P = 2
MP = 6


def assert_tree_equal(got, want, path="spec"):
    if isinstance(want, (dict, tuple)):
        if isinstance(want, dict):
            assert set(got) == set(want), path
            keys = list(want)
        else:
            assert len(got) == len(want), path
            keys = range(len(want))
        for k in keys:
            assert_tree_equal(got[k], want[k], f"{path}/{k}")
        return
    g, w = np.asarray(got), np.asarray(want)
    assert g.dtype == w.dtype, f"{path}: {g.dtype} != {w.dtype}"
    np.testing.assert_array_equal(g, w, err_msg=path)


def make_pair(n, players, device_verify, spec_backend, played):
    """A port core and a reference core with the same confirmed frames
    ticked in (one save each), so the ring holds real snapshots."""
    port = ResimCore(ExGame(players, n), MP, players, device_verify=device_verify, device="cpu")
    ref = RefResimCore(RefExGame(players, n), max_prediction=MP, num_players=players,
                       device_verify=device_verify, spec_backend=spec_backend, tick_backend="xla")
    W = port.window
    for f, row in enumerate(played):
        inputs = np.zeros((W, players, 1), np.uint8)
        inputs[0] = row
        statuses = np.zeros((W, players), np.int32)
        slots = np.full((W,), port.scratch_slot, np.int32)
        slots[0] = f % port.ring_len
        for core in (port, ref):
            core.tick(False, 0, inputs, statuses, slots, 1, start_frame=f)
    return port, ref


def ref_leaves(core):
    return jax.device_get({"ring": core.ring, "state": core.state, "verify": core.verify})


SPEC_CASES = [
    # entities, players, B, L, anchor slot, seed
    (1024, 2, 6, 5, 2, 9),  # tests/test_pallas_beam.py's shape
    (256, 2, 16, 8, 3, 4),
    (384, 4, 5, 7, 0, 1),
    (200, 3, 1, 1, 1, 5),  # a width-1 history launch, a ragged world
]


# the reference's Pallas rollout in interpret mode unrolls B x L steps and
# takes minutes past its own test's shape, so it runs that shape alone
BACKEND_CASES = [("xla",) + c for c in SPEC_CASES] + [("pallas-interpret",) + SPEC_CASES[0]]


@pytest.mark.parametrize("spec_backend,n,players,B,L,slot,seed", BACKEND_CASES)
def test_speculate_matches_reference(spec_backend, n, players, B, L, slot, seed):
    rng = np.random.default_rng(seed)
    port, ref = make_pair(n, players, False, spec_backend, rng.integers(0, 16, (4, players, 1)))
    beam_inputs = rng.integers(0, 16, size=(B, L, players, 1), dtype=np.uint8)
    beam_statuses = np.zeros((B, L, players), np.int32)
    got = speculation_to_reference(port.speculate(slot, beam_inputs, beam_statuses))
    want = jax.device_get(ref.speculate(slot, beam_inputs, beam_statuses))
    assert_tree_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_speculate_with_disconnected_cells_matches_reference(seed):
    """DISCONNECTED cells step with the disconnect input in both (the
    reference routes such statuses to its XLA rollout)."""
    rng = np.random.default_rng(seed)
    players = 4 if seed else 2
    port, ref = make_pair(256, players, False, "xla", rng.integers(0, 16, (4, players, 1)))
    B, L = 6, 7
    beam_inputs = rng.integers(0, 16, size=(B, L, players, 1), dtype=np.uint8)
    beam_statuses = np.where(rng.random((B, L, players)) < 0.3, int(InputStatus.DISCONNECTED),
                             int(InputStatus.CONFIRMED)).astype(np.int32)
    got = speculation_to_reference(port.speculate(3, beam_inputs, beam_statuses))
    want = jax.device_get(ref.speculate(3, beam_inputs, beam_statuses))
    assert_tree_equal(got, want)
