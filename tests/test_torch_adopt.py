"""The port's adoption (`ResimCore.adopt`, plain versions on the CPU)
against the reference `ResimCore`, tolerance zero: full hits (the
reference's branchless and cond programs), partial hits (its
`_adopt_impl`; the port serves the matched prefix and runs the suffix as
one K3 row), shift 0/1/2, device verification on and off — his/los, the
ring with its frame tags, the live state and the verify history with its
latch."""

import numpy as np
import pytest

from ggrs_tpu_torch import ContractViolation
from ggrs_tpu_torch.convert import resim_to_reference
from test_torch_speculate import P, assert_tree_equal, make_pair, ref_leaves


def adopt_case(shift, count, matched, device_verify, history, ref_full_program):
    """Speculate from frame 3 - shift on both cores, adopt member 2 at load
    frame 3 (slots 3..3+count saved, the trailing save included), and
    compare. `history` frames were played first: with 7 the served frames
    4..6 were seen before with other states, so the verify latch fires."""
    rng = np.random.default_rng(40 + shift)
    played = rng.integers(0, 16, size=(history, P, 1), dtype=np.uint8)
    port, ref = make_pair(64, P, device_verify, "xla", played)
    if not ref_full_program:
        ref._adopt_full_fn = None  # the reference's cond program for full hits
    W, R = port.window, port.ring_len
    anchor = 3 - shift
    B, L = 4, 6
    beam_inputs = rng.integers(0, 16, size=(B, L, P, 1), dtype=np.uint8)
    beam_inputs[:, :shift] = played[anchor : anchor + shift]
    beam_statuses = np.zeros((B, L, P), np.int32)
    member = 2
    actual = np.zeros((W, P, 1), np.uint8)
    actual[:count] = beam_inputs[member, shift : shift + count]
    actual[matched:count] = (actual[matched:count] + 7) % 16  # the mispredicted suffix
    statuses = np.zeros((W, P), np.int32)
    save_slots = np.full((W,), port.scratch_slot, np.int32)
    for i in range(count + 1):
        save_slots[i] = (3 + i) % R
    out = []
    for core in (port, ref):
        spec = core.speculate(anchor % R, beam_inputs, beam_statuses)
        his, los = core.adopt(spec, member, 3 % R, save_slots, count, shift=shift, load_frame=3,
                              inputs=actual, statuses=statuses, matched=matched)
        out.append((np.asarray(his).view(np.uint32) if core is port else np.asarray(his),
                    np.asarray(los).view(np.uint32) if core is port else np.asarray(los)))
    (p_his, p_los), (r_his, r_los) = out
    np.testing.assert_array_equal(p_his, r_his)
    np.testing.assert_array_equal(p_los, r_los)
    assert_tree_equal(resim_to_reference(port), ref_leaves(ref), "core")
    return port, ref


@pytest.mark.parametrize("device_verify", [False, True])
@pytest.mark.parametrize("ref_full_program", [True, False], ids=["branchless", "cond"])
@pytest.mark.parametrize("shift", [0, 1, 2])
def test_full_adoption_matches_reference(shift, ref_full_program, device_verify):
    adopt_case(shift, 4, 4, device_verify, 4, ref_full_program)


@pytest.mark.parametrize("device_verify", [False, True])
@pytest.mark.parametrize("shift,count,matched", [(0, 5, 3), (1, 4, 1), (2, 4, 2), (0, 3, 1)])
def test_partial_adoption_k3_suffix_matches_adopt_impl(shift, count, matched, device_verify):
    """matched < advance_count: the port serves 0..matched-1 and runs the
    suffix as one K3 row; the reference runs `_adopt_impl`."""
    port, _ = adopt_case(shift, count, matched, device_verify, 4, True)
    assert port.tick_core.launches == 0  # the CPU runs the plain version; no kernel


@pytest.mark.parametrize("full", [True, False])
@pytest.mark.parametrize("shift", [0, 2])
def test_adoption_latches_the_verify_history_like_reference(shift, full):
    """Served frames that were seen before with other states: the port's
    tensor-op history update and the reference's latch the same first
    frame."""
    port, ref = adopt_case(shift, 4, 4 if full else 2, True, 7, True)
    verdict = port.check_device_verdict()
    assert verdict == ref.check_device_verdict()
    assert verdict[0]


def test_suffix_slot0_checksum_equals_the_speculations():
    """The K3 suffix recomputes the checksum of slot `matched` from the
    member's state; it must equal the speculation's own checksum of that
    state and frame (the served value the reference uses)."""
    rng = np.random.default_rng(8)
    port = make_pair(128, P, False, "xla", rng.integers(0, 16, (4, P, 1)))[0]
    W, R = port.window, port.ring_len
    beam_inputs = rng.integers(0, 16, size=(3, 6, P, 1), dtype=np.uint8)
    spec = port.speculate(3, beam_inputs, np.zeros((3, 6, P), np.int32))
    actual = np.zeros((W, P, 1), np.uint8)
    actual[:4] = beam_inputs[1, :4]
    actual[2:4] ^= 1
    slots = np.full((W,), port.scratch_slot, np.int32)
    slots[:5] = (3 + np.arange(5)) % R
    his, los = port.adopt(spec, 1, 3, slots, 4, shift=0, load_frame=3, inputs=actual,
                          statuses=np.zeros((W, P), np.int32), matched=2)
    assert int(his[2]) == int(spec.his[1, 1]) and int(los[2]) == int(spec.los[1, 1])


def test_adopt_rejects_what_the_speculation_does_not_cover():
    rng = np.random.default_rng(2)
    port = make_pair(64, P, False, "xla", rng.integers(0, 16, (4, P, 1)))[0]
    W = port.window
    spec = port.speculate(3, rng.integers(0, 16, (2, 3, P, 1)).astype(np.uint8),
                          np.zeros((2, 3, P), np.int32))
    slots = np.full((W,), port.scratch_slot, np.int32)
    with pytest.raises(ContractViolation):  # past the rollout
        port.adopt(spec, 0, 3, slots, 3, shift=1)
    with pytest.raises(ContractViolation):  # a partial hit without its inputs
        port.adopt(spec, 0, 3, slots, 3, matched=2)
    slots[5] = 0
    with pytest.raises(ContractViolation):  # a real save past a full hit
        port.adopt(spec, 0, 3, slots, 2)
