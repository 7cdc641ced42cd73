"""The port's copies of the host bookkeeping (ggrs_tpu_torch/input_queue.py,
sync_layer.py, frame_info.py) against the reference's modules: seeded,
P2P-shaped operation sequences run on both, and every returned value,
status, misprediction frame and raised error type must agree."""

import numpy as np
import pytest

from ggrs_tpu import frame_info as ref_frame_info
from ggrs_tpu import input_queue as ref_input_queue
from ggrs_tpu import sync_layer as ref_sync_layer
from ggrs_tpu_torch import frame_info, input_queue, sync_layer

STACKS = {
    "port": (input_queue.InputQueue, frame_info.PlayerInput, sync_layer),
    "ref": (ref_input_queue.InputQueue, ref_frame_info.PlayerInput, ref_sync_layer),
}
NULL_FRAME = -1


def drive_queue(stack, seed, delay, frames=80):
    """A remote player's queue as a P2P session uses it: the local side
    requests every frame (predicting when the real input lags), real
    inputs arrive 0-6 frames late with held values, a misprediction rolls
    back (reset, then re-request the corrected frames), and confirmed
    frames are discarded behind the rollback window."""
    Queue, PlayerInput, _ = STACKS[stack]
    rng = np.random.default_rng(seed)
    q = Queue(1)
    q.set_frame_delay(delay)
    log = []
    sent = 0  # next input frame the remote side sends
    value = 0
    for f in range(frames):
        lag = int(rng.integers(0, 7))
        while sent <= f - lag:
            if rng.random() < 0.3:
                value = int(rng.integers(0, 16))
            log.append(("add", q.add_input(PlayerInput(sent, bytes([value])))))
            sent += 1
        if q.first_incorrect_frame != NULL_FRAME:
            bad = q.first_incorrect_frame
            log.append(("mispredicted", bad))
            q.reset_prediction()
            for g in range(bad, f):
                buf, status = q.input(g)
                log.append(("resim", g, buf, int(status)))
        buf, status = q.input(f)
        log.append(("input", f, buf, int(status)))
        if f > 12 and f % 5 == 0:
            q.discard_confirmed_frames(f - 10)
    log.append(("tallies", q.predictions_served, q.mispredictions, q.length, q.head, q.tail))
    return log


@pytest.mark.parametrize("delay", [0, 2])
@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_input_queue_matches_reference(seed, delay):
    got, want = drive_queue("port", seed, delay), drive_queue("ref", seed, delay)
    assert got == want
    assert any(entry[0] == "mispredicted" for entry in got)
    assert any(entry[0] == "input" and entry[3] == 1 for entry in got)  # predictions served


def queue_misuse(stack):
    Queue, PlayerInput, _ = STACKS[stack]
    outcomes = []
    for fn in (
        lambda q: (q.add_input(PlayerInput(0, b"\x00")), q.add_input(PlayerInput(3, b"\x00"))),
        lambda q: (q.add_input(PlayerInput(0, b"\x00")), q.add_input(PlayerInput(0, b"\x00"))),
        lambda q: q.confirmed_input(5),
    ):
        try:
            fn(Queue(1))
            outcomes.append(None)
        except AssertionError as exc:  # ContractViolation keeps the AssertionError face
            outcomes.append(type(exc).__name__)
    return outcomes


def test_input_queue_misuse_matches_reference():
    assert queue_misuse("port") == queue_misuse("ref") == ["AssertionError", "AssertionError",
                                                           "ContractViolation"]


def drive_sync_layer(stack, players, mp, disconnect_at):
    """Local inputs every frame, a prediction threshold hit when
    confirmation stalls, rollbacks inside the window, a player
    disconnecting mid-run: the requests, inputs and errors as plain data."""
    _, PlayerInput, module = STACKS[stack]
    layer = module.SyncLayer(players, mp, 1)
    status = [module.ConnectionStatus() for _ in range(players)]
    log = []
    for f in range(3 * mp):
        if f == disconnect_at:
            status[players - 1].disconnected = True
            status[players - 1].last_frame = f - 1
        try:
            for h in range(players):
                layer.add_local_input(h, PlayerInput(layer.current_frame, bytes([(f * 3 + h) % 16])))
        except Exception as exc:  # noqa: BLE001 - the error type is what is compared
            log.append(("error", type(exc).__name__))
            layer.set_last_confirmed_frame(layer.current_frame - 2, False)
            continue
        save = layer.save_current_state()
        save.cell.save(save.frame, None, save.frame)
        log.append(("save", save.frame))
        log.append(("inputs", tuple((bytes(b), int(s)) for b, s in layer.synchronized_inputs(status))))
        layer.advance_frame()
        if f % 4 == 3:
            back = layer.current_frame - 2
            load = layer.load_frame(back)
            log.append(("load", load.frame, load.cell.frame))
            for _ in range(2):
                layer.synchronized_inputs(status)
                layer.advance_frame()
    log.append(("end", layer.current_frame, layer.last_confirmed_frame, layer.last_saved_frame,
                layer.check_simulation_consistency(NULL_FRAME)))
    return log


@pytest.mark.parametrize("players,mp,disconnect_at", [(2, 4, 7), (3, 6, 20), (4, 8, 100)])
def test_sync_layer_matches_reference(players, mp, disconnect_at):
    got = drive_sync_layer("port", players, mp, disconnect_at)
    assert got == drive_sync_layer("ref", players, mp, disconnect_at)
    assert ("error", "PredictionThreshold") in got
    assert any(entry[0] == "load" for entry in got)
    disconnected = any(entry[0] == "inputs" and entry[1][-1][1] == 2 for entry in got)
    assert disconnected == (disconnect_at < 3 * mp)
