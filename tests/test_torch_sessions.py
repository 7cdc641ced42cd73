"""The port's host SyncTest session (ggrs_tpu_torch/sessions/) against the
reference's: for seeded inputs both emit the same request stream — request
types, frames, input bytes and statuses — and the same typed errors on
misuse."""

import numpy as np
import pytest

from ggrs_tpu import SessionBuilder as RefSessionBuilder
from ggrs_tpu.errors import InvalidRequest as RefInvalidRequest
from ggrs_tpu.errors import MismatchedChecksum as RefMismatchedChecksum
from ggrs_tpu_torch import InvalidRequest, MismatchedChecksum, SessionBuilder


class FrameChecksums:
    """Fulfils saves with a checksum derived from the frame (and an
    optional corruption at one frame), loads and advances with nothing:
    enough for a session to run, and the same on both stacks."""

    def __init__(self, bad_frame=None):
        self.bad_frame = bad_frame
        self.seen = set()

    def handle_requests(self, requests):
        for req in requests:
            if type(req).__name__ == "SaveGameState":
                checksum = req.frame * 7919
                if req.frame == self.bad_frame and req.frame in self.seen:
                    checksum += 1  # a resimulation that disagrees with the first save
                self.seen.add(req.frame)
                req.cell.save(req.frame, None, checksum)


def build(builder_cls, players, mp, cd, delay, lag=0, device_verify=False):
    return (
        builder_cls(input_size=1)
        .with_num_players(players)
        .with_max_prediction_window(mp)
        .with_check_distance(cd)
        .with_input_delay(delay)
        .with_deferred_checksum_verification(lag)
        .with_device_checksum_verification(device_verify)
        .start_synctest_session()
    )


def describe(requests):
    """A request list as plain data, the same shape for both stacks."""
    out = []
    for r in requests:
        kind = type(r).__name__
        if kind == "AdvanceFrame":
            out.append((kind, tuple((bytes(buf), int(status)) for buf, status in r.inputs)))
        else:
            out.append((kind, r.frame, r.cell.frame))
    return out


def run(sess, handler, players, frames, seed):
    rng = np.random.default_rng(seed)
    stream = []
    for _ in range(frames):
        for h in range(players):
            sess.add_local_input(h, bytes([int(rng.integers(0, 256))]))
        reqs = sess.advance_frame()
        stream.append(describe(reqs))
        handler.handle_requests(reqs)
    return stream


@pytest.mark.parametrize(
    "players,mp,cd,delay,lag,device_verify",
    [(2, 8, 2, 0, 0, False), (2, 8, 7, 2, 0, False), (3, 10, 4, 1, 3, False),
     (4, 12, 7, 0, 0, True)],
)
def test_request_stream_matches_reference(players, mp, cd, delay, lag, device_verify):
    port = build(SessionBuilder, players, mp, cd, delay, lag, device_verify)
    ref = build(RefSessionBuilder, players, mp, cd, delay, lag, device_verify)
    got = run(port, FrameChecksums(), players, 30, seed=players + cd)
    want = run(ref, FrameChecksums(), players, 30, seed=players + cd)
    assert got == want
    # a rollback every tick once the frame passes check_distance
    assert sum(kind == "LoadGameState" for tick in got for kind, *_ in tick) == 30 - cd - 1
    assert port.sync_layer.current_frame == ref.sync_layer.current_frame == 30


@pytest.mark.parametrize("lag", [0, 3])
def test_host_verification_raises_at_the_same_frame(lag):
    """A resimulated save that disagrees with the first one is caught by
    both sessions at the same frame, eager (lag 0) and deferred."""
    frames = []
    for builder_cls, mismatch in ((SessionBuilder, MismatchedChecksum),
                                  (RefSessionBuilder, RefMismatchedChecksum)):
        sess = build(builder_cls, 2, 8, 4, 0, lag)
        with pytest.raises(mismatch) as exc:
            run(sess, FrameChecksums(bad_frame=12), 2, 40, seed=1)
            sess.flush_checksum_checks()
        frames.append(exc.value.frame)
    assert frames[0] == frames[1] == 12


def misuse_outcomes(builder_cls):
    """Each probe's error type name and message (None when it passes)."""

    def attempt(fn):
        try:
            fn()
        except Exception as exc:  # noqa: BLE001 - the probe records any error
            return type(exc).__name__, str(exc)
        return None

    def missing_input():
        sess = build(builder_cls, 2, 8, 2, 0)
        sess.add_local_input(0, b"\x01")
        sess.advance_frame()

    def bad_handle():
        build(builder_cls, 2, 8, 2, 0).add_local_input(2, b"\x01")

    def flush_with_device_verification():
        build(builder_cls, 2, 8, 2, 0, device_verify=True).flush_checksum_checks()

    return [
        attempt(missing_input),
        attempt(bad_handle),
        attempt(lambda: build(builder_cls, 2, 8, 8, 0)),  # check_distance >= max_prediction
        attempt(lambda: build(builder_cls, 2, 8, 9, 0)),
        attempt(lambda: build(builder_cls, 2, 8, 7, 0)),  # the largest legal distance
        attempt(lambda: builder_cls(input_size=1).with_max_prediction_window(0)),
        attempt(lambda: builder_cls(input_size=1).with_deferred_checksum_verification(-1)),
        attempt(lambda: builder_cls(input_size=0)),
        attempt(flush_with_device_verification),
    ]


def test_misuse_raises_the_reference_errors():
    got, want = misuse_outcomes(SessionBuilder), misuse_outcomes(RefSessionBuilder)
    assert got == want
    assert [o is None for o in got] == [False, False, False, False, True, False, False, False, False]
    assert all(o[0] == "InvalidRequest" for o in got if o is not None)
    with pytest.raises(InvalidRequest):
        build(SessionBuilder, 2, 8, 8, 0)
    with pytest.raises(RefInvalidRequest):
        build(RefSessionBuilder, 2, 8, 8, 0)
