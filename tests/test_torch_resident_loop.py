"""The port's device-resident serving loop (`SessionHost(resident=True)`:
the device mailbox and its drive, device="cpu") against its
dispatch-per-tick twin fed the same seeded traffic, tolerance zero: every
session's frame and `local_checksum_history`, the canonical stacked rings
and states and the slot checksums — the port's counterparts of
tests/test_resident_loop.py's lossy-fleet parity, its starvation and
disconnect arm (blackhole windows past the prediction gate from
`loadgen.starve_on_tick`, then a hard disconnect of one peer a match; the
port has no speculation, so no drafts fill the holes), any drive cadence
(`resident_ticks` 1, 3 and 16), and a checkpoint taken mid fill cycle out
of resident mode that the port's and the reference's cores restore to the
twin's bytes. The sharded, migration and jit-cache cases wait for ROADMAP
items 10, 4 and 9. ExGame(4, 16), at most 16 sessions and 60 ticks."""

import numpy as np
import pytest

from ggrs_tpu_torch import ExGame, MultiSessionDeviceCore
from ggrs_tpu_torch.network.sockets import InMemoryNetwork
from ggrs_tpu_torch.serve import SessionHost
from ggrs_tpu_torch.serve.loadgen import build_matches, drive_scripted, held_scripts, make_scripts, starve_on_tick, \
    sync_fleet
from ggrs_tpu_torch.utils.clock import FakeClock

ENTITIES = 16


def build_fleet(*, resident, seed=13, sessions=16, ticks=40, loss=0.03, resident_ticks=8, on_tick=None,
                scripts_fn=make_scripts, settle=True):
    """A seeded lossy loadgen fleet; `resident` picks the arm. An ample
    inflight window, so the twin never queues on backpressure (the
    resident arm has no dispatch queue: traffic must be the same in both
    arms). `settle`: wait for the device at the end (a resident host's
    mailbox drives then)."""
    clock = FakeClock()
    net = InMemoryNetwork(clock, latency_ms=20, jitter_ms=8, loss=loss, seed=seed)
    host = SessionHost(ExGame(4, ENTITIES), max_prediction=8, num_players=4, max_sessions=sessions + 4,
                       clock=clock, idle_timeout_ms=0, resident=resident, resident_ticks=resident_ticks,
                       max_inflight_rows=4 * (sessions + 4), device="cpu")
    matches = build_matches(host, net, clock, sessions=sessions, seed=seed)
    sync_fleet(host, matches, clock)
    desyncs = drive_scripted(host, matches, clock, scripts_fn(matches, ticks, seed), ticks,
                             on_tick=on_tick(net, matches) if on_tick is not None else None)
    assert not desyncs, f"fleet desynced (resident={resident})"
    if settle:
        host.device.block_until_ready()
    return host, [k for keys in matches for k in keys]


def assert_stacks_equal(a, b):
    for got, want in zip(a, b):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


def assert_bitwise_twins(host_r, keys_r, host_t, keys_t):
    published = 0
    for ka, kb in zip(keys_r, keys_t):
        sa, sb = host_r.session(ka), host_t.session(kb)
        assert sa.current_frame == sb.current_frame > 0
        assert sa.local_checksum_history == sb.local_checksum_history
        published += len(sa.local_checksum_history)
    assert published > 0  # desync detection really ran
    assert_stacks_equal(host_r.device.stacked_canonical(), host_t.device.stacked_canonical())
    for got, want in zip(host_r.device.checksum_slots(), host_t.device.checksum_slots()):
        np.testing.assert_array_equal(got, want)


def test_resident_bitwise_parity_lossy_fleet():
    """Lossy 16-session fleet (rollbacks every few ticks): the resident
    host equals its dispatch-per-tick twin, while drives really amortize
    (several virtual ticks a drive, no megabatch, no overflow)."""
    host_r, keys_r = build_fleet(resident=True)
    host_t, keys_t = build_fleet(resident=False)
    assert_bitwise_twins(host_r, keys_r, host_t, keys_t)
    dev = host_r.device
    assert dev.driver_dispatches > 0
    assert dev.vticks_executed / dev.driver_dispatches > 1
    assert dev.mailbox.overflows == 0 and dev.mailbox.pending_rows == 0
    assert dev.megabatches == 0 < host_t.device.megabatches
    assert dev.rows_dispatched == host_t.device.rows_dispatched
    section = host_r._host_section()["resident"]
    assert section["driver_dispatches"] == dev.driver_dispatches and section["mailbox_overflows"] == 0


def test_resident_parity_under_starvation_and_disconnect():
    """Hold-shaped scripts, blackhole windows past the prediction gate
    (starved lanes), then a hard disconnect of peer 0 of every match at
    tick 44 (DISCONNECTED statuses in the staged rows): still
    bit-identical, no row dropped."""

    def hostile(net, matches):
        starve = starve_on_tick(net, matches, hole_every=20, hole_len=12)

        def on_tick(t):
            starve(t)
            if t == 44:
                net.set_blackhole([(m, 0) for m in range(len(matches))], True)

        return on_tick

    kw = dict(loss=0.01, ticks=60, scripts_fn=held_scripts, on_tick=hostile, seed=7)
    host_r, keys_r = build_fleet(resident=True, **kw)
    host_t, keys_t = build_fleet(resident=False, **kw)
    assert_bitwise_twins(host_r, keys_r, host_t, keys_t)
    assert host_r.device.mailbox.overflows == 0
    throttled = sum(lane.throttled_ticks for lane in host_r._lanes.values())
    assert throttled > 0 and throttled == sum(lane.throttled_ticks for lane in host_t._lanes.values())


@pytest.mark.parametrize("resident_ticks", [1, 3, 16])
def test_resident_parity_any_cadence(resident_ticks):
    """The drive cadence is a performance knob only: a drive every tick,
    an odd depth and a depth past the desync interval give the same
    bytes."""
    host_r, keys_r = build_fleet(resident=True, resident_ticks=resident_ticks, ticks=24, seed=29)
    host_t, keys_t = build_fleet(resident=False, ticks=24, seed=29)
    assert_bitwise_twins(host_r, keys_r, host_t, keys_t)
    assert host_r.device.mailbox.overflows == 0


def test_resident_checkpoint_restore_round_trip(tmp_path):
    """A checkpoint of a resident host taken with rows still in the
    mailbox drives them first; the port's (non-resident) core and the
    reference's both restore it to the dispatch-per-tick twin's bytes."""
    from ggrs_tpu.models.ex_game import ExGame as RefExGame
    from ggrs_tpu.tpu.backend import MultiSessionDeviceCore as RefCore

    host_r, _ = build_fleet(resident=True, ticks=29, seed=21, settle=False)
    host_t, _ = build_fleet(resident=False, ticks=29, seed=21)
    assert host_r.device.mailbox.pending_rows > 0  # mid fill cycle
    path = str(tmp_path / "resident.npz")
    host_r.checkpoint(path)
    assert host_r.device.mailbox.pending_rows == 0
    want = host_t.device.stacked_canonical()
    assert_stacks_equal(MultiSessionDeviceCore.restore(path, ExGame(4, ENTITIES), device="cpu").stacked_canonical(),
                        want)
    assert_stacks_equal(RefCore.restore(path, RefExGame(num_players=4, num_entities=ENTITIES)).stacked_canonical(),
                        want)
