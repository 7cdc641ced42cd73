"""The port's speculative beam end to end on the CPU: the port's
`SyncTestSession` driving `DeviceRollbackBackend(beam_width=B,
device="cpu")` against the reference's session driving
`TpuRollbackBackend(beam_width=B)` and against the port's beam-off twin,
on the same scripts, tolerance zero — the live state after every tick,
every save's checksum captured at save time, the converted core at the
end, and the beam's counters (hits, partial hits, misses, rollback frames
and frames adopted) equal to the reference's, not merely close."""

import jax
import numpy as np
import pytest

from ggrs_tpu import SessionBuilder as RefSessionBuilder
from ggrs_tpu.models.ex_game import ExGame as RefExGame
from ggrs_tpu.tpu import TpuRollbackBackend
from ggrs_tpu_torch import DeviceRollbackBackend, ExGame, SaveGameState, SessionBuilder
from ggrs_tpu_torch.convert import resim_to_reference

P, N, MP, CD = 2, 64, 6, 4

SCRIPTS = {
    "constant": lambda t, h: 3 + 2 * h,
    "varying": lambda t, h: (t * (h + 3) + h) % 16,
    "toggle": lambda t, h: (5 if (t // 6) % 2 == 0 else 9) + h,
    # players toggling at different periods: switches land at different
    # offsets of one rollback window, so only prefixes can be adopted
    "staggered": lambda t, h: (3 if (t // (5 if h == 0 else 7)) % 2 == 0 else 12) + h,
}
COUNTERS = ("beam_hits", "beam_partial_hits", "beam_misses", "rollback_frames",
            "rollback_frames_adopted")


def session(builder_cls, device_verify=False):
    return (
        builder_cls(input_size=1)
        .with_num_players(P)
        .with_max_prediction_window(MP)
        .with_check_distance(CD)
        .with_device_checksum_verification(device_verify)
        .start_synctest_session()
    )


def port_backend(beam, lazy=0, device_verify=False, **kw):
    return DeviceRollbackBackend(ExGame(P, N), MP, P, device_verify=device_verify, lazy_ticks=lazy,
                                 beam_width=beam, device="cpu", **kw)


def ref_backend(beam, lazy=0, device_verify=False):
    return TpuRollbackBackend(RefExGame(P, N), max_prediction=MP, num_players=P, beam_width=beam,
                              lazy_ticks=lazy, device_verify=device_verify, spec_backend="xla",
                              tick_backend="xla")


def drive(sess, backend, script, ticks, states=None):
    """Run the script; returns every save's (frame, checksum) bound at save
    time, and appends the live state after each tick to `states`."""
    saves = []
    for t in range(ticks):
        for h in range(P):
            sess.add_local_input(h, bytes([script(t, h)]))
        reqs = sess.advance_frame()
        backend.handle_requests(reqs)
        saves += [(r.frame, r.cell.checksum_getter()) for r in reqs if type(r).__name__ == "SaveGameState"]
        if states is not None:
            states.append({k: np.asarray(v) for k, v in jax.device_get(backend.state_numpy()).items()})
    return [(f, g()) for f, g in saves]


def assert_states_equal(a, b, what):
    assert len(a) == len(b)
    for t, (x, y) in enumerate(zip(a, b)):
        for k in y:
            np.testing.assert_array_equal(x[k], y[k], err_msg=f"{what}: state[{k}] at tick {t}")


def counters(backend):
    return {k: getattr(backend, k) for k in COUNTERS}


def compare_three(script, ticks, beam, lazy=0, device_verify=False):
    port, twin, ref = port_backend(beam, lazy, device_verify), port_backend(0, lazy, device_verify), \
        ref_backend(beam, lazy, device_verify)
    states = {name: [] for name in ("port", "twin", "ref")}
    saves = {
        "port": drive(session(SessionBuilder, device_verify), port, script, ticks, states["port"]),
        "twin": drive(session(SessionBuilder, device_verify), twin, script, ticks, states["twin"]),
        "ref": drive(session(RefSessionBuilder, device_verify), ref, script, ticks, states["ref"]),
    }
    assert saves["port"] == saves["twin"] == saves["ref"]
    assert_states_equal(states["port"], states["ref"], "port vs reference")
    assert_states_equal(states["port"], states["twin"], "port vs beam-off twin")
    assert counters(port) == counters(ref)
    assert list(port._launch_value) == list(ref._launch_value)
    core = jax.device_get({"ring": ref.core.ring, "state": ref.core.state, "verify": ref.core.verify})
    got = resim_to_reference(port.core)
    for part in ("ring", "state"):
        for k in core[part]:
            np.testing.assert_array_equal(got[part][k], core[part][k], err_msg=f"{part}/{k}")
    if device_verify:
        port.check()
        ref.check()
    return port


@pytest.mark.parametrize("lazy", [0, 3])
@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_beam_backend_matches_reference_and_twin(name, lazy):
    port = compare_three(SCRIPTS[name], 28, 8, lazy)
    assert port.beam_hits + port.beam_partial_hits > 0


def test_wide_beam_on_a_toggle_matches_reference():
    """The 32-wide toggle of the reference's own suite: branch members hit
    mid-window switches; a majority of rollbacks adopts."""
    port = compare_three(SCRIPTS["toggle"], 40, 32, device_verify=True)
    assert port.beam_hits > port.beam_misses


def test_beam_requires_the_statuses_contract():
    from ggrs_tpu_torch import ConfigError

    class NoContract(ExGame):
        statuses_contract = None

    with pytest.raises(ConfigError, match="statuses_contract"):
        DeviceRollbackBackend(NoContract(P, N), MP, P, beam_width=8, device="cpu")
    # beam off: nothing is ever adopted, no contract needed
    DeviceRollbackBackend(NoContract(P, N), MP, P, device="cpu")


@pytest.mark.parametrize("lazy", [0, 3])
def test_reset_mid_run_equals_a_fresh_backend(lazy):
    """reset() mid-run clears the speculation and every counter (the input
    model survives, as in the reference): a new session then drives it
    exactly like a fresh backend that saw the same first session."""
    script = SCRIPTS["toggle"]
    a, b = port_backend(8, lazy), port_backend(8, lazy)
    for backend in (a, b):
        drive(session(SessionBuilder), backend, script, 17)
        backend.reset()
        assert backend.current_frame == 0 and backend._spec is None
        assert all(v == 0 for v in counters(backend).values())
    fresh = port_backend(8, lazy)
    drive(session(SessionBuilder), fresh, script, 17)
    fresh.reset()
    assert drive(session(SessionBuilder), a, SCRIPTS["varying"], 20) == \
        drive(session(SessionBuilder), fresh, SCRIPTS["varying"], 20)
    assert counters(a) == counters(fresh)


def test_deferred_speculation_equals_launching_in_the_tick():
    script = SCRIPTS["staggered"]
    eager, deferred = port_backend(8), port_backend(8, defer_speculation=True)
    se, sd = session(SessionBuilder), session(SessionBuilder)
    for t in range(24):
        for sess in (se, sd):
            for h in range(P):
                sess.add_local_input(h, bytes([script(t, h)]))
        eager.handle_requests(se.advance_frame())
        deferred.handle_requests(sd.advance_frame())
        deferred.launch_pending_speculation()
    assert counters(eager) == counters(deferred)
    assert eager.beam_hits + eager.beam_partial_hits > 0


def test_warmup_leaves_the_state_and_measures_the_cost():
    warmed, fresh = port_backend(4, speculation_gate="adaptive"), port_backend(4)
    before = {k: v.clone() for k, v in warmed.core.carry.items()}
    warmed.warmup()
    for k, v in before.items():
        assert bool((warmed.core.carry[k] == v).all()), k
    assert warmed._spec_cost_s > 0 and warmed._spec_hist_cost_s > 0
    script = SCRIPTS["constant"]
    assert drive(session(SessionBuilder), warmed, script, 15) == \
        drive(session(SessionBuilder), fresh, script, 15)


def probe(sess, backend, corrupt, check):
    """Drive a constant script, then corrupt the rot plane of the ring slot
    the next speculation anchors on (one tick ahead: current + 1 - depth)
    and tick until the device verdict latches; returns its frame."""
    script = SCRIPTS["constant"]
    for t in range(14):
        for h in range(P):
            sess.add_local_input(h, bytes([script(t, h)]))
        backend.handle_requests(sess.advance_frame())
    corrupt(backend, (backend.current_frame + 1 - backend._depth) % backend.core.ring_len)
    for t in range(14, 18):
        for h in range(P):
            sess.add_local_input(h, bytes([script(t, h)]))
        backend.handle_requests(sess.advance_frame())
        frame = check(backend)
        if frame is not None:
            return frame
    raise AssertionError("the corrupted anchor was never reported")


def test_divergence_probe_latches_with_the_beam_on_like_reference():
    """Adoption copies trajectories into the ring; a corrupted anchor
    snapshot therefore reaches the verify history through the speculation
    (the loaded slot is never read on a full hit). Both stacks latch the
    same frame."""
    from ggrs_tpu.errors import MismatchedChecksum as RefMismatched
    from ggrs_tpu_torch import MismatchedChecksum

    def corrupt_port(b, slot):
        b.core.carry["ring"][slot, 4, 0] += 7

    def corrupt_ref(b, slot):
        ring = dict(b.core.ring)
        ring["rot"] = ring["rot"].at[slot, 0].add(7)
        b.core.ring = ring

    def check(cls):
        def read(b):
            try:
                b.check()
            except cls as exc:
                return exc.frame
            return None
        return read

    port = port_backend(8, device_verify=True)
    ref = ref_backend(8, device_verify=True)
    got = probe(session(SessionBuilder, True), port, corrupt_port, check(MismatchedChecksum))
    want = probe(session(RefSessionBuilder, True), ref, corrupt_ref, check(RefMismatched))
    assert got == want
    assert port.beam_hits > 0


def test_cells_hold_adopted_checksums():
    """An adopted tick's cells resolve through the ledger like a resimulated
    tick's (the lazy checksum batch of the adoption)."""
    backend = port_backend(8)
    sess = session(SessionBuilder)
    cells = []
    for t in range(12):
        for h in range(P):
            sess.add_local_input(h, bytes([3]))
        reqs = sess.advance_frame()
        backend.handle_requests(reqs)
        cells += [r.cell for r in reqs if isinstance(r, SaveGameState)]
    assert backend.beam_hits > 0
    assert all(isinstance(c.checksum, int) for c in cells)
