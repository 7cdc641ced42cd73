"""The port's request path on the CPU — `SessionBuilder().
start_synctest_session()` driving `DeviceRollbackBackend(device="cpu")` —
against the reference's builder driving `TpuRollbackBackend` (tick_backend
"xla" and "pallas-interpret") on the same seeded inputs, tolerance zero:
every save's checksum captured at save time, the final state, the current
frame and the converted core. Also against the reference's numpy oracle
fulfilling the port session's requests one by one, and a divergence probe
that both stacks must report at the same frame."""

import jax
import numpy as np
import pytest

from ggrs_tpu import SessionBuilder as RefSessionBuilder
from ggrs_tpu.errors import MismatchedChecksum as RefMismatchedChecksum
from ggrs_tpu.models import ex_game as ref_ex_game
from ggrs_tpu.ops.fixed_point import combine_checksum as ref_combine
from ggrs_tpu.tpu import TpuRollbackBackend
from ggrs_tpu_torch import (
    ConfigError,
    DeviceRollbackBackend,
    ExGame,
    MismatchedChecksum,
    SessionBuilder,
    SnapshotRef,
)
from ggrs_tpu_torch.convert import resim_to_reference
from ggrs_tpu_torch.types import AdvanceFrame, LoadGameState, SaveGameState

P, N, MP, FRAMES = 2, 128, 8, 36


def session(builder_cls, cd, delay, device_verify):
    return (
        builder_cls(input_size=1)
        .with_num_players(P)
        .with_max_prediction_window(MP)
        .with_check_distance(cd)
        .with_input_delay(delay)
        .with_device_checksum_verification(device_verify)
        .start_synctest_session()
    )


def port_stack(cd, delay, lazy, device_verify):
    backend = DeviceRollbackBackend(ExGame(P, N), MP, P, device_verify=device_verify,
                                    lazy_ticks=lazy, device="cpu")
    return session(SessionBuilder, cd, delay, device_verify), backend


def ref_stack(cd, delay, lazy, device_verify, tick_backend):
    backend = TpuRollbackBackend(ref_ex_game.ExGame(P, N), max_prediction=MP, num_players=P,
                                 device_verify=device_verify, lazy_ticks=lazy,
                                 tick_backend=tick_backend)
    return session(RefSessionBuilder, cd, delay, device_verify), backend


def tick(sess, backend, rng, saves):
    for h in range(P):
        sess.add_local_input(h, bytes([int(rng.integers(0, 16))]))
    reqs = sess.advance_frame()
    backend.handle_requests(reqs)
    # ring cells are reused: bind each save's checksum getter now
    saves += [(r.frame, r.cell.checksum_getter()) for r in reqs if type(r).__name__ == "SaveGameState"]


def drive(sess, backend, frames=FRAMES, seed=3):
    rng = np.random.default_rng(seed)
    saves = []
    for _ in range(frames):
        tick(sess, backend, rng, saves)
    return [(f, g()) for f, g in saves]


def ref_core_leaves(backend):
    core = backend.core
    return jax.device_get({"ring": core.ring, "state": core.state, "verify": core.verify})


def assert_tree_equal(got, want, path="core"):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_tree_equal(got[k], want[k], f"{path}/{k}")
        return
    g, w = np.asarray(got), np.asarray(want)
    assert g.dtype == w.dtype, f"{path}: {g.dtype} != {w.dtype}"
    np.testing.assert_array_equal(g, w, err_msg=path)


def compare_stacks(cd, delay, lazy, device_verify, tick_backend):
    ps, pb = port_stack(cd, delay, lazy, device_verify)
    rs, rb = ref_stack(cd, delay, lazy, device_verify, tick_backend)
    port_saves, ref_saves = drive(ps, pb), drive(rs, rb)
    assert len(port_saves) == len(ref_saves) > FRAMES
    assert port_saves == ref_saves
    assert_tree_equal(pb.state_numpy(), jax.device_get(rb.state_numpy()), "state")
    assert pb.current_frame == rb.current_frame == FRAMES
    assert_tree_equal(resim_to_reference(pb.core), ref_core_leaves(rb))
    if device_verify:
        pb.check()
        rb.check()
    else:
        ps.flush_checksum_checks()


XLA_CASES = [(cd, delay, lazy, dv) for cd in (2, 7) for delay in (0, 2) for lazy in (0, 5)
             for dv in (False, True)]
# the reference's Pallas tick kernel runs only multi-row (lazy) dispatches
# on a world this small; the pair covers both distances, delays and verdicts
PALLAS_CASES = [(2, 2, 5, True), (7, 0, 5, False)]


@pytest.mark.parametrize("cd,delay,lazy,device_verify", XLA_CASES)
def test_request_path_matches_reference_xla(cd, delay, lazy, device_verify):
    compare_stacks(cd, delay, lazy, device_verify, "xla")


@pytest.mark.parametrize("cd,delay,lazy,device_verify", PALLAS_CASES)
def test_request_path_matches_reference_tick_kernel(cd, delay, lazy, device_verify):
    compare_stacks(cd, delay, lazy, device_verify, "pallas-interpret")


class OracleRunner:
    """Fulfils the ordered request list on the host with the reference's
    numpy oracle — the straight, unfused execution of the same contract."""

    def __init__(self):
        self.state = ref_ex_game.init_oracle(P, N)

    def handle_requests(self, requests):
        for req in requests:
            if isinstance(req, SaveGameState):
                assert int(self.state["frame"]) == req.frame
                copy = {k: np.copy(v) for k, v in self.state.items()}
                req.cell.save(req.frame, copy, ref_combine(*ref_ex_game.checksum_oracle(self.state)))
            elif isinstance(req, LoadGameState):
                self.state = {k: np.copy(v) for k, v in req.cell.load().items()}
            elif isinstance(req, AdvanceFrame):
                inputs = np.array([buf[0] for buf, _ in req.inputs], dtype=np.uint8)
                statuses = np.array([int(s) for _, s in req.inputs], dtype=np.int32)
                self.state = ref_ex_game.step_oracle(self.state, inputs, statuses, P)


@pytest.mark.parametrize("cd,lazy", [(2, 0), (7, 5)])
def test_request_path_matches_numpy_oracle(cd, lazy):
    ps, pb = port_stack(cd, 0, lazy, False)
    oracle_sess = session(SessionBuilder, cd, 0, False)
    oracle = OracleRunner()
    port_saves, oracle_saves = drive(ps, pb), drive(oracle_sess, oracle)
    assert port_saves == oracle_saves
    dev = pb.state_numpy()
    for key in ("frame", "pos", "vel", "rot"):
        np.testing.assert_array_equal(dev[key], oracle.state[key])


def test_cells_hold_snapshot_refs_and_lazy_checksums():
    ps, pb = port_stack(2, 0, 0, False)
    rng = np.random.default_rng(0)
    cells = []
    for _ in range(6):
        for h in range(P):
            ps.add_local_input(h, bytes([int(rng.integers(0, 16))]))
        reqs = ps.advance_frame()
        pb.handle_requests(reqs)
        cells += [r.cell for r in reqs if isinstance(r, SaveGameState)]
    assert all(isinstance(c.load(), SnapshotRef) for c in cells)
    assert all(isinstance(c.checksum, int) for c in cells)


@pytest.mark.parametrize("lazy", [0, 5])
def test_reset_gives_a_fresh_session(lazy):
    """A backend reset mid-run (lazy rows still buffered) then driven by a
    new session equals a fresh backend on the same inputs."""
    ps, pb = port_stack(4, 0, lazy, True)
    drive(ps, pb, frames=13, seed=1)
    pb.reset()
    assert pb.current_frame == 0
    again = drive(session(SessionBuilder, 4, 0, True), pb, seed=2)
    fs, fb = port_stack(4, 0, lazy, True)
    assert again == drive(fs, fb, seed=2)
    assert_tree_equal(resim_to_reference(pb.core), resim_to_reference(fb.core))
    pb.check()


def corrupt_port(backend, slot):
    backend.core.carry["ring"][slot, 4, 0] += 7  # the heading plane: never clamped


def corrupt_ref(backend, slot):
    ring = dict(backend.core.ring)
    ring["rot"] = ring["rot"].at[slot, 0].add(7)
    backend.core.ring = ring


def run_probe(sess, backend, corrupt, mismatch_cls, device_verify, cd):
    """Drive, corrupt the rot plane of the ring slot the next rollback
    loads, then tick until the stack reports the mismatch; returns its
    frame (the host path raises from the session, the device path from
    backend.check())."""
    rng = np.random.default_rng(9)
    saves = []
    for _ in range(20):
        tick(sess, backend, rng, saves)
    backend.flush()
    corrupt(backend, (backend.current_frame - cd) % backend.core.ring_len)
    for _ in range(4):
        try:
            tick(sess, backend, rng, saves)
            if device_verify:
                backend.check()
        except mismatch_cls as exc:
            return exc.frame
    raise AssertionError("the corrupted ring slot was never reported")


@pytest.mark.parametrize("lazy", [0, 5])
@pytest.mark.parametrize("device_verify", [False, True])
def test_divergence_probe_reports_the_same_frame(device_verify, lazy):
    cd = 4
    ps, pb = port_stack(cd, 0, lazy, device_verify)
    rs, rb = ref_stack(cd, 0, lazy, device_verify, "xla")
    port_frame = run_probe(ps, pb, corrupt_port, MismatchedChecksum, device_verify, cd)
    ref_frame = run_probe(rs, rb, corrupt_ref, RefMismatchedChecksum, device_verify, cd)
    assert port_frame == ref_frame


def test_backend_on_cuda_without_a_card_raises_config_error(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ConfigError):
        DeviceRollbackBackend(ExGame(P, N), MP, P)
    with pytest.raises(ValueError):  # the stdlib face is kept
        DeviceRollbackBackend(ExGame(P, N), MP, P, device="cuda")
