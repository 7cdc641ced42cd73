"""Durable checkpoint/resume on the port (ggrs_tpu_torch/utils/checkpoint.py,
`DeviceSyncTestSession.save`/`restore`, `DeviceRollbackBackend.save`/
`restore`), on the CPU, tolerance zero.

The first part mirrors tests/test_checkpoint.py case by case on the port.
The second crosses the two stacks for ex_game, arena and swarm, the fused
session and the request-path backend (device verification and lazy ticks
on): a file the port writes restores into the reference and continues
bit-identical to the reference's uninterrupted run, a file the reference
writes does the same in the port, and the two stacks' files for the same
run hold the same arrays under the same names, shapes and dtypes."""

import json
import os
import signal
import subprocess
import sys
import time
import zipfile

import jax
import numpy as np
import pytest
import torch

from ggrs_tpu import SessionBuilder as RefSessionBuilder
from ggrs_tpu.models.arena import Arena as RefArena
from ggrs_tpu.models.ex_game import ExGame as RefExGame
from ggrs_tpu.models.swarm import Swarm as RefSwarm
from ggrs_tpu.tpu import TpuRollbackBackend, TpuSyncTestSession
from ggrs_tpu_torch import (
    Arena,
    CheckpointIncompatible,
    DeviceRollbackBackend,
    DeviceSyncTestSession,
    ExGame,
    MismatchedChecksum,
    SessionBuilder,
    Swarm,
)
from ggrs_tpu_torch.convert import CARRY_KEYS, carry_to_reference
from ggrs_tpu_torch.utils import checkpoint as ck
from ggrs_tpu_torch.utils.checkpoint import (
    CHECKPOINT_FORMAT_VERSION,
    atomic_write_bytes,
    load_device_checkpoint,
    save_device_checkpoint,
)

PLAYERS = 2
ENTITIES = 64


def scripted(frames, seed=23, mod=16):
    rng = np.random.default_rng(seed)
    return rng.integers(0, mod, size=(frames, PLAYERS, 1), dtype=np.uint8)


def assert_tree_equal(got, want, path="tree"):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_tree_equal(got[k], want[k], f"{path}/{k}")
        return
    g, w = np.asarray(got), np.asarray(want)
    assert g.dtype == w.dtype, f"{path}: {g.dtype} != {w.dtype}"
    assert g.shape == w.shape, f"{path}: {g.shape} != {w.shape}"
    np.testing.assert_array_equal(g, w, err_msg=path)


def synctest_session(builder_cls, device_verify=False, check_distance=4, max_prediction=8):
    return (
        builder_cls(input_size=1)
        .with_num_players(PLAYERS)
        .with_max_prediction_window(max_prediction)
        .with_check_distance(check_distance)
        .with_device_checksum_verification(device_verify)
        .start_synctest_session()
    )


def drive(handler, sess, inputs, lo, hi):
    for f in range(lo, hi):
        for h in range(PLAYERS):
            sess.add_local_input(h, bytes(inputs[f, h]))
        handler.handle_requests(sess.advance_frame())


# ----------------------------------------------------------------------
# tests/test_checkpoint.py, case by case, on the port
# ----------------------------------------------------------------------


def test_roundtrip_flatten(tmp_path):
    tree = {
        "a": np.arange(6, dtype=np.int32).reshape(2, 3),
        "nested": {"x": np.zeros((), np.uint32), "y": np.ones(4, np.uint8)},
    }
    path = str(tmp_path / "ck.npz")
    save_device_checkpoint(path, tree, {"n": 42, "s": "hi"})
    got, meta = load_device_checkpoint(path)
    assert meta == {"n": 42, "s": "hi"}
    np.testing.assert_array_equal(got["a"], tree["a"])
    np.testing.assert_array_equal(got["nested"]["y"], tree["nested"]["y"])
    assert ck._unflatten(ck._flatten(tree)).keys() == tree.keys()


def test_fused_session_resume_bitexact(tmp_path):
    inputs = scripted(90)
    game = ExGame(PLAYERS, ENTITIES)

    straight = DeviceSyncTestSession(game, PLAYERS, check_distance=5, input_delay=2, device="cpu")
    straight.advance_frames(inputs)

    resumed = DeviceSyncTestSession(game, PLAYERS, check_distance=5, input_delay=2, device="cpu")
    resumed.advance_frames(inputs[:50])
    path = str(tmp_path / "sess.npz")
    resumed.save(path)

    back = DeviceSyncTestSession.restore(path, ExGame(PLAYERS, ENTITIES), device="cpu")
    assert back.current_frame == 50
    back.advance_frames(inputs[50:])
    back.check()

    a, b = straight.state_numpy(), back.state_numpy()
    for key in ("frame", "pos", "vel", "rot"):
        np.testing.assert_array_equal(a[key], b[key])
    for k in CARRY_KEYS:
        assert torch.equal(straight.carry[k], back.carry[k]), k


def test_backend_resume_bitexact(tmp_path):
    inputs = scripted(60, seed=7)
    game = ExGame(PLAYERS, ENTITIES)
    straight = DeviceRollbackBackend(game, 8, PLAYERS, device="cpu")
    drive(straight, synctest_session(SessionBuilder), inputs, 0, 60)

    first = DeviceRollbackBackend(game, 8, PLAYERS, device="cpu")
    sess = synctest_session(SessionBuilder)
    drive(first, sess, inputs, 0, 35)
    path = str(tmp_path / "backend.npz")
    first.save(path)

    # the session's host-side queues are not part of the device checkpoint:
    # the same session object continues against the restored backend
    back = DeviceRollbackBackend.restore(path, ExGame(PLAYERS, ENTITIES), device="cpu")
    assert back.current_frame == 35
    drive(back, sess, inputs, 35, 60)

    a, b = straight.state_numpy(), back.state_numpy()
    for key in ("frame", "pos", "vel", "rot"):
        np.testing.assert_array_equal(a[key], b[key])
    for k, v in straight.core.carry.items():
        assert torch.equal(v, back.core.carry[k]), k


def test_backend_device_verify_survives_restore(tmp_path):
    """A checkpointed device-verify run resumes with its first-seen history
    and its latch: a divergence injected before the save is still reported
    after restore."""
    inputs = scripted(40, seed=9)
    backend = DeviceRollbackBackend(ExGame(PLAYERS, ENTITIES), 8, PLAYERS, device_verify=True, device="cpu")
    sess = synctest_session(SessionBuilder, device_verify=True)
    drive(backend, sess, inputs, 0, 20)
    backend.check()  # clean so far
    # corrupt a saved ring slot: the next re-save of that frame must differ
    slot = (backend.current_frame - 4) % backend.core.ring_len
    backend.core.carry["ring"][slot, 0, 0] += 7
    drive(backend, sess, inputs, 20, 26)

    path = str(tmp_path / "dv.npz")
    backend.save(path)
    restored = DeviceRollbackBackend.restore(path, ExGame(PLAYERS, ENTITIES), device="cpu")
    assert restored.core.device_verify, "device_verify lost in restore"
    with pytest.raises(MismatchedChecksum):
        restored.check()


@pytest.mark.parametrize("family,backends", [
    ("ex_game", ("torch", "cuda-fused", "cuda-tiled")),
    ("arena", ("torch", "cuda-fused", "cuda-tiled", "cuda-tiled-injected")),
    ("swarm", ("torch", "cuda-fused", "cuda-tiled")),
])
def test_fused_resume_across_backends(tmp_path, family, backends):
    """Checkpoints are backend-agnostic: a run saved under the plain scan
    resumes bit-exactly under the plain twin of every kernel route."""
    _, port_game, mod = FAMILIES[family]
    script = np.random.default_rng(3).integers(0, mod, size=(24, 2, 1), dtype=np.uint8)
    sess = DeviceSyncTestSession(port_game(2, 256), 2, 3, backend="torch", device="cpu")
    sess.advance_frames(script[:12])
    path = str(tmp_path / "xb.npz")
    sess.save(path)

    resumed = {}
    for backend in backends:
        r = DeviceSyncTestSession.restore(path, port_game(2, 256), backend=backend, device="cpu")
        assert r.backend == backend
        r.advance_frames(script[12:])
        r.check()
        resumed[backend] = r.carry
    for backend in backends[1:]:
        for k in CARRY_KEYS:
            assert torch.equal(resumed[backend][k], resumed["torch"][k]), (backend, k)


def test_backend_restore_preserves_performance_knobs(tmp_path):
    """The knobs the port has (lazy_ticks, the speculation gate,
    defer_speculation, the beam width) round-trip through the meta; the
    reference's knobs the port lacks are written at its defaults, the
    kernel choices as "auto"; a file that predates the knobs restores with
    the defaults."""
    game = ExGame(PLAYERS, ENTITIES)
    backend = DeviceRollbackBackend(game, 6, PLAYERS, beam_width=4, lazy_ticks=5,
                                    speculation_gate="adaptive", defer_speculation=True, device="cpu")
    path = str(tmp_path / "knobs.npz")
    backend.save(path)

    restored = DeviceRollbackBackend.restore(path, ExGame(PLAYERS, ENTITIES), device="cpu")
    assert restored.lazy_ticks == 5
    assert restored.speculation_gate == "adaptive"
    assert restored.defer_speculation is True
    assert restored.beam_width == 4
    _, meta = load_device_checkpoint(path)
    assert meta["async_dispatch"] is False and meta["async_inflight"] == 4 and meta["depth_routing"] is True
    assert meta["spec_backend"] == meta["tick_backend"] == "auto"

    tree, meta = load_device_checkpoint(path)
    for key in ("lazy_ticks", "speculation_gate", "defer_speculation", "spec_backend", "tick_backend"):
        meta.pop(key)
    old_path = str(tmp_path / "old.npz")
    save_device_checkpoint(old_path, tree, meta)
    legacy = DeviceRollbackBackend.restore(old_path, ExGame(PLAYERS, ENTITIES), device="cpu")
    assert legacy.lazy_ticks == 0
    assert legacy.speculation_gate == "always"


def _small_checkpoint(tmp_path, name="fmt.npz"):
    tree = {
        "rings": {"pos": np.arange(12, dtype=np.int32).reshape(3, 4)},
        "states": {"pos": np.ones((4,), np.uint32)},
    }
    path = str(tmp_path / name)
    save_device_checkpoint(path, tree, {"kind": "test", "n": 1})
    return path, tree


def test_checkpoint_stamps_version_and_manifest(tmp_path):
    path, tree = _small_checkpoint(tmp_path)
    with np.load(path) as data:  # raw read: the stamp is in the file...
        meta = json.loads(bytes(data["__meta__"]).decode("utf-8"))
    fmt = meta["__format__"]
    assert fmt["version"] == CHECKPOINT_FORMAT_VERSION == 2
    assert set(fmt["manifest"]) == {"t/rings/pos", "t/states/pos"}
    # ...and the stamp is internal: callers' meta round-trips unchanged
    got, meta_back = load_device_checkpoint(path)
    assert meta_back == {"kind": "test", "n": 1}
    np.testing.assert_array_equal(got["rings"]["pos"], tree["rings"]["pos"])


def test_checkpoint_truncated_file_raises_typed(tmp_path):
    path, _ = _small_checkpoint(tmp_path)
    blob = open(path, "rb").read()
    for cut in (len(blob) // 2, 10):
        with open(path, "wb") as f:
            f.write(blob[:cut])
        with pytest.raises(CheckpointIncompatible):
            load_device_checkpoint(path)


def test_checkpoint_future_version_raises_with_both_versions(tmp_path, monkeypatch):
    path, tree = _small_checkpoint(tmp_path)
    monkeypatch.setattr(ck, "CHECKPOINT_FORMAT_VERSION", CHECKPOINT_FORMAT_VERSION + 5)
    ck.save_device_checkpoint(path, tree, {"kind": "test"})  # "a newer build wrote it"
    monkeypatch.undo()
    with pytest.raises(CheckpointIncompatible) as exc_info:
        ck.load_device_checkpoint(path)
    assert exc_info.value.found == CHECKPOINT_FORMAT_VERSION + 5
    assert exc_info.value.expected == CHECKPOINT_FORMAT_VERSION


def test_checkpoint_manifest_catches_missing_payload(tmp_path):
    path, _ = _small_checkpoint(tmp_path)
    clipped = str(tmp_path / "clipped.npz")
    with zipfile.ZipFile(path) as src, zipfile.ZipFile(clipped, "w") as dst:
        for item in src.infolist():
            if item.filename != "t/states/pos.npy":  # drop one payload
                dst.writestr(item, src.read(item.filename))
    with pytest.raises(CheckpointIncompatible) as exc_info:
        load_device_checkpoint(clipped)
    assert exc_info.value.expected == "t/states/pos"


def test_checkpoint_legacy_unstamped_still_loads(tmp_path):
    """Pre-version checkpoints (no __format__ in meta) load best-effort."""
    path = str(tmp_path / "legacy.npz")
    flat = {
        "t/a": np.arange(3, dtype=np.int32),
        "__meta__": np.frombuffer(json.dumps({"kind": "old"}).encode(), dtype=np.uint8),
    }
    np.savez_compressed(path, **flat)
    tree, meta = load_device_checkpoint(path)
    assert meta == {"kind": "old"}
    np.testing.assert_array_equal(tree["a"], np.arange(3, dtype=np.int32))


def test_atomic_write_failure_leaves_previous_file_intact(tmp_path, monkeypatch):
    """A write that dies at the commit point leaves the previous complete
    file at the path and no visible temp file."""
    path = str(tmp_path / "state.bin")
    atomic_write_bytes(path, b"v1" * 1000)

    def dying_replace(src, dst):
        raise OSError("simulated death at the commit point")

    monkeypatch.setattr(os, "replace", dying_replace)
    with pytest.raises(OSError):
        atomic_write_bytes(path, b"v2" * 1000)
    monkeypatch.undo()
    with open(path, "rb") as f:
        assert f.read() == b"v1" * 1000
    assert [p for p in os.listdir(tmp_path) if ".tmp." in p] == []


def test_save_device_checkpoint_crash_mid_write_keeps_old_checkpoint(tmp_path, monkeypatch):
    path = str(tmp_path / "host.npz")
    tree = {"a": np.arange(8, dtype=np.int32)}
    save_device_checkpoint(path, tree, {"kind": "t"})

    def dying_savez(buf, **arrays):
        buf.write(b"PK\x03\x04partial")  # a torn zip prefix
        raise RuntimeError("killed mid-write")

    monkeypatch.setattr(np, "savez_compressed", dying_savez)
    with pytest.raises(RuntimeError):
        save_device_checkpoint(path, {"a": np.arange(8, dtype=np.int32) + 1}, {"kind": "t"})
    monkeypatch.undo()
    loaded, meta = load_device_checkpoint(path)
    np.testing.assert_array_equal(loaded["a"], tree["a"])
    assert meta == {"kind": "t"}


def test_atomic_write_survives_real_sigkill_mid_write(tmp_path):
    """A child SIGKILLed while overwriting the same path in a tight loop can
    never leave a torn file."""
    path = str(tmp_path / "hammer.bin")
    child = subprocess.Popen([
        sys.executable, "-c",
        "import sys; sys.path.insert(0, %r)\n"
        "from ggrs_tpu_torch.utils.checkpoint import atomic_write_bytes\n"
        "i = 0\n"
        "while True:\n"
        "    atomic_write_bytes(%r, bytes([i %% 256]) * 65536)\n"
        "    i += 1\n"
        % (os.getcwd(), path),
    ], cwd=os.getcwd())
    try:
        deadline = time.monotonic() + 20
        while not os.path.exists(path):
            assert child.poll() is None, "writer died before first write"
            assert time.monotonic() < deadline, "writer never wrote"
            time.sleep(0.01)
        time.sleep(0.25)
    finally:
        child.send_signal(signal.SIGKILL)
        child.wait(timeout=10)
    with open(path, "rb") as f:
        data = f.read()
    assert len(data) == 65536
    assert data == bytes([data[0]]) * 65536


def test_restore_refuses_another_kind_or_world(tmp_path):
    """A session file is no backend file and the reverse, and a file of
    another world size is refused at the door, all typed."""
    sess = DeviceSyncTestSession(ExGame(PLAYERS, ENTITIES), PLAYERS, 3, device="cpu")
    sess.advance_frames(scripted(6))
    sess_path = str(tmp_path / "s.npz")
    sess.save(sess_path)
    backend = DeviceRollbackBackend(ExGame(PLAYERS, ENTITIES), 8, PLAYERS, device="cpu")
    backend_path = str(tmp_path / "b.npz")
    backend.save(backend_path)
    with pytest.raises(CheckpointIncompatible, match="backend"):
        DeviceRollbackBackend.restore(sess_path, ExGame(PLAYERS, ENTITIES), device="cpu")
    with pytest.raises(CheckpointIncompatible, match="session"):
        DeviceSyncTestSession.restore(backend_path, ExGame(PLAYERS, ENTITIES), device="cpu")
    with pytest.raises(CheckpointIncompatible, match="shape"):
        DeviceSyncTestSession.restore(sess_path, ExGame(PLAYERS, 2 * ENTITIES), device="cpu")
    with pytest.raises(CheckpointIncompatible, match="shape"):
        DeviceRollbackBackend.restore(backend_path, ExGame(PLAYERS, 2 * ENTITIES), device="cpu")


def test_injection_route_resumes_mid_run(tmp_path):
    """The injection route derives its reduction table from the frame the
    session hands it, so a session restored mid-run on it (here after a
    kill probe, where its rolled table keeps sums the XLA scan does not)
    continues bit-identical to the run that never stopped, and latches the
    same frame."""
    d = 4
    script = np.random.default_rng(8).integers(0, 64, size=(30, 2, 1), dtype=np.uint8)

    def start():
        s = DeviceSyncTestSession(Arena(2, 256), 2, d, backend="cuda-tiled-injected", device="cpu")
        s.advance_frames(script[:12])
        s.carry["ring"][(12 - d) % (d + 2), 4, :48] = 0  # kill entities in the slot loaded next
        s.advance_frames(script[12:17])
        return s

    straight = start()
    straight.advance_frames(script[17:])
    first = start()
    path = str(tmp_path / "inj.npz")
    first.save(path)
    for backend in ("cuda-tiled-injected", "cuda-fused"):  # K1's cache keeps the same sums
        back = DeviceSyncTestSession.restore(path, Arena(2, 256), backend=backend, device="cpu")
        back.advance_frames(script[17:])
        for k in CARRY_KEYS:
            assert torch.equal(back.carry[k], straight.carry[k]), (backend, k)
        with pytest.raises(MismatchedChecksum) as err:
            back.check()
        assert err.value.frame == 12 - d + 1


# ----------------------------------------------------------------------
# across the stacks: ex_game, arena and swarm
# ----------------------------------------------------------------------

# family -> (reference game class, port game class, inputs below)
FAMILIES = {
    "ex_game": (RefExGame, ExGame, 16),
    "arena": (RefArena, Arena, 64),
    "swarm": (RefSwarm, Swarm, 128),
}
CROSS_N = 128
FRAMES, SAVE_AT = 24, 11  # the save falls past check_distance
D, DELAY = 4, 1
MP, LAZY = 8, 4


def raw_file(path):
    """A checkpoint as it lies on disk: member -> array, and the meta JSON."""
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files if k != "__meta__"}
        meta = json.loads(bytes(data["__meta__"]).decode("utf-8"))
    return arrays, meta


def assert_files_equal(port_path, ref_path):
    port_arrays, port_meta = raw_file(port_path)
    ref_arrays, ref_meta = raw_file(ref_path)
    assert sorted(port_arrays) == sorted(ref_arrays)
    for name, want in ref_arrays.items():
        got = port_arrays[name]
        assert (got.dtype.str, got.shape) == (want.dtype.str, want.shape), name
        np.testing.assert_array_equal(got, want, err_msg=name)
    return port_meta, ref_meta


@pytest.fixture(scope="module")
def session_runs(tmp_path_factory):
    """Per family: both stacks' fused sessions over one script, each saved
    at SAVE_AT and run on uninterrupted; each stack's file restored in the
    other stack and run on from there."""
    runs = {}
    for family, (ref_game, port_game, mod) in FAMILIES.items():
        folder = tmp_path_factory.mktemp(f"session_{family}")
        script = scripted(FRAMES, seed=len(family), mod=mod)
        ref = TpuSyncTestSession(ref_game(PLAYERS, CROSS_N), PLAYERS, D, input_delay=DELAY, backend="xla")
        port = DeviceSyncTestSession(port_game(PLAYERS, CROSS_N), PLAYERS, D, input_delay=DELAY, device="cpu")
        ref.advance_frames(script[:SAVE_AT])
        port.advance_frames(script[:SAVE_AT])
        paths = {"ref": str(folder / "ref.npz"), "port": str(folder / "port.npz")}
        ref.save(paths["ref"])
        port.save(paths["port"])
        ref.advance_frames(script[SAVE_AT:])
        port.advance_frames(script[SAVE_AT:])
        ref_from_port = TpuSyncTestSession.restore(paths["port"], ref_game(PLAYERS, CROSS_N), backend="xla")
        ref_from_port.advance_frames(script[SAVE_AT:])
        port_from_ref = DeviceSyncTestSession.restore(paths["ref"], port_game(PLAYERS, CROSS_N), device="cpu")
        port_from_ref.advance_frames(script[SAVE_AT:])
        runs[family] = dict(ref=ref, port=port, ref_from_port=ref_from_port, port_from_ref=port_from_ref,
                            paths=paths)
    return runs


@pytest.mark.parametrize("family", list(FAMILIES))
def test_session_port_file_restores_in_reference(session_runs, family):
    run = session_runs[family]
    back = run["ref_from_port"]
    assert back.current_frame == FRAMES
    back.check()
    assert_tree_equal(jax.device_get(back.carry), jax.device_get(run["ref"].carry))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_session_reference_file_restores_in_port(session_runs, family):
    run = session_runs[family]
    back = run["port_from_ref"]
    assert back.current_frame == FRAMES
    back.check()
    for k in CARRY_KEYS:
        assert torch.equal(back.carry[k], run["port"].carry[k]), k
    assert_tree_equal(carry_to_reference(back.carry), jax.device_get(run["ref"].carry))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_session_files_hold_equal_arrays(session_runs, family):
    paths = session_runs[family]["paths"]
    port_meta, ref_meta = assert_files_equal(paths["port"], paths["ref"])
    assert port_meta == ref_meta


@pytest.fixture(scope="module")
def backend_runs(tmp_path_factory):
    """Per family: both stacks' request paths (device verification, lazy
    ticks) driven in lockstep, saved at SAVE_AT; each stack's file
    restored in the other stack, which drives it on from there with its
    own session; beside both, each stack's uninterrupted run."""
    runs = {}
    for family, (ref_game, port_game, mod) in FAMILIES.items():
        folder = tmp_path_factory.mktemp(f"backend_{family}")
        inputs = scripted(FRAMES, seed=40 + len(family), mod=mod)

        def ref_backend():
            return TpuRollbackBackend(ref_game(PLAYERS, CROSS_N), max_prediction=MP, num_players=PLAYERS,
                                      device_verify=True, lazy_ticks=LAZY)

        def port_backend():
            return DeviceRollbackBackend(port_game(PLAYERS, CROSS_N), MP, PLAYERS, device_verify=True,
                                         lazy_ticks=LAZY, device="cpu")

        ref_straight, port_straight = ref_backend(), port_backend()
        drive(ref_straight, synctest_session(RefSessionBuilder, True, D, MP), inputs, 0, FRAMES)
        drive(port_straight, synctest_session(SessionBuilder, True, D, MP), inputs, 0, FRAMES)

        ref, port = ref_backend(), port_backend()
        ref_sess = synctest_session(RefSessionBuilder, True, D, MP)
        port_sess = synctest_session(SessionBuilder, True, D, MP)
        drive(ref, ref_sess, inputs, 0, SAVE_AT)
        drive(port, port_sess, inputs, 0, SAVE_AT)
        paths = {"ref": str(folder / "ref.npz"), "port": str(folder / "port.npz")}
        ref.save(paths["ref"])
        port.save(paths["port"])
        ref_from_port = TpuRollbackBackend.restore(paths["port"], ref_game(PLAYERS, CROSS_N))
        port_from_ref = DeviceRollbackBackend.restore(paths["ref"], port_game(PLAYERS, CROSS_N), device="cpu")
        drive(ref_from_port, ref_sess, inputs, SAVE_AT, FRAMES)
        drive(port_from_ref, port_sess, inputs, SAVE_AT, FRAMES)
        runs[family] = dict(ref_straight=ref_straight, port_straight=port_straight, ref_from_port=ref_from_port,
                            port_from_ref=port_from_ref, paths=paths)
    return runs


def ref_core_tree(backend):
    backend.flush()
    core = backend.core
    return jax.device_get({"ring": core.ring, "state": core.state, "verify": core.verify})


@pytest.mark.parametrize("family", list(FAMILIES))
def test_backend_port_file_restores_in_reference(backend_runs, family):
    run = backend_runs[family]
    back = run["ref_from_port"]
    assert back.current_frame == FRAMES and back.core.device_verify and back.lazy_ticks == LAZY
    back.check()
    assert_tree_equal(ref_core_tree(back), ref_core_tree(run["ref_straight"]))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_backend_reference_file_restores_in_port(backend_runs, family):
    run = backend_runs[family]
    back = run["port_from_ref"]
    assert back.current_frame == FRAMES and back.core.device_verify and back.lazy_ticks == LAZY
    back.check()
    back.flush()
    for k, v in run["port_straight"].core.carry.items():
        assert torch.equal(back.core.carry[k], v), k
    assert_tree_equal(back.core.checkpoint_tree(), ref_core_tree(run["ref_straight"]))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_backend_files_hold_equal_arrays(backend_runs, family):
    paths = backend_runs[family]["paths"]
    port_meta, ref_meta = assert_files_equal(paths["port"], paths["ref"])
    # the same meta keys; the reference writes its resolved kernel choices
    # where the port writes "auto"
    assert set(port_meta) == set(ref_meta)
    for key in set(ref_meta) - {"spec_backend", "tick_backend", "__format__"}:
        assert port_meta[key] == ref_meta[key], key
    assert port_meta["__format__"] == ref_meta["__format__"]
