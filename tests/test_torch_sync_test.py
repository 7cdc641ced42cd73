"""The port's fused SyncTest (ggrs_tpu_torch/device/) against the reference
`TpuSyncTestSession` and `PallasTiledSyncTestCore`, full carry, tolerance
zero, over multi-batch runs with rollbacks, input delay and an injected
divergence; plus the port's package rules (no jax, no ggrs_tpu, no silent
CPU). Each CUDA kernel against its plain version, on a card only, is in
test_torch_card.py.

The reference runs as its own tests run it on the CPU: backend "xla", and
the Pallas kernels in interpret mode. Every configuration is compared with
"xla"; a covering subset (each (d, N), both input delays, both player
counts) with the interpret-mode kernels, which cost several seconds each.
"""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ggrs_tpu.errors import MismatchedChecksum as RefMismatchedChecksum
from ggrs_tpu.models.ex_game import ExGame as RefExGame
from ggrs_tpu.tpu import TpuSyncTestSession
from ggrs_tpu.tpu.pallas_tiled import PallasTiledSyncTestCore
from ggrs_tpu_torch import ConfigError, DeviceSyncTestSession, ExGame, MismatchedChecksum
from ggrs_tpu_torch.convert import CARRY_KEYS, carry_from_reference, carry_to_reference
from ggrs_tpu_torch.device import sync_test
from ggrs_tpu_torch.device.fused_core import FusedSyncTestCore, plain_batch
from ggrs_tpu_torch.device.planes import PlaneContext
from ggrs_tpu_torch.device.tiled_core import TiledSyncTestCore, plain_parts, plain_verdict

REPO = Path(__file__).resolve().parent.parent
BATCHES, T = 3, 10


def assert_tree_equal(got, want, path="carry"):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_tree_equal(got[k], want[k], f"{path}/{k}")
        return
    g, w = np.asarray(got), np.asarray(want)
    assert g.dtype == w.dtype, f"{path}: {g.dtype} != {w.dtype}"
    np.testing.assert_array_equal(g, w, err_msg=path)


def script(players, seed=7):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 16, size=(BATCHES * T, players, 1), dtype=np.uint8)


def ref_session(backend, d, n, players, delay=0):
    return TpuSyncTestSession(
        RefExGame(players, n), num_players=players, check_distance=d,
        input_delay=delay, backend=backend,
    )


def port_session(backend, d, n, players, delay=0):
    return DeviceSyncTestSession(
        ExGame(players, n), players, d, input_delay=delay, backend=backend, device="cpu",
    )


def drive_and_compare(ref_backend, port_backend, d, n, players, delay):
    sc = script(players)
    ref = ref_session(ref_backend, d, n, players, delay)
    port = port_session(port_backend, d, n, players, delay)
    for b in range(BATCHES):
        ref.advance_frames(sc[b * T:(b + 1) * T])
        port.advance_frames(sc[b * T:(b + 1) * T])
        assert_tree_equal(carry_to_reference(port.carry), jax.device_get(ref.carry))
    ref.check()
    port.check()
    assert port.current_frame == BATCHES * T


CASES = [(d, n, delay, players) for d, n in [(2, 256), (5, 1024), (8, 256)]
         for delay in (0, 2) for players in (2, 3)]
# each pair covers both input delays and both player counts
WHOLE_BATCH_CASES = [(2, 256, 0, 2), (5, 1024, 2, 3)]
TILED_CASES = [(2, 256, 2, 3), (5, 1024, 0, 2)]


@pytest.mark.parametrize("d,n,delay,players", CASES)
def test_plain_session_matches_reference_xla(d, n, delay, players):
    drive_and_compare("xla", "torch", d, n, players, delay)


@pytest.mark.parametrize("d,n,delay,players", WHOLE_BATCH_CASES)
def test_plain_session_matches_reference_whole_batch_kernel(d, n, delay, players):
    drive_and_compare("pallas-interpret", "torch", d, n, players, delay)


@pytest.mark.parametrize("d,n,delay,players", TILED_CASES)
def test_tiled_twin_session_matches_reference_tiled_kernel(d, n, delay, players):
    """backend="cuda-tiled" on a CPU carry runs K2's plain twin (parts +
    verdict) against the reference's entity-tiled kernel."""
    drive_and_compare("pallas-tiled-interpret", "cuda-tiled", d, n, players, delay)


def test_tiled_twin_parts_match_reference_run_kernel():
    """plain_parts' parts_hi/parts_lo, ring, r_frame, input ring and state
    equal the reference kernel's raw outputs (two tiles of 8 rows), from a
    mid-run carry so rollbacks and masked events both occur; then
    plain_verdict equals the reference's `_verdict` post-pass."""
    players, n, d = 2, 2048, 3
    sc = script(players, seed=8)
    ref = ref_session("xla", d, n, players)
    ref.advance_frames(sc[:2])  # ends at frame 2 <= d: the next batch starts unrolled
    carry = jax.device_get(ref.carry)
    core = PallasTiledSyncTestCore(RefExGame(players, n), players, d, interpret=True, tile_rows=8)
    assert core.n_tiles == 2
    inputs = sc[2:14]
    out = jax.device_get(core.run_kernel(ref.carry, jnp.asarray(inputs)))

    port = carry_from_reference(carry, "cpu")
    ctx = PlaneContext(ExGame(players, n), players, d, "cpu")
    parts_hi, parts_lo = plain_parts(port, torch.from_numpy(inputs.astype(np.int32)), ctx)
    np.testing.assert_array_equal(parts_hi.numpy(), out["parts_hi"])
    np.testing.assert_array_equal(parts_lo.numpy(), out["parts_lo"])
    assert (parts_hi.numpy()[:, :-1] == 0).any() and (parts_hi.numpy() != 0).any()
    for k, (name, _, _) in enumerate(ctx.adapter.planes):
        np.testing.assert_array_equal(port["state"][k].numpy(), out[name].reshape(n), err_msg=name)
        np.testing.assert_array_equal(
            port["ring"][:, k].numpy(), out["r_" + name].reshape(ctx.ring_len, n), err_msg=name)
    np.testing.assert_array_equal(port["r_frame"].numpy(), out["r_frame"])
    np.testing.assert_array_equal(port["iring"].numpy().reshape(d + 2, -1), out["iring"])

    verdict = jax.device_get(core._verdict(
        ref.carry, jnp.asarray(out["parts_hi"]), jnp.asarray(out["parts_lo"]),
        ref.carry["frame"], len(inputs)))
    plain_verdict(port, parts_hi, parts_lo, ctx)
    got = carry_to_reference(port)
    for k in ("h_tag", "h_hi", "h_lo", "mismatch", "mismatch_frame", "frame"):
        assert_tree_equal(got[k], verdict[k], k)


@pytest.mark.parametrize("port_backend", ["torch", "cuda-tiled"])
def test_injected_ring_corruption_latches_same_frame(port_backend):
    """Corrupt the ring slot the next rollback loads (frame 12 - d): both
    sides raise MismatchedChecksum at the first re-save after that load,
    and the carries still agree."""
    players, n, d = 2, 512, 4
    sc = script(players, seed=9)
    ref = ref_session("xla", d, n, players)
    port = port_session(port_backend, d, n, players)
    ref.advance_frames(sc[:12])
    port.advance_frames(sc[:12])
    ref.check()
    port.check()
    slot = (port.current_frame - d) % port.ring_len
    ring = dict(ref.carry["ring"])
    ring["pos"] = ring["pos"].at[slot, 0, 0].add(7)
    ref.carry = {**ref.carry, "ring": ring}
    port.carry["ring"][slot, 0, 0] += 7  # plane px, entity 0: the same word
    ref.advance_frames(sc[12:24])
    port.advance_frames(sc[12:24])
    with pytest.raises(RefMismatchedChecksum) as ref_err:
        ref.check()
    with pytest.raises(MismatchedChecksum) as port_err:
        port.check()
    assert port_err.value.frame == ref_err.value.frame == 12 - d + 1
    assert_tree_equal(carry_to_reference(port.carry), jax.device_get(ref.carry))


def test_carry_round_trip():
    sc = script(3, seed=10)
    ref = ref_session("xla", 4, 256, 3, delay=1)
    ref.advance_frames(sc[:9])
    x = jax.device_get(ref.carry)
    assert_tree_equal(carry_to_reference(carry_from_reference(x, "cpu")), x)


def test_plain_kernel_wrappers_take_cpu_carries():
    """A kernel wrapper given a CPU carry runs its plain version: K1's and
    K2's wrappers equal plain_batch, and count no launch."""
    game = ExGame(2, 256)
    ctx = PlaneContext(game, 2, 3, "cpu")
    inputs = torch.from_numpy(script(2, seed=11)[:20].astype(np.int32))
    want = sync_test.initial_carry(ctx)
    plain_batch(want, inputs, ctx)
    for core in (FusedSyncTestCore(ctx), TiledSyncTestCore(ctx)):
        carry = sync_test.initial_carry(ctx)
        core.batch(carry, inputs)
        for k in CARRY_KEYS:
            assert torch.equal(carry[k], want[k]), k
        assert core.launches == 0


def test_auto_picks_as_the_reference_does():
    cuda = torch.device("cuda")
    assert sync_test.pick_backend(ExGame(2, 4096), 8, cuda) == "cuda-fused"
    assert sync_test.pick_backend(ExGame(2, 65536), 16, cuda) == "cuda-fused"
    assert sync_test.pick_backend(ExGame(2, 1 << 20), 8, cuda) == "cuda-tiled"
    assert sync_test.pick_backend(ExGame(2, 1 << 20), 8, torch.device("cpu")) == "torch"
    assert port_session("auto", 2, 256, 2).backend == "torch"


def test_no_cuda_and_no_explicit_cpu_raises_config_error(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ConfigError):
        DeviceSyncTestSession(ExGame(2, 256), 2, 2)
    with pytest.raises(ValueError):  # the stdlib face is kept
        DeviceSyncTestSession(ExGame(2, 256), 2, 2, device="cuda")
    with pytest.raises(ConfigError):
        port_session("cuda-magic", 2, 256, 2)


def test_port_imports_neither_jax_nor_reference():
    # every module of the package, the request path's, the beam's, arena's and swarm's included
    code = (
        "import importlib, pkgutil, sys, ggrs_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(ggrs_tpu_torch.__path__, 'ggrs_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert {'ggrs_tpu_torch.device.backend', 'ggrs_tpu_torch.device.resim',\n"
        "        'ggrs_tpu_torch.device.tick_core', 'ggrs_tpu_torch.sync_layer',\n"
        "        'ggrs_tpu_torch.sessions.builder', 'ggrs_tpu_torch.input_queue',\n"
        "        'ggrs_tpu_torch.beam', 'ggrs_tpu_torch.input_model',\n"
        "        'ggrs_tpu_torch.device.beam_core', 'ggrs_tpu_torch.models.arena',\n"
        "        'ggrs_tpu_torch.device.reduce_core', 'ggrs_tpu_torch.device.injected_core',\n"
        "        'ggrs_tpu_torch.models.swarm'} <= set(names)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'ggrs_tpu' or m.startswith('ggrs_tpu.')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, timeout=120)

    for path in list((REPO / "ggrs_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "ggrs_tpu"), f"{path}: imports {name}"

