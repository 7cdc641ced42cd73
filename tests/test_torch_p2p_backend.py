"""The port's DeviceRollbackBackend(device="cpu") on P2P request streams:
peer 0's requests in a reference 2- and 4-player mesh (latency, jitter,
loss, desync detection on) are tapped each tick and fulfilled by the
reference's TpuRollbackBackend and the port's backend alike — every save's
checksum, the final state and the snapshot ring (through convert.py) must
be equal, tolerance zero: eager, lazy_ticks=5, sparse saving, a disconnect
(DISCONNECTED inputs in rollbacks). The other peers run the reference's
numpy oracle, so desync detection also holds the reference backend to the
oracle. Then the beam: in a port mesh, peer 0 on a beam_width=4 backend
and a beam-off twin fulfilling the same requests must stay equal. One
reference game shape, ExGame(P, 128). Budget: under 60 s on the CPU."""

import jax
import numpy as np
import pytest

from ggrs_tpu.models import ex_game as ref_ex_game
from ggrs_tpu.ops.fixed_point import combine_checksum as ref_combine
from ggrs_tpu.tpu import TpuRollbackBackend
from ggrs_tpu_torch import DeviceRollbackBackend, ExGame
from ggrs_tpu_torch.convert import resim_to_reference
from ggrs_tpu_torch.sync_layer import GameStateCell
from ggrs_tpu_torch.types import AdvanceFrame, LoadGameState, SaveGameState
from torch_p2p_mesh import PORT, REF, build_peers, count, play, synchronize

N = 128


class OracleGame:
    """Fulfils either stack's requests with the reference's numpy oracle,
    checksums included."""

    def __init__(self, players):
        self.players = players
        self.state = ref_ex_game.init_oracle(players, N)

    def handle_requests(self, requests):
        for r in requests:
            kind = type(r).__name__
            if kind == "SaveGameState":
                copy = {k: np.copy(v) for k, v in self.state.items()}
                r.cell.save(r.frame, copy, ref_combine(*ref_ex_game.checksum_oracle(self.state)))
            elif kind == "LoadGameState":
                self.state = {k: np.copy(v) for k, v in r.cell.load().items()}
            else:
                inputs = np.array([buf[0] for buf, _ in r.inputs], dtype=np.uint8)
                statuses = np.array([int(s) for _, s in r.inputs], dtype=np.int32)
                self.state = ref_ex_game.step_oracle(self.state, inputs, statuses, self.players)


class Tap:
    """Peer 0's handler: the session's own backend fulfils its requests,
    and each other backend gets the same requests on cells of its own.
    Every save's checksum getter is bound at save time, per backend."""

    def __init__(self, first, *others):
        self.backends = (first,) + others
        self.cells = [{} for _ in others]
        self.saves = [[] for _ in self.backends]

    def handle_requests(self, requests):
        lists = [requests]
        for cells in self.cells:
            lists.append([self._copy(r, cells) for r in requests])
        for backend, reqs, saves in zip(self.backends, lists, self.saves):
            backend.handle_requests(reqs)
            saves += [(r.frame, r.cell.checksum_getter()) for r in reqs if type(r).__name__ == "SaveGameState"]

    @staticmethod
    def _copy(r, cells):
        kind = type(r).__name__
        if kind == "AdvanceFrame":
            return AdvanceFrame(inputs=list(r.inputs))
        cell = cells.setdefault(id(r.cell), GameStateCell())
        return (SaveGameState if kind == "SaveGameState" else LoadGameState)(cell=cell, frame=r.frame)

    def checksums(self):
        return [[(f, g()) for f, g in saves] for saves in self.saves]


def mesh(stack, players, *, sparse=False, seed=33):
    clock = stack.FakeClock()
    net = stack.InMemoryNetwork(clock, latency_ms=40, jitter_ms=15, loss=0.05, seed=seed)
    sessions = build_peers(stack, clock, net, players, mp=8, sparse=sparse, desync=10)
    if stack is REF:
        for s in sessions:
            s.batched_pump = False
    synchronize(stack, sessions, clock, [])
    return clock, sessions


def assert_tree_equal(got, want, path="core"):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_tree_equal(got[k], want[k], f"{path}/{k}")
        return
    g, w = np.asarray(got), np.asarray(want)
    assert g.dtype == w.dtype, f"{path}: {g.dtype} != {w.dtype}"
    np.testing.assert_array_equal(g, w, err_msg=path)


CASES = {
    "2p-eager": dict(players=2, lazy=0),
    "2p-lazy5": dict(players=2, lazy=5),
    "2p-sparse": dict(players=2, lazy=0, sparse=True),
    "4p-disconnect": dict(players=4, lazy=0, leave=(70, 3)),
    "4p-lazy5-disconnect": dict(players=4, lazy=5, leave=(50, 2)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_tapped_stream_matches_reference_backend(case):
    kw = CASES[case]
    players, lazy = kw["players"], kw["lazy"]
    clock, sessions = mesh(REF, players, sparse=kw.get("sparse", False))
    ref = TpuRollbackBackend(ref_ex_game.ExGame(players, N), max_prediction=8, num_players=players)
    port = DeviceRollbackBackend(ExGame(players, N), 8, players, lazy_ticks=lazy, device="cpu")
    tap = Tap(ref, port)
    handlers = [tap] + [OracleGame(players) for _ in range(players - 1)]
    log = play(REF, sessions, handlers, clock, 140, leave=kw.get("leave"))
    assert count(log, "LoadGameState") > 40
    assert count(log, "DesyncDetected") == 0  # the reference backend agrees with the oracles
    want, got = tap.checksums()
    assert len(got) > 80 and got == want
    assert_tree_equal(port.state_numpy(), jax.device_get(ref.state_numpy()), "state")
    assert port.current_frame == ref.current_frame
    assert_tree_equal(resim_to_reference(port.core), jax.device_get(
        {"ring": ref.core.ring, "state": ref.core.state, "verify": ref.core.verify}))
    if "leave" in kw:
        assert any(item[0] == "AdvanceFrame" and any(s == 2 for _, s in item[1])
                   for entry in log if isinstance(entry, list) for item in entry)


def toggle_script(ticks, players):
    """Each player toggles between two inputs every 6 ticks (phase by
    player): a switch to the toggle partner is what the beam's candidates
    cover, so rollbacks get adopted."""
    t = np.arange(ticks)[:, None]
    i = np.arange(players)[None, :]
    return np.where((t + 2 * i) // 6 % 2 == 0, 3 + i, 9 + i)[..., None]


@pytest.mark.parametrize("players,leave", [(2, None), (4, (60, 3))])
def test_beam_matches_beam_off_on_p2p_stream(players, leave):
    clock, sessions = mesh(PORT, players)
    beam = DeviceRollbackBackend(ExGame(players, N), 8, players, beam_width=4, device="cpu")
    off = DeviceRollbackBackend(ExGame(players, N), 8, players, device="cpu")
    tap = Tap(beam, off)
    handlers = [tap] + [OracleGame(players) for _ in range(players - 1)]
    log = play(PORT, sessions, handlers, clock, 120, leave=leave, script=toggle_script(120, players))
    assert count(log, "DesyncDetected") == 0
    got, want = tap.checksums()
    assert got == want
    assert_tree_equal(resim_to_reference(beam.core), resim_to_reference(off.core))
    assert beam.rollback_frames > 0
    assert beam.beam_hits + beam.beam_partial_hits > 0  # adoption served frames
