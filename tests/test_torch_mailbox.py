"""The port's device mailbox and resident drive (`MultiSessionDeviceCore.
attach_mailbox`, `stage_mailbox_row`, `commit_mailbox`, `drive_mailbox`;
device="cpu": `plain_resident_drive`) against the reference's
`ggrs_tpu.tpu.backend.MultiSessionDeviceCore` with a mailbox, fed the same
rows, tolerance zero: every drive's [K, S, W] checksums, every staged save's
bound checksum, the stacked rings and states and `checksum_slots`. Cases:
lanes at different fills and an empty lane, a fast-only cycle, a mixed
cycle, a rollback row loading a slot an earlier row of the cycle saved, a
lane overflowing the depth (an extra drive, counted on both), a lane
dropped after its rows were committed, and a slot reset mid-cycle. Then
the typed errors where the reference raises them, `plain_resident_drive`
against the per-virtual-tick `plain_megabatch` twin for the three families,
the wrapper's launch on a device off the CPU (the `meta` device), and, on a
card only, K3's resident entry against `plain_resident_drive`.

The reference is imported inside the tests that need it, so on a machine
with a card and no jax the card tests run without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_mailbox.py -q -m cuda
"""

import numpy as np
import pytest
import torch

from ggrs_tpu_torch import Arena, ExGame, InvariantViolation, KernelError, MailboxLaneFull, MultiSessionDeviceCore, Swarm
from ggrs_tpu_torch.device.rowgen import megabatch_ticks
from ggrs_tpu_torch.device.tick_core import ResidentTickCore, plain_megabatch, plain_resident_drive

P, N, MP, CAP, DEPTH = 4, 64, 8, 8, 3
W = MP + 2
_REF = {}


def ref_core():
    """The reference core with a mailbox of DEPTH (one for the module:
    every drive program compiles once), every slot back at its initial
    world."""
    core = _REF.get("core")
    if core is None:
        from ggrs_tpu.models.ex_game import ExGame as RefExGame
        from ggrs_tpu.tpu.backend import MultiSessionDeviceCore as RefCore

        core = _REF["core"] = RefCore(RefExGame(P, N), MP, P, CAP, buckets=(8,), depth_buckets=(2, 4, W))
        core.attach_mailbox(DEPTH)
    core.reset_slots_masked(np.ones(CAP, dtype=bool))
    core.driver_dispatches = 0
    core.mailbox.overflows = 0
    return core


def port_core(game=None, depth=DEPTH, device="cpu"):
    core = MultiSessionDeviceCore(game or ExGame(P, N), MP, P, CAP, depth_buckets=(2, 4, W), device=device)
    core.attach_mailbox(depth)
    return core


def depth_row(core, rng, depth, frame):
    """A row of rollback depth `depth` at `frame` (0: no load, one advance,
    one save; d: load frame's slot, d advances, d saves)."""
    inputs = rng.integers(0, 16, size=(W, P, 1), dtype=np.uint8)
    save_slots = np.full((W,), core.scratch_slot, dtype=np.int32)
    count = max(depth, 1)
    for i in range(count):
        save_slots[i] = (frame + i) % core.ring_len
    return core.pack_tick_row(depth > 0, frame % core.ring_len, inputs, np.zeros((W, P), np.int32), save_slots,
                              count, start_frame=frame)


def stage_op(core, slot, row, la):
    return ("stage", slot, row, la, core.fast_eligible(row, la))


def session_ops(core, n_ticks, seed, skip=lambda t, s: False, drive_every=None):
    """Host ticks of megabatch_ticks' session-shaped rows, staged slot by
    slot (a slot skipped by `skip(t, s)` keeps its row for a later tick, so
    each slot's stream stays in order), a commit a tick, a drive every
    `drive_every` ticks."""
    per_slot = list(zip(*megabatch_ticks(core, n_ticks, seed=seed)))
    at = [0] * CAP
    ops = []
    for t in range(n_ticks):
        for s in range(CAP):
            if not skip(t, s):
                slot, row, la = per_slot[s][at[s]]
                ops.append(stage_op(core, slot, row, la))
                at[s] += 1
        ops.append(("commit",))
        if drive_every and (t + 1) % drive_every == 0:
            ops.append(("drive",))
    return ops


def run_ops(core, ops):
    """Apply ops; returns (every staged save binding (batch, base), every
    drive's batch)."""
    bound, drives = [], []
    for op in ops:
        if op[0] == "stage":
            _, slot, row, la, fast = op
            bound.append(core.stage_mailbox_row(slot, row, last_active=la, fast=fast))
        elif op[0] == "commit":
            core.commit_mailbox()
        elif op[0] == "drive":
            drives.append(core.drive_mailbox())
        elif op[0] == "drop":
            assert core.drop_mailbox_lane(op[1]) == op[2]
        elif op[0] == "reset":
            core.reset_slot(op[1])
    return bound, drives


def assert_runs_equal(port, ref, ops):
    p_bound, p_drives = run_ops(port, ops)
    r_bound, r_drives = run_ops(ref, ops)
    for pd, rd in zip(p_drives, r_drives):
        assert (pd is None) == (rd is None)
        if pd is not None:
            for j in range(DEPTH * (CAP + 1) * W):
                assert pd.resolve(j) == rd.resolve(j), f"drive output entry {j}"
    for k, ((pb, pbase), (rb, rbase)) in enumerate(zip(p_bound, r_bound)):
        assert pbase == rbase
        for i in range(W):
            assert pb.resolve(pbase + i) == rb.resolve(rbase + i), f"staged row {k} window slot {i}"
    for got, want in zip(port.stacked_canonical(), ref.stacked_canonical()):
        for k in want:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    for got, want in zip(port.checksum_slots(), ref.checksum_slots()):
        np.testing.assert_array_equal(got, np.asarray(want))
    assert port.mailbox.overflows == ref.mailbox.overflows
    assert port.driver_dispatches == ref.driver_dispatches > 0
    assert port.mailbox.pending_rows == ref.mailbox.pending_rows == 0


def case_fills(core, rng):
    """Lanes at different fills (slot s staged on 3 - s % 4 of 3 ticks, so
    fills 3, 2, 1 and 0) and slot 7 never: one drive."""
    return session_ops(core, 3, 11, skip=lambda t, s: s == 7 or t < s % 4, drive_every=3)


def case_fast_only(core, rng):
    """Every row zero-rollback (no load, one advance, one save): the port
    drives at 2 window slots, the reference its fast driver."""
    ops = []
    for t in range(DEPTH):
        ops += [stage_op(core, s, depth_row(core.core, rng, 0, t), 1) for s in range(CAP)]
        ops.append(("commit",))
    return ops + [("drive",)]


def case_mixed(core, rng):
    """Session-shaped rows (rollbacks of random depth, skipped saves,
    DISCONNECTED slots) over two cycles."""
    return session_ops(core, 6, 5, drive_every=3)


def case_cycle_load(core, rng):
    """Virtual tick 2 of each lane loads the slot virtual tick 0 of the
    same cycle saved, and resimulates over the frames virtual tick 1 saved."""
    ops = []
    for s in range(CAP):
        d = 1 + s % 2
        ops += [stage_op(core, s, depth_row(core.core, rng, 0, 0), 1), stage_op(core, s, depth_row(core.core, rng, 0, 1), 1),
                stage_op(core, s, depth_row(core.core, rng, d, 0), d)]
    return ops + [("commit",), ("drive",)]


def case_overflow(core, rng):
    """Slot 2 stages DEPTH + 2 rows in one cycle: the row past the depth
    drives the mailbox first (an overflow on both stacks), never dropped."""
    ops = [stage_op(core, 2, depth_row(core.core, rng, 0, f), 1) for f in range(DEPTH + 2)]
    ops += [stage_op(core, 5, depth_row(core.core, rng, 0, 0), 1), ("commit",), ("drive",)]
    return ops


def case_drop(core, rng):
    """Slot 3's rows committed, then dropped: its watermark masks them, the
    other lanes run."""
    ops = [stage_op(core, s, depth_row(core.core, rng, 0, f), 1) for f in range(2) for s in range(CAP)]
    return ops + [("commit",), ("drop", 3, 2), ("drive",)]


def case_reset(core, rng):
    """reset_slot mid-cycle drives the staged rows first, then the slot
    starts over; the next cycle runs on."""
    ops = [stage_op(core, s, depth_row(core.core, rng, 0, f), 1) for f in range(2) for s in range(CAP)]
    ops += [("commit",), ("reset", 4)]
    ops += [stage_op(core, s, depth_row(core.core, rng, 0, 0 if s == 4 else 2), 1) for s in range(CAP)]
    return ops + [("commit",), ("drive",)]


CASES = {"fills": case_fills, "fast_only": case_fast_only, "mixed": case_mixed, "cycle_load": case_cycle_load,
         "overflow": case_overflow, "drop_after_commit": case_drop, "reset_mid_cycle": case_reset}


@pytest.mark.parametrize("case", CASES)
def test_mailbox_core_matches_reference(case):
    """The port's mailbox core and the reference's on the same ops: equal
    drive outputs, bound checksums, stacks, slot checksums and overflow
    counts."""
    port, ref = port_core(), ref_core()
    ops = CASES[case](port, np.random.default_rng(7))
    assert_runs_equal(port, ref, ops)
    if case == "overflow":
        assert port.mailbox.overflows == 1 and port.driver_dispatches == 2
    if case == "fast_only":
        assert port.plan_cache.signatures.get(("resident_drive", 0)) == 1


def test_mailbox_errors_match_reference():
    """Staging past the depth without a drive raises MailboxLaneFull, and
    closing a cycle with uncommitted rows raises InvariantViolation, on
    both stacks; block_until_ready and reset_slot drive what is staged."""
    from ggrs_tpu.errors import InvariantViolation as RefInvariantViolation
    from ggrs_tpu.errors import MailboxLaneFull as RefMailboxLaneFull

    port, ref = port_core(), ref_core()
    row = depth_row(port.core, np.random.default_rng(1), 0, 0)
    for core, full, invariant in ((port, MailboxLaneFull, InvariantViolation),
                                  (ref, RefMailboxLaneFull, RefInvariantViolation)):
        for f in range(DEPTH):
            core.mailbox.stage(0, row, 1, True)
        with pytest.raises(full, match="full mailbox lane"):
            core.mailbox.stage(0, row, 1, True)
        with pytest.raises(invariant, match="uncommitted"):
            core.mailbox.take_cycle()
        core.mailbox.drop_lane(0)
        core.mailbox._staged.clear()
        core.mailbox.take_cycle()
    with pytest.raises(InvariantViolation):
        MultiSessionDeviceCore(ExGame(P, N), MP, P, CAP, device="cpu").attach_mailbox(0)
    # reads of the worlds drive first
    port.stage_mailbox_row(1, row, last_active=1, fast=True)
    port.commit_mailbox()
    assert port.mailbox.pending_rows == 1
    port.block_until_ready()
    assert port.mailbox.pending_rows == 0 and port.driver_dispatches == 1
    port.stage_mailbox_row(1, depth_row(port.core, np.random.default_rng(2), 0, 1), last_active=1, fast=True)
    port.reset_slot(6)
    assert port.driver_dispatches == 2 and port.state_numpy(1)["frame"] == 2


FAMILIES = {"ex_game": (ExGame, 16, False), "swarm": (Swarm, 128, False), "arena": (Arena, 64, True)}


@pytest.mark.parametrize("family", FAMILIES)
def test_plain_resident_drive_matches_per_vtick_megabatches(family):
    """plain_resident_drive over a cycle (lanes at fills 4..0) equals
    plain_megabatch run virtual tick by virtual tick over the lanes with a
    row there: his/los and the whole stack."""
    cls, mod, prime = FAMILIES[family]
    core = MultiSessionDeviceCore(cls(P, N), MP, P, 5, device="cpu")
    ticks = megabatch_ticks(core, 4, seed=9, mod=mod, prime=prime)
    K, S = 4, core.stack_slots
    marks = np.array([4, 3, 2, 1, 0, 0], dtype=np.int32)
    mbox = np.tile(core._pad_row, (S, K, 1))
    for s in range(5):
        for t in range(marks[s]):
            mbox[s, t] = ticks[t][s][1]
    twin = {k: v.clone() for k, v in core.stack.items()}
    lanes = [s for s in range(S) if marks[s]]
    his, los = plain_resident_drive(core.stack, torch.from_numpy(mbox), lanes, marks[lanes], W, core.core)
    for t in range(K):
        idx = [s for s in lanes if marks[s] > t]
        h, lo = plain_megabatch(twin, idx, mbox[idx, t], W, core.core)
        for r, s in enumerate(idx):
            assert torch.equal(his[t, s], h[r]) and torch.equal(los[t, s], lo[r])
        for s in set(range(S)) - set(idx):
            assert not his[t, s].any() and not los[t, s].any()
    for k in twin:
        assert torch.equal(twin[k], core.stack[k]), k


class RecordingLib:
    """Any entry point, recorded (the stacked-launch test's pattern)."""

    def __init__(self, rc):
        self.rc, self.fns = rc, {}

    def __getattr__(self, name):
        class Fn:
            argtypes = None
            calls = []

            def __call__(fn, *args):
                fn.calls.append(args)
                return self.rc

        return self.fns.setdefault(name, Fn())


@pytest.mark.parametrize("rc", [0, 2], ids=["launches", "refused"])
@pytest.mark.parametrize("family,symbol,n_args", [("ex_game", "resim_tick_resident_launch", 21),
                                                   ("swarm", "resim_tick_swarm_resident_launch", 20)])
def test_drive_on_a_device_launches_the_resident_entry_or_raises(monkeypatch, family, symbol, n_args, rc):
    """Off the CPU (the `meta` device, which holds no data) a drive is ONE
    call of the model's resident entry with the stacked tensors, the
    mailbox, the live lanes and the depth; a CUDA error raises KernelError
    and nothing falls back; more lanes than a grid dimension holds raise
    before any launch."""
    from ggrs_tpu_torch.kernels import build, launch

    lib = RecordingLib(rc)
    monkeypatch.setattr(build, "load", lambda name: lib)
    monkeypatch.setattr(launch, "stream_of", lambda device: 0)
    core = MultiSessionDeviceCore({"ex_game": ExGame, "swarm": Swarm}[family](P, N), MP, P, CAP, device="cpu")
    rc_core = ResidentTickCore(core.core, core.stack_slots, DEPTH, 2)
    stack = {k: v.to("meta") for k, v in core.stack.items()}
    mbox = torch.zeros((core.stack_slots, DEPTH, core.core.packed_len), dtype=torch.int32, device="meta")
    marks = np.array([3, 0, 1, 0, 0, 2, 0, 0, 0], dtype=np.int32)
    call = lambda: rc_core.drive(stack, mbox, marks, 4)  # noqa: E731
    if rc:
        with pytest.raises(KernelError, match="CUDA error 2"):
            call()
        assert rc_core.launches == 0
    else:
        his, _ = call()
        assert rc_core.launches == 1 and tuple(his.shape) == (DEPTH, CAP + 1, W)
        assert rc_core._pool.arrays[rc_core._pool._flip][:12].tolist() == [0, 2, 5, 1, 3, 4, 6, 7, 8, 3, 1, 2]
    assert list(lib.fns) == [symbol] and len(lib.fns[symbol].calls) == 1
    args = lib.fns[symbol].calls[0]
    assert len(lib.fns[symbol].argtypes) == n_args == len(args)
    assert args[9:17] == (N, P, 1, W, CAP + 1, DEPTH, 3, 4)  # entities, players, I, W, S, depth, lanes, nslots
    wide = ResidentTickCore(core.core, 70000, 1, 2)
    with pytest.raises(KernelError, match="65535"):
        wide.drive(stack, mbox, np.ones(70000, dtype=np.int32), 2)


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("a CUDA kernel has no CPU or interpret mode; runs on an H100 (python3 chip_smoke.py)")


@pytest.mark.cuda
@pytest.mark.parametrize("family", FAMILIES)
def test_resident_entry_matches_plain_on_the_card(cuda_card, family):
    """K3's resident entry (arena: a K3-arena launch a lane) against
    plain_resident_drive on a clone of the stack, his/los and the whole
    stack equal after every drive: crafted cycles of 4096-entity worlds —
    lanes at fills 0..8 with an empty lane, a fast-only cycle at 2 slots,
    a mixed cycle at a depth bucket, one at the full window, and a lane
    whose rows load what an earlier row of the cycle saved."""
    cls, mod, prime = FAMILIES[family]
    depth, n = 8, 4096
    core = port_core(cls(P, n), depth=depth, device="cuda")
    core.warmup()
    rng = np.random.default_rng(3)
    per_slot = list(zip(*megabatch_ticks(core, 4 * depth, seed=21, mod=mod, prime=prime)))
    at = [0] * CAP
    wrapper = core.resident_core if core.resident_core.stacked else core.core.tick_core
    wrapper.launches = live = 0
    for cycle, fills in enumerate([[8, 7, 5, 3, 2, 1, 1, 0], [1] * CAP, [8] * CAP, [4, 0, 4, 0, 4, 0, 4, 4]]):
        for s in range(CAP):
            for _ in range(fills[s]):
                if cycle == 1:
                    row, la = depth_row(core.core, rng, 0, at[s]), 1
                else:
                    _, row, la = per_slot[s][at[s]]
                core.stage_mailbox_row(s, row, last_active=la, fast=core.fast_eligible(row, la))
                at[s] += 1
        core.commit_mailbox()
        mbox = core.mailbox
        marks = mbox._counts.copy()
        nslots = 2 if mbox._cycle_all_fast else core.depth_bucket_for(mbox._cycle_max_last_active)
        rows = mbox.rows_dev.clone()
        twin = {k: v.clone() for k, v in core.stack.items()}
        batch = core.drive_mailbox()
        lanes = [s for s in range(core.stack_slots) if marks[s]]
        live += len(lanes)
        his, los = plain_resident_drive(twin, rows, lanes, marks[lanes], nslots, core.core)
        torch.cuda.synchronize()
        assert torch.equal(batch._his, his) and torch.equal(batch._los, los), f"cycle {cycle}"
        for k in twin:
            assert torch.equal(twin[k], core.stack[k]), f"cycle {cycle} {k}"
    assert core.driver_dispatches == 4
    assert wrapper.launches == (4 if core.resident_core.stacked else live)
