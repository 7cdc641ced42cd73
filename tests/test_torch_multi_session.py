"""The port's cross-session megabatch core (`ggrs_tpu_torch.
MultiSessionDeviceCore`, device="cpu": `plain_megabatch`) against the
reference's `ggrs_tpu.tpu.backend.MultiSessionDeviceCore` on the same
seeded rows, per model family (ExGame, Swarm, Arena; 4 players, 256
entities, capacity 8, max_prediction 8), tolerance zero: every slot's
checksums, the stacked rings and the stacked states after every megabatch.
Cases: the mixed-depth megabatch of tests/test_windowed_dispatch.py routed
(fast rows, then a megabatch per depth bucket) against the full window on
both stacks, then session-shaped host ticks; `dispatch_rows` against
`dispatch`; `reset_slots_masked` and `reset_slot`; a slot exported from
either stack imported into the other (and a payload of another world
refused); a checkpoint of either stack restored by the other. Each run
goes on after the handover and stays equal.

The reference core compiles one program per (row bucket x depth bucket),
so it gets buckets=(8,) and depth_buckets=(2, W), and one core per family
serves every test (reset between them)."""

import numpy as np
import pytest

from ggrs_tpu.errors import MigrationIncompatible as RefMigrationIncompatible
from ggrs_tpu.models.arena import Arena as RefArena
from ggrs_tpu.models.ex_game import ExGame as RefExGame
from ggrs_tpu.models.swarm import Swarm as RefSwarm
from ggrs_tpu.tpu.backend import MultiSessionDeviceCore as RefCore
from ggrs_tpu_torch import (
    Arena, CheckpointIncompatible, ConfigError, ContractViolation, ExGame, MigrationIncompatible,
    MultiSessionDeviceCore, Swarm,
)
from ggrs_tpu_torch.device.rowgen import megabatch_ticks
from ggrs_tpu_torch.device.tick_core import plain_megabatch

P, N, MP, CAP = 4, 256, 8, 8
W = MP + 2
FAMILIES = {"ex_game": (RefExGame, ExGame, 16), "swarm": (RefSwarm, Swarm, 128), "arena": (RefArena, Arena, 64)}
_REF = {}


def ref_core(family):
    """The family's reference core, every slot back at its initial world."""
    core = _REF.get(family)
    if core is None:
        core = _REF[family] = RefCore(FAMILIES[family][0](P, N), MP, P, CAP, buckets=(8,), depth_buckets=(2, W))
    core.reset_slots_masked(np.ones(CAP, dtype=bool))
    return core


def port_core(family, **kw):
    return MultiSessionDeviceCore(FAMILIES[family][1](P, N), MP, P, CAP, device="cpu", **kw)


def assert_stacks_equal(port, ref, what=""):
    for got, want in zip(port.stacked_canonical(), ref.stacked_canonical()):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=f"{what} {k}")


def assert_batches_equal(port_batch, ref_batch, n, what=""):
    for j in range(n * W):
        assert port_batch.resolve(j) == ref_batch.resolve(j), f"{what} entry {j // W} slot {j % W}"


def tick(cores, entries):
    """One host tick's entries through each core, grouped as the first
    core's `group` groups them; the batches' checksums compared with the
    first core's."""
    for key, group, la in cores[0].group(entries):
        batches = []
        for core in cores:
            if key == "fast":
                batches.append(core.dispatch(group, fast=True)[0])
            else:
                batches.append(core.dispatch(group, last_active=la)[0])
        for b in batches[1:]:
            assert_batches_equal(batches[0], b, len(group), f"megabatch {key}")


def depth_row(core, rng, depth, frame):
    """tests/test_windowed_dispatch.py's row of rollback depth `depth` (0: no
    load, one advance, one save)."""
    inputs = rng.integers(0, 16, size=(W, P, 1), dtype=np.uint8)
    save_slots = np.full((W,), core.scratch_slot, dtype=np.int32)
    count = max(depth, 1)
    for i in range(count):
        save_slots[i] = (frame + i) % core.ring_len
    return core.pack_tick_row(depth > 0, frame % core.ring_len, inputs, np.zeros((W, P), np.int32), save_slots,
                              count, start_frame=frame)


@pytest.mark.parametrize("family", FAMILIES)
def test_mixed_depth_megabatch_matches_reference(family):
    """tests/test_windowed_dispatch.py:175's eight rows of depths 0..8:
    routed (fast + a megabatch per depth bucket, the port at its default
    depth buckets) and as one full-window megabatch (the port's grouping
    without depth routing), on both stacks, all four equal; then 14
    session-shaped host ticks routed on both stacks, and the slots' world
    checksums."""
    ref = ref_core(family)
    routed, full = port_core(family), port_core(family, depth_routing=False)
    depths = [0, 3, 0, 8, 1, 0, 5, 0]
    rng = np.random.default_rng(23)
    rows = [depth_row(routed.core, rng, d, 4) for d in depths]
    entries = [(s, r, max(d, 1)) for s, (r, d) in enumerate(zip(rows, depths))]
    keys = [k for k, _, _ in routed.group(entries)]
    assert keys[0] == "fast" and len(keys) >= 3
    snapshot = ref.stacked_canonical()
    got = {}
    for key, group, la in routed.group(entries):
        batch = routed.dispatch(group, fast=True)[0] if key == "fast" else routed.dispatch(group, last_active=la)[0]
        ref_batch = ref.dispatch(group, fast=True)[0] if key == "fast" else ref.dispatch(group, last_active=la)[0]
        assert_batches_equal(batch, ref_batch, len(group), f"routed {key}")
        got.update({slot: (batch, k) for k, (slot, _) in enumerate(group)})
    routed_stack = ref.stacked_canonical()
    assert_stacks_equal(routed, ref, "routed")
    ref.load_stacked(*snapshot)
    [(key, group, la)] = full.group(entries)
    assert key is None and la is None and full.group_depth(key) == W
    full_batch = full.dispatch(group, last_active=la)[0]
    ref_full = ref.dispatch([(s, r) for s, r, _ in entries])[0]
    assert_batches_equal(full_batch, ref_full, CAP, "full window")
    assert_stacks_equal(full, ref, "full window")
    for slot, (batch, k) in got.items():
        for i in range(W):
            assert batch.resolve(k * W + i) == full_batch.resolve(slot * W + i)
    ref.load_stacked(*routed_stack)
    assert {d for _, d, _ in routed.megabatch_programs()} <= {0, None, *routed.depth_buckets}

    # session-shaped ticks from here on, routed on both stacks
    for entries in megabatch_ticks(routed, 14, seed=3, mod=FAMILIES[family][2], prime=family == "arena"):
        tick([routed, ref], entries)
    assert_stacks_equal(routed, ref, "after the ticks")
    for got_cs, want_cs in zip(routed.checksum_slots(), ref.checksum_slots()):
        np.testing.assert_array_equal(got_cs, np.asarray(want_cs))


@pytest.mark.parametrize("family", FAMILIES)
def test_dispatch_rows_matches_dispatch_and_reference(family):
    """The same host ticks as row blocks (`dispatch_rows`) on the port and
    the reference, and as (slot, row) entries (`dispatch`) on a second
    port core: checksums and stacks equal after every tick."""
    ref = ref_core(family)
    blocks, entries_core = port_core(family), port_core(family)
    for entries in megabatch_ticks(blocks, 10, seed=11, mod=FAMILIES[family][2], prime=family == "arena"):
        for key, group, la in blocks.group(entries):
            idx = np.array([s for s, _ in group], dtype=np.int32)
            rows = np.stack([r for _, r in group])
            kw = {"fast": True} if key == "fast" else {"last_active": la}
            b1 = blocks.dispatch_rows(idx, rows, **kw)[0]
            b2 = ref.dispatch_rows(idx, rows, **kw)[0]
            b3 = entries_core.dispatch(group, **kw)[0]
            assert_batches_equal(b1, b2, len(group), f"dispatch_rows {key}")
            assert_batches_equal(b1, b3, len(group), f"dispatch {key}")
    assert_stacks_equal(blocks, ref)
    assert_stacks_equal(entries_core, ref)
    assert blocks.megabatches == entries_core.megabatches and blocks.rows_dispatched == 10 * CAP


@pytest.mark.parametrize("family", FAMILIES)
def test_reset_slots_masked_matches_reference(family):
    """Ticks, a masked reset of three slots, `reset_slot` of another, and
    more ticks: equal to the reference's after each step."""
    ref = ref_core(family)
    port = port_core(family)
    ticks = megabatch_ticks(port, 12, seed=5, mod=FAMILIES[family][2], prime=family == "arena")
    for entries in ticks[:6]:
        tick([port, ref], entries)
    mask = np.zeros(CAP, dtype=bool)
    mask[[0, 3, 6]] = True
    port.reset_slots_masked(mask)
    ref.reset_slots_masked(mask)
    assert_stacks_equal(port, ref, "masked reset")
    port.reset_slot(5)
    ref.reset_slot(5)
    assert_stacks_equal(port, ref, "reset_slot")
    port.reset_slots_masked(np.zeros(CAP, dtype=bool))  # an empty mask changes nothing
    for entries in ticks[6:]:
        tick([port, ref], entries)
    assert_stacks_equal(port, ref, "after the resets")


@pytest.mark.parametrize("family", FAMILIES)
def test_export_import_slot_across_stacks(family):
    """A slot exported by the port goes into another slot of the reference
    and one exported by the reference into the port; both run on equal. A
    payload of another world (a narrower one) is refused by both with
    MigrationIncompatible."""
    ref = ref_core(family)
    port = port_core(family)
    ticks = megabatch_ticks(port, 12, seed=9, mod=FAMILIES[family][2], prime=family == "arena")
    for entries in ticks[:6]:
        tick([port, ref], entries)
    from_port, from_ref = port.export_slot(2), ref.export_slot(1)
    mine = port.export_slot(1)
    for name in ("ring", "state"):
        assert set(mine[name]) == set(from_ref[name])
        for k, v in from_ref[name].items():
            np.testing.assert_array_equal(mine[name][k], np.asarray(v), err_msg=f"{name}/{k}")
    ref.import_slot(5, from_port)
    port.import_slot(5, from_port)
    port.import_slot(6, from_ref)
    ref.import_slot(6, from_ref)
    assert_stacks_equal(port, ref, "after the imports")
    for entries in ticks[6:]:
        tick([port, ref], entries)
    assert_stacks_equal(port, ref, "after the ticks")

    narrow = MultiSessionDeviceCore(FAMILIES[family][1](P, N // 2), MP, P, 2, device="cpu").export_slot(0)
    with pytest.raises(MigrationIncompatible):
        port.import_slot(0, narrow)
    with pytest.raises(RefMigrationIncompatible):
        ref.import_slot(0, narrow)
    other = "swarm" if family != "swarm" else "ex_game"
    with pytest.raises(MigrationIncompatible):
        port.import_slot(0, port_core(other).export_slot(0))


@pytest.mark.parametrize("family", FAMILIES)
def test_save_restore_across_stacks(family, tmp_path):
    """The port's checkpoint restores as a reference core (and loads into
    the running one), the reference's as a port core; each run goes on
    equal."""
    ref = ref_core(family)
    port = port_core(family)
    ticks = megabatch_ticks(port, 12, seed=13, mod=FAMILIES[family][2], prime=family == "arena")
    for entries in ticks[:5]:
        tick([port, ref], entries)
    port_file, ref_file = str(tmp_path / "port.npz"), str(tmp_path / "ref.npz")
    port.save(port_file)
    ref.save(ref_file)
    restored_ref = RefCore.restore(port_file, FAMILIES[family][0](P, N))
    assert_stacks_equal(port, restored_ref, "the port's file as a reference core")
    restored_port = MultiSessionDeviceCore.restore(ref_file, FAMILIES[family][1](P, N), device="cpu")
    assert (restored_port.capacity, restored_port.num_players, restored_port.core.max_prediction) == (CAP, P, MP)
    assert_stacks_equal(restored_port, ref, "the reference's file as a port core")
    ref.load_stacked(*restored_ref.stacked_canonical())
    for entries in ticks[5:]:
        tick([restored_port, ref], entries)
    assert_stacks_equal(restored_port, ref, "after the restore")
    with pytest.raises(CheckpointIncompatible):
        MultiSessionDeviceCore.restore(port_file, FAMILIES[family][1](P, N // 2), device="cpu")


def test_plain_megabatch_windows_rows_as_the_reference():
    """plain_megabatch at a depth shallower than a row's last active slot
    runs the row cut to that window, as the reference's windowed program
    does (a depth-8 rollback at depth bucket 2), and pad rows read (0, 0)."""
    ref = ref_core("ex_game")
    port = port_core("ex_game", buckets=(8,))
    rng = np.random.default_rng(1)
    spin = [(s, depth_row(port.core, rng, 0, 0)) for s in range(CAP)]
    port.dispatch(spin, fast=True)
    ref.dispatch(spin, fast=True)
    deep = [(2, depth_row(port.core, rng, 8, 0)), (4, depth_row(port.core, rng, 5, 0))]
    b1, bucket = port.dispatch(deep, last_active=2)
    b2, _ = ref.dispatch(deep, last_active=2)
    assert bucket == 8 and tuple(b1._his.shape) == (8, W)
    assert_batches_equal(b1, b2, 2, "windowed")
    assert not b1._his[2:].any() and not b1._los[2:].any()
    assert_stacks_equal(port, ref)
    twin = {k: v.clone() for k, v in port.stack.items()}
    his, los = plain_megabatch(twin, [3], np.stack([deep[0][1]]), W, port.core, 4)
    assert tuple(his.shape) == (4, W) and not his[1:].any()


def test_routing_fence_and_misuse():
    """Buckets and depth buckets as the reference's, the fence read as
    retired on the CPU, a fault seam consulted before anything changes,
    and the misuses the reference asserts on raising typed errors."""
    ref = RefCore(RefExGame(P, N), MP, P, CAP)  # its defaults; nothing is compiled
    port = port_core("ex_game")
    assert port.buckets == ref.buckets == (1, 2, 4, 8) and port.depth_buckets == ref.depth_buckets == (2, 4, 8, W)
    assert port.dispatch_bucket_budget() == ref.dispatch_bucket_budget() == 4 * 5
    assert [port.bucket_for(n) for n in range(1, CAP + 1)] == [ref.bucket_for(n) for n in range(1, CAP + 1)]
    assert [port.depth_bucket_for(la) for la in range(1, W + 1)] == [ref.depth_bucket_for(la) for la in range(1, W + 1)]
    with pytest.raises(ContractViolation):
        port.depth_bucket_for(W + 1)
    rng = np.random.default_rng(2)
    rows = [(s, depth_row(port.core, rng, 0, 0)) for s in range(3)]
    port.dispatch(rows, fast=True)
    assert port.poll_retired() == 0 and port.inflight_rows == 0 and len(port.fence) == 0
    assert port.megabatch_programs() == [(4, 0, 1)]
    before = [v.clone() for v in port.stack.values()]

    class Seam:
        def before_dispatch(self, op, slots):
            raise RuntimeError(f"{op} {slots}")

    port.fault_seam = Seam()
    with pytest.raises(RuntimeError, match="megabatch"):
        port.dispatch(rows, fast=True)
    port.fault_seam = None
    assert all((a == b).all() for a, b in zip(before, port.stack.values()))
    with pytest.raises(ContractViolation):
        port.dispatch([rows[0], rows[0]], fast=True)  # one row per slot
    with pytest.raises(ContractViolation):
        port.dispatch([(CAP, rows[0][1])])  # the dummy slot is not a session's
    deep = depth_row(port.core, rng, 3, 0)
    with pytest.raises(ContractViolation):
        port.dispatch([(0, deep)], fast=True)  # a rollback row on the fast dispatch
    assert not port.fast_eligible(deep) and port.fast_eligible(rows[0][1])
    with pytest.raises(ConfigError):
        MultiSessionDeviceCore.create(ExGame(P, N), MP, P, CAP, mesh=object(), device="cpu")
    with pytest.raises(ConfigError):
        port_core("ex_game", depth_buckets=(W + 1,))
    port.warmup()  # no-op launches on the dummy slot: the worlds stay as they were
    assert all((a == b).all() for a, b in zip(before, port.stack.values()))


class RecordingLaunch:
    def __init__(self, rc):
        self.argtypes = None
        self.rc = rc
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return self.rc


class RecordingLib:
    """Any entry point, recorded: the wrapper's choice shows in `fns`."""

    def __init__(self, rc):
        self.rc = rc
        self.fns = {}

    def __getattr__(self, name):
        return self.fns.setdefault(name, RecordingLaunch(self.rc))


@pytest.mark.parametrize("rc", [0, 2], ids=["launches", "refused"])
@pytest.mark.parametrize("family,symbol,n_args", [("ex_game", "resim_tick_stacked_launch", 20),
                                                   ("swarm", "resim_tick_swarm_stacked_launch", 19)])
def test_megabatch_on_a_device_launches_the_stacked_entry_or_raises(monkeypatch, family, symbol, n_args, rc):
    """On a stack off the CPU (here the `meta` device, which holds no data)
    a megabatch is one call of the model's stacked entry point with the
    stacked tensors, the slots, the live rows, the depth and the bucket; a
    CUDA error raises KernelError and nothing falls back to the plain
    version (it could not run on `meta`)."""
    from ggrs_tpu_torch import KernelError
    from ggrs_tpu_torch.kernels import build, launch

    lib = RecordingLib(rc)
    monkeypatch.setattr(build, "load", lambda name: lib)
    monkeypatch.setattr(launch, "stream_of", lambda device: 0)
    port = port_core(family)
    tc = port.tick_core
    stack = {k: v.to("meta") for k, v in port.stack.items()}
    rows = np.stack([depth_row(port.core, np.random.default_rng(4), d, 0) for d in (0, 3)])
    idx = torch_tensor(np.array([2, 5], dtype=np.int32))
    call = lambda: tc.tick(stack, idx, torch_tensor(rows), 4, 8)  # noqa: E731
    if rc:
        with pytest.raises(KernelError, match="CUDA error 2"):
            call()
        assert tc.launches == 0
    else:
        his, _ = call()
        assert tc.launches == 1 and tuple(his.shape) == (8, W)
    assert list(lib.fns) == [symbol] and len(lib.fns[symbol].calls) == 1
    args = lib.fns[symbol].calls[0]
    assert len(lib.fns[symbol].argtypes) == n_args == len(args)
    assert args[9:16] == (N, P, 1, W, 2, 4, 8)  # entities, players, input size, window, rows, depth, bucket


def torch_tensor(a):
    import torch

    return torch.from_numpy(a).to("meta")
