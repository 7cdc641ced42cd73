"""The port's CUDA kernels (ggrs_tpu_torch/csrc/): a build that cannot run
raises a typed error, and, on a card only, each kernel equals its plain
PyTorch version bit for bit after every batch (K1, K2), dispatch (K3),
megabatch (K3's stacked entry, arena's per-row launches), speculation (K4)
or table (K5), for ex_game, arena (past 16 teams too) and swarm; a P2P
match on the card equals its replay on the plain versions, and the async
pipeline equals the eager dispatch.

This file imports no jax, so on a machine with a card and no jax it runs
without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -q
"""

import numpy as np
import pytest
import torch

from chip_smoke import TICK_STREAMS, VERDICT_STREAMS, p2p_match, p2p_replay, tick_stream, verdict_stream
from ggrs_tpu_torch import (
    Arena, DeviceRollbackBackend, DeviceSyncTestSession, ExGame, KernelError, MultiSessionDeviceCore, SaveGameState,
    SessionBuilder, Swarm,
)
from ggrs_tpu_torch.convert import CARRY_KEYS, copy_carry
from ggrs_tpu_torch.device import sync_test
from ggrs_tpu_torch.device.beam_core import beam_plan, plain_rollout
from ggrs_tpu_torch.device.fused_core import FusedSyncTestCore, plain_batch
from ggrs_tpu_torch.device.injected_core import InjectedReduceCore
from ggrs_tpu_torch.device.reduce_core import STATE as STATE_SLOT
from ggrs_tpu_torch.device.reduce_core import ReduceTableCore, plain_reduce_table, source_slots
from ggrs_tpu_torch.device.planes import PlaneContext
from ggrs_tpu_torch.device.resim import RESIM_KEYS, ResimCore
from ggrs_tpu_torch.device.rowgen import megabatch_ticks, prime_row, random_tick_rows
from ggrs_tpu_torch.device.tick_core import arena_tick_plan, plain_megabatch, plain_tick_multi, windowed_row
from ggrs_tpu_torch.device.tiled_core import TiledSyncTestCore, plain_injected_tick, plain_parts, plain_verdict
from ggrs_tpu_torch.kernels import build


@pytest.fixture
def cuda_card():
    """Skips, at run time, a test of a CUDA kernel on a host without a card."""
    if not torch.cuda.is_available():
        pytest.skip("a CUDA kernel has no CPU or interpret mode; runs on an H100 (python3 chip_smoke.py)")


def test_missing_compiler_or_source_is_a_kernel_error(monkeypatch, tmp_path):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(KernelError, match="nvcc not found"):
        build.nvcc()
    with pytest.raises(KernelError, match="no CUDA source"):
        build.build(["no_such_kernel"])


def assert_latch_probes(core, ctx, steady, script, corrupt, t_ticks):
    """Divergence probes that K1 latches in its tail (and K2 in its verdict
    kernel), each run by the kernel and the plain version: full carry equal
    and the same frame latched. (1) The history value of the first frame
    tick 0 re-saves is flipped: that re-save is compared with the carried
    history. (2) From a fresh carry, frames 0..3, then the ring slot of
    frame 1 corrupted: the batch that crosses frame d loads it only at its
    last tick (frame d+1), and latches frame 2 there. With single-tick
    batches every batch is its own last tick."""
    d = ctx.d

    def run(pair, inputs):
        core.batch(pair[0], inputs)
        plain_batch(pair[1], inputs, ctx)
        torch.cuda.synchronize()
        for k in CARRY_KEYS:
            assert torch.equal(pair[0][k], pair[1][k]), k

    pair = [copy_carry(steady[0]), copy_carry(steady[1])]
    c0 = int(pair[0]["meta"][0])
    assert c0 > d and int(pair[0]["meta"][1]) == 0
    for carry in pair:
        carry["h_hi"][(c0 - d + 1) % ctx.hist_len] ^= 1 << 5
    run(pair, script(t_ticks))
    assert pair[0]["meta"].tolist()[1:] == [1, c0 - d + 1]

    pair = [sync_test.initial_carry(ctx)]
    pair.append(copy_carry(pair[0]))
    for ticks in ([4] if t_ticks > 1 else [1] * (d + 1)):
        run(pair, script(ticks))
    for carry in pair:
        corrupt(carry, 1 % ctx.ring_len)
    run(pair, script(d + 2 - int(pair[0]["meta"][0]) if t_ticks > 1 else 1))
    assert pair[0]["meta"].tolist() == [d + 2, 1, 2]


@pytest.mark.cuda
@pytest.mark.parametrize("core_cls", [FusedSyncTestCore, TiledSyncTestCore])
def test_kernel_matches_plain_on_card(cuda_card, core_cls):
    dev = torch.device("cuda")
    ctx = PlaneContext(ExGame(2, 4096), 2, 8, dev)
    core = core_cls(ctx)
    kernel = sync_test.initial_carry(ctx)
    plain = copy_carry(kernel)
    rng = np.random.default_rng(12)
    batches = 3

    def script(t_ticks):
        return torch.from_numpy(rng.integers(0, 16, size=(t_ticks, 2, 1)).astype(np.int32)).to(dev)

    for _ in range(batches):
        inputs = script(24)
        core.batch(kernel, inputs)
        plain_batch(plain, inputs, ctx)
        torch.cuda.synchronize()
        for k in CARRY_KEYS:
            assert torch.equal(kernel[k], plain[k]), k
    assert core.launches == batches

    def corrupt(carry, slot):  # the heading: never clamped back
        carry["ring"][slot, 4, :64] += 7

    assert_latch_probes(core, ctx, (kernel, plain), script, corrupt, 24)


@pytest.mark.cuda
@pytest.mark.parametrize("stream", VERDICT_STREAMS, ids=[s[0] for s in VERDICT_STREAMS])
def test_verdict_kernel_matches_plain_on_card(cuda_card, stream):
    """synctest_verdict_launch (one block, a thread an event) equals the
    serial plain_verdict on each crafted stream (test_torch_verdict.py holds
    plain_verdict against the reference on the same streams)."""
    name, d, t_ticks, c0, carried, plants, latched = stream
    ctx = PlaneContext(ExGame(2, 4096), 2, d, torch.device("cuda"))
    ph, pl, tag, hhi, hlo, meta = verdict_stream(np, d, t_ticks, c0, carried, plants, latched,
                                                 ctx.cs_frame_weight, seed=d * 1000 + t_ticks)
    kernel = sync_test.initial_carry(ctx)
    for key, value in (("h_tag", tag), ("h_hi", hhi), ("h_lo", hlo), ("meta", meta)):
        kernel[key].copy_(torch.from_numpy(value))
    plain = copy_carry(kernel)
    core = TiledSyncTestCore(ctx)
    parts = torch.from_numpy(ph).cuda(), torch.from_numpy(pl).cuda()
    core.verdict(kernel, *parts)
    plain_verdict(plain, *parts, ctx)
    torch.cuda.synchronize()
    for k in ("h_tag", "h_hi", "h_lo", "meta"):
        assert torch.equal(kernel[k], plain[k]), (name, k)
    assert core.verdict_launches == 1


@pytest.mark.cuda
@pytest.mark.parametrize("rows_per_dispatch", [1, 8])
def test_tick_kernel_matches_plain_on_card(cuda_card, rows_per_dispatch):
    """K3 on a 4-player stream with rollbacks, skipped and trailing saves
    and DISCONNECTED slots, device verification on: his/los and the whole
    core (the verify history and its latch included) equal
    plain_tick_multi's after every dispatch."""
    core = ResimCore(ExGame(4, 4096), 12, 4, device_verify=True, device="cuda")
    plain = {k: v.clone() for k, v in core.carry.items()}
    rows = random_tick_rows(core, 4 * 8 + 14, seed=5)
    for b in range(0, len(rows), rows_per_dispatch):
        batch = rows[b : b + rows_per_dispatch]
        his, los = core.tick_multi(batch)
        p_his, p_los = plain_tick_multi(plain, core.upload(batch), core)
        torch.cuda.synchronize()
        assert torch.equal(his, p_his) and torch.equal(los, p_los), b
        for k in RESIM_KEYS:
            assert torch.equal(core.carry[k], plain[k]), (k, b)
    assert core.tick_core.launches == -(-len(rows) // rows_per_dispatch)
    # the stream's rollbacks replay frames with new inputs: the history latches
    assert core.check_device_verdict()[0]


@pytest.mark.cuda
def test_request_path_host_checksums_match_plain_on_card(cuda_card):
    """The request path with the verdict on the host: a session driving
    the backend on the card (K3, lazy ticks, checksums resolved through the
    ledger with pinned prefetches) and one driving it on the CPU (the plain
    version) capture the same checksum for every save, and the same state."""
    runs = []
    for device in ("cuda", "cpu"):
        sess = (SessionBuilder().with_num_players(2).with_max_prediction_window(9)
                .with_check_distance(8).with_deferred_checksum_verification(3)
                .start_synctest_session())
        backend = DeviceRollbackBackend(ExGame(2, 4096), 9, 2, lazy_ticks=4, device=device)
        rng = np.random.default_rng(21)
        saves = []
        for _ in range(30):
            for h in range(2):
                sess.add_local_input(h, bytes([int(rng.integers(0, 16))]))
            reqs = sess.advance_frame()
            backend.handle_requests(reqs)
            saves += [(r.frame, r.cell.checksum_getter()) for r in reqs if isinstance(r, SaveGameState)]
        sess.flush_checksum_checks()
        runs.append(([(f, g()) for f, g in saves], backend.state_numpy()))
    assert runs[0][0] == runs[1][0]
    for k in ("frame", "pos", "vel", "rot"):
        assert np.array_equal(runs[0][1][k], runs[1][1][k]), k


@pytest.mark.cuda
def test_beam_kernel_matches_plain_on_card(cuda_card):
    """K4 from every ring slot of a 4-player core (filled by a random tick
    stream), 30% DISCONNECTED cells: the trajectory, its checksums, the
    anchor's checksum and frame equal plain_rollout's on the same inputs."""
    core = ResimCore(ExGame(4, 4096), 12, 4, device="cuda")
    core.tick_multi(random_tick_rows(core, 20, seed=3))
    rng = np.random.default_rng(4)
    for slot in range(core.ring_len):
        B, L = 16, 1 + slot % core.window
        inputs = rng.integers(0, 16, size=(B, L, 4, 1), dtype=np.uint8)
        statuses = np.where(rng.random((B, L, 4)) < 0.3, 2, 0).astype(np.int32)
        spec = core.speculate(slot, inputs, statuses)
        plain = plain_rollout(core.carry["ring"][slot], core.carry["r_frame"][slot],
                              torch.from_numpy(inputs).cuda(), torch.from_numpy(statuses).cuda(), core.ctx)
        torch.cuda.synchronize()
        for k, a, b in zip(spec._fields, spec, plain):
            assert torch.equal(a, b), (slot, k)
    assert core.beam_rollout.launches == core.ring_len


@pytest.mark.cuda
def test_beam_request_path_matches_cpu_on_card(cuda_card):
    """The beam on the card (K4 speculations, adoptions, K3 suffixes) and
    on the CPU (the plain versions) capture the same checksum for every
    save and the same counters, on a toggling script."""
    runs = []
    for device in ("cuda", "cpu"):
        sess = (SessionBuilder().with_num_players(2).with_max_prediction_window(9)
                .with_check_distance(8).start_synctest_session())
        backend = DeviceRollbackBackend(ExGame(2, 4096), 9, 2, beam_width=16, device=device)
        saves = []
        for t in range(40):
            for h in range(2):
                sess.add_local_input(h, bytes([(5 if (t // 6) % 2 == 0 else 9) + h]))
            reqs = sess.advance_frame()
            backend.handle_requests(reqs)
            saves += [(r.frame, r.cell.checksum_getter()) for r in reqs if isinstance(r, SaveGameState)]
        runs.append(([(f, g()) for f, g in saves], backend.beam_hits, backend.beam_partial_hits,
                     backend.beam_misses, backend.state_numpy()))
        if device == "cuda":
            assert backend.core.beam_rollout.launches > 0
    assert runs[0][:4] == runs[1][:4]
    for k in ("frame", "pos", "vel", "rot"):
        assert np.array_equal(runs[0][4][k], runs[1][4][k]), k


def arena_script(rng, t_ticks, players, input_size):
    raw = rng.integers(0, 64, size=(t_ticks, players, input_size))
    if input_size == 2:
        raw[..., 1] = rng.integers(0, 16, size=(t_ticks, players))
    return torch.from_numpy(raw.astype(np.int32)).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("players,input_size,t_ticks", [(2, 1, 24), (4, 2, 24), (2, 1, 1), (17, 1, 24), (32, 2, 1),
                                                       (64, 1, 24), (64, 1, 1)])
def test_arena_fused_kernel_matches_plain_on_card(cuda_card, players, input_size, t_ticks):
    """K1 for arena (cached reductions when T > 1, inline when T == 1;
    grid barriers, cooperative launch) equals plain_batch after every
    batch, across the frame-d boundary, and after hp corruption of the
    slot the next rollback loads."""
    ctx = PlaneContext(Arena(players, 4096, input_size), players, 8, torch.device("cuda"))
    core = FusedSyncTestCore(ctx)
    kernel = sync_test.initial_carry(ctx)
    plain = copy_carry(kernel)
    rng = np.random.default_rng(players + t_ticks)
    batches = 3 if t_ticks > 1 else 14
    steady = None
    for b in range(batches):
        if b == batches - 1:  # kill 64 entities in the slot the next rollback loads
            steady = copy_carry(kernel), copy_carry(plain)
            slot = (int(kernel["meta"][0]) - ctx.d) % ctx.ring_len
            for carry in (kernel, plain):
                carry["ring"][slot, 4, :64] = 0
        inputs = arena_script(rng, t_ticks, players, input_size)
        core.batch(kernel, inputs)
        plain_batch(plain, inputs, ctx)
        torch.cuda.synchronize()
        for k in CARRY_KEYS:
            assert torch.equal(kernel[k], plain[k]), (b, k)
    assert core.launches == batches
    assert int(kernel["meta"][1]) == 1  # the probe latched

    def kill(carry, slot):
        carry["ring"][slot, 4, :64] = 0

    assert_latch_probes(core, ctx, steady, lambda t: arena_script(rng, t, players, input_size), kill, t_ticks)


@pytest.mark.cuda
def test_arena_fused_grid_that_cannot_be_resident_raises(cuda_card):
    """K1's arena grid must be resident at once for its barriers: a world
    of 8176 blocks raises KernelError instead of launching."""
    ctx = PlaneContext(Arena(16, (1 << 20) - 16 * 128), 16, 1, torch.device("cuda"))
    carry = sync_test.initial_carry(ctx)
    with pytest.raises(KernelError, match="resident"):
        FusedSyncTestCore(ctx).batch(carry, torch.zeros((2, 16, 1), dtype=torch.int32, device="cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4096, 65536])
def test_reduce_table_matches_plain_on_card(cuda_card, n):
    """K5 equals plain_reduce_table over d+1 ring slots and the state, and
    over the state alone, on a carry with dead entities."""
    ctx = PlaneContext(Arena(3, n), 3, 8, torch.device("cuda"))
    carry = sync_test.initial_carry(ctx)
    FusedSyncTestCore(ctx).batch(carry, arena_script(np.random.default_rng(1), 20, 3, 1))
    carry["ring"][2, 4, ::7] = 0
    core = ReduceTableCore(ctx)
    for frame in (3, 20):
        slots = source_slots(frame, ctx.d, ctx.ring_len)
        got = core.reduce_sources(carry, frame)
        want = plain_reduce_table(torch.stack([carry["state"] if s < 0 else carry["ring"][s] for s in slots]), ctx)
        assert torch.equal(got, want), frame
    assert torch.equal(core.frontier(carry), plain_reduce_table(carry["state"][None], ctx))
    assert torch.equal(core.table(carry["ring"]), plain_reduce_table(carry["ring"], ctx))
    assert core.launches == 4


@pytest.mark.cuda
def test_arena_injected_route_matches_plain_on_card(cuda_card):
    """The injected-reduction route (K5 tables, K2's one-launch tick: the
    tick, the next table and the verdict) on the card equals the same route
    on a CPU copy of the carry (its plain twin) after every batch, across
    the frame-d boundary, and launches one kernel a steady-state tick."""
    ctx = PlaneContext(Arena(2, 4096), 2, 8, torch.device("cuda"))
    cpu_ctx = PlaneContext(Arena(2, 4096), 2, 8, "cpu")
    core, twin = InjectedReduceCore(ctx), InjectedReduceCore(cpu_ctx)
    kernel = sync_test.initial_carry(ctx)
    plain = {k: v.cpu() for k, v in kernel.items()}
    rng = np.random.default_rng(5)
    for b in range(3):
        inputs = arena_script(rng, 7, 2, 1)
        core.batch(kernel, inputs, frame=7 * b)
        twin.batch(plain, inputs.cpu())
        torch.cuda.synchronize()
        for k in CARRY_KEYS:
            assert torch.equal(kernel[k].cpu(), plain[k]), (b, k)
    # one launch a tick, the verdict in it; K5 at each batch's first tick and
    # for each boot tick (frames 0..6 before d = 8 but a batch's last)
    assert core.tiled.launches == 21 and core.tiled.verdict_launches == 0
    assert core.reduce.launches == 3 + 7


def sms():
    return torch.cuda.get_device_properties(0).multi_processor_count


def force_tick_layout(core, regime):
    """K3-arena on `regime` ("plan": whatever arena_tick_plan picks;
    "grid-global": the states in global memory, forced on a world whose
    states would fit on chip)."""
    if regime == "grid-global":
        plan = arena_tick_plan(core.ctx.n, core.num_players, core.window, core.ctx.input_size, sms(), 0)
        core.tick_core.prepare(build.load("resim_tick"), plan)


@pytest.mark.cuda
@pytest.mark.parametrize("players,n,input_size,mp,rows_per_dispatch,regime",
                         [(2, 4096, 1, 9, 1, "plan"), (4, 4096, 2, 12, 8, "plan"), (2, 65536, 1, 9, 8, "plan"),
                          (4, 153600, 1, 9, 4, "plan"), (17, 4352, 1, 9, 8, "plan"), (32, 4096, 2, 12, 4, "plan"),
                          (64, 4096, 1, 9, 8, "plan"), (5, 4000, 2, 9, 8, "plan"), (65, 4160, 1, 9, 4, "plan"),
                          (2, 4096, 1, 9, 8, "grid-global"), (5, 4000, 2, 12, 4, "grid-global"),
                          (17, 4352, 1, 9, 1, "grid-global"), (65, 4160, 2, 9, 8, "grid-global")])
def test_arena_tick_kernel_matches_plain_on_card(cuda_card, players, n, input_size, mp, rows_per_dispatch, regime):
    """K3's arena body (a whole-world reduction and a grid barrier before
    every advance, on a persistent grid of one block an SM with the states
    on chip or, forced here on small worlds too, in global memory) on a
    stream with rollbacks, skipped and trailing saves, the throttle byte and
    DISCONNECTED slots: his/los and the whole core equal plain_tick_multi's
    after every dispatch, up to 153,600 entities, for team counts a power of
    two and not (5), past 16 and past 64 (one shared row of team sums), and
    a world not a multiple of 128."""
    core = ResimCore(Arena(players, n, input_size), mp, players, device_verify=True, device="cuda")
    force_tick_layout(core, regime)
    plain = {k: v.clone() for k, v in core.carry.items()}
    rows = np.concatenate([prime_row(core)[None],
                           random_tick_rows(core, mp + 2 + (4 if n > 65536 else 12), seed=n + players, mod=64)])
    for b in range(0, len(rows), rows_per_dispatch):
        batch = rows[b : b + rows_per_dispatch]
        his, los = core.tick_multi(batch)
        p_his, p_los = plain_tick_multi(plain, core.upload(batch), core)
        torch.cuda.synchronize()
        assert torch.equal(his, p_his) and torch.equal(los, p_los), b
        for k in RESIM_KEYS:
            assert torch.equal(core.carry[k], plain[k]), (k, b)
    assert core.tick_core.launches == -(-len(rows) // rows_per_dispatch)
    assert (core.carry["state"][4] > 0).any()
    if regime != "plan":
        assert core.tick_core.plan.regime == regime


@pytest.mark.cuda
@pytest.mark.parametrize("game_cls", [ExGame, Swarm, Arena])
@pytest.mark.parametrize("stream", TICK_STREAMS, ids=[s[0] for s in TICK_STREAMS])
def test_tick_kernel_matches_plain_on_crafted_streams_on_card(cuda_card, stream, game_cls):
    """K3's parallel scalar pass on the crafted streams of
    chip_smoke.TICK_STREAMS (loads of slots the same dispatch saved, frames
    that go back, history keys reused, hits, mismatches with the earlier
    latching, a latch carried in, verification off, skipped saves, zero-
    advance rows; 1, 8 and 16 rows at W = 11 and 14), every body (arena
    also with its states in global memory), the kernel's dispatches launched
    back to back: his/los of every dispatch and the whole core at the end
    equal plain_tick_multi's."""
    name, players, mp, per, verify, latched, specs = stream
    mod = {"ExGame": 16, "Arena": 64, "Swarm": 128}[game_cls.__name__]
    for regime in ("plan", "grid-global") if game_cls is Arena else ("plan",):
        core = ResimCore(game_cls(players, 4096), mp, players, device_verify=verify, device="cuda")
        force_tick_layout(core, regime)
        if latched:
            core.carry["flag"].copy_(torch.tensor([1, 3], dtype=torch.int32))
        plain = {k: v.clone() for k, v in core.carry.items()}
        rows = tick_stream(core, specs, seed=len(name), mod=mod)
        batches = [core.upload(rows[b : b + per]) for b in range(0, len(rows), per)]
        outs = [core.tick_core.tick_multi(core.carry, batch) for batch in batches]
        for batch, (his, los) in zip(batches, outs):
            p_his, p_los = plain_tick_multi(plain, batch, core)
            assert torch.equal(his, p_his) and torch.equal(los, p_los), regime
        for k in core.carry:
            assert torch.equal(core.carry[k], plain[k]), (regime, k)
        if verify:
            assert bool(core.carry["flag"][0])  # every stream mismatches somewhere
        assert core.tick_core.launches == len(outs)


def force_beam_layout(core, B, L, layout):
    """K4-arena on `layout`: "plan" (what beam_plan picks), "global" (the
    plan's group with the states read back from the trajectory)."""
    if layout == "global":
        ctx = core.ctx
        plan = beam_plan(ctx.n, ctx.num_players, B, core.beam_rollout.max_steps, sms(), 0)
        core.beam_rollout.prepare(build.load("beam_rollout"), B, plan)


@pytest.mark.cuda
@pytest.mark.parametrize("players,n,input_size,B,L,layout", [
    (2, 4096, 1, 16, 11, "plan"), (2, 65536, 1, 16, 11, "plan"), (4, 4096, 2, 16, 14, "plan"),
    (17, 4352, 1, 16, 11, "plan"), (32, 4096, 2, 8, 14, "plan"), (64, 4096, 1, 16, 11, "plan"),
    (5, 4000, 2, 16, 11, "plan"), (65, 4160, 1, 12, 11, "plan"), (4, 131072, 1, 16, 11, "plan"),
    (2, 4096, 1, 16, 11, "global"), (5, 4000, 2, 16, 14, "global"), (17, 4352, 1, 3, 11, "global"),
    (65, 4160, 2, 16, 11, "global"), (2, 2048, 1, 140, 4, "plan")])
def test_arena_beam_kernel_matches_plain_on_card(cuda_card, players, n, input_size, B, L, layout):
    """K4's arena body (each member reduces its own world before every
    step among its own blocks; 65536 x 16 runs where the reference falls
    back to XLA) equals plain_rollout from several ring slots, with 20%
    DISCONNECTED cells, its states on chip or read back from the
    trajectory (131,072 entities a member, and forced on small worlds),
    for team counts a power of two and not, past 16 and past 64, a world
    not a multiple of 128, and more members than the grid holds at once
    (140: a group serves two in turn)."""
    core = ResimCore(Arena(players, n, input_size), 12, players, device="cuda")
    force_beam_layout(core, B, L, layout)
    core.tick_multi(np.concatenate([prime_row(core)[None], random_tick_rows(core, 20, seed=3, mod=64)]))
    rng = np.random.default_rng(n + B)
    for slot in (0, 3, 7):
        inputs = rng.integers(0, 64, size=(B, L, players, input_size), dtype=np.uint8)
        if input_size == 2:
            inputs[..., 1] = rng.integers(0, 16, size=(B, L, players))
        statuses = np.where(rng.random((B, L, players)) < 0.2, 2, 0).astype(np.int32)
        spec = core.speculate(slot, inputs, statuses)
        plain = plain_rollout(core.carry["ring"][slot], core.carry["r_frame"][slot],
                              torch.from_numpy(inputs).cuda(), torch.from_numpy(statuses).cuda(), core.ctx)
        torch.cuda.synchronize()
        for k, a, b in zip(spec._fields, spec, plain):
            assert torch.equal(a, b), (slot, k)
    assert core.beam_rollout.launches == 3
    assert core.beam_rollout.plans[B].on_chip == (layout == "plan" and n <= 65536)


@pytest.mark.cuda
def test_arena_beam_request_path_matches_cpu_on_card(cuda_card):
    """Arena's beam on the card (K4 speculations, adoptions, K3 suffixes)
    and on the CPU (the plain versions) capture the same checksum for every
    save and the same counters, on a toggling script, device verification
    on."""
    runs = []
    for device in ("cuda", "cpu"):
        sess = (SessionBuilder().with_num_players(2).with_max_prediction_window(9)
                .with_check_distance(8).with_device_checksum_verification(True).start_synctest_session())
        backend = DeviceRollbackBackend(Arena(2, 4096), 9, 2, beam_width=16, device_verify=True, device=device)
        saves = []
        for t in range(40):
            for h in range(2):
                sess.add_local_input(h, bytes([(1 if (t // 6) % 2 == 0 else 9) + h]))
            reqs = sess.advance_frame()
            backend.handle_requests(reqs)
            saves += [(r.frame, r.cell.checksum_getter()) for r in reqs if isinstance(r, SaveGameState)]
        backend.check()
        runs.append(([(f, g()) for f, g in saves], backend.beam_hits, backend.beam_partial_hits,
                     backend.beam_misses, backend.state_numpy()))
        if device == "cuda":
            assert backend.core.beam_rollout.launches > 0 and backend.core.tick_core.launches > 0
    assert runs[0][:4] == runs[1][:4]
    assert runs[0][1] + runs[0][2] > 0
    for k in ("frame", "pos", "vel", "hp", "energy"):
        assert np.array_equal(runs[0][4][k], runs[1][4][k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("players", [17, 32, 64])
def test_arena_many_teams_reduce_and_injected_route_match_plain_on_card(cuda_card, players):
    """Past 16 teams (summed 16 a pass): K5 over d+1 sources with dead
    entities equals plain_reduce_table, and the injection route (K5 tables,
    K2 one tick per launch, the verdict) equals its plain twin on a CPU
    copy after every batch, across frame d."""
    n = 4096 + (256 if players == 17 else 0)
    ctx = PlaneContext(Arena(players, n), players, 8, torch.device("cuda"))
    cpu_ctx = PlaneContext(Arena(players, n), players, 8, "cpu")
    core, twin = InjectedReduceCore(ctx), InjectedReduceCore(cpu_ctx)
    kernel = sync_test.initial_carry(ctx)
    plain = {k: v.cpu() for k, v in kernel.items()}
    rng = np.random.default_rng(players)
    for b in range(3):
        inputs = arena_script(rng, 7, players, 1)
        core.batch(kernel, inputs, frame=7 * b)
        twin.batch(plain, inputs.cpu())
        torch.cuda.synchronize()
        for k in CARRY_KEYS:
            assert torch.equal(kernel[k].cpu(), plain[k]), (b, k)
    kernel["ring"][:, 4, 1::3] = 0
    slots = source_slots(21, ctx.d, ctx.ring_len)
    want = plain_reduce_table(torch.stack([kernel["state"] if s < 0 else kernel["ring"][s] for s in slots]), ctx)
    assert torch.equal(core.reduce.reduce_sources(kernel, 21), want)


@pytest.mark.cuda
@pytest.mark.parametrize("players,n,input_size,t_ticks,regime", [
    (2, 4096, 1, 24, "grid-shared"), (3, 4096, 2, 1, "grid-shared"), (17, 4352, 1, 12, "grid-shared"),
    (16, 1 << 19, 1, 12, "grid-shared"), (3, 96, 1, 12, "grid-shared"), (3, 9000, 2, 1, "grid-shared"),
    (3, 9000, 1, 12, "grid-shared"), (5, 20000, 1, 12, "grid-shared"), (12, 12672, 1, 12, "grid-shared"),
    (32, 2_000_000, 1, 2, "grid-global"), (65, 1024, 1, 12, "grid-shared")])
def test_arena_tiled_inline_kernel_matches_plain_on_card(cuda_card, players, n, input_size, t_ticks, regime):
    """K2's inline whole-world arena route (any T per launch, a grid
    barrier before every step) in each regime `inline_plan` picks — the
    states on chip (the headline world, Arena(16, 2^19), 96 entities one
    a block) and in global memory (two million entities); blocks of 96,
    160 and 96 threads that 3, 5 and 12 teams divide, so a thread's team
    is fixed with P no power of two; past 64 teams the warps share one row
    of team sums — equals plain_parts and
    plain_verdict: parts and full carry after every batch, across frame d,
    and after hp = 0 in the slot the next rollback loads, where both latch
    the same frame."""
    ctx = PlaneContext(Arena(players, n, input_size), players, 8, torch.device("cuda"))
    core = TiledSyncTestCore(ctx)
    kernel = sync_test.initial_carry(ctx)
    plain = copy_carry(kernel)
    rng = np.random.default_rng(players + t_ticks)
    batches = {1: 12, 2: 7}.get(t_ticks, 3)  # the probe's batch rolls back
    for b in range(batches):
        if b == batches - 1:
            slot = (int(kernel["meta"][0]) - ctx.d) % ctx.ring_len
            for carry in (kernel, plain):
                carry["ring"][slot, 4, :64] = 0
        inputs = arena_script(rng, t_ticks, players, input_size)
        k_hi, k_lo = core.run_kernel(kernel, inputs)
        p_hi, p_lo = plain_parts(plain, inputs, ctx)
        torch.cuda.synchronize()
        assert torch.equal(k_hi, p_hi) and torch.equal(k_lo, p_lo), b
        core.verdict(kernel, k_hi, k_lo)
        plain_verdict(plain, p_hi, p_lo, ctx)
        for k in CARRY_KEYS:
            assert torch.equal(kernel[k], plain[k]), (b, k)
    assert core.launches == core.verdict_launches == batches
    assert kernel["meta"][1] == 1  # the probe latched
    assert core.plan.regime == regime


@pytest.mark.cuda
def test_reduce_table_back_to_back_into_dirty_out_on_card(cuda_card):
    """50 K5 launches back to back, no synchronisation between them, of
    mixed S (1, d+1, the whole ring) and worlds (one block a source at
    4096; a scratch row and a ticket a source at 65536 and past it; teams
    dividing the block and not; past 64 teams, one shared row of team
    sums), each into an `out` full of garbage: each
    equals plain_reduce_table, so the kernel overwrites `out` and leaves its
    scratch and tickets zero for the next launch."""
    rng = np.random.default_rng(50)
    worlds = []
    for players, n in ((2, 4096), (3, 65536), (17, 70000), (64, 4096), (80, 12000)):
        ctx = PlaneContext(Arena(players, n), players, 8, torch.device("cuda"))
        carry = sync_test.initial_carry(ctx)
        carry["ring"].copy_(torch.from_numpy(rng.integers(0, 1 << 18, size=tuple(carry["ring"].shape),
                                                          dtype=np.int32)))
        carry["ring"][:, 4] -= 1 << 16  # hp: about a quarter dead
        worlds.append((ctx, ReduceTableCore(ctx), carry))
    results = []
    for k in range(50):
        ctx, core, carry = worlds[rng.integers(len(worlds))]
        slots = [(STATE_SLOT,), source_slots(int(rng.integers(0, 40)), ctx.d, ctx.ring_len),
                 tuple(range(ctx.ring_len))][k % 3]
        out = torch.full((len(slots), ctx.reduce_len), -12345, dtype=torch.int32, device="cuda")
        core.gather(carry["ring"], carry["state"], slots, out=out)
        want = plain_reduce_table(torch.stack([carry["state"] if s < 0 else carry["ring"][s] for s in slots]), ctx)
        results.append((out, want))
    torch.cuda.synchronize()
    for k, (out, want) in enumerate(results):
        assert torch.equal(out, want), k
    assert sum(core.launches for _, core, _ in worlds) == 50


def swarm_script(rng, t_ticks, players):
    return torch.from_numpy(rng.integers(0, 128, size=(t_ticks, players, 1)).astype(np.int32)).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("core_cls,n,t_ticks", [(FusedSyncTestCore, 4096, 24), (FusedSyncTestCore, 4096, 1),
                                                (TiledSyncTestCore, 65536, 24)])
def test_swarm_synctest_kernels_match_plain_on_card(cuda_card, core_cls, n, t_ticks):
    """K1's and K2's swarm bodies equal plain_batch after every batch
    (inputs below 128: all axis bits and BOOST), across frame d and after a
    corrupted position in the slot the next rollback loads."""
    ctx = PlaneContext(Swarm(3, n), 3, 8, torch.device("cuda"))
    core = core_cls(ctx)
    kernel = sync_test.initial_carry(ctx)
    plain = copy_carry(kernel)
    rng = np.random.default_rng(n + t_ticks)
    batches = 3 if t_ticks > 1 else 14
    steady = None
    for b in range(batches):
        if b == batches - 1:
            steady = copy_carry(kernel), copy_carry(plain)
            slot = (int(kernel["meta"][0]) - ctx.d) % ctx.ring_len
            for carry in (kernel, plain):
                carry["ring"][slot, 0, 5] += 7
        inputs = swarm_script(rng, t_ticks, 3)
        core.batch(kernel, inputs)
        plain_batch(plain, inputs, ctx)
        torch.cuda.synchronize()
        for k in CARRY_KEYS:
            assert torch.equal(kernel[k], plain[k]), (b, k)
    assert core.launches == batches
    assert int(kernel["meta"][1]) == 1  # the probe latched

    def corrupt(carry, slot):  # px: the torus wrap keeps it
        carry["ring"][slot, 0, 5] += 7

    assert_latch_probes(core, ctx, steady, lambda t: swarm_script(rng, t, 3), corrupt, t_ticks)


@pytest.mark.cuda
@pytest.mark.parametrize("rows_per_dispatch", [1, 8])
def test_swarm_tick_kernel_matches_plain_on_card(cuda_card, rows_per_dispatch):
    """K3's swarm body on a 4-player stream with rollbacks, skipped and
    trailing saves and DISCONNECTED slots: his/los and the whole core equal
    plain_tick_multi's after every dispatch."""
    core = ResimCore(Swarm(4, 4096), 12, 4, device_verify=True, device="cuda")
    plain = {k: v.clone() for k, v in core.carry.items()}
    rows = random_tick_rows(core, 4 * 8 + 14, seed=6, mod=128)
    for b in range(0, len(rows), rows_per_dispatch):
        batch = rows[b : b + rows_per_dispatch]
        his, los = core.tick_multi(batch)
        p_his, p_los = plain_tick_multi(plain, core.upload(batch), core)
        torch.cuda.synchronize()
        assert torch.equal(his, p_his) and torch.equal(los, p_los), b
        for k in RESIM_KEYS:
            assert torch.equal(core.carry[k], plain[k]), (k, b)
    assert core.tick_core.launches == -(-len(rows) // rows_per_dispatch)


@pytest.mark.cuda
def test_swarm_beam_kernel_matches_plain_on_card(cuda_card):
    """K4's swarm body from every ring slot of a 4-player core, 30%
    DISCONNECTED cells: trajectory, checksums, anchor equal plain_rollout's."""
    core = ResimCore(Swarm(4, 4096), 12, 4, device="cuda")
    core.tick_multi(random_tick_rows(core, 20, seed=3, mod=128))
    rng = np.random.default_rng(7)
    for slot in range(core.ring_len):
        B, L = 16, 1 + slot % core.window
        inputs = rng.integers(0, 128, size=(B, L, 4, 1), dtype=np.uint8)
        statuses = np.where(rng.random((B, L, 4)) < 0.3, 2, 0).astype(np.int32)
        spec = core.speculate(slot, inputs, statuses)
        plain = plain_rollout(core.carry["ring"][slot], core.carry["r_frame"][slot],
                              torch.from_numpy(inputs).cuda(), torch.from_numpy(statuses).cuda(), core.ctx)
        torch.cuda.synchronize()
        for k, a, b in zip(spec._fields, spec, plain):
            assert torch.equal(a, b), (slot, k)
    assert core.beam_rollout.launches == core.ring_len


@pytest.mark.cuda
@pytest.mark.parametrize("game", [ExGame(2, 4096), ExGame(2, 4096, substeps=2), Swarm(2, 4096)],
                         ids=["ex_game", "ex_game_substeps2", "swarm"])
def test_beam_back_to_back_launches_match_plain_on_card(cuda_card, game):
    """K4's per-entity body launched back to back into the scratch the
    previous launch left (zeroed once, never again), at widths that grow
    and shrink: every speculation equals plain_rollout's, also from a
    corrupted anchor, which changes every checksum."""
    mod = 128 if isinstance(game, Swarm) else 16
    core = ResimCore(game, 12, 2, device="cuda")
    core.tick_multi(random_tick_rows(core, 20, seed=5, mod=mod))
    ring, r_frame = core.carry["ring"], core.carry["r_frame"]
    rng = np.random.default_rng(8)
    plane = 0 if isinstance(game, Swarm) else 4
    clean = None
    for k, (B, L) in enumerate([(16, 11), (16, 11), (5, 3), (16, 11), (12, 12), (1, 1), (16, 11)]):
        slot = (2 * k + 1) % core.ring_len
        inputs = rng.integers(0, mod, size=(B, L, 2, 1), dtype=np.uint8)
        statuses = np.where(rng.random((B, L, 2)) < 0.1, 2, 0).astype(np.int32)
        corrupt = k == 3
        if corrupt:
            clean = core.speculate(slot, inputs, statuses)
            ring[slot, plane, :64] += 7
        spec = core.speculate(slot, inputs, statuses)
        plain = plain_rollout(ring[slot], r_frame[slot], torch.from_numpy(inputs).cuda(),
                              torch.from_numpy(statuses).cuda(), core.ctx)
        torch.cuda.synchronize()
        for name, a, b in zip(spec._fields, spec, plain):
            assert torch.equal(a, b), (k, name)
        if corrupt:
            assert not torch.equal(spec.his, clean.his) and not torch.equal(spec.a_hi, clean.a_hi)
            ring[slot, plane, :64] -= 7
    assert core.beam_rollout.launches == 8
    assert not core.beam_rollout._scratch.any()


@pytest.mark.cuda
@pytest.mark.parametrize("players", [2, 17])
def test_injected_tick_back_to_back_matches_plain_on_card(cuda_card, players):
    """K2's injected tick launched back to back on alternating tables into
    the scratch the previous launch left, across frame d, from a fresh
    carry: after every launch the carry, the table it ran on (row d left
    zero) and the next table equal plain_injected_tick's on a CPU copy; the
    scratch stays zero; then a kill probe in the slot the next launch
    loads latches the same frame."""
    d = 8
    n = 4096 + (256 if players == 17 else 0)
    ctx = PlaneContext(Arena(players, n), players, d, torch.device("cuda"))
    cpu_ctx = PlaneContext(Arena(players, n), players, d, "cpu")
    core, k5 = TiledSyncTestCore(ctx), ReduceTableCore(ctx)
    kernel = sync_test.initial_carry(ctx)
    plain = {k: v.cpu() for k, v in kernel.items()}
    tables = torch.zeros((2, d + 1, 3 * players), dtype=torch.int32, device="cuda")
    cpu_tables = tables.cpu()
    rng = np.random.default_rng(players)
    k5.reduce_sources(kernel, 0, out=tables[0])
    cpu_tables[0] = tables[0].cpu()
    cur = 0
    for c in range(2 * d + 4):
        if c == 2 * d + 2:  # the probe: hp = 0 in the slot this tick loads
            for carry in (kernel, plain):
                carry["ring"][(c - d) % ctx.ring_len, 4, :64] = 0
        inputs = arena_script(rng, 1, players, 1)
        core.tick_injected(kernel, inputs, tables[cur], tables[1 - cur])
        plain_injected_tick(plain, inputs.cpu(), cpu_tables[cur], cpu_tables[1 - cur], cpu_ctx)
        torch.cuda.synchronize()
        for k in CARRY_KEYS:
            assert torch.equal(kernel[k].cpu(), plain[k]), (c, k)
        assert torch.equal(tables.cpu(), cpu_tables), c
        assert not tables[cur][d].any() and not core._tick_scratch.any(), c
        cur = 1 - cur
        if c < d:  # the boot branch: the next table in full
            k5.reduce_sources(kernel, c + 1, out=tables[cur])
            cpu_tables[cur] = tables[cur].cpu()
    assert kernel["meta"].tolist()[1:] == [1, d + 3] == plain["meta"].tolist()[1:]
    assert core.launches == 2 * d + 4 and core.verdict_launches == 0


@pytest.mark.cuda
def test_swarm_paths_match_cpu_on_card(cuda_card):
    """Swarm's fused session (auto -> K1) and its beam request path (K4,
    adoptions, K3 suffixes) on the card equal the same runs on the CPU."""
    rng = np.random.default_rng(8)
    raw = rng.integers(0, 128, size=(30, 2, 1), dtype=np.uint8)
    carries = []
    for device in ("cuda", "cpu"):
        sess = DeviceSyncTestSession(Swarm(2, 4096), 2, 8, device=device)
        for b in range(3):
            sess.advance_frames(raw[10 * b : 10 * b + 10])
        sess.check()
        carries.append({k: v.cpu() for k, v in sess.carry.items()})
    for k in CARRY_KEYS:
        assert torch.equal(carries[0][k], carries[1][k]), k
    runs = []
    for device in ("cuda", "cpu"):
        sess = (SessionBuilder().with_num_players(2).with_max_prediction_window(9)
                .with_check_distance(8).with_device_checksum_verification(True).start_synctest_session())
        backend = DeviceRollbackBackend(Swarm(2, 4096), 9, 2, beam_width=16, device_verify=True, device=device)
        saves = []
        for t in range(40):
            for h in range(2):
                sess.add_local_input(h, bytes([(65 if (t // 6) % 2 == 0 else 22) + h]))
            reqs = sess.advance_frame()
            backend.handle_requests(reqs)
            saves += [(r.frame, r.cell.checksum_getter()) for r in reqs if isinstance(r, SaveGameState)]
        backend.check()
        runs.append(([(f, g()) for f, g in saves], backend.beam_hits, backend.beam_partial_hits,
                     backend.beam_misses, backend.state_numpy()))
        if device == "cuda":
            assert backend.core.beam_rollout.launches > 0 and backend.core.tick_core.launches > 0
    assert runs[0][:4] == runs[1][:4]
    assert runs[0][1] + runs[0][2] > 0
    for k in ("frame", "pos", "vel", "charge"):
        assert np.array_equal(runs[0][4][k], runs[1][4][k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("lazy", [0, 5])
def test_p2p_match_matches_plain_on_card(cuda_card, lazy):
    """A short 2-player P2P match (port sessions on an in-memory network with
    latency, jitter and loss) with both peers on the card: peer 0's
    recorded stream replayed on the plain versions on the CPU gives every
    save's checksum, the state and the ring; no desync is reported."""
    m = p2p_match(np, 2, 1024, 8, 80, "cuda", lazy=lazy)
    for b in m.backends:
        b.block_until_ready()
    assert m.loads > 10 and all(b.core.tick_core.launches > 0 for b in m.backends)
    assert not any(type(e).__name__ == "DesyncDetected" for ev in m.events for e in ev)
    cpu = DeviceRollbackBackend(ExGame(2, 1024), 8, 2, lazy_ticks=lazy, device="cpu")
    saves, _ = p2p_replay(m.stream, cpu)
    cpu.flush()
    assert [(f, g()) for f, g in saves] == [(f, g()) for f, g in m.saves0]
    card = m.backends[0].core.carry
    for k, v in cpu.core.carry.items():
        assert torch.equal(v, card[k].cpu()), k


MEGABATCH_GAMES = [(ExGame, 16), (Swarm, 128), (Arena, 64)]  # the family and its input bound


def assert_megabatch_launches(m):
    """A stacked K3 launch a megabatch, or a K3-arena launch a row."""
    if m.tick_core.stacked:
        assert m.tick_core.launches == m.megabatches and m.core.tick_core.launches == 0
    else:
        assert m.core.tick_core.launches == m.rows_dispatched and m.tick_core.launches == 0


def request_kinds(stream):
    """A recorded P2P stream without its cells' identities."""
    return [[r if r[0] == "AdvanceFrame" else r[:2] for r in tick] for tick in stream]


def assert_megabatch_matches_plain(m, twin, key, entries, la):
    """One megabatch through the core on the card and through
    plain_megabatch on a twin stack: his/los of every bucket row (the pad
    rows (0, 0)) and both whole stacks equal."""
    nslots = m.group_depth(key)
    batch, bucket = (m.dispatch(entries, fast=True) if key == "fast" else m.dispatch(entries, last_active=la))
    idx = [s for s, _ in entries]
    rows = np.stack([r for _, r in entries])
    p_his, p_los = plain_megabatch(twin, idx, rows, nslots, m.core, bucket)
    torch.cuda.synchronize()
    assert batch._his.shape == (bucket, m.core.window)
    assert torch.equal(batch._his, p_his) and torch.equal(batch._los, p_los), key
    assert not batch._his[len(entries):].any() and not batch._los[len(entries):].any()
    for k, v in m.stack.items():
        assert torch.equal(v, twin[k]), (key, k)


@pytest.mark.cuda
@pytest.mark.parametrize("game_cls,mod", MEGABATCH_GAMES, ids=[g.__name__ for g, _ in MEGABATCH_GAMES])
def test_megabatch_matches_plain_on_card(cuda_card, game_cls, mod):
    """Eight sessions' seeded session-shaped streams (rollbacks that load a
    slot and save into it in one row, skipped and trailing saves,
    DISCONNECTED slots) as the host groups them, a megabatch per group on
    the card (K3's stacked entry; arena a K3-arena launch a row) against
    plain_megabatch on a twin stack, after every megabatch."""
    m = MultiSessionDeviceCore(game_cls(4, 4096), 8, 4, 8, buckets=(8,), device="cuda")
    twin = {k: v.clone() for k, v in m.stack.items()}
    seen = set()
    for entries in megabatch_ticks(m, 20, seed=41, mod=mod, prime=game_cls is Arena):
        for key, group, la in m.group(entries):
            seen.add(key)
            assert_megabatch_matches_plain(m, twin, key, group, la)
    assert "fast" in seen and len(seen) >= 3
    assert_megabatch_launches(m)


@pytest.mark.cuda
@pytest.mark.parametrize("game_cls,mod", MEGABATCH_GAMES, ids=[g.__name__ for g, _ in MEGABATCH_GAMES])
def test_megabatch_one_live_row_at_every_depth_on_card(cuda_card, game_cls, mod):
    """Launches with one live row in a bucket of 8 (seven pad rows that
    must read (0, 0)) at the fast depth and at every depth bucket,
    including a row that loads the slot it saves first: each equal to
    plain_megabatch on a twin stack."""
    m = MultiSessionDeviceCore(game_cls(4, 4096), 8, 4, 8, buckets=(8,), device="cuda")
    twin = {k: v.clone() for k, v in m.stack.items()}
    ticks = megabatch_ticks(m, 16, seed=7, mod=mod, prime=game_cls is Arena)
    depths = set()
    for t, entries in enumerate(ticks):
        slot, row, la = entries[t % m.capacity]
        key = "fast" if m.fast_eligible(row, la) else m.depth_bucket_for(la)
        depths.add(key)
        assert_megabatch_matches_plain(m, twin, key, [(slot, row)], la)
    # each depth bucket on a row cut to fit it
    for d in m.depth_buckets:
        slot, row, la = ticks[-1][d % m.capacity]
        assert_megabatch_matches_plain(m, twin, d, [(slot, windowed_row(row, d, m.core))], d)
    assert "fast" in depths
    assert_megabatch_launches(m)


def synctest_session(lag=0):
    """A 2-player SyncTest session, check distance 4; `lag` > 0 compares
    checksums `lag` ticks late, in bursts (no read on the other ticks)."""
    return (SessionBuilder(input_size=1).with_num_players(2).with_max_prediction_window(8)
            .with_check_distance(4).with_deferred_checksum_verification(lag).start_synctest_session())


def drive_synctest(sess, backend, ticks, start=0):
    """`ticks` SyncTest ticks (a rollback every tick) of `sess` on
    `backend`, inputs seeded by the tick number from `start`; returns each
    save's (frame, checksum getter), taken at save time."""
    getters = []
    for t in range(start, start + ticks):
        for h in range(2):
            sess.add_local_input(h, bytes([(t * (3 + h) + h) % 16]))
        reqs = sess.advance_frame()
        backend.handle_requests(reqs)
        getters += [(r.frame, r.cell.checksum_getter()) for r in reqs if isinstance(r, SaveGameState)]
    return getters


def assert_backends_equal(a, b):
    a.block_until_ready()
    b.block_until_ready()
    for k, v in a.core.carry.items():
        assert torch.equal(v, b.core.carry[k]), k


@pytest.mark.cuda
def test_async_backend_matches_eager_on_card(cuda_card):
    """The async pipeline on the card (lazy 8 in pinned pooled buffers
    behind a CUDA-event fence of depth 2) against the eager backend over a
    SyncTest stream with a rollback every tick: every save's checksum and
    the final core equal, the fence held and retired."""
    def drive(backend):
        return [(f, g()) for f, g in drive_synctest(synctest_session(), backend, 60)]

    eager = DeviceRollbackBackend(ExGame(2, 4096), 8, 2, device="cuda")
    asynch = DeviceRollbackBackend(ExGame(2, 4096), 8, 2, async_dispatch=True, async_inflight=2, device="cuda")
    assert drive(eager) == drive(asynch)
    assert len(eager.fence) == 0 and asynch.lazy_ticks == 8
    assert_backends_equal(eager, asynch)
    assert asynch.core.tick_core.launches > 0 and len(asynch.fence) == 0


@pytest.mark.cuda
def test_async_backend_reset_mid_pipeline_on_card(cuda_card):
    """An async backend (lazy 2, fence depth 1) reset while a dispatch is
    still queued on the card behind a spin, a row staged: reset waits for
    it, so the next session's rows, packed into the pooled buffer that
    dispatch still has to upload, cannot overwrite it first. Both
    sessions' saves, the old one's read only after the next one ran,
    equal an eager backend's over the same two sessions. The first
    session reads checksums every 8th tick only (a read would wait for
    the spin)."""
    asynch = DeviceRollbackBackend(ExGame(2, 4096), 8, 2, async_dispatch=True, async_inflight=1, lazy_ticks=2,
                                   device="cuda")
    sess = synctest_session(lag=8)
    old = drive_synctest(sess, asynch, 20)
    torch.cuda._sleep(200_000_000)  # about 0.1 s of spinning ahead of the next dispatch
    old += drive_synctest(sess, asynch, 2, start=20)  # a dispatch behind the spin, then a staged row
    asynch.fence.poll()
    assert asynch._rows_count == 1
    assert len(asynch.fence) == 1, "the dispatch behind the spin has retired: nothing was in flight"
    asynch.reset()
    assert len(asynch.fence) == 0 and asynch.current_frame == 0
    new = drive_synctest(synctest_session(), asynch, 30)
    eager = DeviceRollbackBackend(ExGame(2, 4096), 8, 2, device="cuda")
    eager_old = drive_synctest(synctest_session(lag=8), eager, 22)
    eager.reset()
    eager_new = drive_synctest(synctest_session(), eager, 30)
    assert [(f, g()) for f, g in old] == [(f, g()) for f, g in eager_old]
    assert [(f, g()) for f, g in new] == [(f, g()) for f, g in eager_new]
    assert_backends_equal(eager, asynch)


@pytest.mark.cuda
def test_async_p2p_match_matches_eager_on_card(cuda_card):
    """A 2-player P2P match on the card with deterministic checksum
    publishing, every peer eager, then every peer async: the same request
    streams, every save's checksum and the confirmed checksums equal, no
    desync."""
    eager = p2p_match(np, 2, 1024, 8, 80, "cuda", publish="interval")
    asynch = p2p_match(np, 2, 1024, 8, 80, "cuda", publish="interval", async_dispatch=True)
    for m in (eager, asynch):
        assert not any(type(e).__name__ == "DesyncDetected" for ev in m.events for e in ev)
    assert request_kinds(eager.stream) == request_kinds(asynch.stream)
    assert [(f, g()) for f, g in eager.saves0] == [(f, g()) for f, g in asynch.saves0]
    for a, b in zip(eager.sessions, asynch.sessions):
        assert a.local_checksum_history == b.local_checksum_history and a.local_checksum_history
    assert all(b.async_dispatch and b.core.tick_core.launches > 0 for b in asynch.backends)
