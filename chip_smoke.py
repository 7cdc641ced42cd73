#!/usr/bin/env python3
"""Proof that the PyTorch + CUDA port of ggrs_tpu starts and is right on one
NVIDIA card (written for an H100). Run from the repository root:

    python3 chip_smoke.py

1. Prints the card (`nvidia-smi` name and power limit), builds every CUDA
   kernel of the fused SyncTest path from `ggrs_tpu_torch/csrc/` (one
   `nvcc` per source, all in parallel) and prints the build time.
2. Holds each kernel against its plain PyTorch version on the card, full
   carry compared bit for bit after every batch (tolerance zero: the
   determinism contract is exact): K1 (whole-batch) on ExGame(2, 4096),
   d=8, T=60, 3 batches and ExGame(2, 65536), d=16, T=60; K2 (entity-tiled,
   plus its verdict post-pass) on ExGame(2, 1048576), d=8, T=240, 1
   batch. Then a divergence probe per kernel: corrupt the ring slot the
   next rollback loads, and kernel and plain version must latch the same
   mismatch frame. K1's time stands beside its tail's verdict timed alone
   on the same batch's parts; K2's verdict is timed queued back to back.
   Then the verdict kernel against plain_verdict on every crafted stream
   of VERDICT_STREAMS (carried history, planted differences, a latch on
   entry).
3. Drives the main path, `DeviceSyncTestSession(backend="auto")`, at the
   three shapes: "auto" must pick K1, K1, K2; each kernel's launch count is
   set to 0 just before and read just after, and must be above 0; the
   final carry must equal the plain version's from step 2 and `check()`
   must pass. Prints rollback-frames/s and ms per batch (CUDA events).
4. Holds K3, ResimCore's packed control-word tick, against its plain
   version on the card after every dispatch (his/los and the whole core,
   tolerance zero), 1-row and 8-row dispatches of seeded session-shaped
   streams with rollbacks and DISCONNECTED slots, device verification on:
   ExGame(2, 4096) at max_prediction 9, ExGame(4, 4096) at 12 and
   ExGame(2, 1048576) at 9. Then a divergence probe per shape through the
   request path: corrupt the ring slot the next rollback loads, and the
   kernel and the plain version must latch the same mismatch frame. Then
   K3 against its plain version on every crafted stream of TICK_STREAMS
   (what the scalar pass computes: state frames after loads of slots the
   same dispatch saved, frames going back, history keys reused, hits and
   mismatches, a latch carried in, verification off, zero-advance rows; 1,
   8 and 16 rows at W = 11 and 14) on ex_game, swarm and arena, arena on
   both of its layouts, the dispatches launched back to back.
5. Drives the request path, `SessionBuilder().start_synctest_session()`
   -> `DeviceRollbackBackend(device="cuda")` (check distance 8, device
   verification), eager and with lazy_ticks=8, at 4096 and 1M entities: K3's
   launch count is set to 0 just before each run and must be above 0 just
   after; the final core must equal the plain version's on the same inputs
   and `check()` must pass. Prints ms per tick p50/p90 (CUDA events around
   `handle_requests`, and host wall time), the session's host time per
   tick, K3's ms per dispatch (device time, launches queued behind a spin
   kernel) and rollback-frames/s (the frames the run's rollbacks
   resimulated, over its wall time). Then the same path with the verdict on
   the host: every save's checksum, resolved through the lazy-checksum
   ledger, must equal the plain version's.
6. Holds K4, the speculative beam rollout, against its plain version
   (`beam_core.plain_rollout`) on the card, bit for bit (trajectory, per-step
   checksums, the anchor's checksum and frame) for every speculation of a
   short run from a ring filled by random ticks: b16_4096 (ExGame(2, 4096),
   16 members x 11 steps), b12_65536 (65536 entities, 12 x 11) and
   b16_4p_4096 (4 players, 16 x 14, with DISCONNECTED cells). A divergence
   probe corrupts the anchor slot: kernel and plain version still agree, and
   both differ from the clean speculation. Prints K4 ms (queued behind a spin
   kernel), the plain ms and the bound; after the timed launches (into the
   scratch each left) one more must equal the plain version, and the
   scratch must be zero.
7. Drives the beam request path at b16_4096 and b12_65536:
   `SessionBuilder().start_synctest_session()` (check distance 8) ->
   `DeviceRollbackBackend(beam_width=B)` beside a beam-off twin over the same
   inputs, three scripts (constant, per-frame varying, a held toggle every 6
   frames). After every tick the live states must be equal, and every save's
   checksum (bound at save time) must equal the twin's; K4 and K3 launch
   counts are set to 0 before each run and must be above 0 after, with
   adoptions above 0. Prints ms per tick (host wall, CUDA events) beam on
   beside beam off, the host time of candidate generation alone, the
   adopted share of rollback frames and the hit/partial/miss counts. A
   device-verify divergence probe (a corrupted anchor snapshot) must latch
   a mismatch with the beam on.
8. Holds arena's K1 (per-frame reduction cache and grid barriers) against
   its plain version, full carry after every batch, tolerance zero:
   a1_4096 (Arena(2, 4096), d=8, T=60, 3 batches), a1_65536 (Arena(2,
   65536), 2 batches), a1_4p_w (Arena(4, 4096, input_size=2), 2 batches),
   and 12 single-tick batches at 4096 (inline reductions, across frame d).
   A divergence probe per mode kills entities (hp = 0) in the ring slot the
   next rollback loads: kernel and plain version latch the same frame.
   Then K5 (the reduction table) against its plain version over d+1
   sources and over the live state at 4096 and 65536, and the
   injected-reduction route (K5 tables at a batch's start and before frame
   d, K2's one-launch tick: the tick, the next table and the verdict)
   against its plain twin on the card: ai_4096 (60 ticks) and ai_65536 (30
   ticks), both across frame d, with a divergence probe; then the tick
   alone against plain_injected_tick over launches back to back, and its
   time.
9. Drives arena's main path: `DeviceSyncTestSession(Arena(2, N), 2, 8,
   backend="auto")` must pick K1 at 4096 and 65536, and
   backend="cuda-tiled-injected" runs the injection route at both; the launch counts of K1, or of K2's
   tick and K5, are set to 0 just before each run and must be above 0
   after (the route: one tick launch a tick, K5 once a batch and at each
   boot tick, no verdict launch); the final carry must equal the plain
   version's and `check()` must pass. Prints ms per batch (K1) or per tick (injection route) p50/p90
   from CUDA events and rollback-frames/s.
10. Holds arena's K3 body (a whole-world reduction and a grid barrier
   before every advance, on a grid of one block an SM) against
   plain_tick_multi after every dispatch (his/los and the whole core,
   device verification on, tolerance zero): ar4_l16 (Arena(4, 4096),
   max_prediction 9, bench.py:1275's 16-row buffers with an 8-frame
   rollback in every row, timed per rollback tick), ar2_4096, ar2_65536,
   ar4_w (Arena(4, 4096, input_size=2) at max_prediction 12, DISCONNECTED
   slots), ar4_153600 (a few rows, parity only), all with the states on
   chip, and ar32_2m (Arena(32, 2000000), parity only: past the card's
   shared memory, the states in global memory), each with a kill probe
   (hp = 0 in the slot the next rollback loads) through the request path
   that kernel and plain version latch at the same frame; each prints its
   layout and must take the expected one. Then arena's K4 body (each
   member's own blocks and barrier) against plain_rollout (trajectory,
   checksums, anchor): ab16_4096 (Arena(2, 4096), 16 x 11), ab16_65536 (the
   case the reference sends to XLA), ab16_4p_w (Arena(4, 4096,
   input_size=2), 16 x 14, 20% DISCONNECTED), with the states on chip, and
   ab16_131072 (Arena(4, 131072), parity only: the states read back from
   the trajectory), each with a kill probe on the anchor.
11. Drives arena's request path, `SessionBuilder().start_synctest_session()`
   (check distance 8) -> `DeviceRollbackBackend(Arena(2, N), 9,
   device_verify=True)` at 4096 and 65536, eager and lazy_ticks=8, and
   Arena(4, 4096) with 16-row lazy buffers; then the beam path at
   ab16_4096 and ab16_65536 beside a beam-off twin and a plain twin, over
   three scripts (constant, per-frame varying below 64, a 6-frame toggle).
   K3's (and K4's) launch counts are set to 0 before each run and must be
   above 0 after, adoptions above 0; the final core must equal the plain
   version's and `check()` must pass. Prints ms per tick (p50/p90, CUDA
   events and host wall time), K3 or K4 device ms, rollback-frames/s and
   the adopted share.
12. Holds swarm's K1 and K2 bodies against their plain versions, full
   carry after every batch (K2's parts too), inputs below 128 (every axis
   bit and BOOST): s1_4096 (Swarm(2, 4096), d=8, T=60, bench.py:891) and
   s2_1m (Swarm(2, 1048576), d=8, T=240, one batch, 308 MB of state and
   ring), each
   with a position probe (px of the slot the next rollback loads) that
   kernel and plain version latch at the same frame.
13. Drives swarm's fused main path, `DeviceSyncTestSession(Swarm(2, N),
   2, 8, backend="auto")`: auto must pick K1 at 4096 and K2 at 1M; launch
   counts 0 before, above 0 after; carry == plain; `check()` passes.
14. Holds swarm's K3 body against plain_tick_multi after every dispatch
   (sr2_4096: Swarm(2, 4096) at max_prediction 9; sr4_w: Swarm(4, 4096)
   at 12, 30 rows with DISCONNECTED slots), a position probe each through
   the request path; and swarm's K4 body against plain_rollout (sb16_4096:
   16 x 11; sb16_4p: 4 players, 16 x 14, 20% DISCONNECTED cells) with a
   position probe on the anchor.
15. Drives swarm's request path (sr2_4096, eager and lazy_ticks=8) and its
   beam (sb16_4096, three scripts, beside a beam-off and a plain twin), as
   phases 5 and 7 do for ex_game: launches above 0, adoptions above 0,
   final core == plain, `check()` passes.
16. Arena past 16 teams (a1_p17: Arena(17, 4352); a1_p32: Arena(32, 4096);
   the kernels sum teams 16 a pass), parity only bar K1's time: K1 with
   the cache and inline, the injection route and K5 alone, K3 rows and K4
   speculations against their plain versions, kill probes on K1 and the
   injection route, then the main path (auto -> K1) with its launch count.
17. K2's inline whole-world arena route (every step reduces from the world
   entering it, a grid barrier a step) in each regime `inline_plan` picks,
   against plain_parts and plain_verdict, parts and full carry after every
   batch, with a kill probe that both latch at the same frame with the same
   world after it: ati_4096 (Arena(2, 4096), d=8, T=60, explicit
   backend="cuda-tiled": the states on chip), ati_512k (Arena(16, 524288),
   T=60, 138 MB of state and ring, through backend="auto", which must pick
   it: past the reference's whole-batch estimate its auto answers the XLA
   scan; the states on chip), ati_p5 (Arena(5, 20000), T=30: blocks of 160
   threads, so a thread's team is fixed with five teams) and ati_2m
   (Arena(32, 2000000), T=2, "auto": past what the card holds on chip, the
   states in global memory). Each prints its regime and must take the
   expected one. Then each through the session, launch counts 0 before and
   above 0 after, carry == plain, `check()` passing; ms a batch and a tick,
   beside the injection route's ms a tick at 4096 from phase 9. Then what
   the on-chip states buy: kernel-only ms a batch of ati_4096's and
   ati_512k's worlds with the states on chip and in global memory (both
   must end with the same carry).
18. Checkpoints on the card for ex_game, arena and swarm at 4096 entities:
   a session saved mid-run on K1, K2 (inline for arena) and the injection
   route, restored under the same backend and under another, run on, and
   equal to the run that never stopped; a DeviceRollbackBackend on K3
   (device verification, lazy_ticks=8) saved mid-run, restored, driven on
   by the same host session and equal to its uninterrupted twin. Prints
   each file's size and the save and restore ms.
19. The P2P path at BASELINE.json configs[3]'s width (p2p4_4096): four
   port P2P sessions, ExGame(4, 4096), max_prediction 12, desync detection
   on(10), each on its own DeviceRollbackBackend on the card, over one
   InMemoryNetwork (latency 40 ms, jitter 15, loss 0.05, seed 33) on a fake
   clock advanced 16 ms a tick, 300 ticks; peer 3 leaves at tick 200 and
   the other three disconnect it, so DISCONNECTED inputs reach K3; a
   spectator of peer 0 on a backend of its own. Every backend's K3 launch
   count is set to 0 just before the match and must be above 0 after; no
   DesyncDetected, and the peers' confirmed checksums agree. Peer 0's
   recorded stream replayed on the plain K3 gives the same checksum of
   every save, state and ring; the spectator ends on peer 0's state of its
   last frame; the stream on a beam_width=16 backend (K4 launches above 0)
   equals a beam-off twin bit for bit, and so does the stream of a match
   whose players hold their inputs (a change a tick with probability
   0.1). A further match with ring slots of
   peer 1 corrupted must report DesyncDetected. Prints per peer the ms a
   tick of advance_frame and handle_requests (p50, p90), K3's time over the
   peer's host time (launches x the median row's K3 ms, a derived ratio and
   not a trace: K3 runs while the host goes on),
   the K3 launches, loads and the deepest rollback, the beam's adopted share
   and beam-on against beam-off ms a tick; K3 (the match's median row) and
   K4 (the beam's last speculation) against their plain versions, timed.
   Then the async arm: the match again with every session publishing
   checksums at the interval (`checksum_publish = "interval"`), every peer
   eager and then every peer on `DeviceRollbackBackend(async_dispatch=
   True)`: the same request streams, every save's checksum and the
   confirmed checksums equal (and equal to the first match's on the frames
   both hold), 0 desyncs; host ms a tick of `advance_frame` and
   `handle_requests` for both arms, the fence's stalls, the card's idle
   share of each arm from a torch.profiler trace of a second run, and
   peer 0's host tick under cProfile (the top functions by cumulative
   time) in a third.
20. The cross-session megabatch core (mb64_4096): the request streams of 16
   four-peer P2P matches of 140 ticks (ExGame(4, 4096), max_prediction 8,
   P2P_NET with a seed a match; bench.py:1785's 64 sessions) on one
   `MultiSessionDeviceCore` of 64 slots: each host tick every session's
   requests parsed (`parse_request_segment`) into packed rows, the fast
   rows as one megabatch, then one megabatch per occupied depth bucket, a
   session's second row in the next round; each megabatch one launch of
   K3's stacked entry, whose launch count is set to 0 before and must equal
   the megabatches after. Every 24th host tick's megabatches (and each
   kind's first) against plain_megabatch on a clone of the stack; every
   save's checksum and the final stacked rings and states against each
   session's solo `DeviceRollbackBackend` replay and its live match; at
   tick 120 every slot exported into another slot of a second core, and
   the last 20 ticks on both, equal. Prints the megabatches, rows and
   launches, device ms a megabatch by kind (each recorded megabatch
   replayed alone, queued behind a spin; p50, p90), and session-ticks per
   second over the first 120 ticks beside the same ticks through 64 solo
   backends. Then, parity only, 8 slots of Swarm(4, 4096) through the
   stacked swarm entry and 8 of Arena(4, 4096) through a K3-arena launch a
   row, every megabatch against plain_megabatch.
21. The serving path (hs64_4096): the port's `SessionHost` serving 16
   four-peer P2P matches (64 sessions of ExGame(4, 4096), max_prediction 8,
   desync detection on(10), P2P_NET with a seed a match, a fake clock
   advanced 16 ms a tick, 140 ticks after sync), once dispatch-per-tick
   (depth routing: each megabatch one launch of K3's stacked entry) and
   once resident (`resident=True, resident_ticks=16`: the device mailbox,
   each drive ONE launch of K3's resident entry), in ABBA order (dispatch,
   resident, resident, dispatch). Every kernel count is set to 0 just
   before each run's tick loop. Both arms 0 desyncs and equal frames,
   confirmed checksum histories, stacked rings and states and slot
   checksums; the resident arm's launches equal its drives, with no
   megabatch, no stacked launch and no overflow; its first drive and every
   8th against plain_resident_drive on a clone of the stack. Prints each
   arm's dispatches a host tick, session-ticks/s, the card's idle share
   (a torch.profiler trace of a further run), the resident arm's virtual
   ticks a drive and commits a host tick, and the resident entry's device
   ms a drive (recorded drives replayed alone, queued; p50, p90), and for
   the median of the drives held against the plain version its own ms
   beside the plain ms and the bound. Then, parity only, 8 sessions of Swarm(4,
   4096) and 8 of Arena(4, 4096), 32 ticks, resident against
   dispatch-per-tick.
22. Prints one {"kernels": [...]} JSON line (times, bounds, launches), then
   as the last line {"ok": true, "device": {...}}.

Any failure exits nonzero before the result lines. Without a CUDA device,
or without the rest of the repository beside it, it exits nonzero too.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, and int32 ALU ops/s —
# 132 SMs x 64 INT32 lanes x 1.98 GHz, the boost clock at which the sheet's
# 67 TFLOP/s fp32 (132 x 128 lanes x 2) is quoted.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# int32 ops one ex_game substep always executes (input tests, friction,
# sin16/cos16, thrust, turn, |v|^2 test, integrate and clamp); the speed
# clamp's sqrt and divisions run only for entities over the limit and are
# not counted, so the bound stays a least time. One save adds 15 (5 weighted
# products and 10 adds) for its checksum terms.
OPS_PER_SUBSTEP = 69
OPS_PER_SAVE = 15
PLAYERS = 2

SHAPES = [
    # key, kernel "auto" must choose, entities, check distance, ticks per batch, batches
    ("k1_4096", "cuda-fused", 4096, 8, 60, 3),
    ("k1_65536", "cuda-fused", 65536, 16, 60, 1),
    ("k2_1m", "cuda-tiled", 1 << 20, 8, 240, 1),
]
# kernel timing reps (back to back), and main-path batches timed one by one:
# 100 samples give a p90 with ten samples beyond it
TIMED_BATCHES = {"k1_4096": 20, "k1_65536": 5, "k2_1m": 3}
MAIN_PATH_BATCHES = {"k1_4096": 100, "k1_65536": 100, "k2_1m": 20}
DEVICE = "cuda"

# the request path (K3): key, players, entities, max_prediction
TICK_SHAPES = [
    ("r2_4096", 2, 4096, 9),  # BASELINE.json configs[1]
    ("r4_4096", 4, 4096, 12),  # configs[3]'s widths: 4-player P2P-shaped rows
    ("r2_1m", 2, 1 << 20, 9),
]
TICK_STREAM_EXTRA_ROWS = 16  # random rows past the spin-up
CHECK_DISTANCE = 8
LAZY_TICKS = 8
# per-tick samples: p90 keeps at least ten samples beyond it
REQUEST_PATH_TICKS = {"r2_4096": 200, "r2_1m": 104}
TIMED_DISPATCHES = {"r2_4096": 200, "r2_1m": 40}

# the beam (K4): key, players, entities, max_prediction, beam width, steps.
# L = min(depth + 3 + (depth & 1), W) at a SyncTest depth of 8 advances
# beyond the load (check distance 8) is 11 = W at max_prediction 9
BEAM_SHAPES = [
    ("b16_4096", 2, 4096, 9, 16, 11),  # BASELINE.json configs[2] on configs[1]'s world
    ("b12_65536", 2, 65536, 9, 12, 11),  # bench.py:974 bench_beam_ab
    ("b16_4p_4096", 4, 4096, 12, 16, 14),  # configs[3]'s widths, DISCONNECTED cells
]
BEAM_SPECULATIONS = 4  # speculations compared with the plain version per shape
TIMED_SPECULATIONS = {"b16_4096": 200, "b12_65536": 50}
BEAM_PATH_TICKS = {"b16_4096": 100, "b12_65536": 60}
CANDIDATE_REPS = 50  # timed calls of the candidate generator per run
BEAM_SCRIPTS = {
    "constant": lambda t, h: 3 + 2 * h,
    "varying": lambda t, h: (t * (h + 3) + h) % 16,
    "toggle6": lambda t, h: (5 if (t // 6) % 2 == 0 else 9) + h,
}


# arena (K1 with reductions, K5, K2 with an injected table)
ARENA_SHAPES = [
    # key, players, entities, input_size, check distance, ticks per batch, batches
    ("a1_4096", 2, 4096, 1, 8, 60, 3),  # bench.py:891-893, the headline arena cell
    ("a1_65536", 2, 65536, 1, 8, 60, 2),  # top of arena's envelope (32768 per team)
    ("a1_4p_w", 4, 4096, 2, 8, 60, 2),  # R = 12 and the throttle byte; parity only
]
ARENA_TIMED = {"a1_4096": 20, "a1_65536": 5}  # K1 batches timed back to back
ARENA_T1_BATCHES = 12  # single-tick batches at 4096: inline reductions, across frame d
ARENA_MAIN_BATCHES = {"a1_4096": 100, "a1_65536": 20}
KILLED = 64  # entities the divergence probe kills in a ring slot
INJECTED_SHAPES = [
    # key, players, entities, check distance, ticks
    ("ai_4096", 2, 4096, 8, 60),  # bench.py:3491 arena_sharded_stats on one chip
    ("ai_65536", 2, 65536, 8, 30),
]
INJECTED_BATCH = 30  # ticks per advance_frames on the injection route
INJECTED_MAIN_BATCHES = {"ai_4096": 20, "ai_65536": 10}
TIMED_LAUNCHES = 200  # K5 / K2 single-tick launches queued per timing
# arena on the request path (K3's arena body): key, players, entities,
# input_size, max_prediction
ARENA_TICK_SHAPES = [
    ("ar4_l16", 4, 4096, 1, 9),  # bench.py:1275 bench_arena_request_path
    ("ar2_4096", 2, 4096, 1, 9),
    ("ar2_65536", 2, 65536, 1, 9),  # top of arena's envelope (32768 per team)
    ("ar4_w", 4, 4096, 2, 12),  # the throttle byte and DISCONNECTED slots
    ("ar4_153600", 4, 153600, 1, 9),  # near the top of the reference's whole_world_fits
    # past what the card holds on chip (1.3M at 32 teams): K3's states in global memory
    ("ar32_2m", 32, 2_000_000, 1, 9),
]
ARENA_ROLLBACK_ROWS = 16  # ar4_l16: 16-row buffers, an 8-frame rollback in every row
ARENA_STREAM_ROWS = {"ar4_153600": 8, "ar32_2m": 2}  # random rows past the spin-up; parity only there
# the layout arena_tick_plan must pick on an H100 (else "grid-shared": the states on chip)
ARENA_TICK_REGIME = {"ar32_2m": "grid-global"}
ARENA_TICK_ROWS = 8  # rows per multi-row dispatch of the random streams
# the arena request path: key, players, entities, lazy_ticks, ticks, K3 timing reps
ARENA_REQUEST_RUNS = [
    ("ar2_4096", 2, 4096, 0, 200, 200),
    ("ar2_4096", 2, 4096, LAZY_TICKS, 200, 200),
    ("ar2_65536", 2, 65536, 0, 104, 40),
    ("ar2_65536", 2, 65536, LAZY_TICKS, 104, 40),
    ("ar4_l16", 4, 4096, ARENA_ROLLBACK_ROWS, 160, 50),
]
# the arena beam (K4's arena body): key, players, entities, max_prediction,
# beam width, steps (L = 11 at a SyncTest depth of 8 and max_prediction 9)
ARENA_BEAM_SHAPES = [
    ("ab16_4096", 2, 4096, 9, 16, 11),
    ("ab16_65536", 2, 65536, 9, 16, 11),  # the case the reference sends to XLA
    ("ab16_4p_w", 4, 4096, 12, 16, 14),  # the throttle byte, 20% DISCONNECTED cells
    # 16384 entities a block: the states read back from the trajectory; parity only
    ("ab16_131072", 4, 131072, 9, 16, 11),
]
ARENA_BEAM_ON_CHIP = {"ab16_131072": False}  # where beam_plan must not keep the states on chip (else it must)
ARENA_TIMED_SPECULATIONS = {"ab16_4096": 200, "ab16_65536": 50}
ARENA_BEAM_PATH_TICKS = {"ab16_4096": 100, "ab16_65536": 40}
ARENA_BEAM_SCRIPTS = {
    "constant": lambda t, h: 3 + 2 * h,
    "varying": lambda t, h: (t * (h + 3) + h) % 64,
    "toggle6": lambda t, h: (1 if (t // 6) % 2 == 0 else 9) + h,
}
# swarm (K1-K4's swarm bodies). Inputs below 128 exercise all six axis
# bits and BOOST (bench.py:67-70); the probes corrupt px, which the torus
# wrap keeps (a corrupted charge or velocity may be clamped back)
SWARM_MOD = 128
SWARM_SHAPES = [
    # key, kernel "auto" must choose, entities, check distance, ticks per batch, batches
    ("s1_4096", "cuda-fused", 4096, 8, 60, 3),  # bench.py:891, the reference's headline swarm cell
    ("s2_1m", "cuda-tiled", 1 << 20, 8, 240, 1),  # bench.py:242's 1M world on swarm: 308 MB of state and ring
]
SWARM_TIMED = {"s1_4096": 20, "s2_1m": 3}
SWARM_MAIN_BATCHES = {"s1_4096": 100, "s2_1m": 8}
SWARM_TICK_SHAPES = [
    ("sr2_4096", 2, 4096, 9),  # the 4096-entity request path on swarm
    ("sr4_w", 4, 4096, 12),  # 4-player rows with DISCONNECTED slots; parity only
]
SWARM_REQUEST_RUNS = [("sr2_4096", 2, 4096, 0, 200, 200), ("sr2_4096", 2, 4096, LAZY_TICKS, 200, 200)]
SWARM_BEAM_SHAPES = [
    ("sb16_4096", 2, 4096, 9, 16, 11),
    ("sb16_4p", 4, 4096, 12, 16, 14),  # 4 players, 20% DISCONNECTED cells; parity only
]
SWARM_TIMED_SPECULATIONS = {"sb16_4096": 200}
SWARM_BEAM_PATH_TICKS = {"sb16_4096": 100}
SWARM_BEAM_SCRIPTS = {
    "constant": lambda t, h: 5 + 16 * h,
    "varying": lambda t, h: (t * (h + 3) + h) % SWARM_MOD,
    "toggle6": lambda t, h: (65 if (t // 6) % 2 == 0 else 22) + h,
}
# arena past 16 teams (the kernels sum teams 16 a pass): parity on K1-K5
ARENA_TEAM_SHAPES = [("a1_p17", 17, 4352), ("a1_p32", 32, 4096)]
ARENA_TEAM_BATCHES = 3  # K1 batches of 20 ticks, the main path's too

# K2's inline whole-world arena route: key, players, entities, check
# distance, ticks per batch, batches, the backend the session is given
# (and, for "auto", must resolve to "cuda-tiled"), kernel timing reps, and
# the regime inline_plan must pick for it on an H100
ARENA_INLINE_SHAPES = [
    # the reference's headline arena world on "pallas-tiled": the on-chip grid
    ("ati_4096", 2, 4096, 8, 60, 2, "cuda-tiled", 20, "grid-shared"),
    # past the reference's estimate (528 B an entity, 277 MB > 96 MB): its
    # auto answers "xla"; 138 MB of state and ring, its states on chip
    ("ati_512k", 16, 1 << 19, 8, 60, 2, "auto", 5, "grid-shared"),
    # five teams on blocks of 160 threads: each thread's team is fixed, and
    # P is no power of two
    ("ati_p5", 5, 20000, 8, 30, 1, "cuda-tiled", 10, "grid-shared"),
    # past what the card holds on chip (1.27M at 32 teams): states in global
    # memory; 24 B an entity, 480 MB of ring
    ("ati_2m", 32, 2_000_000, 8, 2, 5, "auto", 5, "grid-global"),
]
ARENA_INLINE_MAIN_BATCHES = {"ati_4096": 100, "ati_512k": 10, "ati_p5": 20, "ati_2m": 10}
# what the on-chip states buy: kernel-only batches (d=8, T=60) of these
# worlds (players, entities) with the states on chip and in global memory,
# warm-up batches then timed ones
LAYOUT_WORLDS = ((2, 4096), (16, 1 << 19))
LAYOUT_WARM, LAYOUT_TIMED = 2, 10
# the checkpoint phase: worlds per family, ticks per batch, batches before
# the save, batches after it
CHECKPOINT_N = 4096
CHECKPOINT_DISTANCE = 8
CHECKPOINT_T, CHECKPOINT_BEFORE, CHECKPOINT_AFTER = 20, 2, 1
CHECKPOINT_FRAMES, CHECKPOINT_SAVE_AT = 60, 30  # the request path's ticks, and its save

# int32 ops arena's step always executes per entity (ggrs_tpu_torch/csrc/
# arena_step.cuh): alive test 1, thrust axes 10, overdrive test 4, accel 5,
# energy 5, velocity update 4, rally test 2, friction 4, |v|^2 test 4, dead
# stop 2, torus integrate 4, combat (toroidal deltas, Manhattan distance,
# hit test, damage) 18, throttle 1. The rally pull, the clamp's sqrt and
# divisions run only for some entities and are not counted (a least time).
OPS_PER_ARENA_STEP = 64
OPS_PER_ARENA_SAVE = 18  # 6 weighted products and 12 adds
# int32 ops of one entity's share of a reduction, whatever the team count:
# the alive test, two shifts (px >> 6, py >> 6) and three adds into its own
# team's sums. How a kernel finds that team's sums (block_team_sums walks
# every team) is its cost, not the function's.
OPS_PER_ARENA_REDUCE = 6


# int32 ops swarm's step always executes per entity (ggrs_tpu_torch/csrc/
# swarm_step.cuh): boost test 4, accel select 1, battery 5, per axis friction
# 2, thrust bits 5 and the velocity update 2 (27), |v|^2 test 6, torus
# integrate 6. The clamp's sqrt and divisions run only for entities over
# the limit and are not counted (a least time).
OPS_PER_SWARM_STEP = 49
OPS_PER_SWARM_SAVE = 21  # 7 weighted products and 14 adds
# per kernel body (its name suffix): bytes of one entity column, int32 ops
# of one entity-step and of one entity-save
MODEL_COST = {
    "": (20, OPS_PER_SUBSTEP, OPS_PER_SAVE),
    "_arena": (24, OPS_PER_ARENA_STEP, OPS_PER_ARENA_SAVE),
    "_swarm": (28, OPS_PER_SWARM_STEP, OPS_PER_SWARM_SAVE),
}
COUNTERPART_NOTE = {"": "", "_arena": " with ArenaPlanes (whole-world reductions)", "_swarm": " with SwarmPlanes"}


def body_suffix(game_cls) -> str:
    """The suffix of a model's kernel bodies: "" (ex_game), "_arena", "_swarm"."""
    return {"Arena": "_arena", "Swarm": "_swarm"}.get(game_cls.__name__, "")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def events_ms(torch, fn, reps: int) -> float:
    """Mean device ms of `fn` over `reps` back-to-back calls."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def queued_ms(torch, fn, reps: int, spin: int = 1_000_000) -> float:
    """Mean device ms of `fn` over `reps` launches queued behind a spin
    kernel: the host enqueues every launch while the card is still busy, so
    the launches run back to back with no host gap between them (a dispatch
    shorter than its Python wrapper would otherwise time the wrapper).
    `spin`: the spin kernel's cycles a call (~0.5 ms at the default), more
    than the host takes to enqueue one."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(reps * spin)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def batch_work(n, d, t_ticks, c0, substeps=1):
    """(steps, saves) per entity of one batch starting at frame c0, as this
    run's frames need them (ticks past d roll back d frames)."""
    steps = saves = 0
    for t in range(t_ticks):
        rb = c0 + t > d
        steps += (d if rb else 0) + 1
        saves += (d - 1 if rb else 0) + 1
    return steps * substeps, saves


def bound(n, d, t_ticks, c0, ring_len, suffix=""):
    """Least ms of one batch: each state/ring/input byte read once and
    written once, vs the batch's int32 ops at the ALU peak (`MODEL_COST`
    of the body: ex_game's unless `suffix` names another)."""
    col, step_ops, save_ops = MODEL_COST[suffix]
    steps, saves = batch_work(n, d, t_ticks, c0)
    nbytes = 2 * col * n * (1 + ring_len) + 4 * t_ticks * PLAYERS * 2
    ops = n * (steps * step_ops + saves * save_ops)
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")


def least(nbytes, ops):
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")


def verdict_bound(t_ticks, d, hist):
    """Least ms of the verdict over T*d events: parts read once, history
    and meta read and written once; 12 int32 ops an event."""
    return least(4 * (2 * t_ticks * d + 6 * hist + 6), 12 * t_ticks * d)


def tail_verdict_ms(torch, ctx, carry, inputs):
    """The verdict alone on the parts of one batch of `inputs` from `carry`
    (a copy; K2's kernel makes the same parts K1 sums): what K1's tail
    runs, minus the bookkeeping, as its own launch queued back to back."""
    from ggrs_tpu_torch.convert import copy_carry
    from ggrs_tpu_torch.device.tiled_core import TiledSyncTestCore

    tiled, work = TiledSyncTestCore(ctx), copy_carry(carry)
    parts = tiled.run_kernel(work, inputs)
    return queued_ms(torch, lambda: tiled.verdict(work, *parts), TIMED_LAUNCHES)


def verdict_streams_phase(torch, np, dev, tag):
    """synctest_verdict_launch against plain_verdict on every crafted stream
    of VERDICT_STREAMS: history, latch and frame equal."""
    from ggrs_tpu_torch import ExGame
    from ggrs_tpu_torch.convert import copy_carry
    from ggrs_tpu_torch.device import sync_test
    from ggrs_tpu_torch.device.planes import PlaneContext
    from ggrs_tpu_torch.device.tiled_core import TiledSyncTestCore, plain_verdict

    latched = []
    for name, d, t_ticks, c0, carried, plants, on_entry in VERDICT_STREAMS:
        ctx = PlaneContext(ExGame(PLAYERS, 4096), PLAYERS, d, dev)
        ph, pl, tg, hhi, hlo, meta = verdict_stream(np, d, t_ticks, c0, carried, plants, on_entry,
                                                    ctx.cs_frame_weight, seed=d * 1000 + t_ticks)
        kc = sync_test.initial_carry(ctx)
        for k, v in (("h_tag", tg), ("h_hi", hhi), ("h_lo", hlo), ("meta", meta)):
            kc[k].copy_(torch.from_numpy(v))
        pc = copy_carry(kc)
        parts = torch.from_numpy(ph).to(dev), torch.from_numpy(pl).to(dev)
        TiledSyncTestCore(ctx).verdict(kc, *parts)
        plain_verdict(pc, *parts, ctx)
        torch.cuda.synchronize()
        if carry_err(torch, kc, pc, ("h_tag", "h_hi", "h_lo", "meta")):
            fail(f"verdict stream {name}: synctest_verdict and plain_verdict differ")
        latched.append(f"{name} {kc['meta'].tolist()[1:]}")
    print(f"synctest_verdict == plain_verdict on {len(VERDICT_STREAMS)} crafted streams (latch, frame): "
          f"{', '.join(latched)} {tag}")


def arena_bound(n, players, d, t_ticks, c0, reduces=True):
    """Least ms of one arena K1 batch (or, at T = 1, one K2 tick on an
    injected table, which does the same work bar the reductions). T > 1:
    state and ring read once and written once; T = 1: the loaded slot (or
    the state) read, each saved slot and the state written. Ops: 64 per
    entity-step, 18 per entity-save, and the batch's reductions: one per
    tick with the cache plus the d+1-frame seed (T > 1), one per step (T = 1)."""
    steps, saves = batch_work(n, d, t_ticks, c0)
    col = 4 * 6 * n
    if t_ticks > 1:
        nbytes = 2 * col * (1 + d + 2)
        reductions = t_ticks - 1 + d + 1
    else:
        nbytes = col * (1 + saves + 1)
        reductions = steps if reduces else 0
    nbytes += 4 * t_ticks * players * 2
    ops = n * (steps * OPS_PER_ARENA_STEP + saves * OPS_PER_ARENA_SAVE + reductions * OPS_PER_ARENA_REDUCE)
    return least(nbytes, ops)


def injected_tick_bound(n, players, d, c0):
    """Least ms of the injection route's one-launch tick with every save
    stored: the T = 1 tick's bytes and ops (`arena_bound`, no reductions:
    the table is an input), plus the table read and the next table written
    ([d+1, 3P] each) and the next table's frontier row, 6 int32 ops an
    entity."""
    steps, saves = batch_work(n, d, 1, c0)
    nbytes = 4 * 6 * n * (1 + saves + 1) + 4 * players * 2 + 2 * 4 * (d + 1) * 3 * players
    ops = n * (steps * OPS_PER_ARENA_STEP + saves * OPS_PER_ARENA_SAVE + OPS_PER_ARENA_REDUCE)
    return least(nbytes, ops)


def inline_bound(n, players, d, t_ticks, c0):
    """Least ms of one batch of K2's inline arena route: 64 int32 ops an
    entity-step, 18 an entity-save, and 6 an entity-reduction, one
    reduction before every step (T (d+1) a batch once past frame d). Bytes
    count only what the launch must move, a 24 B column each, as
    `tick_bound` does: a ring slot that a rollback loads before the batch
    saved it, the state when the first step uses it (no rollback at the
    batch's first tick), each distinct slot saved (its final value) and the
    state written; plus the inputs."""
    steps, saves = batch_work(n, d, t_ticks, c0)
    ring_len, saved, read = d + 2, set(), set()
    for c in range(c0, c0 + t_ticks):
        frames = range(c - d + 1, c + 1) if c > d else (c,)
        if c > d and (c - d) % ring_len not in saved:
            read.add((c - d) % ring_len)
        saved |= {f % ring_len for f in frames}
    columns = len(read) + (c0 <= d) + len(saved) + 1
    nbytes = 4 * 6 * n * columns + 4 * t_ticks * players * 2
    ops = n * (steps * (OPS_PER_ARENA_STEP + OPS_PER_ARENA_REDUCE) + saves * OPS_PER_ARENA_SAVE)
    return least(nbytes, ops)


def carry_err(torch, a, b, keys) -> int:
    return max(int((a[k].to(torch.int64) - b[k].to(torch.int64)).abs().max()) for k in keys)


def tick_bound(rows, n, core):
    """Least ms of one K3 dispatch of these rows (`tick_work` over the
    rates)."""
    return least(*tick_work(rows, n, core))


def megabatch_bound(rows, n, core, nslots):
    """Least ms of one megabatch: every row on its own world, cut to
    `nslots` window slots (`tick_work` of each, summed)."""
    from ggrs_tpu_torch.device.tick_core import windowed_row

    work = [tick_work(windowed_row(r, nslots, core)[None], n, core) for r in rows]
    return least(sum(b for b, _ in work), sum(o for _, o in work))


def tick_work(rows, n, core):
    """(bytes, int32 ops) of one K3 dispatch of these rows, vs 69 int32 ops per
    entity-advance and 15 per entity-save for ex_game, 64 + 6 per
    entity-advance (the step and its reduction) and 18 per entity-save for
    arena (over the int32 peak). Bytes (over the HBM rate) count only what
    the dispatch must move, one entity column each (20 B for ex_game, 24 B
    for arena): a ring slot loaded before any row of the launch saved it,
    the state read only when a row uses it before any load, each distinct
    slot saved (its final value), and the state written; plus the rows read
    and his/los written. The ring's frame tags, the verify history and
    arena's reduction rows (under a few hundred words) are left out."""
    W, ring_len = core.window, core.ring_len
    saved, read, state_read, have_state = set(), set(), False, False
    for row in rows:
        slots = {int(s) for s in row[core.off_save : core.off_status] if s < ring_len}
        if row[0]:
            if int(row[1]) not in saved:
                read.add(int(row[1]))
            have_state = True
        elif (row[2] or slots) and not have_state:
            state_read = have_state = True
        saved |= slots
    saves = int((rows[:, core.off_save : core.off_status] < ring_len).sum())
    advances = int(rows[:, 2].sum())
    columns = len(read) + state_read + len(saved) + 1
    nbytes = 4 * core.ctx.n_planes * n * columns + rows.nbytes + 2 * 4 * rows.shape[0] * W
    if core.ctx.reduce_len:  # arena
        ops = n * (advances * (OPS_PER_ARENA_STEP + OPS_PER_ARENA_REDUCE) + saves * OPS_PER_ARENA_SAVE)
    else:
        _, step_ops, save_ops = MODEL_COST[body_suffix(type(core.game))]
        ops = n * (advances * getattr(core.game, "substeps", 1) * step_ops + saves * save_ops)
    return nbytes, ops


# crafted event streams for the first-seen verdict (K2's verdict kernel and
# K1's tail): name, check distance d, ticks T, the batch's first frame c0,
# whether the history holds the frames before c0 (else stale tags only), the
# planted differences, and whether a mismatch is latched on entry. A plant
# (kind, k) flips the checksum of the k-th frame the batch saves twice or
# more: "first" at its first event, "later" at its last; "carried" flips the
# history's value of the k-th frame whose history the batch compares with.
VERDICT_STREAMS = [
    ("d2_t1_fresh", 2, 1, 0, False, (), False),
    ("d2_t60_crossing", 2, 60, 1, True, (("first", 3), ("later", 7)), False),
    ("d2_t240_carried", 2, 240, 100, True, (("carried", 0),), False),
    ("d8_t1_carried", 8, 1, 50, True, (("carried", 2),), False),
    ("d8_t60_two", 8, 60, 0, False, (("later", 5), ("first", 2)), False),
    ("d8_t60_crossing", 8, 60, 5, True, (("later", 4),), False),
    ("d8_t60_first_later", 8, 60, 69, True, (("later", 10), ("first", 3)), False),
    ("d8_t240_latched", 8, 240, 1000, True, (("later", 1),), True),
    ("d16_t1_clean", 16, 1, 16, True, (), False),
    ("d16_t60_crossing", 16, 60, 10, True, (("first", 0), ("later", 20)), False),
    ("d16_t240_carried", 16, 240, 300, True, (("carried", 5), ("later", 40)), False),
    ("d16_t60_stale", 16, 60, 17, False, (), False),
]


def verdict_stream(np, d, t_ticks, c0, carried, plants, latched, frame_weight, seed):
    """One crafted batch for the verdict: (parts_hi, parts_lo) int32 [T, d],
    the frame term not folded in, zero for events that did not happen; and
    the history and meta it meets (h_tag, h_hi, h_lo [d+2], meta [3]), int32
    bit patterns. Every event of a frame carries that frame's checksum,
    bar the planted ones."""
    rng = np.random.default_rng(seed)
    hist, mask = d + 2, (1 << 32) - 1
    truth = {}

    def value(f):
        if f not in truth:
            truth[f] = [int(v) for v in rng.integers(0, 1 << 32, size=2, dtype=np.uint64)]
        return truth[f]

    events = []  # (t, j, frame) in (t, j) order
    for t in range(t_ticks):
        c = c0 + t
        for j in range(d):
            if j == d - 1 or c > d:
                events.append((t, j, c - d + 1 + j if j < d - 1 else c))
    by_frame = {}
    for k, (_, _, f) in enumerate(events):
        by_frame.setdefault(f, []).append(k)
    tag, hhi, hlo = [-1] * hist, [0] * hist, [0] * hist
    if carried:
        for f in range(max(0, c0 - hist), c0):
            tag[f % hist] = f
            hhi[f % hist], hlo[f % hist] = value(f)
    else:  # tags two turns of the history back: never compared with
        for h in range(hist):
            f = c0 - 2 * hist + h
            if f >= 0:
                tag[f % hist] = f
                hhi[f % hist], hlo[f % hist] = value(f + 1)
    ev = [list(value(f)) for _, _, f in events]
    twice = [f for f in sorted(by_frame, key=lambda f: by_frame[f][0]) if len(by_frame[f]) > 1]
    lo_f = min(by_frame)
    compared = [f for f in sorted(by_frame) if tag[f % hist] == f and f - hist < lo_f]
    for kind, k in plants:
        if kind == "carried":
            f = compared[k]
            hhi[f % hist] ^= 1 << 7
        else:
            f = twice[k]
            ev[by_frame[f][0 if kind == "first" else -1]][kind == "later"] ^= 1 << 3
    parts_hi = np.zeros((t_ticks, d), np.int64)
    parts_lo = np.zeros((t_ticks, d), np.int64)
    for (t, j, f), (hi, lo) in zip(events, ev):
        parts_hi[t, j] = (hi - f * frame_weight) & mask
        parts_lo[t, j] = (lo - f) & mask

    def i32(a):
        return np.asarray(a, np.int64).astype(np.uint32).view(np.int32)

    meta = np.array([c0, 1 if latched else 0, 3 if latched else -1], np.int32)
    return i32(parts_hi), i32(parts_lo), np.array(tag, np.int32), i32(hhi), i32(hlo), meta


# crafted K3 row streams, for the scalar pass above all (the state frames,
# ring-frame tags, first-seen history and latch): name, players,
# max_prediction (W = max_prediction + 2), rows a dispatch, device
# verification, a latch carried in, and the stream as specs (`tick_stream`).
# They load slots earlier rows of the same dispatch saved, go back in frames
# (rollbacks, and rows that load an older frame and only save it), reuse
# history keys (frame f and f + W), skip saves, save past the last advance,
# replay frames with their own inputs (hits) and with others (mismatches:
# two or more in a dispatch, the earlier latching), and carry DISCONNECTED
# slots. Each is a whole number of dispatches
TICK_STREAMS = [
    ("w11_t1", 2, 9, 1, True, False,
     [("spin", 11), ("rb", 8, ""), ("rb", 8, ""), ("rb", 3, "skip"), ("rb", 8, "diverge"), ("rb", 8, ""),
      ("rb", 5, "diverge")]),
    ("w11_t8", 2, 9, 8, True, False,
     [("spin", 11), ("rb", 8, ""), ("rb", 8, ""), ("rb", 8, "trail"), ("rb", 8, ""), ("rb", 4, "diverge"),
      ("rb", 2, "trail"), ("rb", 8, "diverge"), ("zero", 0), ("rb", 6, "skip"), ("rb", 8, "disc"),
      ("rb", 1, ""), ("zero", 3), ("rb", 7, "skip trail")]),
    ("w11_t16", 4, 9, 16, True, False,
     [("spin", 10), ("rb", 8, "disc"), ("zero", 5), ("rb", 2, ""), ("rb", 8, "skip"), ("rb", 8, "diverge"),
      ("zero", 0), ("rb", 3, "trail"), ("rb", 8, ""), ("spin", 3), ("rb", 8, "diverge disc"), ("rb", 6, ""),
      ("zero", 8), ("rb", 1, "skip"), ("rb", 8, ""), ("rb", 8, ""), ("rb", 8, "trail"), ("rb", 5, ""),
      ("zero", 2), ("rb", 8, "diverge"), ("rb", 8, "")]),
    ("w14_t1", 2, 12, 1, True, False,
     [("spin", 14), ("rb", 11, ""), ("zero", 0), ("rb", 11, "diverge"), ("zero", 6), ("rb", 4, "trail"),
      ("rb", 11, "skip")]),
    ("w14_t8_latched", 4, 12, 8, True, True,
     [("spin", 13), ("rb", 11, "disc"), ("rb", 11, ""), ("rb", 7, "diverge"), ("zero", 4), ("rb", 11, ""),
      ("rb", 9, "skip trail"), ("rb", 11, "diverge"), ("rb", 11, ""), ("rb", 2, ""), ("rb", 11, ""), ("rb", 11, "")]),
    ("w14_t16", 2, 12, 16, True, False,
     [("spin", 14), ("rb", 11, ""), ("rb", 11, ""), ("zero", 0), ("rb", 11, "trail"), ("rb", 6, "diverge"),
      ("rb", 11, ""), ("rb", 11, "skip"), ("zero", 12), ("rb", 3, ""), ("rb", 11, "diverge disc"),
      ("rb", 11, ""), ("rb", 11, ""), ("spin", 2), ("rb", 11, ""), ("rb", 10, "trail"), ("rb", 11, ""),
      ("rb", 11, "")]),
    ("w11_t8_noverify", 2, 9, 8, False, False,
     [("spin", 11), ("rb", 8, ""), ("rb", 8, "diverge"), ("zero", 3), ("rb", 8, "skip"), ("rb", 5, "trail")]),
]


def tick_stream(core, specs, seed: int, mod: int = 16):
    """The packed int32 rows [T, L] of a crafted stream for `core`. Specs:
    ("spin", k) k rows that advance one frame and save the frame they start
    at; ("rb", depth, flags) a rollback: load the slot of frame c - depth
    (c the live frame), advance depth + 1 frames saving each frame stepped
    from, with the frames' own inputs, or, with "diverge" in flags, others
    (a re-save of those frames then mismatches); "skip" skips the saves at
    positions 1 and depth - 1, "trail" also saves at depth + 1 (past the
    last advance: the frozen state), "disc" makes one player of position 0
    DISCONNECTED; ("zero", back) a row that advances nothing and saves at
    position 0: with back > 0 it first loads the slot of frame c - back,
    so the live world goes back there. Input byte 0 is drawn below `mod`,
    a second byte (arena's throttle) below 16."""
    import numpy as np

    W, P, I = core.window, core.num_players, core.game.input_size
    rng = np.random.default_rng(seed)
    table = rng.integers(0, mod, size=(1024, P, I), dtype=np.int64)
    if I > 1:
        table[..., 1:] %= 16
    rows, frame = [], 0

    def row(do_load, start, adv, saves, flags=""):
        inputs = np.zeros((W, P, I), np.uint8)
        for i in range(adv):
            own = table[start + i]
            inputs[i] = (own + 1) % mod if "diverge" in flags else own
        statuses = np.zeros((W, P), np.int32)
        if "disc" in flags:
            statuses[0, P - 1] = 2  # InputStatus.DISCONNECTED
        slots = np.full((W,), core.scratch_slot, np.int32)
        for i in saves:
            slots[i] = (start + i) % core.ring_len
        rows.append(core.pack_tick_row(do_load, start % core.ring_len if do_load else 0, inputs, statuses, slots,
                                       adv, start_frame=start))

    for kind, arg, *rest in specs:
        if kind == "spin":
            for _ in range(arg):
                row(False, frame, 1, [0])
                frame += 1
        elif kind == "rb":
            flags = rest[0]
            start = frame - arg
            saves = [i for i in range(arg + 1) if not ("skip" in flags and i in (1, arg - 1))]
            if "trail" in flags and arg + 1 < W:
                saves.append(arg + 1)
            row(True, start, arg + 1, saves, flags)
            frame = start + arg + 1
        else:  # zero
            frame -= arg
            row(arg > 0, frame, 0, [0])
    return np.stack(rows)


class PlainTick:
    """Stands in for a ResimCore's K3 wrapper: runs the plain version on
    the same (CUDA) carry, and keeps the rows of every dispatch, by row
    count, so the kernel can be timed on exactly the main path's rows."""

    def __init__(self, core):
        self.core = core
        self.rows = {}

    def tick_multi(self, carry, rows):
        from ggrs_tpu_torch.device.tick_core import plain_tick_multi

        self.rows.setdefault(rows.shape[0], []).append(rows)
        return plain_tick_multi(carry, rows, self.core)


def request_stack(n, players, mp, lazy, dev, plain, host_lag=None, game=None):
    """A port SyncTest session and the backend that fulfils it, with the
    verdict on the device — or, with `host_lag` set, checked on the host
    through the lazy checksums, `host_lag` ticks late (0: every tick).
    `plain` swaps the backend's K3 wrapper for the plain version. `game`:
    ExGame(players, n) unless given."""
    from ggrs_tpu_torch import DeviceRollbackBackend, ExGame, SessionBuilder

    device_verify = host_lag is None
    game = game or ExGame(players, n)
    sess = (
        SessionBuilder(input_size=game.input_size)
        .with_num_players(players)
        .with_max_prediction_window(mp)
        .with_check_distance(CHECK_DISTANCE)
        .with_device_checksum_verification(device_verify)
        .with_deferred_checksum_verification(host_lag or 0)
        .start_synctest_session()
    )
    backend = DeviceRollbackBackend(game, mp, players,
                                    device_verify=device_verify, lazy_ticks=lazy, device=dev)
    if plain:
        backend.core.tick_core = PlainTick(backend.core)
    return sess, backend


def add_inputs(sess, row) -> None:
    """One tick's inputs: row[h] is player h's byte, or its bytes."""
    for h, b in enumerate(row):
        sess.add_local_input(h, bytes(int(v) for v in (b if hasattr(b, "__len__") else [b])))


def tick_phase(torch, np, dev, tag, shapes=None, game_cls=None, mod=16, probe_plane=4):
    """K3 against its plain version after every dispatch, then a divergence
    probe per shape through the request path (`probe_plane` of the slot the
    next rollback loads). `game_cls`: ExGame unless given, its inputs below
    `mod`. Returns {key: max abs err}."""
    from ggrs_tpu_torch import ExGame, MismatchedChecksum, ResimCore
    from ggrs_tpu_torch.device.resim import RESIM_KEYS
    from ggrs_tpu_torch.device.rowgen import random_tick_rows
    from ggrs_tpu_torch.device.tick_core import plain_tick_multi

    game_cls = game_cls or ExGame
    name = f"resim_tick{body_suffix(game_cls)}"
    errs = {}
    for key, players, n, mp in shapes or TICK_SHAPES:
        err = 0
        for per_dispatch in (1, 8):
            core = ResimCore(game_cls(players, n), mp, players, device_verify=True, device=dev)
            plain = {k: v.clone() for k, v in core.carry.items()}
            rows = random_tick_rows(core, mp + 2 + TICK_STREAM_EXTRA_ROWS, seed=players * 100 + mp, mod=mod)
            for b in range(0, len(rows), per_dispatch):
                batch = rows[b : b + per_dispatch]
                his, los = core.tick_multi(batch)
                p_his, p_los = plain_tick_multi(plain, core.upload(batch), core)
                torch.cuda.synchronize()
                err = max(err, carry_err(torch, {"h": his, "l": los}, {"h": p_his, "l": p_los}, "hl"),
                          carry_err(torch, core.carry, plain, RESIM_KEYS))
                if err:
                    fail(f"{key}: K3 and plain version differ at rows {b}.. of {per_dispatch}-row dispatches "
                         f"(max abs err {err})")
            print(f"{key}: {name} == plain after each of {-(-len(rows) // per_dispatch)} "
                  f"{per_dispatch}-row dispatch(es) ({players} players, {n} entities, "
                  f"max_prediction {mp}, device verify, 15% disconnect slots) {tag}")
            del core, plain
        errs[key] = err

        # divergence probe: corrupt a plane the step never clamps back (ex_game's
        # heading, swarm's x) in the slot the next rollback loads, on the
        # kernel's core and the plain version's alike
        stacks = [request_stack(n, players, mp, 0, dev, plain, game=game_cls(players, n))
                  for plain in (False, True)]
        script = np.random.default_rng(7).integers(0, mod, size=(16, players))
        for sess, backend in stacks:
            for row in script[:12]:
                add_inputs(sess, row)
                backend.handle_requests(sess.advance_frame())
        frame = stacks[0][1].current_frame
        latched = []
        for sess, backend in stacks:
            backend.core.carry["ring"][(frame - CHECK_DISTANCE) % backend.core.ring_len, probe_plane, 0] += 7
            add_inputs(sess, script[12])
            backend.handle_requests(sess.advance_frame())
            try:
                backend.check()
                latched.append(None)
            except MismatchedChecksum as exc:
                latched.append(exc.frame)
        want = frame - CHECK_DISTANCE + 1
        if latched != [want, want]:
            fail(f"{key}: divergence probe latched {latched} (kernel, plain), expected frame {want} on both")
        if carry_err(torch, stacks[0][1].core.carry, stacks[1][1].core.carry, RESIM_KEYS):
            fail(f"{key}: K3 and plain version differ after the divergence probe")
        print(f"{key}: divergence probe: K3 and plain both latched mismatch at frame {want}")
        del stacks
    return errs


def tick_streams_phase(torch, np, dev, tag):
    """K3 against plain_tick_multi on the crafted streams of TICK_STREAMS,
    every body (ex_game, swarm, arena on each layout arena_tick_plan can
    pick: the states on chip, and in global memory forced on the same
    world), the kernel's dispatches launched back to back: his/los of every
    dispatch and the whole core at the end, tolerance zero; a stream with
    verification on must end latched."""
    from ggrs_tpu_torch import Arena, ExGame, ResimCore, Swarm
    from ggrs_tpu_torch.device.tick_core import arena_tick_plan, plain_tick_multi
    from ggrs_tpu_torch.kernels import build

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    bodies = [(ExGame, 16, None), (Swarm, SWARM_MOD, None), (Arena, 64, None), (Arena, 64, "grid-global")]
    for name, players, mp, per, verify, latched, specs in TICK_STREAMS:
        for game_cls, mod, regime in bodies:
            core = ResimCore(game_cls(players, 4096), mp, players, device_verify=verify, device=dev)
            if regime is not None:
                core.tick_core.prepare(build.load("resim_tick"), arena_tick_plan(
                    core.ctx.n, players, core.window, core.ctx.input_size, sms, 0))
            if latched:
                core.carry["flag"].copy_(torch.tensor([1, 3], dtype=torch.int32))
            plain = {k: v.clone() for k, v in core.carry.items()}
            rows = tick_stream(core, specs, seed=len(name), mod=mod)
            batches = [core.upload(rows[b : b + per]) for b in range(0, len(rows), per)]
            outs = [core.tick_core.tick_multi(core.carry, batch) for batch in batches]
            err = 0
            for batch, (his, los) in zip(batches, outs):
                p_his, p_los = plain_tick_multi(plain, batch, core)
                err = max(err, carry_err(torch, {"h": his, "l": los}, {"h": p_his, "l": p_los}, "hl"))
            err = max(err, carry_err(torch, core.carry, plain, tuple(core.carry)))
            what = f"{name} {game_cls.__name__}{f' {regime}' if regime else ''}"
            if err:
                fail(f"{what}: K3 and plain version differ on a crafted stream (max abs err {err})")
            if verify and not bool(core.carry["flag"][0]):
                fail(f"{what}: the crafted stream latched no mismatch")
            print(f"{what}: resim_tick == plain on {len(batches)} {per}-row dispatch(es) launched back to back "
                  f"(W={core.window}, verify {'on' if verify else 'off'}, latch "
                  f"{core.carry['flag'].tolist() if verify else 'off'}) {tag}")
            del core, plain


def request_path_phase(torch, np, dev, tag, errs):
    """The main path of this slice, eager and lazy, at r2_4096 and r2_1m.
    Returns (per-run summaries, K3 entries for the kernels line)."""
    runs, entries = [], []
    for key, players, n, mp in TICK_SHAPES:
        if key not in REQUEST_PATH_TICKS:
            continue
        ticks = REQUEST_PATH_TICKS[key]
        script = np.random.default_rng(n + 1).integers(0, 16, size=(ticks, players))
        for lazy in (0, LAZY_TICKS):
            run, entry = request_path_run(torch, np, dev, tag, key, None, players, n, mp, lazy, script,
                                          TIMED_DISPATCHES[key], errs[key])
            runs.append(run)
            entries.append(entry)
    host_verification_check(np, dev, tag)
    return runs, entries


def request_path_run(torch, np, dev, tag, key, game_fn, players, n, mp, lazy, script, reps, err):
    """One run of the request path (SyncTest session, check distance 8,
    device verification) on `game_fn()` (ExGame when None) beside the same
    path with K3 swapped for its plain version: K3's launch count set to 0
    before and above 0 after, the final cores equal, `check()` passing;
    then K3 timed alone on the run's middle dispatch. Returns (the run's
    summary, its K3 entry for the kernels line)."""
    from ggrs_tpu_torch import AdvanceFrame, LoadGameState
    from ggrs_tpu_torch.device.resim import RESIM_KEYS
    from ggrs_tpu_torch.device.tick_core import plain_tick_multi

    ticks = len(script)
    game = game_fn() if game_fn else None
    sess, backend = request_stack(n, players, mp, lazy, dev, plain=False, game=game)
    psess, pbackend = request_stack(n, players, mp, lazy, dev, plain=True, game=game_fn() if game_fn else None)
    suffix = body_suffix(type(backend.core.game))
    tc = backend.core.tick_core
    marks, wall_ms, sess_ms, issued = [], [], [], []
    torch.cuda.synchronize()
    tc.launches = 0
    t_run = time.perf_counter()
    for row in script:
        t0 = time.perf_counter()
        add_inputs(sess, row)
        reqs = sess.advance_frame()
        t1 = time.perf_counter()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        backend.handle_requests(reqs)
        end.record()
        t2 = time.perf_counter()
        marks.append((start, end))
        issued.append(reqs)
        sess_ms.append((t1 - t0) * 1e3)
        wall_ms.append((t2 - t1) * 1e3)
    backend.block_until_ready()
    run_s = time.perf_counter() - t_run
    launches = tc.launches
    if launches < 1:
        fail(f"{key} lazy={lazy}: the request path launched no K3 kernel")
    # frames resimulated: every advance of a tick that loads, less its new
    # frame (the spin-up ticks before the first rollback resimulate nothing)
    resimulated = sum(
        sum(isinstance(r, AdvanceFrame) for r in reqs) - 1
        for reqs in issued if any(isinstance(r, LoadGameState) for r in reqs)
    )
    event_ms = sorted(s.elapsed_time(e) for s, e in marks)
    for row in script:
        add_inputs(psess, row)
        pbackend.handle_requests(psess.advance_frame())
    pbackend.block_until_ready()
    if carry_err(torch, backend.core.carry, pbackend.core.carry, RESIM_KEYS):
        fail(f"{key} lazy={lazy}: the request path's core differs from the plain version's")
    backend.check()
    pbackend.check()
    state = backend.state_numpy()
    if state["pos"].shape[0] != n or int(state["frame"]) != ticks:
        fail(f"{key} lazy={lazy}: state has the wrong shape or frame")

    # K3 alone on exactly the rows this run dispatched (its middle
    # dispatch), back to back on a copy of the core
    t_rows = 1 if lazy == 0 else lazy
    recorded = pbackend.core.tick_core.rows[t_rows]
    rows = recorded[len(recorded) // 2]
    core = backend.core
    timed = {k: v.clone() for k, v in core.carry.items()}
    ptimed = {k: v.clone() for k, v in core.carry.items()}
    ms = queued_ms(torch, lambda: tc.tick_multi(timed, rows), reps)
    b2b_ms = events_ms(torch, lambda: tc.tick_multi(timed, rows), reps)
    plain_ms = events_ms(torch, lambda: plain_tick_multi(ptimed, rows, core), 1)
    b_ms, b_by = tick_bound(rows.cpu().numpy(), n, core)
    del timed, ptimed

    def pct(v, q):
        return v[min(len(v) - 1, (len(v) * q) // 100)]

    wall_sorted, sess_sorted = sorted(wall_ms), sorted(sess_ms)
    mode = "eager" if lazy == 0 else f"lazy_ticks={lazy}"
    run = {
        "key": key, "mode": mode, "ticks": ticks, "launches": launches,
        "event_ms_per_tick_p50": pct(event_ms, 50), "event_ms_per_tick_p90": pct(event_ms, 90),
        "host_ms_per_tick_p50": pct(wall_sorted, 50), "host_ms_per_tick_p90": pct(wall_sorted, 90),
        "slowest_tick_ms": max(w + t for w, t in zip(wall_ms, sess_ms)),  # session + handle_requests
        "session_ms_per_tick_p50": pct(sess_sorted, 50),
        "run_ms_per_tick": run_s * 1e3 / ticks,
        "frames_resimulated": resimulated,
        "rollback_frames_per_s": resimulated / run_s,
        "kernel_ms_per_dispatch": ms, "kernel_ms_back_to_back": b2b_ms,
        "rows_per_dispatch": t_rows,
        # derived, not a trace: K3 device time over the run's wall time
        "device_busy_share": launches * ms / (run_s * 1e3),
    }
    print(f"request path {key} {mode}: {launches} K3 launches over {ticks} ticks; per tick "
          f"event p50 {run['event_ms_per_tick_p50']:.4f} ms (p90 {run['event_ms_per_tick_p90']:.4f}), "
          f"handle_requests host p50 {run['host_ms_per_tick_p50']:.4f} ms "
          f"(p90 {run['host_ms_per_tick_p90']:.4f}), slowest tick {run['slowest_tick_ms']:.4f} ms, session host p50 "
          f"{run['session_ms_per_tick_p50']:.4f} ms, whole run {run['run_ms_per_tick']:.4f} ms/tick, "
          f"{run['rollback_frames_per_s']:.1f} rollback-frames/s ({resimulated} frames "
          f"resimulated); K3 {ms:.4f} ms per "
          f"{t_rows}-row dispatch on the card ({b2b_ms:.4f} ms launched back to back from "
          f"Python) vs plain {plain_ms:.1f} ms, bound {b_ms:.4f} ms ({b_by}); K3 busy "
          f"{run['device_busy_share']:.3f} of the run {tag}")
    entry = {
        "name": f"resim_tick{suffix}", "route": "cuda",
        "source": "ggrs_tpu_torch/csrc/resim_tick.cu",
        "replaces": "ggrs_tpu/tpu/pallas_resim.py:324",
        "tpu_counterpart": "PallasTickCore._build + _scalar_pass" + COUNTERPART_NOTE[suffix],
        "shape": f"{type(core.game).__name__}({players}, {n}), max_prediction {mp}, "
                 f"T={t_rows} SyncTest rows (d={CHECK_DISTANCE})",
        "max_abs_err": err, "bit_equal": err == 0,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None, "launches": launches, "ms_back_to_back": b2b_ms,
    }
    del sess, backend, psess, pbackend
    return run, entry


def host_verification_check(np, dev, tag):
    """The request path with the verdict on the HOST (r2_4096, eager and
    lazy): every save's checksum, captured at save time, resolves through
    the checksum ledger (one copy per drain, pinned prefetches between
    drains) and equals the plain version's; no mismatch is raised."""
    from ggrs_tpu_torch import SaveGameState

    key, players, n, mp = TICK_SHAPES[0]
    script = np.random.default_rng(3).integers(0, 16, size=(48, players))
    for lazy, lag in ((0, 0), (LAZY_TICKS, 4)):
        saves = []
        for plain in (False, True):
            sess, backend = request_stack(n, players, mp, lazy, dev, plain, host_lag=lag)
            got = []
            for row in script:
                add_inputs(sess, row)
                reqs = sess.advance_frame()
                backend.handle_requests(reqs)
                got += [(r.frame, r.cell.checksum_getter()) for r in reqs if isinstance(r, SaveGameState)]
            sess.flush_checksum_checks()
            saves.append([(f, g()) for f, g in got])
        if saves[0] != saves[1] or len(saves[0]) < len(script):
            fail(f"{key} lazy={lazy}: host-verified checksums differ between K3 and the plain version")
        print(f"{key} host verification (lazy={lazy}, deferred lag {lag}): {len(saves[0])} save "
              f"checksums resolved through the ledger, K3 == plain, no mismatch {tag}")


def beam_bound(n, beam, steps, players, input_size, substeps=1, suffix=""):
    """Least ms of one K4 launch: the anchor read once and the trajectory
    written once (one entity column each: 20 B for ex_game, 24 B for arena,
    28 B for swarm), plus the script and the checksums, over the HBM rate;
    vs the int32 ops of B*L entity-steps and checksums and the anchor's
    checksum (`MODEL_COST`), for arena also 6 per entity-reduction:
    the anchor's, then one of each member's state entering steps 1..L-1 —
    over the int32 peak."""
    col, step_ops, save_ops = MODEL_COST[suffix]
    nbytes = col * n * (1 + beam * steps) + 4 * beam * steps * players * (1 + input_size) \
        + 4 * (2 * beam * steps + 3)
    ops = n * (beam * steps * (substeps * step_ops + save_ops) + save_ops)
    if suffix == "_arena":
        ops += n * (1 + beam * (steps - 1)) * OPS_PER_ARENA_REDUCE
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")


def spec_err(torch, a, b) -> int:
    """Max abs difference over every field of two speculations."""
    return max(int((x.to(torch.int64) - y.to(torch.int64)).abs().max()) for x, y in zip(a, b))


def beam_phase(torch, np, dev, tag, shapes=None, game_cls=None, mod=16, probe_plane=4, timed=None):
    """K4 against plain_rollout for every speculation of a short run, a
    divergence probe (`probe_plane` of the anchor), and K4's time per
    launch. `game_cls`: ExGame unless given, its inputs below `mod`.
    Returns {key: (max abs err, ms, plain ms, ms back to back)}."""
    from ggrs_tpu_torch import ExGame, ResimCore
    from ggrs_tpu_torch.device.beam_core import plain_rollout
    from ggrs_tpu_torch.device.rowgen import random_tick_rows

    game_cls, timed = game_cls or ExGame, timed or TIMED_SPECULATIONS
    name, suffix = f"beam_rollout{body_suffix(game_cls)}", body_suffix(game_cls)
    out = {}
    for key, players, n, mp, width, steps in shapes or BEAM_SHAPES:
        core = ResimCore(game_cls(players, n), mp, players, device=dev)
        core.tick_multi(random_tick_rows(core, mp + 2 + 8, seed=n + players, mod=mod))
        ring, r_frame = core.carry["ring"], core.carry["r_frame"]
        rng = np.random.default_rng(players * 1000 + width)
        disconnects = players > 2
        err, cells = 0, 0
        for k in range(BEAM_SPECULATIONS):
            slot = (3 * k + 1) % core.ring_len
            inputs = rng.integers(0, mod, size=(width, steps, players, 1), dtype=np.uint8)
            statuses = np.zeros((width, steps, players), np.int32)
            if disconnects:
                statuses[rng.random(statuses.shape) < 0.2] = 2  # InputStatus.DISCONNECTED
                cells += int((statuses == 2).sum())
            spec = core.speculate(slot, inputs, statuses)
            plain = plain_rollout(ring[slot], r_frame[slot], torch.from_numpy(inputs).to(dev),
                                  torch.from_numpy(statuses).to(dev), core.ctx)
            torch.cuda.synchronize()
            err = max(err, spec_err(torch, spec, plain))
            if err:
                fail(f"{key}: K4 and plain_rollout differ at speculation {k} (max abs err {err})")
        if disconnects and not cells:
            fail(f"{key}: no DISCONNECTED cell was drawn")
        print(f"{key}: {name} == plain_rollout for each of {BEAM_SPECULATIONS} speculations "
              f"({players} players, {n} entities, {width} members x {steps} steps"
              f"{f', {cells} DISCONNECTED cells' if disconnects else ''}) {tag}")

        # divergence probe: a plane the step never clamps back (ex_game's
        # heading, swarm's x) of the anchor slot
        clean = core.speculate(slot, inputs, statuses)
        ring[slot, probe_plane, 0] += 7
        dirty = core.speculate(slot, inputs, statuses)
        pdirty = plain_rollout(ring[slot], r_frame[slot], torch.from_numpy(inputs).to(dev),
                               torch.from_numpy(statuses).to(dev), core.ctx)
        ring[slot, probe_plane, 0] -= 7
        torch.cuda.synchronize()
        if spec_err(torch, dirty, pdirty):
            fail(f"{key}: K4 and plain_rollout differ on a corrupted anchor")
        if torch.equal(clean.his, dirty.his) or torch.equal(clean.a_hi, dirty.a_hi):
            fail(f"{key}: a corrupted anchor left the speculation's checksums unchanged")
        print(f"{key}: divergence probe: corrupted anchor changes every checksum, K4 == plain")

        ms = b2b_ms = plain_ms = None
        if key in timed:
            br = core.beam_rollout
            script = br.script(inputs, statuses)
            reps = timed[key]
            ms = queued_ms(torch, lambda: br.rollout(ring, r_frame, slot, script), reps)
            b2b_ms = events_ms(torch, lambda: br.rollout(ring, r_frame, slot, script), reps)
            t_in, t_st = torch.from_numpy(inputs).to(dev), torch.from_numpy(statuses).to(dev)
            plain_ms = events_ms(torch, lambda: plain_rollout(ring[slot], r_frame[slot], t_in, t_st,
                                                              core.ctx), 1)
            b_ms, b_by = beam_bound(n, width, steps, players, 1, suffix=suffix)
            # after 2 * reps launches back to back, each into the scratch the one before left
            again = br.rollout(ring, r_frame, slot, script)
            want = plain_rollout(ring[slot], r_frame[slot], t_in, t_st, core.ctx)
            torch.cuda.synchronize()
            if spec_err(torch, again, want) or br._scratch.any():
                fail(f"{key}: K4 after {2 * reps} launches back to back differs from plain_rollout or left its "
                     f"scratch dirty")
            print(f"{key}: {name} {ms:.4f} ms per launch on the card ({b2b_ms:.4f} ms launched "
                  f"back to back from Python) vs plain {plain_ms:.1f} ms, bound {b_ms:.4f} ms ({b_by}); "
                  f"== plain_rollout after {2 * reps} launches back to back {tag}")
        out[key] = (err, ms, plain_ms, b2b_ms)
        del core, ring, r_frame
    return out


def beam_stack(n, mp, width, dev, device_verify=False, game_cls=None, plain=False):
    """A port SyncTest session and a backend with a beam of `width` (0:
    off) on `game_cls(PLAYERS, n)` (ExGame unless given); `plain` swaps the
    K3 wrapper for the plain version."""
    from ggrs_tpu_torch import DeviceRollbackBackend, ExGame, SessionBuilder

    sess = (
        SessionBuilder(input_size=1)
        .with_num_players(PLAYERS)
        .with_max_prediction_window(mp)
        .with_check_distance(CHECK_DISTANCE)
        .with_device_checksum_verification(device_verify)
        .start_synctest_session()
    )
    backend = DeviceRollbackBackend((game_cls or ExGame)(PLAYERS, n), mp, PLAYERS,
                                    device_verify=device_verify, beam_width=width, device=dev)
    if plain:
        backend.core.tick_core = PlainTick(backend.core)
    return sess, backend


def beam_path_phase(torch, np, dev, tag, beam_errs, shapes=None, path_ticks=None, scripts=None,
                    game_cls=None, probe_plane=4):
    """The beam request path (K4 + adoption + K3 suffixes) beside a beam-off
    twin, three scripts per shape, and a device-verify divergence probe
    (`probe_plane` of the next anchor). With `game_cls` (arena, swarm) the
    runs verify on the device and a third, plain arm (beam off, K3 swapped
    for its plain version) runs beside them: the beam's final core must
    equal it and `check()` must pass. Returns (per-run summaries, K4
    entries for the kernels line)."""
    from ggrs_tpu_torch import MismatchedChecksum, SaveGameState
    from ggrs_tpu_torch.device.resim import RESIM_KEYS

    shapes, path_ticks = shapes or BEAM_SHAPES, path_ticks or BEAM_PATH_TICKS
    scripts, verified = scripts or BEAM_SCRIPTS, game_cls is not None
    suffix = body_suffix(game_cls) if verified else ""
    runs, entries = [], []
    for key, players, n, mp, width, steps in shapes:
        if key not in path_ticks:
            continue
        ticks = path_ticks[key]
        k4_launches = 0
        for name, script in scripts.items():
            arms = {"on": beam_stack(n, mp, width, dev, verified, game_cls),
                    "off": beam_stack(n, mp, 0, dev, verified, game_cls)}
            if verified:
                arms["plain"] = beam_stack(n, mp, 0, dev, verified, game_cls, plain=True)
            beam = arms["on"][1]
            saves = {arm: [] for arm in arms}
            host = {arm: [] for arm in arms}
            marks = {arm: [] for arm in arms}
            torch.cuda.synchronize()
            beam.core.beam_rollout.launches = 0
            beam.core.tick_core.launches = 0
            for t in range(ticks):
                for arm, (sess, backend) in arms.items():
                    for h in range(players):
                        sess.add_local_input(h, bytes([script(t, h)]))
                    reqs = sess.advance_frame()
                    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    t0 = time.perf_counter()
                    start.record()
                    backend.handle_requests(reqs)
                    end.record()
                    host[arm].append((time.perf_counter() - t0) * 1e3)
                    marks[arm].append((start, end))
                    saves[arm] += [(r.frame, r.cell.checksum_getter()) for r in reqs
                                   if isinstance(r, SaveGameState)]
                a = arms["on"][1].core.carry
                for arm in arms:
                    b = arms[arm][1].core.carry
                    if not (torch.equal(a["state"], b["state"]) and torch.equal(a["state_frame"], b["state_frame"])):
                        fail(f"{key} {name}: the beam's live state differs from the {arm} twin's after tick {t}")
            torch.cuda.synchronize()
            k4, k3 = beam.core.beam_rollout.launches, beam.core.tick_core.launches
            resolved = {arm: [(f, g()) for f, g in v] for arm, v in saves.items()}
            if any(resolved[arm] != resolved["on"] for arm in arms) or len(resolved["on"]) < ticks:
                fail(f"{key} {name}: per-save checksums differ between the beam and its twin")
            if verified:
                if carry_err(torch, beam.core.carry, arms["plain"][1].core.carry, RESIM_KEYS):
                    fail(f"{key} {name}: the beam's final core differs from the plain version's")
                beam.check()
                arms["plain"][1].check()
            adopted = beam.beam_hits + beam.beam_partial_hits
            if k4 < 1 or k3 < 1 or adopted < 1 or beam.rollback_frames_adopted < 1:
                fail(f"{key} {name}: K4 launches {k4}, K3 launches {k3}, adoptions {adopted} "
                     f"(frames {beam.rollback_frames_adopted}): each must be above 0")
            if name == "varying" and beam.beam_partial_hits < 1:
                fail(f"{key} {name}: no partial hit, so no K3 suffix ran")
            k4_launches += k4
            # the host split: candidate generation alone (branching_beam with
            # the pinned history and the model's ranking), as the last tick built it
            t0 = time.perf_counter()
            for _ in range(CANDIDATE_REPS):
                beam._candidates(beam.current_frame, width)
            candidates_ms = (time.perf_counter() - t0) * 1e3 / CANDIDATE_REPS

            def pct(v, q):
                v = sorted(v)
                return v[min(len(v) - 1, (len(v) * q) // 100)]

            ev = {arm: [s.elapsed_time(e) for s, e in marks[arm]] for arm in ("on", "off")}
            run = {
                "key": key, "script": name, "ticks": ticks, "beam_width": width,
                "k4_launches": k4, "k3_launches": k3,
                "beam_hits": beam.beam_hits, "beam_partial_hits": beam.beam_partial_hits,
                "beam_misses": beam.beam_misses, "rollback_frames": beam.rollback_frames,
                "rollback_frames_adopted": beam.rollback_frames_adopted,
                "adopted_share": beam.rollback_frames_adopted / max(beam.rollback_frames, 1),
                "candidates_host_ms": candidates_ms,
            }
            for arm in ("on", "off"):
                run[f"host_ms_p50_{arm}"] = pct(host[arm], 50)
                run[f"host_ms_p90_{arm}"] = pct(host[arm], 90)
                run[f"event_ms_p50_{arm}"] = pct(ev[arm], 50)
                run[f"event_ms_p90_{arm}"] = pct(ev[arm], 90)
            runs.append(run)
            print(f"beam path {key} {name}: {k4} K4 + {k3} K3 launches over {ticks} ticks; hits "
                  f"{beam.beam_hits}, partial {beam.beam_partial_hits}, misses {beam.beam_misses}; adopted "
                  f"{beam.rollback_frames_adopted}/{beam.rollback_frames} rollback frames "
                  f"({run['adopted_share']:.3f}); handle_requests host p50 {run['host_ms_p50_on']:.4f} ms "
                  f"(p90 {run['host_ms_p90_on']:.4f}) beam on vs {run['host_ms_p50_off']:.4f} "
                  f"(p90 {run['host_ms_p90_off']:.4f}) off; events p50 {run['event_ms_p50_on']:.4f} vs "
                  f"{run['event_ms_p50_off']:.4f} ms; candidate generation {candidates_ms:.4f} ms of host; "
                  f"states and {len(resolved['on'])} save checksums equal to the twin's {tag}")
            del arms, beam

        # divergence probe: corrupt the anchor the NEXT speculation rolls
        # out of (its slot is not re-saved before that launch), so the
        # adopted checksums carry the corruption into the verify history
        sess, backend = beam_stack(n, mp, width, dev, device_verify=True, game_cls=game_cls)
        script = scripts["constant"]
        for t in range(14):
            for h in range(players):
                sess.add_local_input(h, bytes([script(t, h)]))
            backend.handle_requests(sess.advance_frame())
        backend.core.carry["ring"][(backend.current_frame + 1 - backend._depth) % backend.core.ring_len,
                                   probe_plane, 0] += 7
        latched = None
        for t in range(14, 18):
            for h in range(players):
                sess.add_local_input(h, bytes([script(t, h)]))
            backend.handle_requests(sess.advance_frame())
            try:
                backend.check()
            except MismatchedChecksum as exc:
                latched = exc.frame
                break
        if latched is None or backend.beam_hits < 1:
            fail(f"{key}: the beam-on divergence probe latched no mismatch (hits {backend.beam_hits})")
        print(f"{key}: divergence probe with the beam on: corrupted anchor latched at frame {latched}")
        del sess, backend

        err, ms, plain_ms, b2b_ms = beam_errs[key]
        b_ms, b_by = beam_bound(n, width, steps, players, 1, suffix=suffix)
        entries.append({
            "name": f"beam_rollout{suffix}", "route": "cuda",
            "source": "ggrs_tpu_torch/csrc/beam_rollout.cu",
            "replaces": "ggrs_tpu/tpu/pallas_beam.py:226",
            "tpu_counterpart": "PallasBeamRollout._build + run_kernel + finish" + COUNTERPART_NOTE[suffix],
            "shape": f"{(game_cls.__name__ + ' ') if verified else ''}{n} entities, P={players}, B={width} x L={steps}",
            "max_abs_err": err, "bit_equal": err == 0,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "launches": k4_launches, "ms_back_to_back": b2b_ms,
        })
    return runs, entries


class PlainTiled:
    """Stands in for the injection route's K2 wrapper: its tick's plain
    version (`plain_injected_tick`) on the same (CUDA) carry."""

    def __init__(self, ctx):
        self.ctx = ctx

    def tick_injected(self, carry, inputs, red, nxt, later=0):
        from ggrs_tpu_torch.device.tiled_core import plain_injected_tick

        plain_injected_tick(carry, inputs, red, nxt, self.ctx)


def plain_injected(ctx):
    """The injection route with every kernel swapped for its plain version,
    on the card: the twin the route is held against."""
    import torch

    from ggrs_tpu_torch.device.injected_core import InjectedReduceCore
    from ggrs_tpu_torch.device.reduce_core import STATE, ReduceTableCore, plain_reduce_table

    class PlainReduce(ReduceTableCore):
        def gather(self, ring, state, slots, out=None):
            table = plain_reduce_table(torch.stack([state if s == STATE else ring[s] for s in slots]), ctx)
            if out is None:
                return table
            out.copy_(table)
            return out

    twin = InjectedReduceCore(ctx)
    twin.tiled, twin.reduce = PlainTiled(ctx), PlainReduce(ctx)
    return twin


def kill(carry, d, ring_len):
    """The divergence probe: kill KILLED entities (hp = 0) in the ring slot
    the next rollback loads."""
    carry["ring"][(int(carry["meta"][0]) - d) % ring_len, 4, :KILLED] = 0


def arena_fused_phase(torch, np, dev, tag):
    """Arena's K1 against plain_batch (T = 60 with the reduction cache, T = 1
    inline), a divergence probe per mode, and K1's times. Returns (scripts,
    plain final carries, entries keyed by shape)."""
    from ggrs_tpu_torch import Arena
    from ggrs_tpu_torch.convert import CARRY_KEYS, copy_carry
    from ggrs_tpu_torch.device import sync_test
    from ggrs_tpu_torch.device.fused_core import FusedSyncTestCore, plain_batch
    from ggrs_tpu_torch.device.planes import PlaneContext

    rng = np.random.default_rng(4096)

    def arena_script(t, players, input_size):
        raw = rng.integers(0, 64, size=(t, players, input_size), dtype=np.uint8)
        if input_size == 2:
            raw[..., 1] = rng.integers(0, 16, size=(t, players))
        return raw

    scripts = {key: [arena_script(t, p, i) for _ in range(b)] for key, p, _, i, _, t, b in ARENA_SHAPES}
    plain_final, entries = {}, {}
    for key, players, n, input_size, d, t_ticks, batches in ARENA_SHAPES:
        ctx = PlaneContext(Arena(players, n, input_size), players, d, dev)
        core = FusedSyncTestCore(ctx)
        kc = sync_test.initial_carry(ctx)
        pc = copy_carry(kc)
        err = 0
        for raw in scripts[key]:
            inputs = torch.from_numpy(raw.astype(np.int32)).to(dev)
            core.batch(kc, inputs)
            plain_batch(pc, inputs, ctx)
            torch.cuda.synchronize()
            err = max(err, carry_err(torch, kc, pc, CARRY_KEYS))
            if err:
                fail(f"{key}: arena K1 and plain version differ (max abs err {err})")
        print(f"{key}: synctest_fused (arena, cached reductions) == plain after each of {batches} batch(es) "
              f"({players} players, {n} entities, input_size {input_size}, d={d}, T={t_ticks}) {tag}")
        plain_final[key] = copy_carry(pc)

        c = int(kc["meta"][0])
        probe = [copy_carry(kc), copy_carry(pc)]
        for carry in probe:
            kill(carry, d, ctx.ring_len)
        inputs = torch.from_numpy(scripts[key][0].astype(np.int32)).to(dev)
        core.batch(probe[0], inputs)
        plain_batch(probe[1], inputs, ctx)
        torch.cuda.synchronize()
        latched = [carry["meta"].tolist() for carry in probe]
        if latched[0] != latched[1] or latched[0][1] != 1 or latched[0][2] != c - d + 1:
            fail(f"{key}: arena divergence probe latched {latched}, expected frame {c - d + 1} on both")
        if carry_err(torch, probe[0], probe[1], CARRY_KEYS):
            fail(f"{key}: arena K1 and plain version differ after the divergence probe")
        print(f"{key}: divergence probe (hp = 0 for {KILLED} entities): both latched frame {c - d + 1}")
        del probe

        if key in ARENA_TIMED:
            timed, ptimed = copy_carry(kc), copy_carry(pc)
            b_ms, b_by = arena_bound(n, players, d, t_ticks, int(timed["meta"][0]))
            tail_ms = tail_verdict_ms(torch, ctx, timed, inputs)
            ms = events_ms(torch, lambda: core.batch(timed, inputs), ARENA_TIMED[key])
            plain_ms = events_ms(torch, lambda: plain_batch(ptimed, inputs, ctx), 1)
            print(f"{key}: synctest_fused (arena) {ms:.4f} ms/batch vs plain {plain_ms:.1f} ms, "
                  f"bound {b_ms:.4f} ms ({b_by}); its tail's verdict alone on this batch's parts "
                  f"{tail_ms:.4f} ms {tag}")
            entries[key] = {
                "name": "synctest_fused_arena", "route": "cuda",
                "source": "ggrs_tpu_torch/csrc/synctest_fused.cu",
                "replaces": "ggrs_tpu/tpu/pallas_core.py:979",
                "tpu_counterpart": "PallasSyncTestCore._build with ArenaPlanes (reduction cache)",
                "shape": f"Arena({players}, {n}), d={d}, T={t_ticks}",
                "max_abs_err": err, "bit_equal": err == 0,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": None, "launches": 0, "tail_verdict_ms": tail_ms,
            }
            del timed, ptimed
        del kc, pc

    # T == 1: inline reductions before every step, d+1 grid barriers a tick
    _, players, n, _, d, _, _ = ARENA_SHAPES[0]
    ctx = PlaneContext(Arena(players, n), players, d, dev)
    core = FusedSyncTestCore(ctx)
    kc = sync_test.initial_carry(ctx)
    pc = copy_carry(kc)
    ticks = arena_script(ARENA_T1_BATCHES + 1, players, 1)
    err = 0
    for k in range(ARENA_T1_BATCHES + 1):
        if k == ARENA_T1_BATCHES:
            c = int(kc["meta"][0])
            plain_final["a1_4096_t1"] = copy_carry(pc)
            for carry in (kc, pc):
                kill(carry, d, ctx.ring_len)
        inputs = torch.from_numpy(ticks[k:k + 1].astype(np.int32)).to(dev)
        core.batch(kc, inputs)
        plain_batch(pc, inputs, ctx)
        torch.cuda.synchronize()
        err = max(err, carry_err(torch, kc, pc, CARRY_KEYS))
        if err:
            fail(f"a1_4096 T=1: arena K1 and plain version differ at tick {k} (max abs err {err})")
    if kc["meta"].tolist() != [c + 1, 1, c - d + 1]:
        fail(f"a1_4096 T=1: divergence probe latched {kc['meta'].tolist()}, expected frame {c - d + 1}")
    print(f"a1_4096 T=1: synctest_fused (arena, inline reductions) == plain after each of "
          f"{ARENA_T1_BATCHES + 1} single-tick batches; divergence probe latched frame {c - d + 1} on both {tag}")
    ms = queued_ms(torch, lambda: core.batch(kc, inputs), TIMED_LAUNCHES)
    b2b_ms = events_ms(torch, lambda: core.batch(kc, inputs), TIMED_LAUNCHES)
    plain_ms = events_ms(torch, lambda: plain_batch(pc, inputs, ctx), 1)
    b_ms, b_by = arena_bound(n, players, d, 1, d + 1)
    print(f"a1_4096 T=1: synctest_fused (arena) {ms:.4f} ms per single-tick launch on the card "
          f"({b2b_ms:.4f} ms launched back to back from Python) vs plain {plain_ms:.1f} ms, "
          f"bound {b_ms:.4f} ms ({b_by}) {tag}")
    entries["a1_4096_t1"] = {
        "name": "synctest_fused_arena", "route": "cuda",
        "source": "ggrs_tpu_torch/csrc/synctest_fused.cu",
        "replaces": "ggrs_tpu/tpu/pallas_core.py:979",
        "tpu_counterpart": "PallasSyncTestCore._build with ArenaPlanes (inline, T == 1)",
        "shape": f"Arena({players}, {n}), d={d}, T=1",
        "max_abs_err": err, "bit_equal": err == 0,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None, "launches": 0, "ms_back_to_back": b2b_ms,
    }
    scripts["a1_4096_t1"] = [ticks[k:k + 1] for k in range(ARENA_T1_BATCHES)]
    return scripts, plain_final, entries


def library_reduce_ms(torch, carry, slots, players, reps):
    """One PyTorch call computing K5's function: a masked index_add_ of
    [S, N, 3] columns (1, px >> 6, py >> 6 of the living) over the owner
    index into [S, P, 3]. The columns and the index are built beforehand
    and left out of the time."""
    from ggrs_tpu_torch.device.reduce_core import STATE

    src = torch.stack([carry["state"] if s == STATE else carry["ring"][s] for s in slots])
    alive = (src[:, 4] > 0).to(torch.int32)
    cols = torch.stack([alive, alive * (src[:, 0] >> 6), alive * (src[:, 1] >> 6)], dim=-1).contiguous()
    owner = torch.arange(src.shape[-1], device=src.device) % players
    out = torch.zeros((len(slots), players, 3), dtype=torch.int32, device=src.device)
    return queued_ms(torch, lambda: out.index_add_(1, owner, cols), reps)


def reduce_and_injected_phase(torch, np, dev, tag):
    """K5 against plain_reduce_table, then the injection route against its
    plain twin on the card, a divergence probe, and the K5 time; then the
    route's one-launch tick alone against its plain version over launches
    back to back, and its time. Returns (twin final carries, scripts,
    entries keyed by name and shape)."""
    from ggrs_tpu_torch import Arena
    from ggrs_tpu_torch.convert import CARRY_KEYS, copy_carry
    from ggrs_tpu_torch.device import sync_test
    from ggrs_tpu_torch.device.injected_core import InjectedReduceCore
    from ggrs_tpu_torch.device.planes import PlaneContext
    from ggrs_tpu_torch.device.reduce_core import STATE, plain_reduce_table, source_slots

    rng = np.random.default_rng(3491)
    scripts = {key: rng.integers(0, 64, size=(ticks, p, 1), dtype=np.uint8)
               for key, p, _, _, ticks in INJECTED_SHAPES}
    twin_final, entries = {}, {}
    for key, players, n, d, ticks in INJECTED_SHAPES:
        ctx = PlaneContext(Arena(players, n), players, d, dev)
        core, twin = InjectedReduceCore(ctx), plain_injected(ctx)
        kc = sync_test.initial_carry(ctx)
        pc = copy_carry(kc)
        err = 0
        for start in range(0, ticks, INJECTED_BATCH):
            inputs = torch.from_numpy(scripts[key][start:start + INJECTED_BATCH].astype(np.int32)).to(dev)
            core.batch(kc, inputs, frame=start)
            twin.batch(pc, inputs, frame=start)
            torch.cuda.synchronize()
            err = max(err, carry_err(torch, kc, pc, CARRY_KEYS))
            if err:
                fail(f"{key}: the injection route and its plain twin differ (max abs err {err})")
        print(f"{key}: injection route (reduce_table + the one-launch synctest_tiled_arena tick) == plain twin "
              f"over {ticks} ticks across frame d={d} ({players} players, {n} entities) {tag}")
        twin_final[key] = copy_carry(pc)

        # K5 alone, over the d+1 sources of the next tick and over the state,
        # on a copy with dead entities in every source
        dead = copy_carry(kc)
        dead["state"][4, 1::5] = 0
        dead["ring"][:, 4, 2::7] = 0
        k5_err = 0
        for slots in (source_slots(ticks, d, ctx.ring_len), (STATE,)):
            got = core.reduce.gather(dead["ring"], dead["state"], slots)
            want = plain_reduce_table(torch.stack([dead["state"] if s == STATE else dead["ring"][s]
                                                   for s in slots]), ctx)
            torch.cuda.synchronize()
            k5_err = max(k5_err, carry_err(torch, {"t": got}, {"t": want}, "t"))
            if k5_err:
                fail(f"{key}: reduce_table and plain_reduce_table differ over {len(slots)} sources")
            S = len(slots)
            ms = queued_ms(torch, lambda: core.reduce.gather(dead["ring"], dead["state"], slots), TIMED_LAUNCHES)
            plain_ms = events_ms(torch, lambda: plain_reduce_table(
                torch.stack([dead["state"] if s == STATE else dead["ring"][s] for s in slots]), ctx), 1)
            lib_ms = library_reduce_ms(torch, dead, slots, players, TIMED_LAUNCHES)
            b_ms, b_by = least(12 * n * S + 4 * S * 3 * players, n * S * OPS_PER_ARENA_REDUCE)
            print(f"{key}: reduce_table == plain over S={S} source(s); {ms:.4f} ms per launch on the card vs "
                  f"plain {plain_ms:.2f} ms, masked index_add_ {lib_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by}) {tag}")
            if S == 1:  # the frontier row: no longer on the route (its tick sums it), parity only
                continue
            entries[("reduce_table", key, S)] = {
                "name": "reduce_table", "route": "cuda",
                "source": "ggrs_tpu_torch/csrc/reduce_table.cu",
                "replaces": "ggrs_tpu/tpu/pallas_tiled.py:612",
                "tpu_counterpart": "PallasTiledSyncTestCore._build_reduce_table",
                "shape": f"Arena({players}, {n}), S={S} sources",
                "max_abs_err": k5_err, "bit_equal": k5_err == 0,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": lib_ms, "launches": 0,
            }

        # divergence probe through the route
        c = int(kc["meta"][0])
        probe = [copy_carry(kc), copy_carry(pc)]
        for carry in probe:
            kill(carry, d, ctx.ring_len)
        inputs = torch.from_numpy(scripts[key][:10].astype(np.int32)).to(dev)
        core.batch(probe[0], inputs, frame=c)
        twin.batch(probe[1], inputs, frame=c)
        torch.cuda.synchronize()
        latched = [carry["meta"].tolist() for carry in probe]
        if latched[0] != latched[1] or latched[0][1] != 1 or latched[0][2] != c - d + 1:
            fail(f"{key}: injection-route divergence probe latched {latched}, expected frame {c - d + 1}")
        if carry_err(torch, probe[0], probe[1], CARRY_KEYS):
            fail(f"{key}: the injection route and its plain twin differ after the divergence probe")
        print(f"{key}: divergence probe (hp = 0 for {KILLED} entities): both latched frame {c - d + 1}")
        del probe

        # the one-launch tick alone, on alternating tables, launched back to
        # back into the scratch the previous launch left, against its plain
        # version after every launch; then timed (every save stored)
        timed, ptimed = copy_carry(kc), copy_carry(kc)
        tables = torch.zeros((2, d + 1, 3 * players), dtype=torch.int32, device=dev)
        ptables = tables.clone()
        core.reduce.reduce_sources(timed, c, out=tables[0])
        ptables[0] = tables[0]
        one = inputs[:1]
        twin_tiled = PlainTiled(ctx)
        for k in range(4):
            core.tiled.tick_injected(timed, one, tables[k % 2], tables[1 - k % 2])
            twin_tiled.tick_injected(ptimed, one, ptables[k % 2], ptables[1 - k % 2])
            torch.cuda.synchronize()
            tick_err = max(carry_err(torch, timed, ptimed, CARRY_KEYS),
                           carry_err(torch, {"t": tables}, {"t": ptables}, "t"))
            if tick_err or core.tiled._tick_scratch.any():
                fail(f"{key}: synctest_tiled_arena and plain_injected_tick differ at launch {k} (max abs err "
                     f"{tick_err}) or left its scratch dirty")
        c = int(timed["meta"][0])
        red, nxt = tables[0], tables[1]
        core.reduce.reduce_sources(timed, c, out=red)
        nxt[d] = 0
        ms = queued_ms(torch, lambda: core.tiled.tick_injected(timed, one, red, nxt), TIMED_LAUNCHES)
        b2b_ms = events_ms(torch, lambda: core.tiled.tick_injected(timed, one, red, nxt), TIMED_LAUNCHES)
        core.reduce.reduce_sources(ptimed, c, out=ptables[0])
        plain_ms = events_ms(torch, lambda: twin_tiled.tick_injected(ptimed, one, ptables[0], ptables[1]), 1)
        b_ms, b_by = injected_tick_bound(n, players, d, c)
        print(f"{key}: synctest_tiled_arena == plain_injected_tick after each of 4 launches back to back; "
              f"{ms:.4f} ms per tick on the card (the tick, the next table and the verdict; {b2b_ms:.4f} ms "
              f"launched back to back from Python) vs plain {plain_ms:.1f} ms, bound {b_ms:.6f} ms ({b_by}) {tag}")
        entries[("synctest_tiled_arena", key)] = {
            "name": "synctest_tiled_arena", "route": "cuda",
            "source": "ggrs_tpu_torch/csrc/synctest_tiled.cu",
            "replaces": "ggrs_tpu/tpu/pallas_tiled.py:428",
            "tpu_counterpart": "PallasTiledSyncTestCore._build, external_reduce, with _verdict (:468) and the "
                              "frontier row (:666) of one ShardedPallasTiledCore tick",
            "shape": f"Arena({players}, {n}), d={d}, T=1 on red [d+1, {3 * players}], the next table and the verdict",
            "max_abs_err": max(err, tick_err), "bit_equal": max(err, tick_err) == 0,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "launches": 0, "ms_back_to_back": b2b_ms,
        }
        del timed, ptimed, tables, ptables, dead, kc, pc
    return twin_final, scripts, entries


def arena_main_path_phase(torch, np, dev, tag, fused_scripts, fused_final, injected_scripts, injected_final,
                          fused_entries, injected_entries):
    """Arena's main path through the session: auto -> K1 at 4096 and 65536,
    and backend="cuda-tiled-injected" (the injection route) at 4096 and 65536."""
    from ggrs_tpu_torch import Arena, DeviceSyncTestSession
    from ggrs_tpu_torch.convert import CARRY_KEYS

    def pct(v, q):
        v = sorted(v)
        return v[min(len(v) - 1, (len(v) * q) // 100)]

    runs = []
    for key, players, n, input_size, d, t_ticks, batches in ARENA_SHAPES:
        if key not in ARENA_MAIN_BATCHES:
            continue
        sess = DeviceSyncTestSession(Arena(players, n, input_size), players, d, backend="auto", device=dev)
        if sess.backend != "cuda-fused":
            fail(f"{key}: auto chose {sess.backend} for arena, expected cuda-fused")
        sess.core.launches = 0
        for raw in fused_scripts[key]:
            sess.advance_frames(raw)
        sess.block_until_ready()
        launches = sess.core.launches
        if launches < 1:
            fail(f"{key}: the arena main path launched no K1 kernel")
        if carry_err(torch, sess.carry, fused_final[key], CARRY_KEYS):
            fail(f"{key}: the arena main path's carry differs from the plain version's")
        sess.check()
        state = sess.state_numpy()
        if state["pos"].shape != (n, 2) or state["hp"].shape != (n,) or int(state["frame"]) != t_ticks * batches:
            fail(f"{key}: arena state has the wrong shape or frame")
        reps = ARENA_MAIN_BATCHES[key]
        samples = [events_ms(torch, lambda: sess.advance_frames(fused_scripts[key][-1]), 1) for _ in range(reps)]
        sess.check()
        ms, p90 = pct(samples, 50), pct(samples, 90)
        rate = t_ticks * d / (ms / 1e3)
        fused_entries[key]["launches"] = launches
        print(f"arena main path {key}: auto -> {sess.backend}, {launches} K1 launches over {batches} batches, "
              f"then median {ms:.4f} ms/batch (p90 {p90:.4f}, n={reps}), {rate:.1f} rollback-frames/s {tag}")
        runs.append({"key": key, "backend": sess.backend, "ms_per_batch_p50": ms, "ms_per_batch_p90": p90,
                     "samples": reps, "rollback_frames_per_s_p50": rate, "launches": launches})
        del sess

    # single-tick batches: K1 with inline reductions, as a per-tick caller drives it
    _, players, n, _, d, _, _ = ARENA_SHAPES[0]
    sess = DeviceSyncTestSession(Arena(players, n), players, d, backend="auto", device=dev)
    sess.core.launches = 0
    for raw in fused_scripts["a1_4096_t1"]:
        sess.advance_frames(raw)
    sess.block_until_ready()
    launches = sess.core.launches
    if launches < 1 or carry_err(torch, sess.carry, fused_final["a1_4096_t1"], CARRY_KEYS):
        fail(f"a1_4096 T=1: the main path launched {launches} K1 kernels or ended apart from the plain version")
    sess.check()
    fused_entries["a1_4096_t1"]["launches"] = launches
    print(f"arena main path a1_4096 T=1: auto -> {sess.backend}, {launches} single-tick K1 launches, "
          f"carry == plain {tag}")
    del sess

    for key, players, n, d, ticks in INJECTED_SHAPES:
        sess = DeviceSyncTestSession(Arena(players, n), players, d, backend="cuda-tiled-injected", device=dev)
        core = sess.core
        core.tiled.launches = core.tiled.verdict_launches = core.reduce.launches = 0
        batches = 0
        for start in range(0, ticks, INJECTED_BATCH):
            sess.advance_frames(injected_scripts[key][start:start + INJECTED_BATCH])
            batches += 1
        sess.block_until_ready()
        counts = {"synctest_tiled_arena": core.tiled.launches, "reduce_table": core.reduce.launches}
        boot = min(d, INJECTED_BATCH - 1)  # ticks below frame d but a batch's last: K5 rebuilds the next table
        if counts != {"synctest_tiled_arena": ticks, "reduce_table": batches + boot} or core.tiled.verdict_launches:
            fail(f"{key}: the injection route launched {counts} and {core.tiled.verdict_launches} verdict kernels over "
                 f"{ticks} ticks, expected one tick kernel a tick and K5 {batches + boot} times "
                 f"({batches} batches + {boot} boot ticks)")
        print(f"{key}: the injection route's launches over {ticks} ticks in {batches} batches: {counts}, "
              f"no verdict launch: one kernel launch a tick past frame d, K5 once a batch and {boot} boot ticks")
        if carry_err(torch, sess.carry, injected_final[key], CARRY_KEYS):
            fail(f"{key}: the injection route's carry differs from the plain twin's")
        sess.check()
        if int(sess.state_numpy()["frame"]) != ticks:
            fail(f"{key}: the injection route ended at the wrong frame")
        reps = INJECTED_MAIN_BATCHES[key]
        batch = injected_scripts[key][-INJECTED_BATCH:]
        samples = [events_ms(torch, lambda: sess.advance_frames(batch), 1) / INJECTED_BATCH for _ in range(reps)]
        sess.check()
        ms, p90 = pct(samples, 50), pct(samples, 90)
        rate = d / (ms / 1e3)
        for (name, k, *_), e in injected_entries.items():
            if k == key:
                e["launches"] = counts[name]
        print(f"arena main path {key}: cuda-tiled-injected (injection route), launches {counts} over {ticks} ticks, "
              f"then median {ms:.4f} ms/tick (p90 {p90:.4f}, {reps} batches of {INJECTED_BATCH}), "
              f"{rate:.1f} rollback-frames/s {tag}")
        runs.append({"key": key, "backend": "cuda-tiled-injected", "ms_per_tick_p50": ms, "ms_per_tick_p90": p90,
                     "samples": reps, "rollback_frames_per_s_p50": rate, "launches": counts})
        del sess
    return runs


def arena_rollback_rows(core, n_rows, seed):
    """bench.py:1275's buffer: `n_rows` rows, each loading frame f - 8,
    advancing 9 frames (8 resimulated and a new one) with dense saves, on
    random inputs below 64."""
    import numpy as np

    W, P = core.window, core.num_players
    rng = np.random.default_rng(seed)
    rows, frame, depth = [], 24, 8
    for _ in range(n_rows):
        inputs = rng.integers(0, 64, size=(W, P, 1), dtype=np.uint8)
        statuses = np.zeros((W, P), np.int32)
        slots = np.full((W,), core.scratch_slot, np.int32)
        start = frame - depth
        for i in range(depth + 1):
            slots[i] = (start + i) % core.ring_len
        rows.append(core.pack_tick_row(True, start % core.ring_len, inputs, statuses, slots, depth + 1,
                                       start_frame=start))
        frame += 1
    return np.stack(rows)


def arena_script(np, rng, ticks, players, input_size):
    """Session inputs for arena: byte 0 below 64, the throttle byte below 16."""
    raw = rng.integers(0, 64, size=(ticks, players, input_size))
    if input_size == 2:
        raw[..., 1] = rng.integers(0, 16, size=(ticks, players))
    return raw if input_size == 2 else raw[..., 0]


def arena_tick_phase(torch, np, dev, tag):
    """K3's arena body against plain_tick_multi after every dispatch (his/los
    and the whole core, device verification on): seeded session-shaped
    streams (arena's inputs, the throttle byte where the game has it, 15%
    DISCONNECTED slots) as 1-row and 8-row dispatches, and ar4_l16's
    rollback buffer as 16-row dispatches; then a kill probe per shape
    through the request path. Returns ({key: max abs err}, {key: (ms, plain
    ms, bound) of ar4_l16's buffer})."""
    from ggrs_tpu_torch import Arena, MismatchedChecksum, ResimCore
    from ggrs_tpu_torch.device.resim import RESIM_KEYS
    from ggrs_tpu_torch.device.rowgen import prime_row, random_tick_rows
    from ggrs_tpu_torch.device.tick_core import plain_tick_multi

    errs, timed = {}, {}
    for key, players, n, input_size, mp in ARENA_TICK_SHAPES:
        err = 0
        for per_dispatch in [ARENA_ROLLBACK_ROWS] if key == "ar4_l16" else [1, ARENA_TICK_ROWS]:
            core = ResimCore(Arena(players, n, input_size), mp, players, device_verify=True, device=dev)
            plain = {k: v.clone() for k, v in core.carry.items()}
            if key == "ar4_l16":
                rows = np.concatenate([arena_rollback_rows(core, ARENA_ROLLBACK_ROWS, seed=3)] * 3)
            else:
                extra = ARENA_STREAM_ROWS.get(key, TICK_STREAM_EXTRA_ROWS)
                rows = random_tick_rows(core, mp + 2 + extra, seed=players * 100 + mp, mod=64)
            core.tick_multi(prime_row(core)[None])
            plain_tick_multi(plain, core.upload(prime_row(core)[None]), core)
            for b in range(0, len(rows), per_dispatch):
                batch = rows[b : b + per_dispatch]
                his, los = core.tick_multi(batch)
                p_his, p_los = plain_tick_multi(plain, core.upload(batch), core)
                torch.cuda.synchronize()
                err = max(err, carry_err(torch, {"h": his, "l": los}, {"h": p_his, "l": p_los}, "hl"),
                          carry_err(torch, core.carry, plain, RESIM_KEYS))
                if err:
                    fail(f"{key}: K3 (arena) and plain version differ at rows {b}.. of {per_dispatch}-row "
                         f"dispatches (max abs err {err})")
            if not bool((core.carry["state"][4] > 0).any()):
                fail(f"{key}: the stream left no living entity, so it tested no reduction")
            disconnects = int((rows[:, core.off_status : core.off_input] == 2).sum())
            plan = core.tick_core.plan
            if plan.regime != ARENA_TICK_REGIME.get(key, "grid-shared"):
                fail(f"{key}: K3-arena took the {plan.regime} layout, expected {ARENA_TICK_REGIME.get(key)}")
            print(f"{key}: resim_tick (arena) == plain after each of {-(-len(rows) // per_dispatch)} "
                  f"{per_dispatch}-row dispatch(es) ({players} players, {n} entities, input_size "
                  f"{input_size}, max_prediction {mp}, device verify, {disconnects} DISCONNECTED cells; "
                  f"{plan.regime}: {plan.blocks} blocks of {plan.threads} threads) {tag}")
            if key == "ar4_l16":
                buf = core.upload(rows[:ARENA_ROLLBACK_ROWS])
                ptimed = {k: v.clone() for k, v in core.carry.items()}
                ms = queued_ms(torch, lambda: core.tick_core.tick_multi(core.carry, buf), 50)
                plain_ms = events_ms(torch, lambda: plain_tick_multi(ptimed, buf, core), 1)
                b_ms, b_by = tick_bound(rows[:ARENA_ROLLBACK_ROWS], n, core)
                timed[key] = (ms, plain_ms, b_ms, b_by)
                print(f"{key}: resim_tick (arena) {ms:.4f} ms per {ARENA_ROLLBACK_ROWS}-row buffer, "
                      f"{ms / ARENA_ROLLBACK_ROWS:.4f} ms per rollback tick, vs plain {plain_ms:.1f} ms, "
                      f"bound {b_ms:.4f} ms ({b_by}) {tag}")
                del ptimed
            del core, plain
        errs[key] = err

        # kill probe through the request path: hp = 0 for KILLED entities in
        # the slot the next rollback loads, on the kernel's core and the
        # plain version's alike
        stacks = [request_stack(n, players, mp, 0, dev, plain, game=Arena(players, n, input_size))
                  for plain in (False, True)]
        script = arena_script(np, np.random.default_rng(7), 16, players, input_size)
        for sess, backend in stacks:
            for row in script[:12]:
                add_inputs(sess, row)
                backend.handle_requests(sess.advance_frame())
        frame = stacks[0][1].current_frame
        latched = []
        for sess, backend in stacks:
            backend.core.carry["ring"][(frame - CHECK_DISTANCE) % backend.core.ring_len, 4, :KILLED] = 0
            add_inputs(sess, script[12])
            backend.handle_requests(sess.advance_frame())
            try:
                backend.check()
                latched.append(None)
            except MismatchedChecksum as exc:
                latched.append(exc.frame)
        want = frame - CHECK_DISTANCE + 1
        if latched != [want, want]:
            fail(f"{key}: kill probe latched {latched} (kernel, plain), expected frame {want} on both")
        if carry_err(torch, stacks[0][1].core.carry, stacks[1][1].core.carry, RESIM_KEYS):
            fail(f"{key}: K3 (arena) and plain version differ after the kill probe")
        print(f"{key}: kill probe (hp = 0 for {KILLED} entities): K3 and plain both latched frame {want}")
        del stacks
    return errs, timed


def arena_beam_phase(torch, np, dev, tag):
    """K4's arena body against plain_rollout for every speculation of a
    short run (trajectory, checksums, anchor), a kill probe on the anchor,
    and K4's time per launch. Returns {key: (max abs err, ms, plain ms, ms
    back to back)}."""
    from ggrs_tpu_torch import Arena, ResimCore
    from ggrs_tpu_torch.device.beam_core import plain_rollout
    from ggrs_tpu_torch.device.rowgen import prime_row, random_tick_rows

    out = {}
    for key, players, n, mp, width, steps in ARENA_BEAM_SHAPES:
        input_size = 2 if key.endswith("_w") else 1
        core = ResimCore(Arena(players, n, input_size), mp, players, device=dev)
        core.tick_multi(np.concatenate([prime_row(core)[None],
                                        random_tick_rows(core, mp + 2 + 8, seed=n + players, mod=64)]))
        ring, r_frame = core.carry["ring"], core.carry["r_frame"]
        rng = np.random.default_rng(players * 1000 + width + 1)
        disconnects = players > 2
        err, cells = 0, 0
        for k in range(BEAM_SPECULATIONS):
            slot = (3 * k + 1) % core.ring_len
            inputs = rng.integers(0, 64, size=(width, steps, players, input_size), dtype=np.uint8)
            if input_size == 2:
                inputs[..., 1] = rng.integers(0, 16, size=(width, steps, players))
            statuses = np.zeros((width, steps, players), np.int32)
            if disconnects:
                statuses[rng.random(statuses.shape) < 0.2] = 2  # InputStatus.DISCONNECTED
                cells += int((statuses == 2).sum())
            spec = core.speculate(slot, inputs, statuses)
            plain = plain_rollout(ring[slot], r_frame[slot], torch.from_numpy(inputs).to(dev),
                                  torch.from_numpy(statuses).to(dev), core.ctx)
            torch.cuda.synchronize()
            err = max(err, spec_err(torch, spec, plain))
            if err:
                fail(f"{key}: K4 (arena) and plain_rollout differ at speculation {k} (max abs err {err})")
        if disconnects and not cells:
            fail(f"{key}: no DISCONNECTED cell was drawn")
        plan = core.beam_rollout.plans[width]
        if plan.on_chip != ARENA_BEAM_ON_CHIP.get(key, True):
            fail(f"{key}: K4-arena's plan {plan} keeps its states {'on' if plan.on_chip else 'off'} chip")
        print(f"{key}: beam_rollout (arena) == plain_rollout for each of {BEAM_SPECULATIONS} speculations "
              f"({players} players, {n} entities, input_size {input_size}, {width} members x {steps} steps"
              f"{f', {cells} DISCONNECTED cells' if disconnects else ''}; {plan.group} blocks a member of "
              f"{plan.threads} threads, states {'on chip' if plan.on_chip else 'in the trajectory'}) {tag}")

        # kill probe: hp = 0 for KILLED entities of the newest snapshot (a
        # slot the stream never saved holds a zero world, dead already)
        slot = int(r_frame[: core.ring_len].argmax())
        if not bool((ring[slot, 4, :KILLED] > 0).any()):
            fail(f"{key}: the kill probe's anchor slot {slot} holds no living entity to kill")
        clean = core.speculate(slot, inputs, statuses)
        saved = ring[slot, 4, :KILLED].clone()
        ring[slot, 4, :KILLED] = 0
        dirty = core.speculate(slot, inputs, statuses)
        pdirty = plain_rollout(ring[slot], r_frame[slot], torch.from_numpy(inputs).to(dev),
                               torch.from_numpy(statuses).to(dev), core.ctx)
        ring[slot, 4, :KILLED] = saved
        torch.cuda.synchronize()
        if spec_err(torch, dirty, pdirty):
            fail(f"{key}: K4 (arena) and plain_rollout differ on a killed anchor")
        if torch.equal(clean.his, dirty.his) or torch.equal(clean.a_hi, dirty.a_hi):
            fail(f"{key}: killing anchor entities left the speculation's checksums unchanged")
        print(f"{key}: kill probe: killed anchor entities change every checksum, K4 == plain")

        ms = b2b_ms = plain_ms = None
        if key in ARENA_TIMED_SPECULATIONS:
            br = core.beam_rollout
            script = br.script(inputs, statuses)
            reps = ARENA_TIMED_SPECULATIONS[key]
            ms = queued_ms(torch, lambda: br.rollout(ring, r_frame, slot, script), reps)
            b2b_ms = events_ms(torch, lambda: br.rollout(ring, r_frame, slot, script), reps)
            t_in, t_st = torch.from_numpy(inputs).to(dev), torch.from_numpy(statuses).to(dev)
            plain_ms = events_ms(torch, lambda: plain_rollout(ring[slot], r_frame[slot], t_in, t_st,
                                                              core.ctx), 1)
            b_ms, b_by = beam_bound(n, width, steps, players, input_size, suffix="_arena")
            print(f"{key}: beam_rollout (arena) {ms:.4f} ms per launch on the card ({b2b_ms:.4f} ms "
                  f"launched back to back from Python) vs plain {plain_ms:.1f} ms, bound {b_ms:.4f} ms "
                  f"({b_by}) {tag}")
        out[key] = (err, ms, plain_ms, b2b_ms)
        del core, ring, r_frame
    return out


def arena_request_path_phase(torch, np, dev, tag, tick_errs, tick_timed):
    """Arena's request path through the session, eager and lazy, at 4096
    and 65536 entities, and ar4_l16's 16-row lazy buffers. Returns (per-run
    summaries, K3 entries for the kernels line)."""
    from ggrs_tpu_torch import Arena

    runs, entries = [], []
    for key, players, n, lazy, ticks, reps in ARENA_REQUEST_RUNS:
        mp = 9
        script = np.random.default_rng(n + lazy + 2).integers(0, 64, size=(ticks, players))
        run, entry = request_path_run(torch, np, dev, tag, key, lambda: Arena(players, n), players, n, mp,
                                      lazy, script, reps, tick_errs[key])
        if key in tick_timed:  # the bench's own buffer, timed in phase 10
            ms, _, b_ms, _ = tick_timed[key]
            run["bench_buffer_ms"], run["bench_buffer_ms_per_rollback_tick"] = ms, ms / ARENA_ROLLBACK_ROWS
        runs.append(run)
        entries.append(entry)
    return runs, entries


def swarm_synctest_phase(torch, np, dev, tag):
    """K1's and K2's swarm bodies against their plain versions, full carry
    after every batch (K2's parts too), a position probe per shape (px of
    the slot the next rollback loads), and each kernel's time. Returns
    (scripts, plain final carries, entries keyed by (name, key))."""
    from ggrs_tpu_torch import Swarm
    from ggrs_tpu_torch.convert import CARRY_KEYS, copy_carry
    from ggrs_tpu_torch.device import sync_test
    from ggrs_tpu_torch.device.fused_core import FusedSyncTestCore, plain_batch
    from ggrs_tpu_torch.device.planes import PlaneContext
    from ggrs_tpu_torch.device.tiled_core import TiledSyncTestCore, plain_parts, plain_verdict

    rng = np.random.default_rng(891)
    scripts = {key: [rng.integers(0, SWARM_MOD, size=(t, PLAYERS, 1), dtype=np.uint8) for _ in range(b)]
               for key, _, _, _, t, b in SWARM_SHAPES}
    plain_final, entries = {}, {}
    for key, backend, n, d, t_ticks, batches in SWARM_SHAPES:
        ctx = PlaneContext(Swarm(PLAYERS, n), PLAYERS, d, dev)
        tiled = backend == "cuda-tiled"
        core = TiledSyncTestCore(ctx) if tiled else FusedSyncTestCore(ctx)
        name = f"{core.kernel}_swarm"
        kc = sync_test.initial_carry(ctx)
        pc = copy_carry(kc)
        err = 0
        for raw in scripts[key]:
            inputs = torch.from_numpy(raw.astype(np.int32)).to(dev)
            if tiled:  # the parts too, before the verdict folds them
                k_hi, k_lo = core.run_kernel(kc, inputs)
                p_hi, p_lo = plain_parts(pc, inputs, ctx)
                err = max(err, carry_err(torch, {"h": k_hi, "l": k_lo}, {"h": p_hi, "l": p_lo}, "hl"))
                core.verdict(kc, k_hi, k_lo)
                plain_verdict(pc, p_hi, p_lo, ctx)
            else:
                core.batch(kc, inputs)
                plain_batch(pc, inputs, ctx)
            torch.cuda.synchronize()
            err = max(err, carry_err(torch, kc, pc, CARRY_KEYS))
            if err:
                fail(f"{key}: {name} and its plain version differ (max abs err {err})")
        if int(pc["state"][6].min()) >= 192:
            fail(f"{key}: no battery drained, so BOOST was never exercised")
        print(f"{key}: {name} == plain after each of {batches} batch(es) ({n} entities, d={d}, T={t_ticks}, "
              f"inputs below {SWARM_MOD}) {tag}")
        plain_final[key] = copy_carry(pc)

        c = int(kc["meta"][0])
        probe = [copy_carry(kc), copy_carry(pc)]
        for carry in probe:
            carry["ring"][(c - d) % ctx.ring_len, 0, 0] += 7  # px of entity 0
        inputs = torch.from_numpy(scripts[key][0].astype(np.int32)).to(dev)
        core.batch(probe[0], inputs)
        plain_batch(probe[1], inputs, ctx)
        torch.cuda.synchronize()
        latched = [carry["meta"].tolist() for carry in probe]
        if latched[0] != latched[1] or latched[0][1] != 1 or latched[0][2] != c - d + 1:
            fail(f"{key}: position probe latched {latched}, expected frame {c - d + 1} on both")
        if carry_err(torch, probe[0], probe[1], CARRY_KEYS):
            fail(f"{key}: {name} and its plain version differ after the position probe")
        print(f"{key}: position probe: both latched mismatch at frame {c - d + 1}")
        del probe

        timed, ptimed = copy_carry(kc), copy_carry(pc)
        b_ms, b_by = bound(n, d, t_ticks, int(timed["meta"][0]), ctx.ring_len, "_swarm")
        reps = SWARM_TIMED[key]
        if tiled:
            parts, pparts = [], []
            ms = events_ms(torch, lambda: parts.append(core.run_kernel(timed, inputs)), reps)
            v_ms = queued_ms(torch, lambda: core.verdict(timed, *parts[-1]), TIMED_LAUNCHES)
            plain_ms = events_ms(torch, lambda: pparts.append(plain_parts(ptimed, inputs, ctx)), 1)
            v_plain_ms = events_ms(torch, lambda: plain_verdict(ptimed, *pparts[-1], ctx), 1)
            v_b, v_by = verdict_bound(t_ticks, d, ctx.hist_len)
            entries[("synctest_verdict", key)] = {
                "name": "synctest_verdict", "route": "cuda", "source": "ggrs_tpu_torch/csrc/synctest_tiled.cu",
                "replaces": "ggrs_tpu/tpu/pallas_tiled.py:468",
                "tpu_counterpart": "PallasTiledSyncTestCore._verdict (jnp post-pass of K2), swarm's batches",
                "shape": f"T={t_ticks}, d={d} events", "max_abs_err": err, "bit_equal": err == 0,
                "ms": v_ms, "plain_ms": v_plain_ms, "bound_ms": v_b, "bound_by": v_by, "library_ms": None,
                "launches": 0,
            }
        else:
            tail_ms = tail_verdict_ms(torch, ctx, timed, inputs)
            ms = events_ms(torch, lambda: core.batch(timed, inputs), reps)
            plain_ms = events_ms(torch, lambda: plain_batch(ptimed, inputs, ctx), 1)
        tail = "" if tiled else f"; its tail's verdict alone on this batch's parts {tail_ms:.4f} ms"
        print(f"{key}: {name} {ms:.4f} ms/batch vs plain {plain_ms:.1f} ms, bound {b_ms:.4f} ms ({b_by}){tail} {tag}")
        entries[(name, key)] = {
            "name": name, "route": "cuda", "source": f"ggrs_tpu_torch/csrc/{core.kernel}.cu",
            "replaces": "ggrs_tpu/tpu/pallas_tiled.py:428" if tiled else "ggrs_tpu/tpu/pallas_core.py:979",
            "tpu_counterpart": ("PallasTiledSyncTestCore._build" if tiled else "PallasSyncTestCore._build")
                               + " with SwarmPlanes",
            "shape": f"Swarm({PLAYERS}, {n}), d={d}, T={t_ticks}", "max_abs_err": err, "bit_equal": err == 0,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "launches": 0,
        }
        if not tiled:
            entries[(name, key)]["tail_verdict_ms"] = tail_ms
        del timed, ptimed, kc, pc
    return scripts, plain_final, entries


def swarm_main_path_phase(torch, np, dev, tag, scripts, plain_final, entries):
    """Swarm's fused path through the session: auto -> K1 at 4096 and K2 +
    the verdict at 1M; launch counts set to 0 before and above 0 after,
    the final carry equal to the plain version's, `check()` passing."""
    from ggrs_tpu_torch import DeviceSyncTestSession, Swarm
    from ggrs_tpu_torch.convert import CARRY_KEYS

    runs = []
    for key, backend, n, d, t_ticks, batches in SWARM_SHAPES:
        sess = DeviceSyncTestSession(Swarm(PLAYERS, n), PLAYERS, d, backend="auto", device=dev)
        if sess.backend != backend:
            fail(f"{key}: auto chose {sess.backend} for swarm, expected {backend}")
        core = sess.core
        core.launches = 0
        if backend == "cuda-tiled":
            core.verdict_launches = 0
        for raw in scripts[key]:
            sess.advance_frames(raw)
        sess.block_until_ready()
        counts = {f"{core.kernel}_swarm": core.launches}
        if backend == "cuda-tiled":
            counts["synctest_verdict"] = core.verdict_launches
        if min(counts.values()) < 1:
            fail(f"{key}: the swarm main path launched no kernel of one kind: {counts}")
        if carry_err(torch, sess.carry, plain_final[key], CARRY_KEYS):
            fail(f"{key}: the swarm main path's carry differs from the plain version's")
        sess.check()
        state = sess.state_numpy()
        if state["pos"].shape != (n, 3) or state["charge"].shape != (n,) or int(state["frame"]) != t_ticks * batches:
            fail(f"{key}: swarm state has the wrong shape or frame")
        reps = SWARM_MAIN_BATCHES[key]
        samples = sorted(events_ms(torch, lambda: sess.advance_frames(scripts[key][-1]), 1) for _ in range(reps))
        sess.check()
        ms, p90 = samples[reps // 2], samples[(reps * 9) // 10]
        rate = t_ticks * d / (ms / 1e3)
        for (name, k), e in entries.items():
            if k == key:
                e["launches"] = counts[name]
        print(f"swarm main path {key}: auto -> {sess.backend}, launches {counts} over {batches} batches, then "
              f"median {ms:.4f} ms/batch (p90 {p90:.4f}, n={reps}), {rate:.1f} rollback-frames/s {tag}")
        runs.append({"key": key, "backend": sess.backend, "ms_per_batch_p50": ms, "ms_per_batch_p90": p90,
                     "samples": reps, "rollback_frames_per_s_p50": rate, "launches": counts})
        del sess
    return runs


def swarm_request_path_phase(torch, np, dev, tag, tick_errs):
    """Swarm's request path through the session, eager and lazy, at 4096
    entities. Returns (per-run summaries, K3 entries for the kernels line)."""
    from ggrs_tpu_torch import Swarm

    runs, entries = [], []
    for key, players, n, lazy, ticks, reps in SWARM_REQUEST_RUNS:
        script = np.random.default_rng(n + lazy + 3).integers(0, SWARM_MOD, size=(ticks, players))
        run, entry = request_path_run(torch, np, dev, tag, key, lambda: Swarm(players, n), players, n, 9, lazy,
                                      script, reps, tick_errs[key])
        runs.append(run)
        entries.append(entry)
    return runs, entries


def arena_teams_phase(torch, np, dev, tag):
    """Arena past 16 teams on the card: K1 with the cache (and its time) and
    inline, the injection route (K5 + K2's one-launch tick) and K5 alone, K3
    rows and K4 speculations, each against its plain version, with kill
    probes on K1 and the injection route; then the main path (auto -> K1)
    with its launch count. Returns K1's entries for the kernels line."""
    from ggrs_tpu_torch import Arena, DeviceSyncTestSession, ResimCore
    from ggrs_tpu_torch.convert import CARRY_KEYS, copy_carry
    from ggrs_tpu_torch.device import sync_test
    from ggrs_tpu_torch.device.beam_core import plain_rollout
    from ggrs_tpu_torch.device.fused_core import FusedSyncTestCore, plain_batch
    from ggrs_tpu_torch.device.injected_core import InjectedReduceCore
    from ggrs_tpu_torch.device.planes import PlaneContext
    from ggrs_tpu_torch.device.reduce_core import STATE, plain_reduce_table, source_slots
    from ggrs_tpu_torch.device.resim import RESIM_KEYS
    from ggrs_tpu_torch.device.rowgen import prime_row, random_tick_rows
    from ggrs_tpu_torch.device.tick_core import plain_tick_multi

    entries = []
    d, t_ticks = CHECK_DISTANCE, 20
    for key, players, n in ARENA_TEAM_SHAPES:
        ctx = PlaneContext(Arena(players, n), players, d, dev)
        rng = np.random.default_rng(players)
        batches = [rng.integers(0, 64, size=(t_ticks, players, 1), dtype=np.uint8)
                   for _ in range(ARENA_TEAM_BATCHES)]

        def same(a, b, keys, what):
            torch.cuda.synchronize()
            err = carry_err(torch, a, b, keys)
            if err:
                fail(f"{key}: {what} and its plain version differ (max abs err {err})")

        def latch(carries, run):
            c = int(carries[0]["meta"][0])
            for carry in carries:
                kill(carry, d, ctx.ring_len)
            run()
            latched = [carry["meta"].tolist() for carry in carries]
            if latched[0] != latched[1] or latched[0][1:] != [1, c - d + 1]:
                fail(f"{key}: kill probe latched {latched}, expected frame {c - d + 1} on both")

        # K1 with the reduction cache, its kill probe and its time
        k1 = FusedSyncTestCore(ctx)
        kc = sync_test.initial_carry(ctx)
        pc = copy_carry(kc)
        for raw in batches:
            inputs = torch.from_numpy(raw.astype(np.int32)).to(dev)
            k1.batch(kc, inputs)
            plain_batch(pc, inputs, ctx)
            same(kc, pc, CARRY_KEYS, "synctest_fused_arena (cached)")
        final = copy_carry(pc)
        timed, ptimed = copy_carry(kc), copy_carry(pc)
        b_ms, b_by = arena_bound(n, players, d, t_ticks, int(timed["meta"][0]))
        ms = events_ms(torch, lambda: k1.batch(timed, inputs), 10)
        plain_ms = events_ms(torch, lambda: plain_batch(ptimed, inputs, ctx), 1)
        probe = [copy_carry(kc), copy_carry(pc)]
        latch(probe, lambda: (k1.batch(probe[0], inputs), plain_batch(probe[1], inputs, ctx)))
        same(*probe, CARRY_KEYS, "synctest_fused_arena after the kill probe")

        # K1 inline: single ticks across frame d, then the kill probe
        kc = sync_test.initial_carry(ctx)
        pc = copy_carry(kc)
        for t in range(d + 4):
            one = torch.from_numpy(batches[0][t:t + 1].astype(np.int32)).to(dev)
            k1.batch(kc, one)
            plain_batch(pc, one, ctx)
            same(kc, pc, CARRY_KEYS, "synctest_fused_arena (inline)")
        latch([kc, pc], lambda: (k1.batch(kc, one), plain_batch(pc, one, ctx)))

        # the injection route across frame d, K5 alone, then the kill probe
        route, twin = InjectedReduceCore(ctx), plain_injected(ctx)
        kc = sync_test.initial_carry(ctx)
        pc = copy_carry(kc)
        for start in range(0, t_ticks, 10):
            ten = torch.from_numpy(batches[1][start:start + 10].astype(np.int32)).to(dev)
            route.batch(kc, ten, frame=start)
            twin.batch(pc, ten, frame=start)
            same(kc, pc, CARRY_KEYS, "the injection route")
        dead = copy_carry(kc)
        dead["ring"][:, 4, 3::5] = 0
        for slots in (source_slots(t_ticks, d, ctx.ring_len), (STATE,)):
            got = route.reduce.gather(dead["ring"], dead["state"], slots)
            want = plain_reduce_table(torch.stack([dead["state"] if s == STATE else dead["ring"][s]
                                                   for s in slots]), ctx)
            same({"t": got}, {"t": want}, "t", f"reduce_table over {len(slots)} sources")
        latch([kc, pc], lambda: (route.batch(kc, ten, frame=t_ticks), twin.batch(pc, ten, frame=t_ticks)))
        same(kc, pc, CARRY_KEYS, "the injection route after the kill probe")

        # K3 rows, then K4 speculations out of the ring they filled
        core = ResimCore(Arena(players, n), 9, players, device_verify=True, device=dev)
        plain = {k: v.clone() for k, v in core.carry.items()}
        rows = np.concatenate([prime_row(core)[None],
                               random_tick_rows(core, 9 + 2 + 8, seed=players, mod=64)])
        for b in range(0, len(rows), ARENA_TICK_ROWS):
            batch = rows[b:b + ARENA_TICK_ROWS]
            his, los = core.tick_multi(batch)
            p_his, p_los = plain_tick_multi(plain, core.upload(batch), core)
            same({"h": his, "l": los}, {"h": p_his, "l": p_los}, "hl", "resim_tick_arena's checksums")
            same(core.carry, plain, RESIM_KEYS, "resim_tick_arena")
        spec_rng = np.random.default_rng(players + 1)
        for slot in (1, 4):
            inputs = spec_rng.integers(0, 64, size=(16, 11, players, 1), dtype=np.uint8)
            statuses = np.where(spec_rng.random((16, 11, players)) < 0.2, 2, 0).astype(np.int32)
            spec = core.speculate(slot, inputs, statuses)
            want = plain_rollout(core.carry["ring"][slot], core.carry["r_frame"][slot],
                                 torch.from_numpy(inputs).to(dev), torch.from_numpy(statuses).to(dev), core.ctx)
            torch.cuda.synchronize()
            if spec_err(torch, spec, want):
                fail(f"{key}: beam_rollout_arena and plain_rollout differ from slot {slot}")
        del core, plain

        # the main path: auto -> K1 with the cache
        sess = DeviceSyncTestSession(Arena(players, n), players, d, backend="auto", device=dev)
        if sess.backend != "cuda-fused":
            fail(f"{key}: auto chose {sess.backend}, expected cuda-fused")
        sess.core.launches = 0
        for raw in batches:
            sess.advance_frames(raw)
        sess.block_until_ready()
        launches = sess.core.launches
        if launches < 1 or carry_err(torch, sess.carry, final, CARRY_KEYS):
            fail(f"{key}: the main path launched {launches} K1 kernels or ended apart from the plain version")
        sess.check()
        print(f"{key}: Arena({players}, {n}) past 16 teams: synctest_fused_arena (cached, inline), the injection "
              f"route (reduce_table + the one-launch synctest_tiled_arena tick), reduce_table, resim_tick_arena and "
              f"beam_rollout_arena == plain, kill probes latched on both; main path auto -> K1, {launches} "
              f"launches, carry == plain; K1 {ms:.4f} ms/batch (T={t_ticks}) vs plain {plain_ms:.1f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}) {tag}")
        entries.append({
            "name": "synctest_fused_arena", "route": "cuda", "source": "ggrs_tpu_torch/csrc/synctest_fused.cu",
            "replaces": "ggrs_tpu/tpu/pallas_core.py:979",
            "tpu_counterpart": "PallasSyncTestCore._build with ArenaPlanes (reduction cache), past 16 teams",
            "shape": f"Arena({players}, {n}), d={d}, T={t_ticks}", "max_abs_err": 0, "bit_equal": True,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "launches": launches,
        })
        del sess, kc, pc, timed, ptimed, dead
    return entries


def arena_inline_phase(torch, np, dev, tag, arena_path):
    """K2's inline whole-world arena route: the kernel against plain_parts
    and plain_verdict (parts and full carry after every batch), a kill
    probe, the kernel's time, then the main path through the session
    (explicit "cuda-tiled" at 4096, "auto" past the reference's estimate)
    with its launch counts, carry == plain and check(); at 4096 its ms a
    tick beside the injection route's from `arena_path` (this run).
    Returns (runs, entries for the kernels line)."""
    from ggrs_tpu_torch import Arena, DeviceSyncTestSession
    from ggrs_tpu_torch.convert import CARRY_KEYS, copy_carry
    from ggrs_tpu_torch.device import sync_test
    from ggrs_tpu_torch.device.planes import PlaneContext
    from ggrs_tpu_torch.device.tiled_core import TiledSyncTestCore, plain_parts, plain_verdict

    runs, entries = [], []
    for key, players, n, d, t_ticks, batches, backend, reps, regime in ARENA_INLINE_SHAPES:
        ctx = PlaneContext(Arena(players, n), players, d, dev)
        core = TiledSyncTestCore(ctx)
        rng = np.random.default_rng(n + players)
        scripts = [rng.integers(0, 64, size=(t_ticks, players, 1), dtype=np.uint8) for _ in range(batches)]
        kc = sync_test.initial_carry(ctx)
        pc = copy_carry(kc)
        err = 0

        def both(raw):
            inputs = torch.from_numpy(raw.astype(np.int32)).to(dev)
            k_hi, k_lo = core.run_kernel(kc, inputs)
            p_hi, p_lo = plain_parts(pc, inputs, ctx)
            e = carry_err(torch, {"h": k_hi, "l": k_lo}, {"h": p_hi, "l": p_lo}, "hl")
            core.verdict(kc, k_hi, k_lo)
            plain_verdict(pc, p_hi, p_lo, ctx)
            torch.cuda.synchronize()
            return max(e, carry_err(torch, kc, pc, CARRY_KEYS))

        t0 = time.perf_counter()
        for raw in scripts:
            err = max(err, both(raw))
            if err:
                fail(f"{key}: synctest_tiled_arena_inline and its plain version differ (max abs err {err})")
        plan = core.plan
        if plan.regime != regime:
            fail(f"{key}: the inline route took the {plan.regime} regime, expected {regime}")
        print(f"{key}: synctest_tiled_arena_inline == plain (parts and full carry) after each of {batches} "
              f"batch(es) ({players} players, {n} entities, d={d}, T={t_ticks}, plain version at T={t_ticks}, "
              f"{time.perf_counter() - t0:.1f} s); regime {plan.regime}: {plan.blocks} blocks of {plan.per_block} "
              f"entities, {plan.smem_bytes} B of shared memory a block {tag}")
        final = copy_carry(pc)

        c = int(kc["meta"][0])
        timed_k, timed_p = copy_carry(kc), copy_carry(pc)
        for carry in (kc, pc):
            kill(carry, d, ctx.ring_len)
        if both(scripts[0]):
            fail(f"{key}: the inline route and its plain version differ after the kill probe")
        latched = [kc["meta"].tolist(), pc["meta"].tolist()]
        if latched[0] != latched[1] or latched[0][1:] != [1, c - d + 1]:
            fail(f"{key}: kill probe latched {latched}, expected frame {c - d + 1} on both")
        print(f"{key}: kill probe (hp = 0 for {KILLED} entities): both latched frame {c - d + 1}, same world after")

        inputs = torch.from_numpy(scripts[-1].astype(np.int32)).to(dev)
        c0 = int(timed_k["meta"][0])
        b_ms, b_by = inline_bound(n, players, d, t_ticks, c0)
        ms = events_ms(torch, lambda: core.run_kernel(timed_k, inputs), reps)
        plain_ms = events_ms(torch, lambda: plain_parts(timed_p, inputs, ctx), 1)
        parts = core.run_kernel(timed_k, inputs)
        v_ms = queued_ms(torch, lambda: core.verdict(timed_k, *parts), TIMED_LAUNCHES)
        v_plain_ms = events_ms(torch, lambda: plain_verdict(timed_p, *parts, ctx), 1)
        v_b, v_by = verdict_bound(t_ticks, d, ctx.hist_len)
        barriers = t_ticks * (d + 1)
        print(f"{key}: synctest_tiled_arena_inline ({plan.regime}) {ms:.4f} ms/batch ({barriers} barriers, "
              f"{ms / barriers * 1e3:.2f} us a step) vs plain {plain_ms:.1f} ms, bound {b_ms:.4f} ms ({b_by}) {tag}")
        entry = {
            "name": "synctest_tiled_arena_inline", "route": "cuda",
            "source": "ggrs_tpu_torch/csrc/synctest_tiled.cu",
            "replaces": "ggrs_tpu/tpu/pallas_tiled.py:428",
            "tpu_counterpart": "PallasTiledSyncTestCore._build, whole-world tile reducing inline (:94-130)",
            "shape": f"Arena({players}, {n}), d={d}, T={t_ticks}", "regime": plan.regime,
            "max_abs_err": err, "bit_equal": err == 0,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "launches": 0,
        }
        v_entry = {
            "name": "synctest_verdict", "route": "cuda", "source": "ggrs_tpu_torch/csrc/synctest_tiled.cu",
            "replaces": "ggrs_tpu/tpu/pallas_tiled.py:468",
            "tpu_counterpart": "PallasTiledSyncTestCore._verdict, after the inline route's batches",
            "shape": f"T={t_ticks}, d={d} events", "max_abs_err": err, "bit_equal": err == 0,
            "ms": v_ms, "plain_ms": v_plain_ms, "bound_ms": v_b, "bound_by": v_by, "library_ms": None,
            "launches": 0,
        }
        print(f"{key}: synctest_verdict after the inline route {v_ms:.4f} ms (queued) vs plain {v_plain_ms:.2f} ms, "
              f"bound {v_b:.7f} ms ({v_by}) {tag}")
        del kc, pc, timed_k, timed_p, parts

        sess = DeviceSyncTestSession(Arena(players, n), players, d, backend=backend, device=dev)
        if sess.backend != "cuda-tiled" or type(sess.core) is not TiledSyncTestCore:
            fail(f"{key}: backend={backend!r} chose {sess.backend} for arena, expected cuda-tiled (inline)")
        sess.core.launches = sess.core.verdict_launches = 0
        for raw in scripts:
            sess.advance_frames(raw)
        sess.block_until_ready()
        counts = {"synctest_tiled_arena_inline": sess.core.launches, "synctest_verdict": sess.core.verdict_launches}
        if min(counts.values()) < 1:
            fail(f"{key}: the inline route launched no kernel of one kind: {counts}")
        if carry_err(torch, sess.carry, final, CARRY_KEYS):
            fail(f"{key}: the inline route's carry differs from the plain version's")
        sess.check()
        state = sess.state_numpy()
        if state["hp"].shape != (n,) or int(state["frame"]) != t_ticks * batches:
            fail(f"{key}: arena state has the wrong shape or frame")
        main_reps = ARENA_INLINE_MAIN_BATCHES[key]
        samples = sorted(events_ms(torch, lambda: sess.advance_frames(scripts[-1]), 1) for _ in range(main_reps))
        sess.check()
        p50, p90 = samples[main_reps // 2], samples[(main_reps * 9) // 10]
        entry["launches"] = counts["synctest_tiled_arena_inline"]
        v_entry["launches"] = counts["synctest_verdict"]
        entries += [entry, v_entry]
        if sess.core.plan.regime != regime:
            fail(f"{key}: the session's inline route took the {sess.core.plan.regime} regime, expected {regime}")
        run = {"key": key, "backend": f"{backend} -> {sess.backend}", "regime": regime, "ms_per_batch_p50": p50,
               "ms_per_batch_p90": p90, "ms_per_tick_p50": p50 / t_ticks, "samples": main_reps,
               "rollback_frames_per_s_p50": t_ticks * d / (p50 / 1e3), "launches": counts}
        injected = [r for r in arena_path if r["key"] == key.replace("ati_", "ai_")]
        beside = ""
        if injected:
            run["injected_ms_per_tick_p50"] = injected[0]["ms_per_tick_p50"]
            beside = f", the injection route {injected[0]['ms_per_tick_p50']:.4f} ms/tick in this run"
        print(f"arena main path {key}: backend={backend} -> {sess.backend} (inline, {regime}), launches {counts}, carry == "
              f"plain; then median {p50:.4f} ms/batch (p90 {p90:.4f}, n={main_reps}), {p50 / t_ticks:.4f} ms/tick"
              f"{beside} {tag}")
        runs.append(run)
        del sess
    return runs, entries


def inline_layout_phase(torch, np, dev, tag):
    """What keeping the states on chip buys the inline route: kernel-only
    ms a batch (d=8, T=60) of each world of LAYOUT_WORLDS with the states
    in shared memory and in global memory (no plain version; both layouts
    must end a batch with the same carry). Returns {world: {regime: ms}}."""
    from ggrs_tpu_torch import Arena
    from ggrs_tpu_torch.convert import CARRY_KEYS
    from ggrs_tpu_torch.device import sync_test
    from ggrs_tpu_torch.device.planes import PlaneContext
    from ggrs_tpu_torch.device.tiled_core import TiledSyncTestCore, grid_plan
    from ggrs_tpu_torch.kernels import build

    lib = build.load("synctest_tiled")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    times = {}
    for players, n in LAYOUT_WORLDS:
        rng = np.random.default_rng(n)
        inputs = torch.from_numpy(rng.integers(0, 64, size=(60, players, 1)).astype(np.int32)).to(dev)
        world, carries = f"Arena({players}, {n})", []
        times[world] = {}
        for on_chip in (True, False):
            plan = grid_plan(n, players, sms, on_chip)
            ctx = PlaneContext(Arena(players, n), players, 8, dev)
            core = TiledSyncTestCore(ctx)
            core._prepare_inline(lib, dev, plan)
            carry = sync_test.initial_carry(ctx)
            for _ in range(LAYOUT_WARM):
                core.batch(carry, inputs)
            carries.append(carry)
            times[world][plan.regime] = events_ms(torch, lambda: core.run_kernel(carry, inputs), LAYOUT_TIMED)
        torch.cuda.synchronize()
        if carry_err(torch, carries[0], carries[1], CARRY_KEYS):
            fail(f"inline layouts of {world}: the states on chip and in global memory end with different carries")
        print(f"inline layouts {world}, d=8, T=60: states on chip {times[world]['grid-shared']:.4f} ms/batch, in "
              f"global memory {times[world]['grid-global']:.4f} ms/batch {tag}")
    return times


def checkpoint_phase(torch, np, dev, tag):
    """Checkpoints on the card, for ex_game, arena and swarm at 4096
    entities: a fused session saved mid-run on K1, on K2 (inline for arena)
    and on the injection route, restored under the same backend and under
    another, run on, and held against the run that never stopped (full
    carry); then a request-path backend on K3 (device verification,
    lazy_ticks=8) saved mid-run, restored and driven on by the same host
    session, held against its uninterrupted twin (core carry, check()).
    Prints each file's size and the save and restore ms (host clock around
    work that ends on the host)."""
    import os
    import tempfile

    from ggrs_tpu_torch import Arena, DeviceRollbackBackend, DeviceSyncTestSession, ExGame, SessionBuilder, Swarm
    from ggrs_tpu_torch.convert import CARRY_KEYS

    families = [("ex_game", ExGame, 16), ("arena", Arena, 64), ("swarm", Swarm, SWARM_MOD)]
    results = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ck") as folder:
        for family, game_cls, mod in families:
            rng = np.random.default_rng(len(family))
            batches = [rng.integers(0, mod, size=(CHECKPOINT_T, PLAYERS, 1), dtype=np.uint8)
                       for _ in range(CHECKPOINT_BEFORE + CHECKPOINT_AFTER)]
            routes = ["cuda-fused", "cuda-tiled"] + (["cuda-tiled-injected"] if family == "arena" else [])
            for route in routes:
                straight = DeviceSyncTestSession(game_cls(PLAYERS, CHECKPOINT_N), PLAYERS, CHECKPOINT_DISTANCE,
                                                 backend=route, device=dev)
                for raw in batches:
                    straight.advance_frames(raw)
                first = DeviceSyncTestSession(game_cls(PLAYERS, CHECKPOINT_N), PLAYERS, CHECKPOINT_DISTANCE,
                                              backend=route, device=dev)
                for raw in batches[:CHECKPOINT_BEFORE]:
                    first.advance_frames(raw)
                path = os.path.join(folder, f"{family}_{route}.npz")
                t0 = time.perf_counter()
                first.save(path)
                save_ms = (time.perf_counter() - t0) * 1e3
                other = "cuda-fused" if route != "cuda-fused" else "cuda-tiled"
                for again in (route, other):
                    t0 = time.perf_counter()
                    back = DeviceSyncTestSession.restore(path, game_cls(PLAYERS, CHECKPOINT_N), backend=again,
                                                         device=dev)
                    back.block_until_ready()
                    restore_ms = (time.perf_counter() - t0) * 1e3
                    if back.backend != again or back.current_frame != CHECKPOINT_T * CHECKPOINT_BEFORE:
                        fail(f"checkpoint {family}: restored {back.backend} at {back.current_frame}")
                    for raw in batches[CHECKPOINT_BEFORE:]:
                        back.advance_frames(raw)
                    torch.cuda.synchronize()
                    if carry_err(torch, back.carry, straight.carry, CARRY_KEYS):
                        fail(f"checkpoint {family}: saved on {route}, resumed on {again}: carry differs from "
                             "the uninterrupted run's")
                    back.check()
                    results.append({"family": family, "saved_on": route, "resumed_on": again,
                                    "bytes": os.path.getsize(path), "save_ms": save_ms, "restore_ms": restore_ms})
                    print(f"checkpoint {family}: saved on {route}, resumed on {again}: carry == uninterrupted run; "
                          f"{os.path.getsize(path)} B, save {save_ms:.1f} ms, restore {restore_ms:.1f} ms {tag}")
                del straight, first, back

            inputs = rng.integers(0, mod, size=(CHECKPOINT_FRAMES, PLAYERS), dtype=np.uint8)

            def stack():
                backend = DeviceRollbackBackend(game_cls(PLAYERS, CHECKPOINT_N), 9, PLAYERS, device_verify=True,
                                                lazy_ticks=LAZY_TICKS, device=dev)
                sess = (SessionBuilder(input_size=1).with_num_players(PLAYERS).with_max_prediction_window(9)
                        .with_check_distance(CHECK_DISTANCE).with_device_checksum_verification()
                        .start_synctest_session())
                return backend, sess

            def drive(backend, sess, lo, hi):
                for f in range(lo, hi):
                    add_inputs(sess, inputs[f])
                    backend.handle_requests(sess.advance_frame())

            straight, s_sess = stack()
            drive(straight, s_sess, 0, CHECKPOINT_FRAMES)
            first, sess = stack()
            first.core.tick_core.launches = 0
            drive(first, sess, 0, CHECKPOINT_SAVE_AT)
            path = os.path.join(folder, f"{family}_backend.npz")
            t0 = time.perf_counter()
            first.save(path)
            save_ms = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            back = DeviceRollbackBackend.restore(path, game_cls(PLAYERS, CHECKPOINT_N), device=dev)
            back.block_until_ready()
            restore_ms = (time.perf_counter() - t0) * 1e3
            back.core.tick_core.launches = 0
            drive(back, sess, CHECKPOINT_SAVE_AT, CHECKPOINT_FRAMES)
            back.flush()
            straight.flush()
            torch.cuda.synchronize()
            if back.core.tick_core.launches < 1 or first.core.tick_core.launches < 1:
                fail(f"checkpoint {family}: the request path launched no K3 kernel around the checkpoint")
            if not back.core.device_verify or back.lazy_ticks != LAZY_TICKS:
                fail(f"checkpoint {family}: the restored backend lost its knobs")
            if carry_err(torch, back.core.carry, straight.core.carry, list(straight.core.carry)):
                fail(f"checkpoint {family}: the resumed backend's core differs from the uninterrupted one's")
            back.check()
            results.append({"family": family, "saved_on": "resim_tick", "resumed_on": "resim_tick",
                            "bytes": os.path.getsize(path), "save_ms": save_ms, "restore_ms": restore_ms})
            print(f"checkpoint {family}: DeviceRollbackBackend (K3, device_verify, lazy_ticks={LAZY_TICKS}) saved at "
                  f"frame {CHECKPOINT_SAVE_AT}, resumed: core == uninterrupted run; {os.path.getsize(path)} B, "
                  f"save {save_ms:.1f} ms, restore {restore_ms:.1f} ms {tag}")
            del straight, first, back
    return results


# -- the P2P phase: BASELINE.json configs[3] (a 4-player P2PSession, a
# 12-frame rollback window) at the flagship world, every peer on its own
# backend on the card, over one in-memory network on a fake clock
P2P_KEY = "p2p4_4096"
P2P_PLAYERS, P2P_N, P2P_MP = 4, 4096, 12
P2P_TICKS, P2P_LEAVE = 300, (200, 3)  # peer 3 leaves at tick 200
P2P_NET = dict(latency_ms=40, jitter_ms=15, loss=0.05, seed=33)
P2P_TICK_MS = 16  # the fake clock's advance a tick
P2P_DESYNC_INTERVAL = 10
P2P_DRAIN_TICKS = 40  # ticks of polling after the match, the spectator still advancing
P2P_BEAM = 16
P2P_PROBE_TICKS, P2P_PROBE_AT = 100, 60  # the corruption probe's match
P2P_TIMED_DISPATCHES = 200
P2P_RANGE = "p2p_ticks"  # the profiler range around a match's tick loop
P2P_PROFILE_TOP = 14  # functions of peer 0's host tick printed by cumulative time


def p2p_match(np, players, n, mp, ticks, dev, *, lazy=0, leave=None, spectator=False, corrupt_at=None,
              seed=5, script=None, async_dispatch=False, publish="ready", net_seed=None, record_all=False,
              profile=None, mark=False):
    """One P2P match of `players` port sessions, peer i holding handle i,
    each on its own DeviceRollbackBackend on `dev`, desync detection on, on
    an InMemoryNetwork (P2P_NET) and a FakeClock advanced P2P_TICK_MS a
    tick; `script[t, i]` is peer i's input at tick t (seeded below 16 when
    not given). Every backend's K3 launch count is set to
    0 just before the first tick. `leave = (tick, handle)`: from that tick
    the peer stops advancing but keeps polling, and once every other peer
    holds its last frame they all call disconnect_player(handle), so each
    disconnects it at the same frame. `spectator`: a spectator of peer 0
    on a backend of its own advances every tick, and through
    P2P_DRAIN_TICKS ticks of polling after the match. `corrupt_at`: at that
    tick the ring slots of peer 1 that its next rollback may load (every
    frame after its confirmed one) are corrupted. Returns a namespace: the
    sessions and backends, peer 0's recorded stream (each tick's requests
    as (kind, frame, cell key) or ("AdvanceFrame", inputs)) and its saves'
    checksum getters, host ms a tick per peer, events, loads and rollback
    depths. `async_dispatch`: every peer's backend runs the async pipeline;
    `publish`: every session's `checksum_publish` ("interval" makes the
    wire bytes independent of when checksums become ready); `net_seed`:
    the network's seed in place of P2P_NET's; `record_all`: every peer's
    stream and save getters (`streams`, `saves`), not only peer 0's;
    `profile`: a cProfile.Profile enabled around peer 0's advance_frame and
    handle_requests; `mark`: the tick loop runs inside a torch.profiler
    range named P2P_RANGE."""
    import random
    from types import SimpleNamespace

    from ggrs_tpu_torch import (DesyncDetection, DeviceRollbackBackend, ExGame, PlayerType, PredictionThreshold,
                                SessionBuilder, SessionState)
    from ggrs_tpu_torch.network.sockets import InMemoryNetwork
    from ggrs_tpu_torch.utils.clock import FakeClock

    clock = FakeClock()
    net = InMemoryNetwork(clock, **dict(P2P_NET, **({} if net_seed is None else {"seed": net_seed})))
    addrs = [f"peer{i}" for i in range(players)]
    sessions, backends = [], []
    for i in range(players):
        b = (SessionBuilder(input_size=1).with_num_players(players).with_max_prediction_window(mp)
             .with_desync_detection_mode(DesyncDetection.on(P2P_DESYNC_INTERVAL)).with_clock(clock)
             .with_rng(random.Random(100 + i)))
        for h, addr in enumerate(addrs):
            b = b.add_player(PlayerType.local() if h == i else PlayerType.remote(addr), h)
        if spectator and i == 0:
            b = b.add_player(PlayerType.spectator("spectator"), players)
        sessions.append(b.start_p2p_session(net.socket(addrs[i])))
        sessions[-1].checksum_publish = publish
        backends.append(DeviceRollbackBackend(ExGame(players, n), mp, players, lazy_ticks=lazy,
                                              async_dispatch=async_dispatch, device=dev))
    spec = spec_backend = None
    if spectator:
        spec = (SessionBuilder(input_size=1).with_num_players(players).with_clock(clock)
                .with_rng(random.Random(99)).start_spectator_session(addrs[0], net.socket("spectator")))
        spec_backend = DeviceRollbackBackend(ExGame(players, n), mp, players, device=dev)
    everyone = sessions + ([spec] if spec else [])
    for _ in range(400):
        for s in everyone:
            s.poll_remote_clients()
            s.events()
        clock.advance(20)
        if all(s.current_state() == SessionState.RUNNING for s in everyone):
            break
    else:
        fail("p2p: the peers did not synchronize")

    if script is None:
        script = np.random.default_rng(seed).integers(0, 16, size=(ticks, players))
    out = SimpleNamespace(sessions=sessions, backends=backends, spectator=spec, spec_backend=spec_backend,
                          stream=[], saves0=[], adv_ms=[[] for _ in sessions], handle_ms=[[] for _ in sessions],
                          events=[[] for _ in sessions], loads=0, depths=[], thresholds=0,
                          disconnected_at=None, dead_inputs=0, spec_frames=0, wall_s=0.0,
                          streams=[[] for _ in sessions], saves=[[] for _ in sessions])

    def spectate():
        try:
            requests = spec.advance_frame()
        except PredictionThreshold:
            return
        spec_backend.handle_requests(requests)
        out.spec_frames += len(requests)

    for backend in backends + ([spec_backend] if spec else []):
        backend.core.tick_core.launches = 0
    gone = None
    span = None
    if mark:
        import torch

        span = torch.profiler.record_function(P2P_RANGE)
        span.__enter__()
    started = time.perf_counter()
    for t in range(ticks):
        if leave is not None and t == leave[0]:
            gone = leave[1]
        if gone is not None and out.disconnected_at is None:
            sessions[gone].poll_remote_clients()
            sessions[gone].events()
            last = sessions[gone].local_connect_status[gone].last_frame
            rest = [i for i in range(players) if i != gone]
            if all(sessions[i].local_connect_status[gone].last_frame == last for i in rest):
                for i in rest:
                    sessions[i].disconnect_player(gone)
                out.disconnected_at = t
        if t == corrupt_at:
            sess, core = sessions[1], backends[1].core
            backends[1].flush()
            for f in range(max(sess.confirmed_frame() + 1, sess.current_frame - mp), sess.current_frame):
                core.carry["ring"][f % core.ring_len, 4, 0] += 7  # the heading plane: never clamped
        for i, sess in enumerate(sessions):
            if i == gone:
                continue
            sess.add_local_input(i, bytes([int(script[t, i])]))
            before = sess.current_frame
            profiled = profile is not None and i == 0
            if profiled:
                profile.enable()
            t0 = time.perf_counter()
            try:
                requests = sess.advance_frame()
            except PredictionThreshold:
                out.thresholds += 1
                if profiled:
                    profile.disable()
                continue
            t1 = time.perf_counter()
            backends[i].handle_requests(requests)
            t2 = time.perf_counter()
            if profiled:
                profile.disable()
            out.adv_ms[i].append((t1 - t0) * 1e3)
            out.handle_ms[i].append((t2 - t1) * 1e3)
            out.events[i] += sess.events()
            for r in requests:
                kind = type(r).__name__
                if kind == "LoadGameState":
                    out.loads += 1
                    out.depths.append(before - r.frame)
                elif kind == "AdvanceFrame":
                    out.dead_inputs += sum(int(s) == 2 for _, s in r.inputs)
            if i == 0 or record_all:
                out.streams[i].append([("AdvanceFrame", list(r.inputs)) if type(r).__name__ == "AdvanceFrame"
                                       else (type(r).__name__, r.frame, id(r.cell)) for r in requests])
                out.saves[i] += [(r.frame, r.cell.checksum_getter()) for r in requests
                                 if type(r).__name__ == "SaveGameState"]
        if spec is not None:
            spectate()
        clock.advance(P2P_TICK_MS)
    out.wall_s = time.perf_counter() - started
    if span is not None:
        span.__exit__(None, None, None)
    out.stream, out.saves0 = out.streams[0], out.saves[0]
    if leave is not None and out.disconnected_at is None:
        fail("p2p: the leaving peer was never disconnected")
    for _ in range(P2P_DRAIN_TICKS if spec is not None else 0):
        for i, sess in enumerate(sessions):
            if i != gone:
                sess.poll_remote_clients()
                out.events[i] += sess.events()
        spec.poll_remote_clients()
        spectate()
        clock.advance(P2P_TICK_MS)
    return out


def stream_requests(tick, cells):
    """One recorded tick of a P2P stream as request objects, on the cells
    of `cells` (cell key -> GameStateCell, filled as keys appear)."""
    from ggrs_tpu_torch import AdvanceFrame, GameStateCell, LoadGameState, SaveGameState

    requests = []
    for kind, *rest in tick:
        if kind == "AdvanceFrame":
            requests.append(AdvanceFrame(inputs=rest[0]))
        else:
            frame, key = rest
            cls = SaveGameState if kind == "SaveGameState" else LoadGameState
            requests.append(cls(cell=cells.setdefault(key, GameStateCell()), frame=frame))
    return requests


def p2p_replay(stream, backend):
    """Fulfil a recorded stream tick by tick with `backend`, on cells of its
    own; returns (every save's (frame, checksum getter), host ms a tick)."""
    from ggrs_tpu_torch import SaveGameState

    cells, saves, host_ms = {}, [], []
    for tick in stream:
        requests = stream_requests(tick, cells)
        t0 = time.perf_counter()
        backend.handle_requests(requests)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        saves += [(r.frame, r.cell.checksum_getter()) for r in requests if isinstance(r, SaveGameState)]
    return saves, host_ms


def held_script(np, ticks, players, seed=6):
    """Inputs a player holds: each changes with probability 0.1 a tick to a
    value below 16, else repeats (buttons held over several frames)."""
    rng = np.random.default_rng(seed)
    change = rng.random((ticks, players)) < 0.1
    values = rng.integers(0, 16, size=(ticks, players))
    script = np.empty((ticks, players), dtype=np.int64)
    script[0] = values[0]
    for t in range(1, ticks):
        script[t] = np.where(change[t], values[t], script[t - 1])
    return script


def p2p_beam(torch, np, m, saves0, players, n, mp, dev, key, what, tag):
    """Peer 0's recorded stream of match `m` on a beam_width=P2P_BEAM
    backend and on a beam-off twin: both must give peer 0's save checksums
    and the same final core. Returns (the beam backend, its summary)."""
    from ggrs_tpu_torch import DeviceRollbackBackend, ExGame

    def pct(v, q):
        v = sorted(v)
        return v[min(len(v) - 1, (len(v) * q) // 100)]

    beam = DeviceRollbackBackend(ExGame(players, n), mp, players, beam_width=P2P_BEAM, device=dev)
    off = DeviceRollbackBackend(ExGame(players, n), mp, players, device=dev)
    beam_saves, beam_ms = p2p_replay(m.stream, beam)
    off_saves, off_ms = p2p_replay(m.stream, off)
    torch.cuda.synchronize()
    keys = tuple(off.core.carry)
    k4 = beam.core.beam_rollout.launches
    if ([(f, g()) for f, g in beam_saves] != saves0 or [(f, g()) for f, g in off_saves] != saves0
            or carry_err(torch, beam.core.carry, off.core.carry, keys)
            or carry_err(torch, beam.core.carry, m.backends[0].core.carry, keys)):
        fail(f"{key} {what}: the beam differs from its beam-off twin")
    if k4 < 1:
        fail(f"{key} {what}: the beam launched no K4 kernel")
    summary = {
        "inputs": what, "k4_launches": k4, "adopted_share": beam.rollback_frames_adopted / max(beam.rollback_frames, 1),
        "rollback_frames": beam.rollback_frames, "rollback_frames_adopted": beam.rollback_frames_adopted,
        "beam_hits": beam.beam_hits, "beam_partial_hits": beam.beam_partial_hits, "beam_misses": beam.beam_misses,
        "beam_on_ms_p50": pct(beam_ms, 50), "beam_on_ms_p90": pct(beam_ms, 90),
        "beam_off_ms_p50": pct(off_ms, 50), "beam_off_ms_p90": pct(off_ms, 90),
    }
    print(f"{key}: beam {P2P_BEAM} on peer 0's stream ({what} inputs): {k4} K4 launches, hits {beam.beam_hits}, "
          f"partial {beam.beam_partial_hits}, misses {beam.beam_misses}; adopted {beam.rollback_frames_adopted}/"
          f"{beam.rollback_frames} rollback frames ({summary['adopted_share']:.3f}); handle_requests host p50 "
          f"{summary['beam_on_ms_p50']:.4f} ms (p90 {summary['beam_on_ms_p90']:.4f}) beam on vs "
          f"{summary['beam_off_ms_p50']:.4f} (p90 {summary['beam_off_ms_p90']:.4f}) off; saves and core equal "
          f"to the beam-off twin's {tag}")
    return beam, summary


def idle_share(torch, prof, name=P2P_RANGE):
    """(the card's idle share, busy ms, window ms, device events) over the
    profiler range `name`: 1 - the union of the device-side events
    (kernels, copies, memsets) inside it over its length; the range's own
    device-side annotation, which spans it whole, is not device work. None
    for the share when the trace holds no device event."""
    events = prof.events()

    def on_device(e):
        return str(getattr(e, "device_type", "")).endswith("CUDA")

    window = [e for e in events if e.name == name and not on_device(e)]
    if not window:
        return None, 0.0, 0.0, 0
    w0, w1 = window[0].time_range.start, window[0].time_range.end
    spans = sorted((max(e.time_range.start, w0), min(e.time_range.end, w1)) for e in events
                   if on_device(e) and e.name != name and e.time_range.end > w0 and e.time_range.start < w1)
    busy, end = 0.0, w0
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    if not spans:
        return None, 0.0, (w1 - w0) / 1e3, 0
    return 1.0 - busy / (w1 - w0), busy / 1e3, (w1 - w0) / 1e3, len(spans)


def p2p_async_arm(torch, np, dev, tag, ready):
    """The P2P phase's async arm: the match of the P2P phase with every
    session publishing checksums at the interval (`checksum_publish =
    "interval"`, so the wire bytes do not depend on when values are ready),
    once with every peer eager and once with every peer on the async
    pipeline: the same request streams, every save's checksum and the
    confirmed checksums equal (and equal to the `ready` match's on the
    frames both hold), no desync; host ms a tick of each, the fence's
    stalls; the card's idle share of each from a torch.profiler trace of a
    second run; and a cProfile of peer 0's host tick in a third."""
    import cProfile
    import io
    import pstats

    players, n, mp = P2P_PLAYERS, P2P_N, P2P_MP
    stayed = [i for i in range(players) if i != P2P_LEAVE[1]]

    def pct(v, q):
        v = sorted(v)
        return v[min(len(v) - 1, (len(v) * q) // 100)]

    def run(asynch, **kw):
        torch.cuda.synchronize()
        m = p2p_match(np, players, n, mp, P2P_TICKS, dev, leave=P2P_LEAVE, publish="interval",
                      async_dispatch=asynch, record_all=True, **kw)
        for b in m.backends:
            b.block_until_ready()
        return m

    def kinds(stream):
        return [[r if r[0] == "AdvanceFrame" else r[:2] for r in tick] for tick in stream]

    arms = {"eager": run(False), "async": run(True)}
    e, a = arms["eager"], arms["async"]
    for name, m in arms.items():
        desyncs = sum(type(ev).__name__ == "DesyncDetected" for evs in m.events for ev in evs)
        launches = [b.core.tick_core.launches for b in m.backends]
        if desyncs or min(launches) < 1:
            fail(f"{P2P_KEY} {name} arm: {desyncs} desyncs, K3 launches {launches}")
    if any(kinds(x) != kinds(y) for x, y in zip(e.streams, a.streams)):
        fail(f"{P2P_KEY}: the async arm's request streams differ from the eager arm's")
    if any([(f, g()) for f, g in x] != [(f, g()) for f, g in y] for x, y in zip(e.saves, a.saves)):
        fail(f"{P2P_KEY}: the async arm's save checksums differ from the eager arm's")
    eh = [e.sessions[i].local_checksum_history for i in stayed]
    ah = [a.sessions[i].local_checksum_history for i in stayed]
    shared = set.intersection(*(set(h) for h in eh))
    if eh != ah or len(shared) < 3 or any(h[f] != eh[0][f] for h in eh for f in shared):
        fail(f"{P2P_KEY}: the arms' confirmed checksums differ, or the peers disagree")
    rh = [ready.sessions[i].local_checksum_history for i in stayed]
    common = sum(len(set(x) & set(y)) for x, y in zip(eh, rh))
    if common < 3 or any(x[f] != y[f] for x, y in zip(eh, rh) for f in set(x) & set(y)):
        fail(f"{P2P_KEY}: the interval-published confirmed checksums differ from the ready-published match's")
    histories = eh
    fence = [b.fence for b in a.backends]
    out = {"ticks": P2P_TICKS, "confirmed_checksums": sum(map(len, histories)), "common_with_ready": common,
           "fence_stalls": sum(f.stalls for f in fence), "fence_stall_ms": sum(f.stall_s for f in fence) * 1e3,
           "async_launches": [b.core.tick_core.launches for b in a.backends],
           "eager_launches": [b.core.tick_core.launches for b in e.backends], "arms": {}}
    for name, m in arms.items():
        adv = [x for i in stayed for x in m.adv_ms[i]]
        hr = [x for i in stayed for x in m.handle_ms[i]]
        out["arms"][name] = {"advance_frame_ms_p50": pct(adv, 50), "advance_frame_ms_p90": pct(adv, 90),
                             "handle_requests_ms_p50": pct(hr, 50), "handle_requests_ms_p90": pct(hr, 90),
                             "wall_s": m.wall_s}
    del arms, e, a

    # the idle share, from a trace of each arm
    from torch.profiler import ProfilerActivity, profile

    for name, asynch in (("eager", False), ("async", True)):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            m = run(asynch, mark=True)
        share, busy, window, count = idle_share(torch, prof)
        out["arms"][name].update(idle_share=share, device_busy_ms=busy, traced_window_ms=window,
                                 device_events=count, traced_wall_s=m.wall_s)
        del prof, m

    # where peer 0's host tick goes
    for name, asynch in (("eager", False), ("async", True)):
        pr = cProfile.Profile()
        run(asynch, profile=pr)
        text = io.StringIO()
        pstats.Stats(pr, stream=text).strip_dirs().sort_stats("cumulative").print_stats(P2P_PROFILE_TOP)
        lines = [ln for ln in text.getvalue().splitlines() if ln.strip()]
        start = next((k for k, ln in enumerate(lines) if ln.lstrip().startswith("ncalls")), 0)
        print(f"{P2P_KEY} {name} arm, peer 0's advance_frame + handle_requests under cProfile, top "
              f"{P2P_PROFILE_TOP} by cumulative time:")
        for ln in lines[start : start + P2P_PROFILE_TOP + 1]:
            print(f"  {ln}")

    for name in ("eager", "async"):
        x = out["arms"][name]
        share = "not measured (no device event in the trace)" if x["idle_share"] is None else \
            (f"{x['idle_share']:.4f} ({x['device_events']} device events, {x['device_busy_ms']:.3f} ms busy in "
             f"{x['traced_window_ms']:.1f} ms traced)")
        print(f"{P2P_KEY} {name} arm (checksum_publish interval): advance_frame p50 {x['advance_frame_ms_p50']:.4f} "
              f"ms (p90 {x['advance_frame_ms_p90']:.4f}), handle_requests p50 {x['handle_requests_ms_p50']:.4f} ms "
              f"(p90 {x['handle_requests_ms_p90']:.4f}) over peers {stayed}; the card's idle share {share} {tag}")
    print(f"{P2P_KEY}: the async arm equals the eager arm (request streams, every save's checksum, "
          f"{out['confirmed_checksums']} confirmed checksums; {out['common_with_ready']} of them equal to the ready "
          f"match's), 0 desyncs; K3 launches {out['async_launches']} async vs {out['eager_launches']} eager; fence "
          f"stalls {out['fence_stalls']} ({out['fence_stall_ms']:.3f} ms) {tag}")
    return out


def p2p_phase(torch, np, dev, tag):
    """The P2P path at configs[3]'s width (the module docstring's phase 19).
    Returns (the run's summary, the K3 and K4 entries of the kernels line)."""
    from ggrs_tpu_torch import DeviceRollbackBackend, ExGame
    from ggrs_tpu_torch.device.beam_core import plain_rollout
    from ggrs_tpu_torch.device.tick_core import plain_tick_multi

    players, n, mp, key = P2P_PLAYERS, P2P_N, P2P_MP, P2P_KEY

    def pct(v, q):
        v = sorted(v)
        return v[min(len(v) - 1, (len(v) * q) // 100)]

    def resolved(saves):
        return [(f, g()) for f, g in saves]

    torch.cuda.synchronize()
    m = p2p_match(np, players, n, mp, P2P_TICKS, dev, leave=P2P_LEAVE, spectator=True)
    torch.cuda.synchronize()
    launches = [b.core.tick_core.launches for b in m.backends] + [m.spec_backend.core.tick_core.launches]
    if min(launches) < 1:
        fail(f"{key}: a backend launched no K3 kernel in the match: {launches} (peers, then the spectator)")
    desyncs = sum(type(e).__name__ == "DesyncDetected" for ev in m.events for e in ev)
    if desyncs:
        fail(f"{key}: {desyncs} DesyncDetected events in a clean match")
    if m.dead_inputs < 1:
        fail(f"{key}: no DISCONNECTED input reached a backend after the disconnect")
    # the peers that played on checksummed their shared confirmed frames alike
    stayed = [i for i in range(players) if i != P2P_LEAVE[1]]
    histories = [m.sessions[i].local_checksum_history for i in stayed]
    shared = set.intersection(*(set(h) for h in histories))
    if len(shared) < 3 or any(h[f] != histories[0][f] for h in histories for f in shared):
        fail(f"{key}: the peers' confirmed checksums disagree or too few are shared ({sorted(shared)})")
    peer0 = m.backends[0]
    keys = tuple(peer0.core.carry)  # no verify history: P2P rollbacks re-save corrected frames
    saves0 = resolved(m.saves0)
    print(f"{key}: {players} peers (ExGame({players}, {n}), max_prediction {mp}, desync detection "
          f"on({P2P_DESYNC_INTERVAL}), latency {P2P_NET['latency_ms']} ms, jitter {P2P_NET['jitter_ms']}, loss "
          f"{P2P_NET['loss']}), {P2P_TICKS} ticks, peer {P2P_LEAVE[1]} disconnected at tick {m.disconnected_at}: "
          f"K3 launches {launches} (peers, spectator), {m.loads} loads, deepest rollback {max(m.depths)} frames, "
          f"{m.dead_inputs} DISCONNECTED inputs, {m.thresholds} PredictionThreshold, 0 desyncs, "
          f"{len(shared)} confirmed checksums agreeing across peers {stayed} {tag}")

    # peer 0's stream replayed on the plain versions: every save's checksum,
    # the final state and ring
    plain = DeviceRollbackBackend(ExGame(players, n), mp, players, device=dev)
    plain.core.tick_core = PlainTick(plain.core)
    plain_saves, _ = p2p_replay(m.stream, plain)
    plain.block_until_ready()
    if resolved(plain_saves) != saves0 or carry_err(torch, plain.core.carry, peer0.core.carry, keys):
        fail(f"{key}: peer 0's stream on the plain versions differs from the kernel's run")
    print(f"{key}: peer 0's {len(m.stream)} ticks replayed on the plain K3: {len(saves0)} save checksums, "
          f"the final state and ring equal to the kernel's {tag}")

    # the spectator ends on peer 0's confirmed state
    frame = m.spec_backend.current_frame
    slot = peer0.core.fetch_ring_slot(frame % peer0.core.ring_len)
    watched = m.spec_backend.state_numpy()
    if int(slot["frame"]) != frame or frame < P2P_TICKS - 20 or any(
            not np.array_equal(np.asarray(watched[k]), np.asarray(slot[k])) for k in watched):
        fail(f"{key}: the spectator's state at frame {frame} differs from peer 0's (its slot holds frame "
             f"{int(slot['frame'])})")
    print(f"{key}: the spectator advanced {m.spec_frames} frames and ends on peer 0's state of frame {frame}")

    # the beam: peer 0's stream on a beam_width=16 backend and a beam-off
    # twin; then the same on a match whose players hold their inputs
    beam, beam_random = p2p_beam(torch, np, m, saves0, players, n, mp, dev, key, "random", tag)
    held = p2p_match(np, players, n, mp, P2P_TICKS, dev, script=held_script(np, P2P_TICKS, players))
    _, beam_held = p2p_beam(torch, np, held, [(f, g()) for f, g in held.saves0], players, n, mp, dev, key,
                            "held", tag)
    k4 = beam_random["k4_launches"]

    # a corrupted slot on peer 1 is reported as a desync
    probe = p2p_match(np, players, n, mp, P2P_PROBE_TICKS, dev, corrupt_at=P2P_PROBE_AT)
    reported = [sum(type(e).__name__ == "DesyncDetected" for e in ev) for ev in probe.events]
    if not any(reported):
        fail(f"{key}: a corrupted ring slot on peer 1 was reported by no peer")
    print(f"{key}: corrupted ring slots on peer 1 at tick {P2P_PROBE_AT}: DesyncDetected per peer {reported}")

    # K3 on a row of this match (the median rollback), then K4 on the
    # beam's last speculation, each against its plain version, and timed
    core, tc = peer0.core, peer0.core.tick_core
    recorded = sorted(plain.core.tick_core.rows[1], key=lambda r: int(r[0, 2]))
    rows = recorded[len(recorded) // 2]
    timed = {k: v.clone() for k, v in core.carry.items()}
    ptimed = {k: v.clone() for k, v in core.carry.items()}
    his, los = tc.tick_multi(timed, rows)
    p_his, p_los = plain_tick_multi(ptimed, rows, core)
    err = max(carry_err(torch, {"h": his, "l": los}, {"h": p_his, "l": p_los}, "hl"),
              carry_err(torch, timed, ptimed, keys))
    if err:
        fail(f"{key}: K3 and its plain version differ on the match's median row")
    ms = queued_ms(torch, lambda: tc.tick_multi(timed, rows), P2P_TIMED_DISPATCHES)
    plain_ms = events_ms(torch, lambda: plain_tick_multi(ptimed, rows, core), 1)
    b_ms, b_by = tick_bound(rows.cpu().numpy(), n, core)
    if beam._spec is None:
        fail(f"{key}: the beam holds no speculation after the replay")
    anchor, beam_inputs, _ = beam._spec
    statuses = np.zeros(beam_inputs.shape[:3], dtype=np.int32)
    br, bring, b_rf = beam.core.beam_rollout, beam.core.carry["ring"], beam.core.carry["r_frame"]
    a_slot = anchor % beam.core.ring_len
    script = br.script(beam_inputs, statuses)
    t_in, t_st = torch.from_numpy(beam_inputs).to(dev), torch.from_numpy(statuses).to(dev)
    k4_err = spec_err(torch, br.rollout(bring, b_rf, a_slot, script),
                      plain_rollout(bring[a_slot], b_rf[a_slot], t_in, t_st, beam.core.ctx))
    if k4_err:
        fail(f"{key}: K4 and plain_rollout differ on the beam's last speculation")
    k4_ms = queued_ms(torch, lambda: br.rollout(bring, b_rf, a_slot, script), P2P_TIMED_DISPATCHES)
    k4_plain_ms = events_ms(torch, lambda: plain_rollout(bring[a_slot], b_rf[a_slot], t_in, t_st,
                                                         beam.core.ctx), 1)
    width, steps = beam_inputs.shape[:2]
    k4_b_ms, k4_b_by = beam_bound(n, width, steps, players, 1)
    print(f"{key}: K3 {ms:.4f} ms on the median row ({int(rows[0, 2])} advances) vs plain "
          f"{plain_ms:.1f} ms, bound {b_ms:.4f} ms ({b_by}); K4 {k4_ms:.4f} ms a speculation "
          f"(B={width} x L={steps}) vs plain {k4_plain_ms:.1f} ms, bound {k4_b_ms:.4f} ms ({k4_b_by}) {tag}")

    run = {"key": key, "ticks": P2P_TICKS, "players": players, "k3_launches": launches, "loads": m.loads,
           "deepest_rollback": max(m.depths), "dead_inputs": m.dead_inputs, "thresholds": m.thresholds,
           "match_wall_s": m.wall_s, "k3_ms": ms, "peers": []}
    for i in stayed + [P2P_LEAVE[1]]:
        adv, hr = m.adv_ms[i], m.handle_ms[i]
        busy = launches[i] * ms
        run["peers"].append({
            "peer": i, "ticks": len(adv),
            "advance_frame_ms_p50": pct(adv, 50), "advance_frame_ms_p90": pct(adv, 90),
            "handle_requests_ms_p50": pct(hr, 50), "handle_requests_ms_p90": pct(hr, 90),
            # derived, not a trace: K3's device time (launches x the median
            # row's time) over the peer's host time in advance_frame and
            # handle_requests; K3 overlaps that host time
            "k3_time_over_host_time": busy / max(sum(adv) + sum(hr), 1e-9),
        })
        p = run["peers"][-1]
        print(f"{key} peer {i}: {p['ticks']} ticks; advance_frame p50 {p['advance_frame_ms_p50']:.4f} ms "
              f"(p90 {p['advance_frame_ms_p90']:.4f}), handle_requests p50 {p['handle_requests_ms_p50']:.4f} ms "
              f"(p90 {p['handle_requests_ms_p90']:.4f}); K3 time over host time "
              f"{p['k3_time_over_host_time']:.4f} "
              f"({launches[i]} K3 launches) {tag}")
    run.update({"beam_width": P2P_BEAM, "beam": [beam_random, beam_held], "probe_desyncs": reported})
    run["async_arm"] = p2p_async_arm(torch, np, dev, tag, m)
    entries = [{
        "name": "resim_tick", "route": "cuda", "source": "ggrs_tpu_torch/csrc/resim_tick.cu",
        "replaces": "ggrs_tpu/tpu/pallas_resim.py:324",
        "tpu_counterpart": "PallasTickCore._build + _scalar_pass",
        "shape": f"ExGame({players}, {n}), max_prediction {mp}, the median P2P row ({int(rows[0, 2])} advances, "
                 f"{key})",
        "max_abs_err": err, "bit_equal": err == 0, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None, "launches": sum(launches),
    }, {
        "name": "beam_rollout", "route": "cuda", "source": "ggrs_tpu_torch/csrc/beam_rollout.cu",
        "replaces": "ggrs_tpu/tpu/pallas_beam.py:226",
        "tpu_counterpart": "PallasBeamRollout._build + run_kernel + finish",
        "shape": f"{n} entities, P={players}, B={width} x L={steps} ({key} peer 0's beam)",
        "max_abs_err": k4_err, "bit_equal": k4_err == 0, "ms": k4_ms, "plain_ms": k4_plain_ms,
        "bound_ms": k4_b_ms, "bound_by": k4_b_by, "library_ms": None, "launches": k4,
    }]
    return run, entries


# -- the cross-session megabatch core (MultiSessionDeviceCore) ------------

MB_KEY = "mb64_4096"
# bench.py:1785 bench_serve_host: 64 sessions, max_prediction 8, the 4-player
# host layout; BASELINE.json configs[1]'s 4096-entity world, configs[3]'s 4
# players; the P2P phase's network (P2P_NET), a seed a match
MB_MATCHES, MB_PLAYERS, MB_N, MB_MP = 16, 4, 4096, 8
MB_TICKS, MB_MIGRATE_AT = 140, 120  # host ticks recorded; the slots migrate to a second core at 120
MB_PLAIN_EVERY = 24  # every 24th host tick's megabatches (and each kind's first) held against plain_megabatch
MB_TIMED = 40  # recorded megabatches of each kind timed alone, queued behind a spin
MB_SLICES = [("mb8_swarm", "Swarm", 128), ("mb8_arena", "Arena", 64)]  # parity only: 8 slots, 20 host ticks
MB_SLICE_TICKS = 20


class MegabatchRecorder:
    """Stands in for a MultiSessionDeviceCore's StackedTickCore: keeps each
    launch's arguments (and the megabatch's depth key, set by `mb_drive`)
    so the recorded megabatches can be timed alone afterwards."""

    def __init__(self, tick_core):
        self.tick_core = tick_core
        self.calls = []

    def __getattr__(self, name):
        return getattr(self.tick_core, name)

    def tick(self, stack, idx, rows, nslots, b_rows, slots=None):
        # copies: on the CPU the staged words are the pool's own buffer
        self.calls.append([idx.clone(), rows.clone(), nslots, b_rows, slots, None])
        return self.tick_core.tick(stack, idx, rows, nslots, b_rows, slots=slots)


def mb_drive(torch, np, mcore, streams, t0, t1, cells, frames, saves, *, slot_of=None, plain_every=None,
             errs=None, recorder=None):
    """Host ticks [t0, t1) of the recorded per-session streams through
    `mcore` as the reference host runs them: each session's tick split at
    its loads into segments, each parsed (`parse_request_segment`) into a
    packed row; a session's first rows grouped (fast rows, then a
    megabatch per occupied depth bucket), its second rows in the next
    round of megabatches. `slot_of[s]`: the slot session s lives in (the
    identity by default). Every save's (frame, batch, flat index) goes to
    saves[s]. With `plain_every`, every plain_every-th tick's megabatches
    and each kind's first are also run by plain_megabatch on a clone of
    the stack taken just before, and his/los and the whole stack compared
    (the largest difference into errs[kind])."""
    from ggrs_tpu_torch import LoadGameState
    from ggrs_tpu_torch.device.backend import parse_request_segment
    from ggrs_tpu_torch.device.tick_core import plain_megabatch

    core = mcore.core
    W, P, I = core.window, core.num_players, core.game.input_size
    inputs = np.zeros((W, P, I), np.uint8)
    statuses = np.zeros((W, P), np.int32)
    save_slots = np.zeros((W,), np.int32)
    slot_of = slot_of or list(range(len(streams)))
    session_of = {slot: s for s, slot in enumerate(slot_of)}
    for t in range(t0, t1):
        rounds = []
        for s, stream in enumerate(streams):
            if t >= len(stream):
                continue
            segments, seg = [], []
            for r in stream_requests(stream[t], cells[s]):
                if isinstance(r, LoadGameState) and seg:
                    segments.append(seg)
                    seg = []
                seg.append(r)
            if seg:
                segments.append(seg)
            for k, seg in enumerate(segments):
                inputs.fill(0)
                statuses.fill(0)
                save_slots.fill(core.scratch_slot)
                load, start, count, _, la, _ = parse_request_segment(
                    seg, window=W, ring_len=core.ring_len, max_prediction=core.max_prediction,
                    current_frame=frames[s], inputs=inputs, statuses=statuses, save_slots=save_slots)
                row = core.pack_tick_row(load is not None, load.frame % core.ring_len if load is not None else 0,
                                         inputs, statuses, save_slots, count, start_frame=start)
                frames[s] = start + count
                while len(rounds) <= k:
                    rounds.append([])
                # every save request, a first-frame double save twice (as a
                # solo replay records them): window slot frame - start
                rounds[k].append((slot_of[s], row, la, [(r.frame - start, r.frame) for r in seg
                                                         if type(r).__name__ == "SaveGameState"]))
        for entries in rounds:
            bound_saves = {slot: sv for slot, _, _, sv in entries}
            for key, group, la in mcore.group([(slot, row, la) for slot, row, la, _ in entries]):
                check = plain_every is not None and (t % plain_every == 0 or key not in errs)
                if check:
                    twin = {k: v.clone() for k, v in mcore.stack.items()}
                batch, bucket = mcore.dispatch(group, fast=key == "fast", last_active=la)
                if recorder is not None:
                    recorder.calls[-1][5] = key
                if check:
                    p_his, p_los = plain_megabatch(twin, [slot for slot, _ in group], np.stack([r for _, r in group]),
                                                   mcore.group_depth(key), core, bucket)
                    err = max(carry_err(torch, {"h": batch._his, "l": batch._los}, {"h": p_his, "l": p_los}, "hl"),
                              carry_err(torch, mcore.stack, twin, tuple(twin)))
                    errs[key] = max(errs.get(key, 0), err)
                    if err:
                        fail(f"{MB_KEY}: megabatch {key} at host tick {t} differs from plain_megabatch (max abs "
                             f"err {err})")
                for k, (slot, _) in enumerate(group):
                    saves[session_of[slot]] += [(frame, batch, k * W + i) for i, frame in bound_saves[slot]]


def mb_kind_times(torch, np, mcore, recorder, n):
    """Each recorded kind (fast, each depth bucket): up to MB_TIMED of its
    megabatches replayed alone on a scratch copy of the stack, each
    queued behind a spin (device ms, p50 and p90), its launches and rows,
    and for the median-sized one the plain ms and the bound."""
    from ggrs_tpu_torch.device.tick_core import plain_megabatch

    def pct(v, q):
        v = sorted(v)
        return v[min(len(v) - 1, (len(v) * q) // 100)]

    scratch = {k: v.clone() for k, v in mcore.stack.items()}
    tc = recorder.tick_core
    kinds = {}
    for call in recorder.calls:
        kinds.setdefault(call[5], []).append(call)
    out = {}
    for key in (["fast"] if "fast" in kinds else []) + sorted(k for k in kinds if k != "fast"):
        calls = kinds[key]
        sample = calls[:: max(1, len(calls) // MB_TIMED)][:MB_TIMED]
        ms = [queued_ms(torch, lambda c=c: tc.tick(scratch, c[0], c[1], c[2], c[3], slots=c[4]), 4)
              for c in sample]
        median = sorted(calls, key=lambda c: c[1].shape[0])[len(calls) // 2]
        idx, rows, nslots, bucket, slots, _ = median
        rows_np = rows.cpu().numpy()
        plain_ms = events_ms(torch, lambda: plain_megabatch(scratch, slots, rows_np, nslots, mcore.core, bucket), 1)
        b_ms, b_by = megabatch_bound(rows_np, n, mcore.core, nslots)
        out[str(key)] = {"megabatches": len(calls), "rows_mean": sum(c[1].shape[0] for c in calls) / len(calls),
                         "nslots": nslots, "ms_p50": pct(ms, 50), "ms_p90": pct(ms, 90), "timed": len(ms),
                         "median_rows": int(rows.shape[0]), "plain_ms": plain_ms, "bound_ms": b_ms,
                         "bound_by": b_by}
    return out


def megabatch_slice(torch, np, dev, tag, key, game_cls, mod):
    """Parity only: 8 slots of game_cls(4, 4096), MB_SLICE_TICKS host ticks of
    seeded session-shaped rows (`megabatch_ticks`; arena's first row primes
    every ring slot) as the host groups them, every megabatch against
    plain_megabatch on a twin stack. Returns (launches, max abs err, the
    kernels-line entry's timing of the median megabatch)."""
    from ggrs_tpu_torch import MultiSessionDeviceCore
    from ggrs_tpu_torch.device.rowgen import megabatch_ticks
    from ggrs_tpu_torch.device.tick_core import plain_megabatch

    m = MultiSessionDeviceCore(game_cls(MB_PLAYERS, MB_N), MB_MP, MB_PLAYERS, 8, device=dev)
    twin = {k: v.clone() for k, v in m.stack.items()}
    wrapper = m.tick_core if m.tick_core.stacked else m.core.tick_core
    wrapper.launches = 0
    err, kinds, timed = 0, set(), None
    for entries in megabatch_ticks(m, MB_SLICE_TICKS, seed=60, mod=mod, prime=not m.tick_core.stacked):
        for gkey, group, la in m.group(entries):
            kinds.add(gkey)
            batch, bucket = m.dispatch(group, fast=gkey == "fast", last_active=la)
            idx, rows = [slot for slot, _ in group], np.stack([r for _, r in group])
            p_his, p_los = plain_megabatch(twin, idx, rows, m.group_depth(gkey), m.core, bucket)
            err = max(err, carry_err(torch, {"h": batch._his, "l": batch._los}, {"h": p_his, "l": p_los}, "hl"),
                      carry_err(torch, m.stack, twin, tuple(twin)))
            if err:
                fail(f"{key}: megabatch {gkey} differs from plain_megabatch (max abs err {err})")
            if gkey != "fast" and (timed is None or len(idx) > len(timed[1])):
                timed = (gkey, idx, rows, bucket)
    torch.cuda.synchronize()
    launches = wrapper.launches
    expected = m.megabatches if m.tick_core.stacked else m.rows_dispatched
    if launches != expected or len(kinds) < 3:
        fail(f"{key}: {launches} launches for {m.megabatches} megabatches of {m.rows_dispatched} rows, kinds {kinds}")
    gkey, idx, rows, bucket = timed
    nslots = m.group_depth(gkey)
    scratch = {k: v.clone() for k, v in m.stack.items()}
    idx_t = torch.tensor(idx, dtype=torch.int32, device=dev)
    rows_t = torch.from_numpy(np.stack([r for r in rows])).to(dev)
    if not m.tick_core.stacked:
        from ggrs_tpu_torch.device.tick_core import windowed_row
        rows_t = torch.from_numpy(np.stack([windowed_row(r, nslots, m.core) for r in rows])).to(dev)
    # arena enqueues a launch a row from Python: a longer spin a megabatch
    spin = 1_000_000 if m.tick_core.stacked else 2_000_000 * len(idx)
    ms = queued_ms(torch, lambda: m.tick_core.tick(scratch, idx_t, rows_t, nslots, bucket, slots=idx), 20, spin)
    plain_ms = events_ms(torch, lambda: plain_megabatch(scratch, idx, rows, nslots, m.core, bucket), 1)
    b_ms, b_by = megabatch_bound(rows, MB_N, m.core, nslots)
    route = "K3's stacked swarm entry" if m.tick_core.stacked else "a K3-arena launch a row"
    print(f"{key}: 8 slots of {game_cls.__name__}({MB_PLAYERS}, {MB_N}), {MB_SLICE_TICKS} host ticks, "
          f"{m.megabatches} megabatches ({m.rows_dispatched} rows, kinds {sorted(map(str, kinds))}) through "
          f"{route}: {launches} launches, every megabatch == plain_megabatch; a {len(idx)}-row depth-{gkey} "
          f"megabatch {ms:.4f} ms vs plain {plain_ms:.1f} ms, bound {b_ms:.4f} ms ({b_by}) {tag}")
    return {"launches": launches, "err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "rows": len(idx), "depth": gkey, "megabatches": m.megabatches, "rows_dispatched": m.rows_dispatched}


def megabatch_phase(torch, np, dev, tag):
    """The cross-session megabatch core on the card (the module docstring's
    phase 20). Returns (the run's summary, its kernels-line entries)."""
    from ggrs_tpu_torch import Arena, DeviceRollbackBackend, ExGame, MultiSessionDeviceCore, Swarm

    S, W = MB_MATCHES * MB_PLAYERS, MB_MP + 2
    started = time.perf_counter()
    # 1. the request streams of 16 four-peer P2P matches
    streams, live_saves = [], []
    for j in range(MB_MATCHES):
        m = p2p_match(np, MB_PLAYERS, MB_N, MB_MP, MB_TICKS, dev, seed=500 + j, net_seed=700 + j, record_all=True)
        if any(type(e).__name__ == "DesyncDetected" for ev in m.events for e in ev):
            fail(f"{MB_KEY}: match {j} reported a desync")
        streams += m.streams
        live_saves += [[(f, g()) for f, g in sv] for sv in m.saves]
        del m
    recorded_s = time.perf_counter() - started
    counted = sum(min(len(st), MB_MIGRATE_AT) for st in streams)

    def fresh(recorder=False):
        mcore = MultiSessionDeviceCore(ExGame(MB_PLAYERS, MB_N), MB_MP, MB_PLAYERS, S, device=dev)
        mcore.warmup()
        rec = None
        if recorder:
            rec = mcore.tick_core = MegabatchRecorder(mcore.tick_core)
        return mcore, rec, [dict() for _ in range(S)], [0] * S, [[] for _ in range(S)]

    # 2. the main path, checked: the megabatch drive (its launches counted)
    # with plain_megabatch on sampled megabatches, then every slot exported
    # and imported into a second core under another slot, and both run on
    main, rec, cells, frames, saves = fresh(recorder=True)
    main.tick_core.tick_core.launches = 0
    main.core.tick_core.launches = 0
    errs = {}
    mb_drive(torch, np, main, streams, 0, MB_MIGRATE_AT, cells, frames, saves, plain_every=MB_PLAIN_EVERY,
             errs=errs, recorder=rec)
    torch.cuda.synchronize()
    at_migration = {k: v.clone() for k, v in main.stack.items()}
    moved, moved_rec, _, _, _ = fresh()
    perm = [(s * 7 + 3) % S for s in range(S)]
    for s in range(S):
        moved.import_slot(perm[s], main.export_slot(s))
    moved_cells = [dict(c) for c in cells]
    moved_frames, moved_saves = list(frames), [[] for _ in range(S)]
    mb_drive(torch, np, main, streams, MB_MIGRATE_AT, MB_TICKS, cells, frames, saves, recorder=rec)
    main_launches = main.tick_core.tick_core.launches
    mb_drive(torch, np, moved, streams, MB_MIGRATE_AT, MB_TICKS, moved_cells, moved_frames, moved_saves,
             slot_of=perm)
    torch.cuda.synchronize()
    if main.core.tick_core.launches or main_launches != main.megabatches or main_launches < 1:
        fail(f"{MB_KEY}: {main_launches} stacked K3 launches for {main.megabatches} megabatches")
    resolved = [[(f, b.resolve(i)) for f, b, i in sv] for sv in saves]
    for s in range(S):
        tail = [(f, b.resolve(i)) for f, b, i in moved_saves[s]]
        if tail != resolved[s][len(resolved[s]) - len(tail):] or frames[s] != moved_frames[s]:
            fail(f"{MB_KEY}: session {s} migrated to slot {perm[s]} of a second core differs from the unmigrated run")
        for k in main.stack:
            if not torch.equal(main.stack[k][s], moved.stack[k][perm[s]]):
                fail(f"{MB_KEY}: session {s}'s {k} after the migration differs")

    # 3. the same 120 host ticks timed on a fresh core, no checks
    timed, _, t_cells, t_frames, t_saves = fresh()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mb_drive(torch, np, timed, streams, 0, MB_MIGRATE_AT, t_cells, t_frames, t_saves)
    torch.cuda.synchronize()
    mb_s = time.perf_counter() - t0
    for k, v in at_migration.items():
        if not torch.equal(v, timed.stack[k]):
            fail(f"{MB_KEY}: the timed run's {k} differs from the checked run's")

    # 4. each session's stream on its own solo backend, the same host-tick
    # order (timed over the same 120 ticks)
    solos = [DeviceRollbackBackend(ExGame(MB_PLAYERS, MB_N), MB_MP, MB_PLAYERS, device=dev) for _ in range(S)]
    solo_cells = [dict() for _ in range(S)]
    solo_saves = [[] for _ in range(S)]
    launches0 = [b.core.tick_core.launches for b in solos]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(MB_TICKS):
        if t == MB_MIGRATE_AT:
            torch.cuda.synchronize()
            solo_s = time.perf_counter() - t0
        for s, stream in enumerate(streams):
            if t < len(stream):
                requests = stream_requests(stream[t], solo_cells[s])
                solos[s].handle_requests(requests)
                solo_saves[s] += [(r.frame, r.cell.checksum_getter()) for r in requests
                                  if type(r).__name__ == "SaveGameState"]
    torch.cuda.synchronize()
    solo_launches = sum(b.core.tick_core.launches for b in solos) - sum(launches0)
    for s in range(S):
        got = [(f, g()) for f, g in solo_saves[s]]
        if got != resolved[s] or got != live_saves[s]:
            fail(f"{MB_KEY}: session {s}'s save checksums differ between the megabatch core, its solo replay and "
                 "its live match")
        carry = solos[s].core.carry
        if solos[s].current_frame != frames[s] or any(not torch.equal(main.stack[k][s], carry[k]) for k in main.stack):
            fail(f"{MB_KEY}: session {s}'s final world and ring differ from its solo replay's")

    kinds = mb_kind_times(torch, np, main, rec, MB_N)
    n_saves = sum(len(r) for r in resolved)
    rate, solo_rate = counted / mb_s, counted / solo_s
    print(f"{MB_KEY}: {MB_MATCHES} four-peer P2P matches of {MB_TICKS} ticks recorded ({recorded_s:.1f} s, "
          f"ExGame({MB_PLAYERS}, {MB_N}), max_prediction {MB_MP}, P2P_NET with a seed a match); {S} sessions on "
          f"one MultiSessionDeviceCore: {main.megabatches} megabatches, {main.rows_dispatched} rows, "
          f"{main_launches} stacked K3 launches; {n_saves} save checksums, the final stacked rings and states "
          f"equal to the {S} solo replays and the live matches; sampled megabatches == plain_megabatch "
          f"(max abs err {max(errs.values())}, kinds {sorted(map(str, errs))}); export -> import of every slot "
          f"into a second core at tick {MB_MIGRATE_AT}, {MB_TICKS - MB_MIGRATE_AT} ticks on, equal {tag}")
    for key, k in kinds.items():
        print(f"{MB_KEY} megabatch {key}: {k['megabatches']} megabatches, {k['rows_mean']:.1f} rows on average, "
              f"{k['nslots']} window slots; device ms p50 {k['ms_p50']:.4f} (p90 {k['ms_p90']:.4f}, {k['timed']} "
              f"timed alone, queued); the median ({k['median_rows']} rows) plain {k['plain_ms']:.1f} ms, bound "
              f"{k['bound_ms']:.4f} ms ({k['bound_by']}) {tag}")
    print(f"{MB_KEY}: {counted} session-ticks in {mb_s:.3f} s through the megabatch core ({rate:.1f} session-ticks/s, "
          f"{main.megabatches / MB_TICKS:.2f} megabatches a host tick) vs "
          f"{solo_s:.3f} s through {S} solo backends ({solo_rate:.1f} session-ticks/s, {solo_launches} K3 launches "
          f"over {MB_TICKS} ticks) {tag}")
    slices = {key: megabatch_slice(torch, np, dev, tag, key, {"Swarm": Swarm, "Arena": Arena}[g], mod)
              for key, g, mod in MB_SLICES}
    summary = {"key": MB_KEY, "sessions": S, "ticks": MB_TICKS, "megabatches": main.megabatches,
               "rows": main.rows_dispatched, "stacked_launches": main_launches, "saves": n_saves,
               "session_ticks": counted, "megabatch_s": mb_s, "session_ticks_per_s": rate, "solo_s": solo_s,
               "solo_session_ticks_per_s": solo_rate, "solo_launches": solo_launches, "kinds": kinds,
               "plain_err": errs, "slices": slices, "phase_s": time.perf_counter() - started}
    entries = []
    for key, k in kinds.items():
        entries.append({
            "name": "resim_tick_stacked", "route": "cuda", "source": "ggrs_tpu_torch/csrc/resim_tick.cu",
            "replaces": "ggrs_tpu/tpu/pallas_resim.py:324",
            "tpu_counterpart": "K3's function a row of MultiSessionDeviceCore's vmapped megabatch "
                               "(ggrs_tpu/tpu/backend.py:2058-2152)",
            "shape": f"{MB_KEY}: {k['median_rows']} rows of ExGame({MB_PLAYERS}, {MB_N}), megabatch {key} "
                     f"({k['nslots']} window slots)",
            "max_abs_err": errs.get(key if key == "fast" else int(key), 0), "ms": k["ms_p50"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"], "bound_by": k["bound_by"], "library_ms": None,
            "launches": k["megabatches"],
        })
    for key, g, _ in MB_SLICES:
        sl = slices[key]
        entries.append({
            "name": "resim_tick_stacked" if g == "Swarm" else "resim_tick_arena_per_row", "route": "cuda",
            "source": "ggrs_tpu_torch/csrc/resim_tick.cu", "replaces": "ggrs_tpu/tpu/pallas_resim.py:324",
            "tpu_counterpart": "K3's function a row of MultiSessionDeviceCore's vmapped megabatch",
            "shape": f"{key}: {sl['rows']} rows of {g}({MB_PLAYERS}, {MB_N}), depth {sl['depth']}"
                     + ("" if g == "Swarm" else f", {sl['rows']} K3-arena launches"),
            "max_abs_err": sl["err"], "ms": sl["ms"], "plain_ms": sl["plain_ms"], "bound_ms": sl["bound_ms"],
            "bound_by": sl["bound_by"], "library_ms": None, "launches": sl["launches"],
        })
    return summary, entries


HS_KEY = "hs64_4096"
# the serving path: 16 four-peer P2P matches (bench.py:1785's 64 sessions,
# BASELINE.json configs[1]/[3]'s widths) on one SessionHost, over the P2P
# phase's network (P2P_NET) with a seed a match, HS_TICKS host ticks after
# sync; the resident arm's mailbox depth is HS_RESIDENT_TICKS
HS_MATCHES, HS_PLAYERS, HS_N, HS_MP = 16, 4, 4096, 8
HS_TICKS, HS_RESIDENT_TICKS = 140, 16
HS_PLAIN_EVERY = 8  # the first drive and every 8th held against plain_resident_drive
HS_TIMED = 24  # recorded drives timed alone, queued behind a spin
HS_RANGE = "host_ticks"  # the profiler range around a fleet's tick loop
HS_SLICES = [("hs8_swarm", "Swarm"), ("hs8_arena", "Arena")]  # parity only: 8 sessions, HS_SLICE_TICKS ticks
# 32, not fewer: a session captures its first confirmed checksum at frame 20
# (frame_to_send must pass max_prediction) and publishes it at frame 29
HS_SLICE_TICKS = 32


class ResidentRecorder:
    """Stands in for a MultiSessionDeviceCore's ResidentTickCore: keeps each
    drive's mailbox rows, marks and depth (copies) so the drives can be
    timed alone afterwards, and for the first drive and every
    HS_PLAIN_EVERY-th a clone of the stack before and after it with the
    drive's output, which `hs_plain_checks` holds against
    plain_resident_drive."""

    def __init__(self, rc):
        self.rc = rc
        self.calls = []
        self.checks = []

    def __getattr__(self, name):
        return getattr(self.rc, name)

    def drive(self, stack, mbox_rows, marks, nslots):
        call = (mbox_rows.clone(), marks.copy(), nslots)
        sampled = len(self.calls) % HS_PLAIN_EVERY == 0
        self.calls.append(call)
        before = {k: v.clone() for k, v in stack.items()} if sampled else None
        his, los = self.rc.drive(stack, mbox_rows, marks, nslots)
        if sampled:
            self.checks.append((before, call, his, los, {k: v.clone() for k, v in stack.items()}))
        return his, los


def resident_bound(rows, marks, n, core, nslots):
    """Least ms of one resident drive: every live lane's rows on its own
    world (`tick_work` of each lane's rows cut to `nslots`), plus the
    (0, 0) his/los of every row not run."""
    import numpy as np

    from ggrs_tpu_torch.device.tick_core import windowed_row

    lanes = [s for s in range(len(marks)) if marks[s]]
    work = [tick_work(np.stack([windowed_row(r, nslots, core) for r in rows[s, : marks[s]]]), n, core)
            for s in lanes]
    unrun = rows.shape[0] * rows.shape[1] - int(sum(marks))
    return least(sum(b for b, _ in work) + 2 * 4 * core.window * unrun, sum(o for _, o in work))


def hs_fleet(torch, np, dev, resident, *, game_cls=None, n=None, matches=None, ticks=None, record=False,
             mark=False):
    """One fleet of `matches` four-peer P2P matches of game_cls(4, n) (ExGame
    by default) on ONE port SessionHost on `dev`: max_prediction HS_MP,
    desync detection on(P2P_DESYNC_INTERVAL), each match on its own
    InMemoryNetwork (P2P_NET, seed 700 + m), a FakeClock advanced
    P2P_TICK_MS a tick, inputs seeded below 16, `ticks` host ticks after
    sync. `resident`: SessionHost(resident=True, resident_ticks=
    HS_RESIDENT_TICKS), else dispatch-per-tick with depth routing; an
    inflight window the dispatch arm never fills, so both arms carry the
    same traffic. Every kernel count of the host's core is set to 0 just
    before the tick loop. `record`: the resident drive goes through a
    ResidentRecorder; `mark`: the tick loop runs inside the profiler range
    HS_RANGE. Returns a namespace (host, keys, desyncs, wall seconds of the
    tick loop, the recorder)."""
    import random
    from types import SimpleNamespace

    from ggrs_tpu_torch import DesyncDetection, ExGame, PlayerType, SessionBuilder
    from ggrs_tpu_torch.network.sockets import InMemoryNetwork
    from ggrs_tpu_torch.serve import SessionHost
    from ggrs_tpu_torch.serve.loadgen import sync_fleet
    from ggrs_tpu_torch.utils.clock import FakeClock

    n, matches, ticks = n or HS_N, matches or HS_MATCHES, ticks or HS_TICKS
    S = matches * HS_PLAYERS
    clock = FakeClock()
    host = SessionHost((game_cls or ExGame)(HS_PLAYERS, n), max_prediction=HS_MP, num_players=HS_PLAYERS,
                       max_sessions=S, clock=clock, idle_timeout_ms=0, max_inflight_rows=8 * S, warmup=True,
                       resident=resident, resident_ticks=HS_RESIDENT_TICKS, device=dev)
    rec = None
    if record:
        rec = host.device.resident_core = ResidentRecorder(host.device.resident_core)
    keys = []
    for m in range(matches):
        net = InMemoryNetwork(clock, **dict(P2P_NET, seed=700 + m))
        addrs = [(m, i) for i in range(HS_PLAYERS)]
        row = []
        for i in range(HS_PLAYERS):
            b = (SessionBuilder(input_size=1).with_num_players(HS_PLAYERS).with_max_prediction_window(HS_MP)
                 .with_desync_detection_mode(DesyncDetection.on(P2P_DESYNC_INTERVAL)).with_clock(clock)
                 .with_rng(random.Random(100 + HS_PLAYERS * m + i)))
            for h, addr in enumerate(addrs):
                b = b.add_player(PlayerType.local() if h == i else PlayerType.remote(addr), h)
            row.append(host.attach(b.start_p2p_session(net.socket(addrs[i]))))
        keys.append(row)
    sync_fleet(host, keys, clock)
    scripts = [np.random.default_rng(500 + m).integers(0, 16, size=(ticks, HS_PLAYERS)) for m in range(matches)]
    core = host.device
    host.device.block_until_ready()
    core.tick_core.launches = core.core.tick_core.launches = 0
    if core.resident_core is not None:
        (rec.rc if rec is not None else core.resident_core).launches = 0
    span = None
    if mark:
        span = torch.profiler.record_function(HS_RANGE)
        span.__enter__()
    desyncs = 0
    t0 = time.perf_counter()
    for t in range(ticks):
        for m, row in enumerate(keys):
            for i, key in enumerate(row):
                host.submit_input(key, i, bytes([int(scripts[m][t, i])]))
        desyncs += sum(type(e).__name__ == "DesyncDetected" for evs in host.tick().values() for e in evs)
        clock.advance(P2P_TICK_MS)
    host.device.block_until_ready()
    wall = time.perf_counter() - t0
    if span is not None:
        span.__exit__(None, None, None)
    return SimpleNamespace(host=host, keys=[k for row in keys for k in row], desyncs=desyncs, wall_s=wall,
                           rec=rec, ticks=ticks, sessions=S)


def hs_compare(np, a, b, what):
    """Fail unless two fleets' sessions hold the same frames and confirmed
    checksum histories and their cores the same stacked bytes and slot
    checksums. Returns the confirmed checksums compared."""
    published = 0
    for ka, kb in zip(a.keys, b.keys):
        sa, sb = a.host.session(ka), b.host.session(kb)
        if sa.current_frame != sb.current_frame or sa.local_checksum_history != sb.local_checksum_history:
            fail(f"{what}: session {ka}'s frame or checksum history differs between the arms")
        published += len(sa.local_checksum_history)
    for x, y in zip(a.host.device.stacked_canonical(), b.host.device.stacked_canonical()):
        for k in y:
            if not np.array_equal(x[k], y[k]):
                fail(f"{what}: the stacked {k} differs between the arms")
    for x, y in zip(a.host.device.checksum_slots(), b.host.device.checksum_slots()):
        if not np.array_equal(x, y):
            fail(f"{what}: checksum_slots differs between the arms")
    if published < 1:
        fail(f"{what}: no confirmed checksum was compared")
    return published


def hs_plain_checks(torch, rec, core):
    """Every sampled drive of a ResidentRecorder against
    plain_resident_drive on its clone of the stack: his/los and the whole
    stack after it. Returns the largest difference and each check's
    (recorded call, the plain drive's device ms)."""
    from ggrs_tpu_torch.device.tick_core import plain_resident_drive

    err, plain = 0, []
    for before, call, his, los, after in rec.checks:
        rows, marks, nslots = call
        lanes = [s for s in range(len(marks)) if marks[s]]
        out = []
        ms = events_ms(torch, lambda: out.append(plain_resident_drive(before, rows, lanes, marks[lanes], nslots,
                                                                      core)), 1)
        p_his, p_los = out[0]
        err = max(err, carry_err(torch, {"h": his, "l": los}, {"h": p_his, "l": p_los}, "hl"),
                  carry_err(torch, after, before, tuple(after)))
        plain.append((call, ms))
    return err, plain


def hs_drive_times(torch, np, host, rec, n, plain, reps=4):
    """Up to HS_TIMED of the recorded drives replayed alone on a scratch
    copy of the stack, each queued behind a spin (device ms p50, p90), and
    the median (by rows) of the drives checked against the plain version
    (`plain`: hs_plain_checks' (call, plain ms) pairs) timed the same way
    beside that check's plain ms and its bound (`ms`: the kernels line's
    time of the work the bound counts)."""

    def pct(v, q):
        v = sorted(v)
        return v[min(len(v) - 1, (len(v) * q) // 100)]

    core = host.device
    scratch = {k: v.clone() for k, v in core.stack.items()}
    calls = rec.calls
    sample = calls[:: max(1, len(calls) // HS_TIMED)][:HS_TIMED]

    # arena enqueues a launch a lane from Python: a longer spin a drive
    def timed(c):
        return queued_ms(torch, lambda: rec.rc.drive(scratch, c[0], c[1], c[2]), reps,
                         1_000_000 if rec.rc.stacked else 2_000_000 * int((c[1] > 0).sum()))

    ms = [timed(c) for c in sample]
    median, plain_ms = sorted(plain, key=lambda cp: int(cp[0][1].sum()))[len(plain) // 2]
    median_ms = timed(median)
    rows, marks, nslots = median
    lanes = [s for s in range(len(marks)) if marks[s]]
    b_ms, b_by = resident_bound(rows.cpu().numpy(), marks, n, core.core, nslots)
    return {"drives": len(calls), "timed": len(ms), "ms_p50": pct(ms, 50), "ms_p90": pct(ms, 90), "ms": median_ms,
            "median_lanes": len(lanes), "median_rows": int(marks.sum()), "median_vticks": int(marks.max()),
            "nslots": nslots, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by}


def hs_slice(torch, np, dev, tag, key, game_cls):
    """Parity only: 8 sessions (two four-peer matches) of game_cls(4, 4096),
    HS_SLICE_TICKS ticks, resident against dispatch-per-tick; the resident
    arm's drives (the first, every 8th) against plain_resident_drive, its
    median drive timed. Returns the kernels-line figures."""
    res = hs_fleet(torch, np, dev, True, game_cls=game_cls, matches=2, ticks=HS_SLICE_TICKS, record=True)
    twin = hs_fleet(torch, np, dev, False, game_cls=game_cls, matches=2, ticks=HS_SLICE_TICKS)
    if res.desyncs or twin.desyncs:
        fail(f"{key}: {res.desyncs} / {twin.desyncs} desyncs (resident / dispatch)")
    hs_compare(np, res, twin, key)
    core = res.host.device
    stacked = core.resident_core.rc.stacked
    launches = core.resident_core.rc.launches if stacked else core.core.tick_core.launches
    lanes = sum(int((c[1] > 0).sum()) for c in res.rec.calls)
    if launches != (core.driver_dispatches if stacked else lanes) or core.driver_dispatches < 1:
        fail(f"{key}: {launches} launches for {core.driver_dispatches} drives of {lanes} lanes")
    err, plain = hs_plain_checks(torch, res.rec, core.core)
    if err:
        fail(f"{key}: a resident drive differs from plain_resident_drive (max abs err {err})")
    times = hs_drive_times(torch, np, res.host, res.rec, HS_N, plain, reps=2)
    route = "K3's resident swarm entry" if stacked else "a K3-arena launch a lane"
    print(f"{key}: 8 sessions of {game_cls.__name__}({HS_PLAYERS}, {HS_N}), {HS_SLICE_TICKS} ticks, resident "
          f"({core.driver_dispatches} drives through {route}, {launches} launches) == dispatch-per-tick "
          f"({twin.host.device.megabatches} megabatches): histories, stacked bytes, slot checksums; sampled drives "
          f"== plain_resident_drive; the median drive ({times['median_rows']} rows) {times['ms']:.4f} ms vs plain "
          f"{times['plain_ms']:.1f} ms, bound {times['bound_ms']:.4f} ms ({times['bound_by']}) {tag}")
    return dict(times, launches=launches, err=err, stacked=stacked)


def serve_phase(torch, np, dev, tag):
    """The serving path on the card (the module docstring's phase 21).
    Returns (the run's summary, its kernels-line entries)."""
    from torch.profiler import ProfilerActivity, profile

    from ggrs_tpu_torch import Arena, Swarm

    started = time.perf_counter()
    # the main path, checked, in ABBA order: dispatch, resident (recorded),
    # resident, dispatch
    runs = {"dispatch": [], "resident": []}
    for resident in (False, True, True, False):
        first = resident and not runs["resident"]
        torch.cuda.synchronize()
        runs["resident" if resident else "dispatch"].append(hs_fleet(torch, np, dev, resident, record=first))
    res, twin = runs["resident"][0], runs["dispatch"][0]
    for arm, fleets in runs.items():
        for f in fleets:
            if f.desyncs:
                fail(f"{HS_KEY}: the {arm} arm reported {f.desyncs} desyncs")
    published = hs_compare(np, res, twin, HS_KEY)
    hs_compare(np, runs["resident"][1], runs["dispatch"][1], HS_KEY)
    hs_compare(np, res, runs["dispatch"][1], HS_KEY)
    core, tcore = res.host.device, twin.host.device
    rc = core.resident_core.rc
    if rc.launches != core.driver_dispatches or rc.launches < 1 or core.tick_core.launches or core.megabatches \
            or core.mailbox.overflows:
        fail(f"{HS_KEY}: {rc.launches} resident launches for {core.driver_dispatches} drives, "
             f"{core.tick_core.launches} stacked launches, {core.megabatches} megabatches, "
             f"{core.mailbox.overflows} overflows")
    if tcore.tick_core.launches != tcore.megabatches or tcore.megabatches < 1:
        fail(f"{HS_KEY}: {tcore.tick_core.launches} stacked launches for {tcore.megabatches} megabatches")
    launches = rc.launches  # the main path's; the timing replays below launch more
    err, plain = hs_plain_checks(torch, res.rec, core.core)
    if err:
        fail(f"{HS_KEY}: a resident drive differs from plain_resident_drive (max abs err {err})")
    times = hs_drive_times(torch, np, res.host, res.rec, HS_N, plain)
    session_ticks = res.sessions * HS_TICKS
    rates = {arm: [session_ticks / f.wall_s for f in fleets] for arm, fleets in runs.items()}
    arms = {}
    for arm, f in (("dispatch", twin), ("resident", res)):
        c = f.host.device
        arms[arm] = {"dispatches_per_tick": (c.megabatches + c.driver_dispatches) / HS_TICKS,
                     "megabatches": c.megabatches, "drives": c.driver_dispatches,
                     "session_ticks_per_s": rates[arm], "wall_s": [g.wall_s for g in runs[arm]]}
    arms["resident"].update(vticks_per_drive=core.vticks_executed / core.driver_dispatches,
                            commits_per_tick=core.mailbox.commits / HS_TICKS, overflows=core.mailbox.overflows,
                            rows_per_drive=core.rows_dispatched / core.driver_dispatches)
    del runs, res, twin

    # the card's idle share in each arm, from a trace of a further run
    for arm in ("dispatch", "resident"):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            f = hs_fleet(torch, np, dev, arm == "resident", mark=True)
        share, busy, window, count = idle_share(torch, prof, HS_RANGE)
        arms[arm].update(idle_share=share, device_busy_ms=busy, traced_window_ms=window, device_events=count,
                         traced_wall_s=f.wall_s)
        del prof, f

    print(f"{HS_KEY}: {HS_MATCHES} four-peer P2P matches of ExGame({HS_PLAYERS}, {HS_N}) on one SessionHost "
          f"(max_prediction {HS_MP}, desync detection on({P2P_DESYNC_INTERVAL}), P2P_NET with a seed a match, "
          f"{HS_TICKS} ticks after sync), dispatch-per-tick (depth routing) and resident (resident_ticks "
          f"{HS_RESIDENT_TICKS}): 0 desyncs; {published} confirmed checksums, the stacked rings and states and the "
          f"slot checksums equal across the arms; {launches} resident K3 launches == {core.driver_dispatches} "
          f"drives, 0 stacked launches, 0 overflows; sampled drives == plain_resident_drive {tag}")
    for arm, a in arms.items():
        share = "not measured (no device event in the trace)" if a["idle_share"] is None else \
            (f"{a['idle_share']:.4f} ({a['device_events']} device events, {a['device_busy_ms']:.3f} ms busy in "
             f"{a['traced_window_ms']:.1f} ms traced)")
        extra = "" if arm == "dispatch" else \
            (f", {a['vticks_per_drive']:.2f} virtual ticks and {a['rows_per_drive']:.1f} rows a drive, "
             f"{a['commits_per_tick']:.3f} commits a host tick")
        print(f"{HS_KEY} {arm} arm: {a['dispatches_per_tick']:.4f} dispatches a host tick ({a['megabatches']} "
              f"megabatches, {a['drives']} drives){extra}; session-ticks/s "
              f"{', '.join(f'{r:.1f}' for r in a['session_ticks_per_s'])} (ABBA: dispatch, resident, resident, "
              f"dispatch); the card's idle share {share} {tag}")
    print(f"{HS_KEY} resident entry: {times['drives']} drives, device ms p50 {times['ms_p50']:.4f} (p90 "
          f"{times['ms_p90']:.4f}, {times['timed']} timed alone, queued); the median checked drive ({times['median_lanes']} "
          f"lanes, {times['median_rows']} rows, {times['median_vticks']} virtual ticks, {times['nslots']} window "
          f"slots) {times['ms']:.4f} ms, plain {times['plain_ms']:.1f} ms, bound {times['bound_ms']:.4f} ms ({times['bound_by']}) {tag}")
    slices = {key: hs_slice(torch, np, dev, tag, key, {"Swarm": Swarm, "Arena": Arena}[g]) for key, g in HS_SLICES}
    summary = {"key": HS_KEY, "sessions": HS_MATCHES * HS_PLAYERS, "ticks": HS_TICKS, "arms": arms,
               "resident_entry": times, "confirmed_checksums": published, "slices": slices,
               "phase_s": time.perf_counter() - started}
    entries = [{
        "name": "resim_tick_resident", "route": "cuda", "source": "ggrs_tpu_torch/csrc/resim_tick.cu",
        "replaces": "ggrs_tpu/tpu/pallas_resim.py:324",
        "tpu_counterpart": "K3's function a virtual tick of MultiSessionDeviceCore's lax.while_loop driver "
                           "(ggrs_tpu/tpu/backend.py:2714-2823)",
        "shape": f"{HS_KEY}: the median drive, {times['median_lanes']} lanes, {times['median_rows']} rows of "
                 f"ExGame({HS_PLAYERS}, {HS_N}), {times['nslots']} window slots",
        "max_abs_err": err, "ms": times["ms"], "plain_ms": times["plain_ms"], "bound_ms": times["bound_ms"],
        "bound_by": times["bound_by"], "library_ms": None, "launches": launches,
    }]
    for key, g in HS_SLICES:
        sl = slices[key]
        entries.append({
            "name": "resim_tick_resident" if sl["stacked"] else "resim_tick_arena_per_lane", "route": "cuda",
            "source": "ggrs_tpu_torch/csrc/resim_tick.cu", "replaces": "ggrs_tpu/tpu/pallas_resim.py:324",
            "tpu_counterpart": "K3's function a virtual tick of MultiSessionDeviceCore's lax.while_loop driver",
            "shape": f"{key}: the median drive, {sl['median_lanes']} lanes, {sl['median_rows']} rows of "
                     f"{g}({HS_PLAYERS}, {HS_N})" + ("" if sl["stacked"] else f", {sl['median_lanes']} K3-arena launches"),
            "max_abs_err": sl["err"], "ms": sl["ms"], "plain_ms": sl["plain_ms"], "bound_ms": sl["bound_ms"],
            "bound_by": sl["bound_by"], "library_ms": None, "launches": sl["launches"],
        })
    return summary, entries


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    try:
        from ggrs_tpu_torch import Arena, DeviceSyncTestSession, ExGame, Swarm
        from ggrs_tpu_torch.convert import CARRY_KEYS, copy_carry
        from ggrs_tpu_torch.device import sync_test
        from ggrs_tpu_torch.device.fused_core import FusedSyncTestCore, plain_batch
        from ggrs_tpu_torch.device.planes import PlaneContext
        from ggrs_tpu_torch.device.tiled_core import TiledSyncTestCore, plain_parts, plain_verdict
        from ggrs_tpu_torch.kernels import build
    except ImportError as exc:
        fail(f"the ggrs_tpu_torch package is not beside this script: {exc}")

    started = time.perf_counter()
    marks = [("start", started)]

    def mark(name):  # the seconds each phase took, printed at the end
        marks.append((name, time.perf_counter()))

    card = card_line()
    print(card)
    tag = f"[{card}]"
    dev = torch.device(DEVICE)
    kinds = build.KINDS
    t0 = time.perf_counter()
    build.build(kinds)
    print(f"kernel build: {time.perf_counter() - t0:.3f} s for {', '.join(k + '.cu' for k in kinds)} (parallel nvcc)")
    for kind in kinds:
        for line in build.ptxas_summary(build.build_report(kind)):
            print(f"  {kind}: {line}")

    rng = np.random.default_rng(2024)
    scripts = {
        key: [rng.integers(0, 16, size=(t, PLAYERS, 1), dtype=np.uint8) for _ in range(b)]
        for key, _, _, _, t, b in SHAPES
    }
    plain_final = {}
    entries = []

    mark("1")

    # -- phase 2: each kernel against its plain version ---------------------
    for key, backend, n, d, t_ticks, batches in SHAPES:
        ctx = PlaneContext(ExGame(PLAYERS, n), PLAYERS, d, dev)
        tiled = backend == "cuda-tiled"
        core = TiledSyncTestCore(ctx) if tiled else FusedSyncTestCore(ctx)
        kc = sync_test.initial_carry(ctx)
        pc = copy_carry(kc)
        err = 0
        for raw in scripts[key]:
            inputs = torch.from_numpy(raw.astype(np.int32)).to(dev)
            if tiled:  # the parts too, before the verdict folds them
                k_hi, k_lo = core.run_kernel(kc, inputs)
                p_hi, p_lo = plain_parts(pc, inputs, ctx)
                err = max(err, carry_err(torch, {"h": k_hi, "l": k_lo}, {"h": p_hi, "l": p_lo}, "hl"))
                core.verdict(kc, k_hi, k_lo)
                plain_verdict(pc, p_hi, p_lo, ctx)
            else:
                core.batch(kc, inputs)
                plain_batch(pc, inputs, ctx)
            torch.cuda.synchronize()
            err = max(err, carry_err(torch, kc, pc, CARRY_KEYS))
            if err:
                fail(f"{key}: kernel and plain version differ (max abs err {err})")
        print(f"{key}: {core.kernel} == plain after each of {batches} batch(es) ({n} entities, d={d}, T={t_ticks}) {tag}")
        plain_final[key] = copy_carry(pc)

        # divergence probe: corrupt the slot the next rollback loads. The
        # heading plane (rot) is never clamped, so the corruption survives
        # the resimulation (a position pinned at the arena wall would not)
        c = int(kc["meta"][0])
        slot = (c - d) % ctx.ring_len
        probe = [copy_carry(kc), copy_carry(pc)]
        for carry in probe:
            carry["ring"][slot, 4, 0] += 7
        inputs = torch.from_numpy(scripts[key][0].astype(np.int32)).to(dev)
        core.batch(probe[0], inputs)
        plain_batch(probe[1], inputs, ctx)
        torch.cuda.synchronize()
        latched = [carry["meta"].tolist() for carry in probe]
        if latched[0] != latched[1] or latched[0][1] != 1 or latched[0][2] != c - d + 1:
            fail(f"{key}: divergence probe latched {latched}, expected frame {c - d + 1} on both")
        if carry_err(torch, probe[0], probe[1], CARRY_KEYS):
            fail(f"{key}: kernel and plain version differ after the divergence probe")
        print(f"{key}: divergence probe: both latched mismatch at frame {c - d + 1}")
        del probe

        # kernel and plain times per batch, steady state (every tick rolls back)
        timed, ptimed = copy_carry(kc), copy_carry(pc)
        c0 = int(timed["meta"][0])
        b_ms, b_by = bound(n, d, t_ticks, c0, ctx.ring_len)
        reps = TIMED_BATCHES[key]
        if tiled:
            parts, pparts = [], []
            ms = events_ms(torch, lambda: parts.append(core.run_kernel(timed, inputs)), reps)
            v_ms = queued_ms(torch, lambda: core.verdict(timed, *parts[-1]), TIMED_LAUNCHES)
            plain_ms = events_ms(torch, lambda: pparts.append(plain_parts(ptimed, inputs, ctx)), 1)
            v_plain_ms = events_ms(torch, lambda: plain_verdict(ptimed, *pparts[-1], ctx), 1)
            v_bound, v_by = verdict_bound(t_ticks, d, ctx.hist_len)
            verdict_entry = {
                "name": "synctest_verdict", "route": "cuda",
                "source": "ggrs_tpu_torch/csrc/synctest_tiled.cu",
                "replaces": "ggrs_tpu/tpu/pallas_tiled.py:468",
                "tpu_counterpart": "PallasTiledSyncTestCore._verdict (jnp post-pass of K2)",
                "shape": f"T={t_ticks}, d={d} events",
                "max_abs_err": err, "bit_equal": err == 0,
                "ms": v_ms, "plain_ms": v_plain_ms,
                "bound_ms": v_bound, "bound_by": v_by,
                "library_ms": None,
            }
        else:
            tail_ms = tail_verdict_ms(torch, ctx, timed, inputs)
            ms = events_ms(torch, lambda: core.batch(timed, inputs), reps)
            plain_ms = events_ms(torch, lambda: plain_batch(ptimed, inputs, ctx), 1)
        del timed, ptimed
        entry = {
            "key": key,
            "name": core.kernel, "route": "cuda",
            "source": f"ggrs_tpu_torch/csrc/{core.kernel}.cu",
            "replaces": "ggrs_tpu/tpu/pallas_tiled.py:428" if tiled else "ggrs_tpu/tpu/pallas_core.py:979",
            "tpu_counterpart": "PallasTiledSyncTestCore._build" if tiled else "PallasSyncTestCore._build",
            "shape": f"{n} entities, d={d}, T={t_ticks}",
            "max_abs_err": err, "bit_equal": err == 0,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        }
        tail = ""
        if not tiled:
            entry["tail_verdict_ms"] = tail_ms
            tail = f"; its tail's verdict alone on this batch's parts {tail_ms:.4f} ms"
        entries.append(entry)
        if tiled:
            entries.append({"key": key, **verdict_entry})
        print(f"{key}: {core.kernel} {ms:.4f} ms/batch vs plain {entry['plain_ms']:.1f} ms, "
              f"bound {b_ms:.4f} ms ({b_by}){tail} {tag}")
        del kc, pc

    verdict_streams_phase(torch, np, dev, tag)

    mark("2")

    # -- phase 3: the main path through backend="auto" -----------------------
    main_path = []
    for key, backend, n, d, t_ticks, batches in SHAPES:
        sess = DeviceSyncTestSession(ExGame(PLAYERS, n), PLAYERS, d, backend="auto", device=dev)
        if sess.backend != backend:
            fail(f"{key}: auto chose {sess.backend}, expected {backend}")
        core = sess.core
        core.launches = 0
        if backend == "cuda-tiled":
            core.verdict_launches = 0
        for raw in scripts[key]:
            sess.advance_frames(raw)
        sess.block_until_ready()
        if carry_err(torch, sess.carry, plain_final[key], CARRY_KEYS):
            fail(f"{key}: main-path carry differs from the plain version's")
        sess.check()
        reps = MAIN_PATH_BATCHES[key]
        samples = sorted(events_ms(torch, lambda: sess.advance_frames(scripts[key][-1]), 1)
                         for _ in range(reps))
        sess.check()
        counts = {core.kernel: core.launches}
        if backend == "cuda-tiled":
            counts["synctest_verdict"] = core.verdict_launches
        if min(counts.values()) < 1:
            fail(f"{key}: the main path launched no kernel: {counts}")
        total = batches + reps
        state = sess.state_numpy()
        if state["pos"].shape != (n, 2) or state["vel"].shape != (n, 2) or state["rot"].shape != (n,):
            fail(f"{key}: state has the wrong shape")
        ms = samples[reps // 2]
        p90 = samples[(reps * 9) // 10] if reps >= 100 else None
        rate = t_ticks * d / (ms / 1e3)
        print(f"main path {key}: auto -> {sess.backend}, launches {counts} over {total} batches, "
              f"median {ms:.4f} ms/batch (p90 {p90}, n={reps}), {rate:.1f} rollback-frames/s {tag}")
        for e in entries:
            if e["key"] == key:
                e["launches"] = counts[e["name"]]
        main_path.append({"key": key, "backend": sess.backend, "ms_per_batch_p50": ms,
                          "ms_per_batch_p90": p90, "samples": reps,
                          "rollback_frames_per_s_p50": rate, "batches": total})
        del sess

    mark("3")

    # -- phases 4 and 5: K3 against its plain version, then the request path
    tick_errs = tick_phase(torch, np, dev, tag)
    tick_streams_phase(torch, np, dev, tag)
    mark("4")
    request_path, tick_entries = request_path_phase(torch, np, dev, tag, tick_errs)
    mark("5")

    # -- phases 6 and 7: K4 against its plain version, then the beam path
    beam_errs = beam_phase(torch, np, dev, tag)
    beam_path, beam_entries = beam_path_phase(torch, np, dev, tag, beam_errs)
    mark("6-7")

    # -- phases 8 and 9: arena on K1, K5 and the injection route, then its main path
    fused_scripts, fused_final, fused_entries = arena_fused_phase(torch, np, dev, tag)
    injected_final, injected_scripts, injected_entries = reduce_and_injected_phase(torch, np, dev, tag)
    arena_path = arena_main_path_phase(torch, np, dev, tag, fused_scripts, fused_final, injected_scripts,
                                       injected_final, fused_entries, injected_entries)
    arena_entries = list(fused_entries.values()) + list(injected_entries.values())
    mark("8-9")

    # -- phases 10 and 11: arena on K3 and K4, then its request and beam paths
    arena_tick_errs, arena_tick_timed = arena_tick_phase(torch, np, dev, tag)
    mark("10 K3")
    arena_beam_errs = arena_beam_phase(torch, np, dev, tag)
    mark("10 K4")
    arena_request_path, arena_tick_entries = arena_request_path_phase(torch, np, dev, tag, arena_tick_errs,
                                                                      arena_tick_timed)
    mark("11 request path")
    arena_beam_path, arena_beam_entries = beam_path_phase(torch, np, dev, tag, arena_beam_errs, ARENA_BEAM_SHAPES,
                                                          ARENA_BEAM_PATH_TICKS, ARENA_BEAM_SCRIPTS, Arena)
    mark("11 beam path")

    # -- phases 12 and 13: swarm on K1 and K2 (position probes), then its fused main path
    swarm_scripts, swarm_final, swarm_fused = swarm_synctest_phase(torch, np, dev, tag)
    swarm_path = swarm_main_path_phase(torch, np, dev, tag, swarm_scripts, swarm_final, swarm_fused)
    mark("12-13")

    # -- phases 14 and 15: swarm on K3 and K4, then its request and beam paths
    swarm_tick_errs = tick_phase(torch, np, dev, tag, SWARM_TICK_SHAPES, Swarm, SWARM_MOD, probe_plane=0)
    swarm_beam_errs = beam_phase(torch, np, dev, tag, SWARM_BEAM_SHAPES, Swarm, SWARM_MOD, probe_plane=0,
                                 timed=SWARM_TIMED_SPECULATIONS)
    swarm_request_path, swarm_tick_entries = swarm_request_path_phase(torch, np, dev, tag, swarm_tick_errs)
    swarm_beam_path, swarm_beam_entries = beam_path_phase(torch, np, dev, tag, swarm_beam_errs, SWARM_BEAM_SHAPES,
                                                          SWARM_BEAM_PATH_TICKS, SWARM_BEAM_SCRIPTS, Swarm,
                                                          probe_plane=0)
    mark("14-15")

    # -- phase 16: arena past 16 teams on K1-K5
    team_entries = arena_teams_phase(torch, np, dev, tag)
    mark("16")

    # -- phase 17: K2's inline whole-world arena route in each regime, then
    # its main path, and what the on-chip states buy
    arena_inline_path, inline_entries = arena_inline_phase(torch, np, dev, tag, arena_path)
    layouts = inline_layout_phase(torch, np, dev, tag)
    mark("17")

    # -- phase 18: checkpoints on the card (K1, K2, the injection route, K3)
    checkpoints = checkpoint_phase(torch, np, dev, tag)
    mark("18")

    # -- phase 19: the P2P path, configs[3] (K3 on every dispatch, K4 with the beam), and its async arm
    p2p_path, p2p_entries = p2p_phase(torch, np, dev, tag)
    mark("19")

    # -- phase 20: the cross-session megabatch core (K3's stacked entry, K3-arena a row)
    megabatch_path, megabatch_entries = megabatch_phase(torch, np, dev, tag)
    mark("20")

    # -- phase 21: the serving path, SessionHost in both cadences (K3's resident entry)
    serve_path, serve_entries = serve_phase(torch, np, dev, tag)
    mark("21")

    for e in entries:
        e.pop("key")
    entries += tick_entries + beam_entries + arena_entries + arena_tick_entries + arena_beam_entries
    entries += list(swarm_fused.values()) + swarm_tick_entries + swarm_beam_entries + team_entries
    entries += inline_entries + p2p_entries + megabatch_entries + serve_entries
    print("chip_smoke: seconds a phase: " + ", ".join(f"{name} {t - marks[i][1]:.1f}"
                                                       for i, (name, t) in enumerate(marks[1:])))
    print(f"chip_smoke: every phase passed in {time.perf_counter() - started:.1f} s")
    print(json.dumps({"card": card, "main_path": main_path, "request_path": request_path,
                      "beam_path": beam_path, "arena_path": arena_path,
                      "arena_request_path": arena_request_path, "arena_beam_path": arena_beam_path,
                      "swarm_path": swarm_path, "swarm_request_path": swarm_request_path,
                      "swarm_beam_path": swarm_beam_path, "arena_inline_path": arena_inline_path,
                      "inline_layout_ms": layouts, "checkpoints": checkpoints, "p2p_path": p2p_path,
                      "megabatch_path": megabatch_path, "serve_path": serve_path}))
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
