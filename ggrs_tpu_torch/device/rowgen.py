"""Seeded, session-shaped packed tick rows that drive the device cores
without sessions: `random_tick_args` / `random_tick_rows` for one world
(ResimCore), `megabatch_ticks` for a MultiSessionDeviceCore's slots, with
`prime_row` and `row_last_active`. The tests and `chip_smoke.py` feed the
kernels and their plain versions the same rows through these."""

from __future__ import annotations

import numpy as np

from ..types import InputStatus


def random_tick_args(players: int, max_prediction: int, n_rows: int, seed: int, mod: int = 16,
                     input_size: int = 1):
    """`n_rows` seeded, session-shaped tick rows as `ResimCore.pack_tick_row`
    arguments (do_load, load_slot, inputs, statuses, save_slots,
    advance_count, start_frame). The shape is what sessions emit: a spin-up
    of one-advance rows so the deepest rollbacks are reachable, then one
    rollback of max_prediction - 1 frames and rows with random rollback
    depths up to max_prediction - 1; dense saves with 10% of them skipped, a
    trailing save 30% of the time, and 15% of the slots with one
    DISCONNECTED player. Input byte 0 is drawn below `mod` (ex_game 16,
    arena 64); with `input_size` 2 the second byte is drawn from 0..7
    (arena's throttle)."""
    W = ring_len = max_prediction + 2
    r = np.random.default_rng(seed)
    frame, out = 0, []
    for k in range(n_rows):
        if k < max_prediction + 2:
            depth = 0
        elif k == max_prediction + 2:
            depth = max_prediction - 1
        else:
            depth = int(r.integers(0, max_prediction))
        do_load = depth > 0 and frame > depth
        count = depth + 1 if do_load else 1
        start = frame - depth if do_load else frame
        inputs = np.zeros((W, players, input_size), np.uint8)
        statuses = np.zeros((W, players), np.int32)
        for i in range(count):
            inputs[i, :, :1] = r.integers(0, mod, (players, 1))
            if input_size > 1:
                inputs[i, :, 1:] = r.integers(0, 8, (players, input_size - 1))
            if r.random() < 0.15:
                statuses[i, r.integers(0, players)] = int(InputStatus.DISCONNECTED)
        slots = np.full((W,), ring_len, np.int32)
        for i in range(count):
            if r.random() >= 0.1:
                slots[i] = (start + i) % ring_len
        if count < W and r.random() < 0.3:
            slots[count] = (start + count) % ring_len
        out.append((do_load, (start % ring_len) if do_load else 0, inputs, statuses, slots, count, start))
        frame = start + count
    return out


def random_tick_rows(core, n_rows: int, seed: int, mod: int = 16):
    """The same stream packed into int32 [n_rows, L] rows for `core`."""
    args = random_tick_args(core.num_players, core.max_prediction, n_rows, seed, mod,
                            core.game.input_size)
    return np.stack([core.pack_tick_row(*a[:6], start_frame=a[6]) for a in args])


def prime_row(core):
    """A row that saves the live world into every ring slot and advances
    nothing. Random streams (and bench.py:1275's buffer) load slots their
    own rows may never have saved; after this row such a load finds the
    initial world instead of an all-zero one, which for arena is a world
    of dead entities."""
    W, P, I = core.window, core.num_players, core.game.input_size
    return core.pack_tick_row(False, 0, np.zeros((W, P, I), np.uint8), np.zeros((W, P), np.int32),
                              np.arange(W, dtype=np.int32), 0)


def row_last_active(core, row) -> int:
    """A packed row's 1-based last active slot: its advances and its
    highest real save (what `parse_request_segment` returns)."""
    saves = [i for i in range(core.window) if int(row[core.off_save + i]) < core.ring_len]
    return max(int(row[2]), 1, saves[-1] + 1 if saves else 0)


def megabatch_ticks(mcore, n_ticks: int, seed: int, mod: int = 16, prime: bool = False):
    """Seeded session-shaped host ticks for a MultiSessionDeviceCore: slot s
    plays `random_tick_args` with seed + s (spin-up, rollbacks of random
    depth, skipped and trailing saves, DISCONNECTED slots), one row a slot
    a tick; `prime` puts a `prime_row` first (arena: every slot then holds
    a living world). Returns [[(slot, row, last_active)] a tick]."""
    core = mcore.core
    per_slot = []
    for s in range(mcore.capacity):
        rows = list(random_tick_rows(core, n_ticks - int(prime), seed + s, mod))
        per_slot.append(([prime_row(core)] if prime else []) + rows)
    return [[(s, per_slot[s][t], row_last_active(core, per_slot[s][t])) for s in range(mcore.capacity)]
            for t in range(n_ticks)]
