"""Speculative input beam: candidate input futures for one anchor snapshot,
and the matchers that decide whether a rollback's corrected script was
speculated — the port of `ggrs_tpu/tpu/beam.py`.

The generators and matchers are numpy only and byte-for-byte the
reference's (`repeat_last_beam`, `branching_beam`, `match_beam`,
`match_beam_longest`). `BeamSpeculator` rolls B candidate futures out of
one state through K4 (`device/beam_core.py`): the beam becomes a select
from a precomputed trajectory instead of a resimulation (BASELINE.json
configs[2]: 16-way beam).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from .device.beam_core import BeamRollout
from .device.planes import PlaneContext, pack_planes, rebuild_from_planes
from .device.sync_test import resolve_device


class BeamSpeculator:
    """B candidate input futures of `window` frames rolled out from one
    state in one dispatch (one K4 launch on CUDA, its plain version on the
    CPU)."""

    def __init__(self, game, window: int, beam_width: int, num_players: int, device="cuda"):
        self.game = game
        self.window = window
        self.beam_width = beam_width
        self.num_players = num_players
        self.device = resolve_device(device)
        self.ctx = PlaneContext(game, num_players, max(window - 2, 1), self.device)
        self.rollout_core = BeamRollout(self.ctx, game.disconnect_input, window)

    def rollout(self, state, beam_inputs: np.ndarray, beam_statuses: np.ndarray):
        """`state`: the reference-layout state (frame and the game's leaves)
        as tensors or numpy; beam_inputs u8[B, W, P, I], beam_statuses
        i32[B, W, P]. Returns (states with leaves [B, ...], hi[B], lo[B]):
        each member's final state and its checksum, hi/lo as int32 tensors
        holding the uint32 bit patterns."""
        assert beam_inputs.shape[0] == self.beam_width
        leaves = {k: torch.as_tensor(np.asarray(v)) for k, v in state.items()}
        planes = pack_planes(self.ctx.adapter, leaves).to(self.device)
        ring = planes[None].contiguous()
        r_frame = leaves["frame"].reshape(1).to(torch.int32).to(self.device)
        spec = self.rollout_core.rollout(ring, r_frame, 0, self.rollout_core.script(beam_inputs, beam_statuses))
        final = rebuild_from_planes(self.ctx.adapter, spec.traj[:, -1])
        final["frame"] = (spec.frame + beam_inputs.shape[1]).expand(self.beam_width).clone()
        return final, spec.his[:, -1], spec.los[:, -1]

    def select(self, beam_states, index: int):
        """Commit one beam member as the new live state."""
        return {k: v[index] for k, v in beam_states.items()}


def repeat_last_beam(
    last_inputs: np.ndarray,
    window: int,
    beam_width: int,
) -> np.ndarray:
    """Candidate generator: beam member 0 is the reference's repeat-last
    prediction; member b>0 XORs bit pattern ((b-1)//P + 1) into one player's
    input for the whole window — cheap, distinct, plausible futures for
    bitmask inputs.

    last_inputs: u8[P, I]. Returns u8[B, W, P, I].
    """
    p, i = last_inputs.shape
    beam = np.tile(last_inputs, (beam_width, window, 1, 1))
    for b in range(1, beam_width):
        player = (b - 1) % p
        k = (b - 1) // p
        # cycle the perturbed byte across the full input width and keep the
        # XOR value in [1, 255] so no candidate ever collapses into member 0
        byte = (k // 255) % i
        pattern = k % 255 + 1
        beam[b, :, player, byte] ^= np.uint8(pattern)
    return beam


def branching_beam(
    last_inputs: np.ndarray,
    prev_inputs: np.ndarray,
    window: int,
    beam_width: int,
    max_offset: Optional[int] = None,
    base_rows: Optional[np.ndarray] = None,
    fixed: Optional[np.ndarray] = None,
    predictions: Optional[List[Tuple[int, int, np.ndarray]]] = None,
) -> np.ndarray:
    """Candidate generator for live sessions: per-frame branching scripts.

    Member 0 is the reference's repeat-last prediction
    (src/input_queue.rs:126-145) for every player. Real input rows are runs
    of held values; a rollback means someone switched mid-window, almost
    always between two recently-held values (press/release toggling). So
    each further member branches between the tracked `last` and
    previous-distinct (`prev`) rows at ONE offset, in four families per
    offset k, likeliest first:

      all-switch@k   every toggling player: last before k, prev from k
      all-back@k     every toggling player: prev before k, last from k
                     (the toggle landed just before the anchor, so replayed
                     frames start on the OLD value and return to last)
      one-switch@k   a single player switches last->prev at k, others repeat
      one-back@k     a single player switches prev->last at k, others repeat

    Offsets are covered breadth-first from 0 (the first unconfirmed frame,
    the most likely switch point) and capped at `max_offset` (pass the
    expected rollout depth: a branch at an offset the rollback never
    replays can only duplicate member 0's matched prefix). Players with no
    toggle history yet (prev == last) have no meaningful branch, so the
    remaining members fall back to single-pattern XOR perturbations (value
    diversity over timing diversity).

    KNOWN HISTORY IS PINNED. The speculation anchors `S` frames in the
    past, and the caller already knows what happened there: `base_rows`
    (u8[S, P, I]) carries the rows actually fed for frames anchor..anchor+S
    and `fixed` (bool[S, P]) marks the cells that are ground truth — the
    local players' own inputs and every confirmed remote input. Every
    member reproduces `base_rows` verbatim at fixed cells, and branch
    families only ever rewrite free cells (unconfirmed remote predictions,
    and everything at offsets >= S). Without this, candidates re-guess
    history the session already played: the tracked `last` for a LOCAL
    player includes its newest input, so every branch family stamps that
    value over prefix frames where the OLD value was played, the
    played-prefix compatibility check (match_beam_longest) rejects the
    member, and live adoption collapses to near zero on exactly the
    scripts the beam exists for (measured: 1 hit / 9 misses on a 2-player
    4-frame-hold toggle, every miss a prefix mismatch of this shape).

    Distinctness is enforced by construction: members that collapse to an
    already-emitted candidate (e.g. a switch at an offset whose cells are
    all fixed) are skipped, not kept as dead weight.

    MODEL-RANKED CANDIDATES COME FIRST. `predictions` is an ordered list of
    (player, offset, value_row) switch specs from the online input model
    (input_model.InputHistoryModel.rank_branches): "player p's next real
    input is value_row, first visible at beam row `offset`". When present,
    members are allocated to these likelihood-ranked specs BEFORE the
    uniform offset sweep — the first prediction member combines every
    player's top-ranked spec (the joint future: multiple players switching
    inside one rollback window needs one member carrying all the
    switches), then each spec lands in its own member in rank order. The
    caller caps the prediction share (DeviceRollbackBackend passes at most
    ~2/3 of the branch members) so the uniform families and XOR
    perturbations always keep guaranteed coverage of novel values and
    unranked offsets; a cold model (predictions=None) degrades to
    exactly the pre-model generator.

    last_inputs/prev_inputs: u8[P, I]. Returns u8[B, W, P, I].
    """
    p, _i = last_inputs.shape
    S = 0 if base_rows is None else int(base_rows.shape[0])
    assert S <= window, (S, window)
    if fixed is None:
        fixed = np.zeros((S, p), dtype=bool)
    beam = np.tile(last_inputs, (beam_width, window, 1, 1))
    if S:
        beam[:, :S] = np.asarray(base_rows, dtype=np.uint8)[None]
    # [W, P] mask of cells a family may rewrite: everything at offsets
    # >= S, plus unconfirmed predictions inside the pinned prefix
    free_mask = np.ones((window, p), dtype=bool)
    if S:
        free_mask[:S] = ~np.asarray(fixed, dtype=bool)

    has_hist = [
        not np.array_equal(prev_inputs[pl], last_inputs[pl]) for pl in range(p)
    ]
    toggling = [pl for pl in range(p) if has_hist[pl]]
    if max_offset is None:
        max_offset = window
    max_offset = min(max_offset, window)

    # one candidate stream per player (offset branches for toggling
    # players, then endless XOR patterns; pure-XOR for the rest), plus the
    # correlated all-players stream — round-robined so no player's pool
    # can crowd out another's
    def player_stream(pl):
        if has_hist[pl]:
            for k in range(max_offset):
                yield ("one", k, False, pl)
                yield ("one", k, True, pl)
        # cycle over every input byte (arena's analog throttle byte gets
        # candidate diversity too) with XOR values in [1, 255] — a zero
        # value would emit a duplicate of member 0. ONE full cycle only:
        # yields past 255 * input_size are byte-identical repeats, and with
        # duplicates skipped (not padded) an endless stream would spin the
        # fill loop forever once beam_width exceeds the distinct pool.
        for k in range(255 * _i):
            yield ("xor", pl, (k // 255) % _i, k % 255 + 1)

    def all_stream():
        for k in range(max_offset):
            yield ("all", k, False)
            yield ("all", k, True)

    def prediction_stream():
        """Model-ranked switch specs, joint-first (see docstring)."""
        assert predictions
        top: dict = {}
        for pl, k, row in predictions:
            if pl not in top:
                top[pl] = (k, row)
        if len(top) >= 2:
            yield ("predjoint", tuple(sorted(top.items())))
        for pl, k, row in predictions:
            yield ("pred", pl, k, row)

    streams = [player_stream(pl) for pl in range(p)]
    if len(toggling) >= 2:
        streams.insert(0, all_stream())
    if predictions:
        # the model stream rides the round-robin WITH the generic
        # families, first slot each round (joint member leads) — it must
        # supplement coverage, not displace it: draining the ranked
        # specs exhaustively first measurably LOST adoptions on
        # staggered multi-player scripts (the smeared hazard of one
        # player's switch crowded out the uniform offset families that
        # were serving everyone else), while interleaving keeps both
        # coverage classes alive at every width
        streams.insert(0, prediction_stream())

    seen = {beam[0].tobytes()}
    b = 1
    iota = np.arange(window)

    def apply_switch(cand, pl, k, row):
        """Rows >= k take `row` for player pl (free cells only)."""
        rows = np.where((iota >= k)[:, None], row, beam[0][:, pl])
        m = free_mask[:, pl]
        cand[m, pl] = rows[m]

    exhausted = [False] * len(streams)
    # every stream is finite (offset families bounded by max_offset, XOR
    # bounded to one distinct cycle), so this terminates even when
    # beam_width exceeds the distinct candidate pool — the surplus members
    # simply stay copies of member 0, as before dedup existed
    while b < beam_width and not all(exhausted):
        for si, stream in enumerate(streams):
            if b >= beam_width:
                break
            spec = next(stream, None)
            if spec is None:
                exhausted[si] = True
                continue
            cand = beam[0].copy()
            if spec[0] == "predjoint":
                for pl, (k, row) in spec[1]:
                    apply_switch(cand, pl, k, row)
            elif spec[0] == "pred":
                _, pl, k, row = spec
                apply_switch(cand, pl, k, row)
            elif spec[0] == "xor":
                _, pl, byte, pattern = spec
                cand[free_mask[:, pl], pl, byte] ^= np.uint8(pattern)
            else:
                kind, k, back = spec[0], spec[1], spec[2]
                players = toggling if kind == "all" else [spec[3]]
                for pl in players:
                    before, after = (
                        (prev_inputs[pl], last_inputs[pl])
                        if back
                        else (last_inputs[pl], prev_inputs[pl])
                    )
                    rows = np.where((iota >= k)[:, None], after, before)
                    m = free_mask[:, pl]
                    cand[m, pl] = rows[m]
            key = cand.tobytes()
            if key in seen:
                continue
            seen.add(key)
            beam[b] = cand
            b += 1
    return beam


def match_beam(
    beam_inputs: np.ndarray, actual_inputs: np.ndarray
) -> Optional[int]:
    """Find a beam member whose first `actual_inputs.shape[0]` frames match
    the now-confirmed inputs; None means full resimulation is needed.

    actual_inputs: u8[K, P, I] with K <= window.
    """
    k = actual_inputs.shape[0]
    for b in range(beam_inputs.shape[0]):
        if np.array_equal(beam_inputs[b, :k], actual_inputs):
            return b
    return None


def match_beam_longest(
    beam_inputs: np.ndarray,
    prefix_inputs: np.ndarray,
    actual_inputs: np.ndarray,
) -> Tuple[int, Optional[int]]:
    """Shift-flexible, longest-prefix beam match: the speculation was
    anchored `S` frames before the rollback's load frame
    (S = prefix_inputs.shape[0]), so a member is considered only if its
    first S rows equal the inputs ACTUALLY PLAYED between anchor and load
    (its trajectory baked them in). Returns (matched, member) where
    `member` is the played-prefix-compatible member whose rows
    match the LONGEST leading run of the corrected script, and `matched` is
    that run's length (0, None when no member clears the played prefix or
    matches even the first corrected row). The device analog of the
    reference's per-player misprediction localization
    (src/input_queue.rs:167-204): one wrong byte costs the suffix, not the
    whole precomputed trajectory. Full matches win ties by construction
    (matched == actual_inputs.shape[0]).

    prefix_inputs: u8[S, P, I]; actual_inputs: u8[K, P, I].
    """
    s, k = prefix_inputs.shape[0], actual_inputs.shape[0]
    best_m, best_b = 0, None
    for b in range(beam_inputs.shape[0]):
        if not np.array_equal(beam_inputs[b, :s], prefix_inputs):
            continue
        kmax = min(k, beam_inputs.shape[1] - s)
        m = 0
        while m < kmax and np.array_equal(
            beam_inputs[b, s + m], actual_inputs[m]
        ):
            m += 1
        if m > best_m:
            best_m, best_b = m, b
            if m == k:
                break
    return best_m, best_b
