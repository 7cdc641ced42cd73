"""Online per-player input statistics feeding the speculation candidates:
the port of `ggrs_tpu/tpu/input_model.py` (numpy only, kept as the port's
own copy, with the counter-based uniform `unit_uniform` of
`ggrs_tpu/env/opponents.py` that `draft_script` draws from).

The reference predicts one future per player — repeat the last confirmed
input (src/input_queue.rs:126-139) — and that floor is exactly what the
beam's member 0 already provides. What the branch members need is a model
of WHEN a player will stop repeating and WHAT they will switch to. Real
input streams are runs of held values; this module learns, per player,

- the HOLD-LENGTH distribution (how long values get held before a switch),
  turned into a discrete hazard: given the current value has been held r
  frames, the probability the switch lands exactly k frames out; and
- the VALUE-TRANSITION distribution (given the held value, which values
  follow it), learned from observed switches.

Both are learned online from FINALIZED history only — frames old enough
that no rollback can rewrite them — so the statistics never ingest a
prediction that later turns out wrong. The product of the two
distributions ranks every (player, switch offset, next value) branch
candidate; `DeviceRollbackBackend` hands the top of that ranking to
`beam.branching_beam(predictions=...)`, which allocates beam members by
likelihood instead of sweeping offsets uniformly. The uniform sweep and
the XOR perturbations remain the fallback for players with no history.
"""

from __future__ import annotations

from collections import Counter, deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from .errors import ModelIncompatible

_M64 = np.uint64(0xFFFFFFFFFFFFFFFF)
_GOLDEN = np.uint64(0x9E3779B97F4A7C15)
_MIX1 = np.uint64(0xBF58476D1CE4E5B9)
_MIX2 = np.uint64(0x94D049BB133111EB)


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer over uint64 lanes."""
    with np.errstate(over="ignore"):
        x = (x + _GOLDEN) & _M64
        x = ((x ^ (x >> np.uint64(30))) * _MIX1) & _M64
        x = ((x ^ (x >> np.uint64(27))) * _MIX2) & _M64
        return x ^ (x >> np.uint64(31))


def unit_uniform(seed: int, t: int, idx: np.ndarray) -> np.ndarray:
    """Counter-based uniform in [0, 1) per index: a pure hash of
    (seed, t, idx) — no RNG state, so replays and branches agree."""
    with np.errstate(over="ignore"):
        key = (
            idx.astype(np.uint64) * np.uint64(0x2545F4914F6CDD1D)
            ^ (np.uint64(t & 0xFFFFFFFF) * _MIX1)
            ^ (np.uint64(seed & 0xFFFFFFFF) * _MIX2)
        ) & _M64
    return (_splitmix64(key) >> np.uint64(11)).astype(np.float64) * (
        1.0 / (1 << 53)
    )


# Smoothing pseudo-count for the hazard estimate: with few observed holds
# the model should spread probability over nearby offsets rather than
# spike on the single length it happened to see first.
HAZARD_PRIOR = 0.5


class _PlayerStats:
    """Sequential run tracker + bounded hold/transition statistics for one
    player. observe() consumes finalized rows strictly in frame order."""

    __slots__ = (
        "cur_value", "cur_len", "holds", "hold_counts", "transitions",
        "trans_log", "max_holds", "max_transitions",
    )

    def __init__(self, max_holds: int = 64, max_transitions: int = 64):
        self.cur_value: Optional[bytes] = None
        self.cur_len = 0
        # trailing window of hold lengths; the Counter mirrors the deque so
        # hazard queries are O(support), not O(window)
        self.holds: deque = deque()
        self.hold_counts: Counter = Counter()
        # value -> Counter of successor values, with a trailing log so old
        # behavior ages out of the counts
        self.transitions: Dict[bytes, Counter] = {}
        self.trans_log: deque = deque()
        self.max_holds = max_holds
        self.max_transitions = max_transitions

    def observe(self, row: bytes) -> None:
        if row == self.cur_value:
            self.cur_len += 1
            return
        if self.cur_value is not None:
            self._record_hold(self.cur_len)
            self._record_transition(self.cur_value, row)
        self.cur_value = row
        self.cur_len = 1

    def _record_hold(self, length: int) -> None:
        self.holds.append(length)
        self.hold_counts[length] += 1
        if len(self.holds) > self.max_holds:
            old = self.holds.popleft()
            self.hold_counts[old] -= 1
            if self.hold_counts[old] <= 0:
                del self.hold_counts[old]

    def _record_transition(self, src: bytes, dst: bytes) -> None:
        self.transitions.setdefault(src, Counter())[dst] += 1
        self.trans_log.append((src, dst))
        if len(self.trans_log) > self.max_transitions:
            osrc, odst = self.trans_log.popleft()
            c = self.transitions.get(osrc)
            if c is not None:
                c[odst] -= 1
                if c[odst] <= 0:
                    del c[odst]
                if not c:
                    del self.transitions[osrc]

    # -- queries -------------------------------------------------------

    def n_holds(self) -> int:
        return len(self.holds)

    def hazard(self, t: int) -> float:
        """P(hold == t | hold >= t) from the trailing hold window, with a
        flat pseudo-count so sparse data yields a spread, not a spike."""
        if not self.holds:
            return 0.0
        support = len(self.hold_counts) + 1  # +1: unseen-length mass
        at = self.hold_counts.get(t, 0) + HAZARD_PRIOR
        ge = sum(c for ln, c in self.hold_counts.items() if ln >= t)
        ge += HAZARD_PRIOR * support
        return at / ge

    def next_values(self, src: bytes, limit: int = 3) -> List[Tuple[bytes, float]]:
        """Ranked successor values for `src` with probability shares."""
        c = self.transitions.get(src)
        if not c:
            return []
        total = sum(c.values())
        if total <= 0:
            return []
        ranked = c.most_common(limit)
        return [(v, n / total) for v, n in ranked if n > 0]

    # -- migration carry (JSON-safe: byte values travel hex-encoded) ---

    def state_dict(self) -> dict:
        return {
            "cur_value": (
                self.cur_value.hex() if self.cur_value is not None else None
            ),
            "cur_len": self.cur_len,
            "holds": list(self.holds),
            "trans_log": [(s.hex(), d.hex()) for s, d in self.trans_log],
        }

    def load_state_dict(self, state: dict) -> None:
        cv = state.get("cur_value")
        self.cur_value = bytes.fromhex(cv) if cv is not None else None
        self.cur_len = int(state.get("cur_len", 0))
        # the deques are the source of truth; the Counters mirror them
        self.holds = deque(int(h) for h in state.get("holds", ()))
        self.hold_counts = Counter(self.holds)
        self.transitions = {}
        self.trans_log = deque()
        for s_hex, d_hex in state.get("trans_log", ()):
            src, dst = bytes.fromhex(s_hex), bytes.fromhex(d_hex)
            self.transitions.setdefault(src, Counter())[dst] += 1
            self.trans_log.append((src, dst))


class InputHistoryModel:
    """Per-player hold/transition statistics over finalized input rows.

    Feed rows with `observe(player, row)` strictly in frame order (the
    backend does this for frames beyond rollback reach). Query ranked
    branch candidates with `rank_branches`.
    """

    # minimum observed holds before a player's hazard ranking is trusted;
    # below this the generic offset sweep covers the player instead
    MIN_HOLDS = 3
    # per-player cap on emitted specs: the hazard of one imminent switch
    # smears over adjacent offsets, and members are too scarce to spend
    # more than this on a single player's timing uncertainty
    MAX_SPECS_PER_PLAYER = 3

    # state_dict discriminator: exported statistics only load into the
    # same kind of model
    kind = "online"

    def __init__(self, num_players: int, input_size: int):
        self.num_players = num_players
        self.input_size = input_size
        self._stats = [_PlayerStats() for _ in range(num_players)]

    def observe(self, player: int, row: bytes) -> None:
        self._stats[player].observe(row)

    def break_run(self, player: int) -> None:
        """Sever the run without recording anything (disconnect dummy
        rows are not player behavior)."""
        st = self._stats[player]
        st.cur_value = None
        st.cur_len = 0

    def reset(self) -> None:
        self._stats = [_PlayerStats() for _ in self._stats]

    def state_dict(self) -> dict:
        """Everything learned, by value and JSON-safe — what a migration
        ticket carries so a migrated session's speculation resumes warm
        instead of relearning from MIN_HOLDS."""
        return {
            "kind": self.kind,
            "num_players": self.num_players,
            "input_size": self.input_size,
            "players": [st.state_dict() for st in self._stats],
        }

    def load_state_dict(self, state: dict) -> None:
        for field in ("kind", "num_players", "input_size"):
            found, expected = state.get(field), getattr(self, field)
            if found != expected:
                raise ModelIncompatible(
                    f"input-model state {field} mismatch",
                    found=found, expected=expected,
                )
        for st, sd in zip(self._stats, state["players"]):
            st.load_state_dict(sd)

    def rank_branches(
        self,
        confirmed: List[Optional[Tuple[int, bytes, int]]],
        anchor_frame: int,
        rollout: int,
        limit: int,
    ) -> List[Tuple[int, int, np.ndarray]]:
        """Rank (player, beam-row offset, next value) switch candidates.

        `confirmed[p]` is (frontier_frame, value_bytes, run_len): the last
        frame whose input for player p is confirmed, the value held there,
        and how many consecutive confirmed frames it has been held. None
        means no confirmed signal for that player (no candidates emitted).
        Beam row j carries the input fed at frame anchor_frame + j, so a
        switch first visible at frame F maps to offset F - anchor_frame.

        Returns up to `limit` (player, offset, value_row) specs, allocated
        ROUND-ROBIN across players (ordered by each player's top score,
        hazard(run + delta) * P(value | held value)) with at most
        MAX_SPECS_PER_PLAYER specs each; only offsets inside [0, rollout)
        survive. Round-robin, not global rank order: hazard mass smears
        over adjacent offsets of the SAME imminent switch, and a pure
        rank sort lets one player's smear crowd every other player out of
        the beam entirely (measured: a 4-player staggered toggle lost a
        third of its adoptions that way). The caller composes the specs
        into beam members (beam.branching_beam's prediction stream).

        The score is the EXACT switch-at-offset-d probability: the
        hazard h(run + d - 1) times the survival product over the
        intervening frames, prod(1 - h(t)) for t in [run, run + d - 1),
        times P(value | held value). Dropping the survival factor would
        bias scores toward LATER offsets whenever hazard rises with hold
        length, because later offsets skip more of the shrinking
        product."""
        per_player: List[List[Tuple[float, int, int, bytes]]] = []
        for p in range(self.num_players):
            if confirmed[p] is None:
                continue
            st = self._stats[p]
            if st.n_holds() < self.MIN_HOLDS:
                continue
            frontier, value, run = confirmed[p]
            succ = st.next_values(value)
            if not succ:
                continue
            scored: List[Tuple[float, int, int, bytes]] = []
            # the switch can land at any not-yet-confirmed frame: frame
            # frontier + d (d >= 1) means the value was held run + d - 1
            # frames in total before switching; `surv` carries
            # prod(1 - h(t)) for t in [run, run + d - 1) and must
            # accumulate across EVERY d, including offsets outside the
            # beam window — survival through them still discounts later
            # candidates
            surv = 1.0
            for d in range(1, rollout + 1):
                h = st.hazard(run + d - 1)
                offset = frontier + d - anchor_frame
                if offset < 0 or offset >= rollout:
                    surv *= 1.0 - h
                    continue
                if h > 0.0 and surv > 0.0:
                    w = h * surv
                    for v, pv in succ:
                        scored.append((w * pv, p, offset, v))
                surv *= 1.0 - h
            if scored:
                scored.sort(key=lambda t: (-t[0], t[2]))
                per_player.append(scored[: self.MAX_SPECS_PER_PLAYER])
        # players ordered by their best score; then take one spec per
        # player per round so every predicted switch keeps coverage
        per_player.sort(key=lambda specs: -specs[0][0])
        out: List[Tuple[int, int, np.ndarray]] = []
        rank = 0
        while len(out) < limit and any(rank < len(s) for s in per_player):
            for specs in per_player:
                if rank < len(specs) and len(out) < limit:
                    _w, p, offset, v = specs[rank]
                    row = np.frombuffer(v, dtype=np.uint8).copy()
                    out.append((p, offset, row))
            rank += 1
        return out

    # per-player cap on successor values sampled by draft_script draws
    DRAFT_SUCC_LIMIT = 8
    # a width-1 draft only deviates from repeat-last when the learned
    # transition is CONFIDENT: the verify pass ANDs every cell of a row
    # (one wrong player kills the frame), so betting a cell on a value
    # the model gives < ~half its mass is negative-EV — with the floor,
    # unpredictable streams degrade to exactly the repeat-last floor
    # (which is what serves no-rollback recoveries), while streams with
    # a dominant successor keep the switch bets that serve rollbacks
    MIN_SWITCH_CONF = 0.45

    def draft_script(
        self,
        base_rows: np.ndarray,
        pinned: np.ndarray,
        *,
        anchor_frame: int,
        seed: int,
        init_values: np.ndarray,
        init_holds: np.ndarray,
    ) -> np.ndarray:
        """Fill the unpinned cells of `base_rows` (u8[D, P, I], row j =
        the input fed at frame anchor_frame + j) with hold/switch draws
        from the learned statistics — the WIDTH-1 drafted script the
        serving host's speculative bubble-filling rolls out for an
        input-starved session.

        `pinned` (bool[D, P]) marks ground-truth cells (played local
        inputs and confirmed remote inputs): they are left verbatim and
        RE-ANCHOR the per-player hold run. Every other cell draws like
        env/opponents.InputModelOpponent: at each frame the player
        switches with probability hazard(current hold length) — a
        counter-based splitmix64 uniform of (seed, absolute frame,
        player) decides, never a stateful RNG stream (the DET-lint
        determinism contract), so re-drafting the same anchor with the
        same statistics reproduces a byte-identical script — and a
        switching player samples its next value from the learned
        transition distribution (a second counter uniform). Players with
        no learned signal hold forever: exactly the reference's
        repeat-last prediction floor, which is also what maximizes the
        verify pass's prefix hits on streams of held values.

        `init_values` (u8[P, I]) / `init_holds` (int[P]) are each
        player's value and run length entering row 0 (derived from the
        played history before the anchor). The per-frame switch and
        successor uniforms are drawn VECTORIZED across the player axis
        (two unit_uniform calls per frame); the sequential frame
        loop is irreducible — each draw's hazard depends on the hold run
        the previous draw produced. Fills in place and returns
        base_rows."""
        D, P, I = base_rows.shape
        assert pinned.shape == (D, P)
        ids = np.arange(P)
        cur = np.array(init_values, dtype=np.uint8, copy=True)
        hold = np.array(init_holds, dtype=np.int64, copy=True)
        for j in range(D):
            frame = anchor_frame + j
            u = unit_uniform(seed, frame, ids)
            u2 = unit_uniform(seed ^ 0x5EED, frame, ids)
            for p in range(P):
                if pinned[j, p]:
                    v = base_rows[j, p]
                    if np.array_equal(v, cur[p]):
                        hold[p] += 1
                    else:
                        cur[p] = v
                        hold[p] = 1
                    continue
                st = self._stats[p]
                if st.n_holds():
                    if u[p] < st.hazard(int(hold[p])):
                        succ = [
                            sv
                            for sv in st.next_values(
                                cur[p].tobytes(),
                                limit=self.DRAFT_SUCC_LIMIT,
                            )
                            if sv[1] >= self.MIN_SWITCH_CONF
                        ]
                        if succ:
                            probs = np.array(
                                [w for _, w in succ], dtype=np.float64
                            )
                            cum = np.cumsum(probs / probs.sum())
                            k = int(
                                np.searchsorted(cum, u2[p], side="right")
                            )
                            k = min(k, len(succ) - 1)
                            cur[p] = np.frombuffer(
                                succ[k][0], dtype=np.uint8
                            )
                            hold[p] = 0
                hold[p] += 1
                base_rows[j, p] = cur[p]
        return base_rows
