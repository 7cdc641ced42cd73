"""The second model family on torch tensors: the reference's
`ggrs_tpu/models/arena.py`, an ECS arena with combat.

State is a dict of int32 tensors in the reference's layout — `frame` [],
`pos` [N,2], `vel` [N,2] (Q8 subpixels on a 2^18 torus), `hp` [N],
`energy` [N] — and entity i follows the input of player (team)
i % num_players. Unlike ex_game, every frame needs a CROSS-ENTITY
reduction: per team, the count of living entities and the sums of their
positions >> 6, finalized into a centroid by exact floor division. The
step is written once on planes (`step_planes`), taking the finalized
per-team values as arguments, and serves both `Arena.step` and the
packed-plane kernels' plain versions
(`ggrs_tpu_torch.device.planes.ArenaPlanes`), which may hand it cached or
injected reductions instead of inline ones.

Input: one byte per player (bits 0-3 thrust right/left/down/up, bit 4
rally toward the own centroid, bit 5 overdrive), and with input_size=2 an
analog throttle byte (t in [0, 15]; t = 4 reproduces the 1-byte
dynamics). A DISCONNECTED player's entities coast with throttle 4.

`init_oracle`, `step_oracle` and `checksum_oracle` restate the reference's
numpy path, for the tests.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..ops import fixed_point as fx
from ..types import InputStatus

INPUT_UP = 1 << 0
INPUT_DOWN = 1 << 1
INPUT_LEFT = 1 << 2
INPUT_RIGHT = 1 << 3
INPUT_RALLY = 1 << 4
INPUT_OVERDRIVE = 1 << 5
INPUT_SIZE = 1  # bytes per player per frame

ARENA_BITS = 18  # 1024 px in Q8 subpixels; power of two => branch-free wrap
ARENA_MASK = (1 << ARENA_BITS) - 1
CENTROID_SHIFT = 6  # centroid sums accumulate pos >> 6 (overflow budget)

ACCEL = 48
FRICTION_NUM = 247  # ~0.965 as 247/256
MAX_SPEED = 8 * fx.SUBPIX
RALLY_SHIFT = 10
RALLY_MAX = 96
COMBAT_RANGE = 120 * fx.SUBPIX  # Manhattan radius around the enemy centroid
DAMAGE = 1
HP_INIT = 100
ENERGY_INIT = 128
ENERGY_MAX = 256
ENERGY_DRAIN = 2
ENERGY_REGEN = 1
DISCONNECT_THROTTLE = 4

CHECKSUM_KEYS = ("pos", "vel", "hp", "energy")

State = Dict[str, torch.Tensor]


def _init_arrays(num_entities: int) -> Dict[str, np.ndarray]:
    """Deterministic grid spawn, teams interleaved (host-side numpy)."""
    i = np.arange(num_entities, dtype=np.int64)
    side = int(np.ceil(np.sqrt(num_entities)))
    gx = (i % side) * ((1 << ARENA_BITS) // side)
    gy = (i // side) * ((1 << ARENA_BITS) // max(1, (num_entities + side - 1) // side))
    pos = np.stack([gx, gy], axis=1).astype(np.int32) & ARENA_MASK
    return {
        "frame": np.zeros((), dtype=np.int32),
        "pos": pos,
        "vel": np.zeros((num_entities, 2), dtype=np.int32),
        "hp": np.full((num_entities,), HP_INIT, dtype=np.int32),
        "energy": np.full((num_entities,), ENERGY_INIT, dtype=np.int32),
    }


def team_sums(px, py, hp, owner, num_players: int) -> torch.Tensor:
    """The raw reduction: int32 [..., 3P] holding, per team t, the count of
    living entities it owns, Σ(px >> 6) and Σ(py >> 6) over them. Sums wrap
    to 32 bits, as the reference's int32 sums do."""
    alive = hp > 0
    sx, sy = px >> CENTROID_SHIFT, py >> CENTROID_SHIFT
    zero = torch.zeros_like(px)
    out = []
    for t in range(num_players):
        mask = (owner == t) & alive
        out.append(mask.to(torch.int64).sum(-1))
        out.append(torch.where(mask, sx, zero).to(torch.int64).sum(-1))
        out.append(torch.where(mask, sy, zero).to(torch.int64).sum(-1))
    return fx.to_i32(torch.stack(out, dim=-1))


def finalize(raw: torch.Tensor, num_players: int):
    """Complete raw sums [..., 3P] -> (cx, cy, count), each int32 [..., P]:
    the centroid of each team's living entities (exact floor division),
    and their count. Leading axes (the beam's members) carry through."""
    raw = raw.reshape(*raw.shape[:-1], num_players, 3)
    count, sx, sy = raw[..., 0], raw[..., 1], raw[..., 2]
    safe = torch.clamp(count, min=1)
    cx = fx.floor_div(sx, safe) << CENTROID_SHIFT
    cy = fx.floor_div(sy, safe) << CENTROID_SHIFT
    return cx, cy, count


def entity_inputs(player_inputs: torch.Tensor, statuses, owner: torch.Tensor, input_size: int):
    """Per-entity (input byte, throttle) int32 from uint8/int32 [..., P, I]
    (or flat [P * I]) player inputs; a DISCONNECTED player's entities get
    input 0 and throttle 4; `statuses` [..., P], None meaning all
    CONFIRMED. Leading axes (the beam's members) carry through: [..., P, I]
    -> [..., N]."""
    rows = player_inputs.to(torch.int32)
    if rows.dim() == 1:
        rows = rows.reshape(-1, input_size)
    inp = rows[..., 0]
    throttle = rows[..., 1] & 0x0F if input_size >= 2 else torch.full_like(inp, DISCONNECT_THROTTLE)
    if statuses is not None:
        disconnected = statuses.to(torch.int32) == int(InputStatus.DISCONNECTED)
        inp = torch.where(disconnected, torch.zeros_like(inp), inp)
        throttle = torch.where(disconnected, torch.full_like(throttle, DISCONNECT_THROTTLE), throttle)
    own = owner.long()
    return inp[..., own], throttle[..., own]


def _bit(inp, mask):
    return ((inp & mask) != 0).to(torch.int32)


def step_planes(px, py, vx, vy, hp, energy, inp, throttle, owner, red, num_players: int):
    """One frame on int32 planes `[..., N]`. `inp`/`throttle`: per-entity
    int32; `red`: (cx, cy, count), each `[..., P]`, per team for the state
    entering the step (leading axes: one world per member). Returns the
    new (px, py, vx, vy, hp, energy)."""
    cx, cy, count = red
    own = owner.long()
    enemy = ((owner + 1) % num_players).long()
    alive = hp > 0

    # thrust (direct axis accel), overdrive doubling while energy lasts
    ax = _bit(inp, INPUT_RIGHT) - _bit(inp, INPUT_LEFT)
    ay = _bit(inp, INPUT_DOWN) - _bit(inp, INPUT_UP)
    over = ((inp & INPUT_OVERDRIVE) != 0) & (energy > 0)
    accel_base = (ACCEL * (throttle + 4)) >> 3
    accel = torch.where(over, 2 * accel_base, accel_base)
    energy = torch.where(over, energy - ENERGY_DRAIN, torch.clamp(energy + ENERGY_REGEN, max=ENERGY_MAX))
    energy = torch.clamp(energy, min=0)
    vx = vx + ax * accel
    vy = vy + ay * accel

    # rally: bounded pull toward the own team's centroid (arithmetic >>)
    rally = _bit(inp, INPUT_RALLY)
    vx = vx + rally * torch.clamp((cx[..., own] - px) >> RALLY_SHIFT, -RALLY_MAX, RALLY_MAX)
    vy = vy + rally * torch.clamp((cy[..., own] - py) >> RALLY_SHIFT, -RALLY_MAX, RALLY_MAX)

    # friction + speed clamp (floor division: the numerators can be negative)
    vx = (vx * FRICTION_NUM) >> 8
    vy = (vy * FRICTION_NUM) >> 8
    m2 = vx * vx + vy * vy
    mag = fx.isqrt24(m2)
    too_fast = m2 > MAX_SPEED * MAX_SPEED
    safe_mag = torch.where(mag == 0, torch.ones_like(mag), mag)
    vx = torch.where(too_fast, fx.floor_div(vx * MAX_SPEED, safe_mag), vx)
    vy = torch.where(too_fast, fx.floor_div(vy * MAX_SPEED, safe_mag), vy)

    # dead entities stop; integrate on the torus
    vx = vx * alive.to(torch.int32)
    vy = vy * alive.to(torch.int32)
    px = (px + vx) & ARENA_MASK
    py = (py + vy) & ARENA_MASK

    # combat inside the (pre-move) enemy centroid's toroidal Manhattan radius;
    # an extinct team projects no force
    half = 1 << (ARENA_BITS - 1)
    dx = ((px - cx[..., enemy] + half) & ARENA_MASK) - half
    dy = ((py - cy[..., enemy] + half) & ARENA_MASK) - half
    hit = alive & (count[..., enemy] > 0) & (dx.abs() + dy.abs() < COMBAT_RANGE)
    hp = torch.clamp(hp - hit.to(torch.int32) * DAMAGE, min=0)
    return px, py, vx, vy, hp, energy


class Arena:
    """Device game: step and checksum over SoA int32 tensors.
    `input_size=2` enables the analog-throttle byte."""

    input_size = INPUT_SIZE
    checksum_keys = CHECKSUM_KEYS
    # the step reads statuses only to make DISCONNECTED players' entities coast
    statuses_contract = "disconnect-only"

    def __init__(self, num_players: int = 2, num_entities: int = 4096, input_size: int = 1):
        if input_size not in (1, 2):
            raise ValueError(f"arena input_size must be 1 or 2, got {input_size}")
        self.num_players = num_players
        self.num_entities = num_entities
        self.input_size = input_size

    @property
    def disconnect_input(self) -> bytes:
        """The input row substituted for DISCONNECTED players: no buttons
        (coast) and throttle 4, which is what the status branch of the step
        gives."""
        return bytes([0, DISCONNECT_THROTTLE][: self.input_size])

    def init_state(self, device) -> State:
        return {k: torch.from_numpy(v).to(device) for k, v in _init_arrays(self.num_entities).items()}

    def owner(self, device) -> torch.Tensor:
        return torch.arange(self.num_entities, dtype=torch.int32, device=device) % self.num_players

    def step(self, state: State, inputs: torch.Tensor, statuses: torch.Tensor) -> State:
        """inputs: uint8 [P, input_size] (or flat [P * input_size]);
        statuses: int32 [P]."""
        pos, vel = state["pos"], state["vel"]
        owner = self.owner(pos.device)
        P = self.num_players
        inp, throttle = entity_inputs(inputs, statuses, owner, self.input_size)
        red = finalize(team_sums(pos[:, 0], pos[:, 1], state["hp"], owner, P), P)
        px, py, vx, vy, hp, energy = step_planes(
            pos[:, 0], pos[:, 1], vel[:, 0], vel[:, 1], state["hp"], state["energy"],
            inp, throttle, owner, red, P,
        )
        return {
            "frame": state["frame"] + 1,
            "pos": torch.stack([px, py], dim=1),
            "vel": torch.stack([vx, vy], dim=1),
            "hp": hp,
            "energy": energy,
        }

    def checksum(self, state: State):
        """(hi, lo) as 0-dim int32 tensors holding the uint32 bit patterns."""
        return fx.weighted_checksum_parts([state[k] for k in CHECKSUM_KEYS] + [state["frame"]])


# ---------------------------------------------------------------------------
# numpy oracle: the reference's `_step_generic` evaluated with numpy
# ---------------------------------------------------------------------------


def init_oracle(num_players: int = 2, num_entities: int = 4096) -> Dict[str, np.ndarray]:
    return _init_arrays(num_entities)


def step_oracle(state, inputs: np.ndarray, statuses: np.ndarray, num_players: int, input_size: int = 1):
    with np.errstate(over="ignore"):
        n = state["pos"].shape[0]
        owner = np.arange(n, dtype=np.int32) % num_players
        inp_bytes = np.asarray(inputs).astype(np.int32).reshape(num_players, input_size)
        inp = inp_bytes[:, 0][owner]
        status = np.asarray(statuses).astype(np.int32)[owner]
        disconnected = status == int(InputStatus.DISCONNECTED)
        inp = np.where(disconnected, 0, inp)
        if input_size >= 2:
            throttle = np.where(disconnected, DISCONNECT_THROTTLE, inp_bytes[:, 1][owner] & 0x0F)
        else:
            throttle = np.int32(DISCONNECT_THROTTLE)
        pos, vel, hp, energy = state["pos"], state["vel"], state["hp"], state["energy"]
        alive = hp > 0
        cents, counts = [], []
        for t in range(num_players):
            mask = ((owner == t) & alive).astype(np.int32)
            count = mask.sum(dtype=np.int32)
            s = (mask[:, None] * (pos >> CENTROID_SHIFT)).sum(axis=0, dtype=np.int32)
            cents.append((s // np.maximum(count, 1)) << CENTROID_SHIFT)
            counts.append(count)
        centroids, live = np.stack(cents), np.stack(counts)
        enemy = (owner + 1) % num_players
        ax = np.where(inp & INPUT_RIGHT, 1, 0) - np.where(inp & INPUT_LEFT, 1, 0)
        ay = np.where(inp & INPUT_DOWN, 1, 0) - np.where(inp & INPUT_UP, 1, 0)
        over = ((inp & INPUT_OVERDRIVE) != 0) & (energy > 0)
        accel_base = (ACCEL * (throttle + 4)) >> 3
        accel = np.where(over, 2 * accel_base, accel_base)
        energy = np.maximum(np.where(over, energy - ENERGY_DRAIN, np.minimum(energy + ENERGY_REGEN, ENERGY_MAX)), 0)
        vel = vel + np.stack([ax * accel, ay * accel], axis=1)
        rally = ((inp & INPUT_RALLY) != 0).astype(np.int32)
        vel = vel + rally[:, None] * np.clip((centroids[owner] - pos) >> RALLY_SHIFT, -RALLY_MAX, RALLY_MAX)
        vel = (vel * FRICTION_NUM) >> 8
        vx, vy = vel[:, 0], vel[:, 1]
        m2 = vx * vx + vy * vy
        mag = fx.isqrt24_np(m2)
        too_fast = m2 > MAX_SPEED * MAX_SPEED
        safe = np.where(mag == 0, 1, mag)
        vel = np.stack([np.where(too_fast, (vx * MAX_SPEED) // safe, vx),
                        np.where(too_fast, (vy * MAX_SPEED) // safe, vy)], axis=1)
        vel = vel * alive.astype(np.int32)[:, None]
        pos = (pos + vel) & ARENA_MASK
        half = 1 << (ARENA_BITS - 1)
        d = ((pos - centroids[enemy] + half) & ARENA_MASK) - half
        hit = alive & (live[enemy] > 0) & (np.abs(d[:, 0]) + np.abs(d[:, 1]) < COMBAT_RANGE)
        hp = np.maximum(hp - hit.astype(np.int32) * DAMAGE, 0)
        return {
            "frame": (state["frame"] + np.int32(1)).astype(np.int32),
            "pos": pos.astype(np.int32),
            "vel": vel.astype(np.int32),
            "hp": hp.astype(np.int32),
            "energy": energy.astype(np.int32),
        }


def checksum_oracle(state) -> tuple:
    """(hi, lo) as Python ints: the weighted word sum over pos, vel, hp,
    energy and the frame, each word weighted (index + 1) * GOLDEN32."""
    return fx.checksum_np([state[k] for k in CHECKSUM_KEYS] + [state["frame"]])
