"""The flagship deterministic workload on torch tensors: the reference's
`ggrs_tpu/models/ex_game.py`, an N-entity SoA "ice physics" world.

State is a dict of int32 tensors in the reference's layout — `frame` [],
`pos` [N,2], `vel` [N,2] (Q8 subpixels), `rot` [N] (16-bit angle) — and
entity i follows the input of player i % num_players. The step is written
once, on the five component planes (`substep_planes`), and serves both the
reference-layout `ExGame.step` and the packed-plane kernels' plain
versions (`ggrs_tpu_torch.device.planes.ExGamePlanes`).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..ops import fixed_point as fx
from ..types import InputStatus

# Input bitmask, one byte per player.
INPUT_UP = 1 << 0
INPUT_DOWN = 1 << 1
INPUT_LEFT = 1 << 2
INPUT_RIGHT = 1 << 3
INPUT_SIZE = 1  # bytes per player per frame

# Arena in Q8 subpixels.
WINDOW_W = 600
WINDOW_H = 800
MAX_X = WINDOW_W * fx.SUBPIX
MAX_Y = WINDOW_H * fx.SUBPIX

# Dynamics constants in fixed point at 60fps.
MOVE_SPEED = 64
ROT_SPEED = 434
MAX_SPEED = 7 * fx.SUBPIX
FRICTION_NUM = 251  # ~0.98 as 251/256
# Disconnected players spin: their input is replaced by INPUT_LEFT.
DISCONNECT_INPUT = 4

# Checksum word order: pos, vel, rot concatenated, frame folded in last.
CHECKSUM_KEYS = ("pos", "vel", "rot")

State = Dict[str, torch.Tensor]


def _init_arrays(num_entities: int) -> Dict[str, np.ndarray]:
    """Ring formation around the arena center, integer-only, built on the
    host with numpy exactly as the reference builds it."""
    i = np.arange(num_entities, dtype=np.int64)
    rot_base = ((i * fx.ANGLE_MOD) // num_entities).astype(np.int32)
    cos_t = fx.COS_TABLE[fx.angle_index(rot_base)]
    sin_t = fx.SIN_TABLE[fx.angle_index(rot_base)]
    r = (WINDOW_W // 4) * fx.SUBPIX
    cx, cy = MAX_X // 2, MAX_Y // 2
    pos = np.stack(
        [cx + ((r * cos_t) >> fx.TRIG_SCALE_BITS), cy + ((r * sin_t) >> fx.TRIG_SCALE_BITS)],
        axis=1,
    ).astype(np.int32)
    vel = np.zeros((num_entities, 2), dtype=np.int32)
    rot = (rot_base + fx.ANGLE_MOD // 2) & (fx.ANGLE_MOD - 1)
    return {
        "frame": np.zeros((), dtype=np.int32),
        "pos": pos,
        "vel": vel,
        "rot": rot.astype(np.int32),
    }


def substep_planes(px, py, vx, vy, rot, inp):
    """One physics sub-iteration on int32 planes; `inp` is the per-entity
    input byte (int32). Returns the new (px, py, vx, vy, rot)."""
    up = (inp & INPUT_UP) != 0
    down = (inp & INPUT_DOWN) != 0
    left = (inp & INPUT_LEFT) != 0
    right = (inp & INPUT_RIGHT) != 0

    # friction: arithmetic shift == floor(v * 251 / 256)
    vx = (vx * FRICTION_NUM) >> 8
    vy = (vy * FRICTION_NUM) >> 8

    # thrust/brake along the current heading (before this frame's turn)
    thrust = (up & ~down).to(torch.int32) - (down & ~up).to(torch.int32)
    cos_t = fx.cos16(rot)
    sin_t = fx.sin16(rot)
    vx = vx + thrust * ((MOVE_SPEED * cos_t) >> fx.TRIG_SCALE_BITS)
    vy = vy + thrust * ((MOVE_SPEED * sin_t) >> fx.TRIG_SCALE_BITS)

    # turn
    turn = ((right & ~left).to(torch.int32) - (left & ~right).to(torch.int32)) * ROT_SPEED
    rot = (rot + turn) & (fx.ANGLE_MOD - 1)

    # speed clamp: integer sqrt + floor division (vx may be negative)
    m2 = vx * vx + vy * vy
    mag = fx.isqrt24(m2)
    over = m2 > MAX_SPEED * MAX_SPEED
    safe_mag = torch.where(mag == 0, torch.ones_like(mag), mag)
    vx = torch.where(over, fx.floor_div(vx * MAX_SPEED, safe_mag), vx)
    vy = torch.where(over, fx.floor_div(vy * MAX_SPEED, safe_mag), vy)

    # integrate + clamp to the arena
    px = torch.clamp(px + vx, 0, MAX_X)
    py = torch.clamp(py + vy, 0, MAX_Y)
    return px, py, vx, vy, rot


def entity_inputs(player_inputs: torch.Tensor, statuses, owner: torch.Tensor) -> torch.Tensor:
    """Per-entity int32 input byte from uint8/int32 [..., P, input_size]
    player inputs, with DISCONNECTED players' inputs replaced by the spin
    input; `statuses` [..., P], None meaning all CONFIRMED. Leading axes
    (the beam's members) carry through: [..., P, I] -> [..., N]."""
    inp = player_inputs[..., 0].to(torch.int32)
    if statuses is not None:
        disconnected = statuses.to(torch.int32) == int(InputStatus.DISCONNECTED)
        inp = torch.where(disconnected, torch.full_like(inp, DISCONNECT_INPUT), inp)
    return inp[..., owner]


class ExGame:
    """Device game: step and checksum over SoA int32 tensors."""

    input_size = INPUT_SIZE
    checksum_keys = CHECKSUM_KEYS
    disconnect_input = bytes([DISCONNECT_INPUT])
    # the step reads statuses only to substitute DISCONNECTED players'
    # inputs: a trajectory speculated from candidate rows is the one the
    # corrected script produces (DeviceRollbackBackend's beam requires it)
    statuses_contract = "disconnect-only"

    def __init__(self, num_players: int = 2, num_entities: int = 4096, substeps: int = 1):
        """`substeps`: physics sub-iterations per frame (frame still
        advances by 1)."""
        self.num_players = num_players
        self.num_entities = num_entities
        self.substeps = substeps

    def init_state(self, device) -> State:
        return {
            k: torch.from_numpy(v).to(device)
            for k, v in _init_arrays(self.num_entities).items()
        }

    def owner(self, device) -> torch.Tensor:
        """The owning player of every entity (entity index % players)."""
        return torch.arange(self.num_entities, dtype=torch.int32, device=device) % self.num_players

    def step(self, state: State, inputs: torch.Tensor, statuses: torch.Tensor) -> State:
        """inputs: uint8 [P, input_size]; statuses: int32 [P]."""
        pos, vel, rot = state["pos"], state["vel"], state["rot"]
        inp = entity_inputs(inputs, statuses, self.owner(pos.device))
        planes = (pos[:, 0], pos[:, 1], vel[:, 0], vel[:, 1], rot)
        for _ in range(self.substeps):
            planes = substep_planes(*planes, inp)
        px, py, vx, vy, rot = planes
        return {
            "frame": state["frame"] + 1,
            "pos": torch.stack([px, py], dim=1),
            "vel": torch.stack([vx, vy], dim=1),
            "rot": rot,
        }

    def checksum(self, state: State):
        """(hi, lo) as 0-dim int32 tensors holding the uint32 bit patterns."""
        return fx.weighted_checksum_parts(
            [state[k] for k in CHECKSUM_KEYS] + [state["frame"]]
        )
