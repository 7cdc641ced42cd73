"""The third model family on torch tensors: the reference's
`ggrs_tpu/models/swarm.py`, a 3-D drone swarm with a battery economy.

State is a dict of int32 tensors in the reference's layout — `frame` [],
`pos` [N,3] (Q8 subpixels on a 2^17 torus cube), `vel` [N,3], `charge`
[N] — and entity i follows the input of player i % num_players. Its
vectors are three components wide (three planes a key), and its dynamics
are strictly per entity: no cross-entity reduction. The step is written
once on planes (`step_planes`) and serves both `Swarm.step` and the
packed-plane kernels' plain versions
(`ggrs_tpu_torch.device.planes.SwarmPlanes`).

Input: one bitmask byte per player, six axis bits and BOOST, which doubles
the acceleration while the battery lasts. A DISCONNECTED player's drones
sink (their input becomes INPUT_ZM).

`init_oracle`, `step_oracle` and `checksum_oracle` restate the reference's
numpy path, for the tests.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..ops import fixed_point as fx
from ..types import InputStatus

INPUT_XP = 1 << 0
INPUT_XM = 1 << 1
INPUT_YP = 1 << 2
INPUT_YM = 1 << 3
INPUT_ZP = 1 << 4
INPUT_ZM = 1 << 5
INPUT_BOOST = 1 << 6
INPUT_SIZE = 1  # bytes per player per frame

# 512-px torus cube in Q8 subpixels; power of two => branch-free wrap
SPACE_BITS = 17
SPACE_MASK = (1 << SPACE_BITS) - 1

ACCEL = 40  # Q8 subpixels/frame^2
MAX_SPEED = 7 * fx.SUBPIX
FRICTION_NUM = 248  # ~0.97 as 248/256
CHARGE_MAX = 192
CHARGE_DRAIN = 6  # per boosted frame
CHARGE_REGEN = 2  # per un-boosted frame
DISCONNECT_INPUT = INPUT_ZM  # disconnected drones sink along -z

CHECKSUM_KEYS = ("pos", "vel", "charge")

State = Dict[str, torch.Tensor]


def _init_arrays(num_entities: int) -> Dict[str, np.ndarray]:
    """Diagonal lattice through the torus volume (three decorrelated odd
    strides), zero velocity, full battery; host-side numpy."""
    i = np.arange(num_entities, dtype=np.int64)
    pos = np.stack(
        [(i * 40503) & SPACE_MASK, (i * 30011) & SPACE_MASK, (i * 24593) & SPACE_MASK], axis=1
    ).astype(np.int32)
    return {
        "frame": np.zeros((), dtype=np.int32),
        "pos": pos,
        "vel": np.zeros((num_entities, 3), dtype=np.int32),
        "charge": np.full((num_entities,), CHARGE_MAX, dtype=np.int32),
    }


def _axis(inp, plus, minus):
    return ((inp & plus) != 0).to(torch.int32) - ((inp & minus) != 0).to(torch.int32)


def step_planes(px, py, pz, vx, vy, vz, charge, inp):
    """One frame on int32 planes `[..., N]`; `inp`: the per-entity input
    byte (int32). Returns the new (px, py, pz, vx, vy, vz, charge)."""
    boost = ((inp & INPUT_BOOST) != 0) & (charge > 0)
    accel = ACCEL + ACCEL * boost.to(torch.int32)  # doubled while boosting
    charge = torch.where(boost, charge - CHARGE_DRAIN, torch.clamp(charge + CHARGE_REGEN, max=CHARGE_MAX))
    charge = torch.clamp(charge, min=0)

    vx = ((vx * FRICTION_NUM) >> 8) + _axis(inp, INPUT_XP, INPUT_XM) * accel
    vy = ((vy * FRICTION_NUM) >> 8) + _axis(inp, INPUT_YP, INPUT_YM) * accel
    vz = ((vz * FRICTION_NUM) >> 8) + _axis(inp, INPUT_ZP, INPUT_ZM) * accel

    # 3-D speed clamp: integer sqrt + floor division (components may be
    # negative); |v| <= MAX_SPEED + 2 * ACCEL keeps m2 inside isqrt24's domain
    m2 = vx * vx + vy * vy + vz * vz
    mag = fx.isqrt24(m2)
    over = m2 > MAX_SPEED * MAX_SPEED
    safe = torch.where(mag == 0, torch.ones_like(mag), mag)
    vx = torch.where(over, fx.floor_div(vx * MAX_SPEED, safe), vx)
    vy = torch.where(over, fx.floor_div(vy * MAX_SPEED, safe), vy)
    vz = torch.where(over, fx.floor_div(vz * MAX_SPEED, safe), vz)

    # torus wrap, branch-free
    px = (px + vx) & SPACE_MASK
    py = (py + vy) & SPACE_MASK
    pz = (pz + vz) & SPACE_MASK
    return px, py, pz, vx, vy, vz, charge


def entity_inputs(player_inputs: torch.Tensor, statuses, owner: torch.Tensor) -> torch.Tensor:
    """Per-entity int32 input byte from uint8/int32 [..., P, input_size] (or
    flat [P]) player inputs, a DISCONNECTED player's byte replaced by
    DISCONNECT_INPUT; `statuses` [..., P], None meaning all CONFIRMED.
    Leading axes (the beam's members) carry through: [..., P, I] -> [..., N]."""
    rows = player_inputs.to(torch.int32)
    inp = rows if rows.dim() == 1 else rows[..., 0]
    if statuses is not None:
        disconnected = statuses.to(torch.int32) == int(InputStatus.DISCONNECTED)
        inp = torch.where(disconnected, torch.full_like(inp, DISCONNECT_INPUT), inp)
    return inp[..., owner.long()]


class Swarm:
    """Device game: step and checksum over SoA int32 tensors."""

    input_size = INPUT_SIZE
    checksum_keys = CHECKSUM_KEYS
    # statuses only substitute DISCONNECTED players' inputs: beam adoption
    # of all-CONFIRMED rollouts is sound
    statuses_contract = "disconnect-only"
    disconnect_input = bytes([DISCONNECT_INPUT])

    def __init__(self, num_players: int = 2, num_entities: int = 4096):
        self.num_players = num_players
        self.num_entities = num_entities

    def init_state(self, device) -> State:
        return {k: torch.from_numpy(v).to(device) for k, v in _init_arrays(self.num_entities).items()}

    def owner(self, device) -> torch.Tensor:
        """The owning player of every entity (entity index % players)."""
        return torch.arange(self.num_entities, dtype=torch.int32, device=device) % self.num_players

    def step(self, state: State, inputs: torch.Tensor, statuses: torch.Tensor) -> State:
        """inputs: uint8 [P, input_size] (or flat [P]); statuses: int32 [P]."""
        pos, vel = state["pos"], state["vel"]
        inp = entity_inputs(inputs, statuses, self.owner(pos.device))
        px, py, pz, vx, vy, vz, charge = step_planes(*pos.unbind(1), *vel.unbind(1), state["charge"], inp)
        return {
            "frame": state["frame"] + 1,
            "pos": torch.stack([px, py, pz], dim=1),
            "vel": torch.stack([vx, vy, vz], dim=1),
            "charge": charge,
        }

    def checksum(self, state: State):
        """(hi, lo) as 0-dim int32 tensors holding the uint32 bit patterns."""
        return fx.weighted_checksum_parts([state[k] for k in CHECKSUM_KEYS] + [state["frame"]])


# ---------------------------------------------------------------------------
# numpy oracle: the reference's `_step_generic` evaluated with numpy
# ---------------------------------------------------------------------------


def init_oracle(num_players: int = 2, num_entities: int = 4096) -> Dict[str, np.ndarray]:
    return _init_arrays(num_entities)


def step_oracle(state, inputs: np.ndarray, statuses: np.ndarray, num_players: int):
    with np.errstate(over="ignore"):
        n = state["pos"].shape[0]
        owner = np.arange(n, dtype=np.int32) % num_players
        inp = np.asarray(inputs).reshape(-1).astype(np.int32)[owner]
        status = np.asarray(statuses).astype(np.int32)[owner]
        inp = np.where(status == int(InputStatus.DISCONNECTED), DISCONNECT_INPUT, inp)

        def axis(plus, minus):
            return np.where((inp & plus) != 0, 1, 0) - np.where((inp & minus) != 0, 1, 0)

        charge = state["charge"]
        boost = ((inp & INPUT_BOOST) != 0) & (charge > 0)
        accel = np.where(boost, 2 * ACCEL, ACCEL)
        charge = np.maximum(np.where(boost, charge - CHARGE_DRAIN, np.minimum(charge + CHARGE_REGEN, CHARGE_MAX)), 0)
        vel = (state["vel"] * FRICTION_NUM) >> 8
        vel = vel + np.stack([axis(INPUT_XP, INPUT_XM) * accel, axis(INPUT_YP, INPUT_YM) * accel,
                              axis(INPUT_ZP, INPUT_ZM) * accel], axis=1)
        m2 = (vel * vel).sum(axis=1)
        mag = fx.isqrt24_np(m2)
        over = (m2 > MAX_SPEED * MAX_SPEED)[:, None]
        safe = np.where(mag == 0, 1, mag)[:, None]
        vel = np.where(over, (vel * MAX_SPEED) // safe, vel)
        pos = (state["pos"] + vel) & SPACE_MASK
        return {
            "frame": (state["frame"] + np.int32(1)).astype(np.int32),
            "pos": pos.astype(np.int32),
            "vel": vel.astype(np.int32),
            "charge": charge.astype(np.int32),
        }


def checksum_oracle(state) -> tuple:
    """(hi, lo) as Python ints: the weighted word sum over pos, vel, charge
    and the frame."""
    return fx.checksum_np([state[k] for k in CHECKSUM_KEYS] + [state["frame"]])
