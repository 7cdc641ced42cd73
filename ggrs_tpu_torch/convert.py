"""The device carries, carried across between the reference and the port:
the fused SyncTest's carry and the request path's `ResimCore` carry.

The reference (`ggrs_tpu.tpu.sync_test.TpuSyncTestSession`) keeps its carry
as a pytree; as numpy (`jax.device_get`) it is

    state:   {frame i32[], pos i32[N,2], vel i32[N,2], rot i32[N]}
    ring:    {frame i32[R], pos i32[R,N,2], vel i32[R,N,2], rot i32[R,N]}
    input_ring u8[d+2,P,I], h_tag i32[H], h_hi u32[H], h_lo u32[H],
    mismatch bool[], mismatch_frame i32[], frame i32[]

for ex_game (arena's state and ring hold pos, vel, hp i32[N] and energy
i32[N] instead; swarm's pos and vel are [..., N, 3] and it holds charge
i32[N]), with R = H = d+2. The port keeps it as packed SoA planes, so the
kernels read coalesced columns:

    state   i32[K,N]     K planes: px, py, vx, vy, rot (ex_game),
                         px, py, vx, vy, hp, energy (arena) or
                         px, py, pz, vx, vy, vz, charge (swarm)
    ring    i32[R,K,N]
    r_frame i32[R]       the ring's frame tags
    iring   i32[d+2,P,I]
    h_tag, h_hi, h_lo i32[H]  (h_hi/h_lo hold the uint32 bit patterns)
    meta    i32[3]       frame, mismatch (0/1), mismatch_frame

The state's own frame is not stored: it always equals the tick frame
(meta[0]), as in the reference. Every backend updates the carry IN PLACE
(the tiled kernel swaps in a new `iring` tensor), so a caller that keeps a
carry across batches must copy it (`copy_carry`). The game's plane layout
follows from the leaves themselves (`planes.layout_of`): the state's keys
one way, its plane count the other.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .device.planes import layout_of, pack_planes, rebuild_from_planes
from .errors import ConfigError

CARRY_KEYS = ("state", "ring", "r_frame", "iring", "h_tag", "h_hi", "h_lo", "meta")


def carry_from_reference(np_carry, device) -> Dict[str, torch.Tensor]:
    """Reference carry (numpy leaves) -> port carry on `device`."""
    frame = int(np_carry["frame"])
    if int(np_carry["state"]["frame"]) != frame:
        raise ConfigError("reference carry breaks the state-frame == tick-frame invariant")

    def t(a, dtype=np.int32):
        return torch.from_numpy(np.array(a, dtype=dtype))

    def planes(tree):
        return pack_planes(layout_of(keys=tree), {k: t(v) for k, v in tree.items() if k != "frame"})

    carry = {
        "state": planes(np_carry["state"]),
        "ring": planes(np_carry["ring"]),
        "r_frame": t(np_carry["ring"]["frame"]),
        "iring": t(np_carry["input_ring"]),
        "h_tag": t(np_carry["h_tag"]),
        "h_hi": _u32_bits(np_carry["h_hi"]),
        "h_lo": _u32_bits(np_carry["h_lo"]),
        "meta": t([frame, int(bool(np_carry["mismatch"])), int(np_carry["mismatch_frame"])]),
    }
    return {k: v.to(device) for k, v in carry.items()}


def planes_to_reference(planes: torch.Tensor, frame_leaf) -> dict:
    """Packed planes (on any device) -> reference-layout numpy leaves, with
    `frame_leaf` as the `frame` leaf."""
    leaves = rebuild_from_planes(layout_of(n_planes=planes.shape[-2]), planes.detach().cpu())
    out = {k: v.numpy().astype(np.int32) for k, v in leaves.items()}
    out["frame"] = frame_leaf
    return out


def _u32_bits(a) -> torch.Tensor:
    """uint32 leaf -> int32 tensor of the same bit pattern."""
    return torch.from_numpy(np.asarray(a, dtype=np.uint32).view(np.int32).copy())


def _u32_value(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().view(np.uint32).copy()


def carry_to_reference(carry) -> dict:
    """Port carry -> the reference's carry as numpy, dtypes included."""
    c = {k: carry[k].detach().cpu() for k in CARRY_KEYS}
    frame = np.int32(int(c["meta"][0]))
    return {
        "state": planes_to_reference(c["state"], frame),
        "ring": planes_to_reference(c["ring"], c["r_frame"].numpy().astype(np.int32)),
        "input_ring": c["iring"].numpy().astype(np.uint8),
        "h_tag": c["h_tag"].numpy().astype(np.int32),
        "h_hi": _u32_value(c["h_hi"]),
        "h_lo": _u32_value(c["h_lo"]),
        "mismatch": np.bool_(bool(c["meta"][1])),
        "mismatch_frame": np.int32(int(c["meta"][2])),
        "frame": frame,
    }


def copy_carry(carry) -> Dict[str, torch.Tensor]:
    return {k: carry[k].clone() for k in CARRY_KEYS}


# ---------------------------------------------------------------------------
# The request path's ResimCore carry. The reference core keeps three
# pytrees; as numpy they are
#
#     ring:   {frame i32[R+1], pos i32[R+1,N,2], vel i32[R+1,N,2], rot i32[R+1,N]}
#     state:  {frame i32[], pos i32[N,2], vel i32[N,2], rot i32[N]}
#     verify: {} or {h_tag i32[R], h_hi u32[R], h_lo u32[R], flag i32[2]}
#
# for ex_game (arena's ring and state hold pos, vel, hp and energy), with
# R = ring_len = max_prediction + 2 (slot R is the scratch slot). The port
# keeps state [K,N], state_frame [], ring [R+1,K,N] (K planes), r_frame
# [R+1] and the verify leaves flat in one carry dict (device/resim.py).
# ---------------------------------------------------------------------------


def resim_from_reference(ring, state, verify, device="cpu") -> Dict[str, torch.Tensor]:
    """The reference core's numpy leaves -> a port ResimCore carry on
    `device` (uint32 history as int32 bit patterns)."""

    def planes(tree):
        return pack_planes(
            layout_of(keys=tree),
            {k: torch.from_numpy(np.array(v, dtype=np.int32)) for k, v in tree.items() if k != "frame"},
        )

    carry = {
        "state": planes(state),
        "state_frame": torch.tensor(int(state["frame"]), dtype=torch.int32),
        "ring": planes(ring),
        "r_frame": torch.from_numpy(np.array(ring["frame"], dtype=np.int32)),
    }
    if verify:
        carry.update(
            h_tag=torch.from_numpy(np.array(verify["h_tag"], dtype=np.int32)),
            h_hi=_u32_bits(verify["h_hi"]),
            h_lo=_u32_bits(verify["h_lo"]),
            flag=torch.from_numpy(np.array(verify["flag"], dtype=np.int32)),
        )
    return {k: v.to(device) for k, v in carry.items()}


def resim_to_reference(core) -> dict:
    """A port ResimCore's carry -> the reference core's {"ring", "state",
    "verify"} as numpy, with the reference's dtypes."""
    c = core.carry
    out = {
        "state": planes_to_reference(c["state"], np.int32(int(c["state_frame"]))),
        "ring": planes_to_reference(c["ring"], c["r_frame"].cpu().numpy().astype(np.int32)),
        "verify": {},
    }
    if "flag" in c:
        out["verify"] = {
            "h_tag": c["h_tag"].cpu().numpy().astype(np.int32),
            "h_hi": _u32_value(c["h_hi"]),
            "h_lo": _u32_value(c["h_lo"]),
            "flag": c["flag"].cpu().numpy().astype(np.int32),
        }
    return out


def speculation_to_reference(spec) -> tuple:
    """A port `Speculation` -> the reference's speculation tuple as numpy:
    (traj {frame i32[B,L], pos i32[B,L,N,2], vel i32[B,L,N,2], rot
    i32[B,L,N]} — arena's hp and energy i32[B,L,N] in place of rot, swarm's
    [B,L,N,3] pos and vel and charge —, his
    u32[B,L], los u32[B,L], a_hi u32[], a_lo u32[])."""
    B, L = spec.his.shape
    frames = int(spec.frame) + 1 + np.arange(L, dtype=np.int32)
    traj = planes_to_reference(spec.traj, np.broadcast_to(frames, (B, L)).astype(np.int32))
    return (
        traj,
        _u32_value(spec.his),
        _u32_value(spec.los),
        np.uint32(int(spec.a_hi) & 0xFFFFFFFF),
        np.uint32(int(spec.a_lo) & 0xFFFFFFFF),
    )
