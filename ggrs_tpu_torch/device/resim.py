"""The device snapshot ring and the packed control-word tick: the port of
`ggrs_tpu/tpu/resim.py` `ResimCore`, tick family only.

One tick is an optional ring load, then W = max_prediction + 2 fused
(save?, advance?) slots driven by ONE packed control-word row — 4 header
words (do_load, load_slot, advance_count, start_frame), then
save_slots[W], statuses[W*P], inputs[W*P*I] — byte for byte the
reference's layout (`pack_tick_row`). A save slot of `ring_len` (the
scratch slot) means "no save". The carry is packed SoA planes, updated in
place by every dispatch:

    state       i32[5, N]           planes px, py, vx, vy, rot
    state_frame i32[]               the live world's own frame
    ring        i32[ring_len+1, 5, N]  the last slot is the scratch slot
    r_frame     i32[ring_len+1]     the ring's frame tags
    h_tag, h_hi, h_lo i32[ring_len], flag i32[2]
                                    the device-verify first-seen history
                                    and mismatch latch (device_verify only;
                                    h_hi/h_lo hold uint32 bit patterns)

On CUDA every dispatch is one launch of K3 (`tick_core.TickCore`):
`tick_row` as a 1-row launch, `tick_multi` as a T-row launch; on the CPU
the same calls run `tick_core.plain_tick_multi`. The reference's XLA
routing variants (windowed, branchless, the `nslots` depth variants, the
size gates) give the same bits and exist only for XLA's dispatch costs;
the port keeps their `last_active` argument in the signatures and ignores
it, as the reference's Pallas path does. Speculation and adoption come
with the beam slice.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..convert import planes_to_reference
from ..errors import ContractViolation
from .planes import PlaneContext, pack_planes
from .sync_test import resolve_device
from .tick_core import VERIFY_KEYS, TickCore, check_rows

# every leaf a ResimCore carry can hold (the verify ones with device_verify)
RESIM_KEYS = ("state", "state_frame", "ring", "r_frame") + VERIFY_KEYS


class ResimCore:
    """Device snapshot ring + fused (load, resimulate, save, checksum) tick
    for one game world. `device`: "cuda" by default; the CPU only when
    asked for (then every dispatch runs the plain version)."""

    def __init__(self, game, max_prediction: int, num_players: int,
                 device_verify: bool = False, device="cuda"):
        self.device = resolve_device(device)
        self.game = game
        self.num_players = num_players
        self.max_prediction = max_prediction
        self.ring_len = max_prediction + 2  # parity with SavedStates
        self.scratch_slot = self.ring_len  # "no save" slots point here
        self.window = max_prediction + 2  # advances + possible trailing save
        self.device_verify = device_verify
        # PlaneContext's ring and history are d+2 long: with d =
        # max_prediction that is this core's ring_len
        self.ctx = PlaneContext(game, num_players, max_prediction, self.device)
        self.disconnect_input = int(game.disconnect_input[0])
        p, i = num_players, game.input_size
        self.off_save = 4
        self.off_status = self.off_save + self.window
        self.off_input = self.off_status + self.window * p
        self.packed_len = self.off_input + self.window * p * i
        self.tick_core = TickCore(self)
        self.carry = {}
        self.reset()

    # ------------------------------------------------------------------

    def pack_tick_row(self, do_load: bool, load_slot: int, inputs: np.ndarray,
                      statuses: np.ndarray, save_slots: np.ndarray, advance_count: int,
                      start_frame: int = 0) -> np.ndarray:
        """Build one tick's packed control-word row — dispatched alone by
        tick() or buffered for a multi-tick dispatch by the backend's lazy
        batching."""
        packed = np.empty((self.packed_len,), dtype=np.int32)
        self.pack_tick_row_into(packed, do_load, load_slot, inputs, statuses, save_slots,
                                advance_count, start_frame)
        return packed

    def pack_tick_row_into(self, out: np.ndarray, do_load: bool, load_slot: int,
                           inputs: np.ndarray, statuses: np.ndarray, save_slots: np.ndarray,
                           advance_count: int, start_frame: int = 0) -> np.ndarray:
        """pack_tick_row writing into a caller-owned buffer."""
        out[0] = 1 if do_load else 0
        out[1] = load_slot
        out[2] = advance_count
        out[3] = start_frame
        out[self.off_save : self.off_status] = save_slots
        out[self.off_status : self.off_input] = statuses.reshape(-1)
        out[self.off_input :] = inputs.reshape(-1)
        return out

    def pad_tick_row(self) -> np.ndarray:
        """A true no-op tick row (no load, zero advances, scratch-only
        saves): pads a partial lazy buffer to its fixed depth."""
        return self.pack_tick_row(
            False,
            0,
            np.zeros((self.window, self.num_players, self.game.input_size), dtype=np.uint8),
            np.zeros((self.window, self.num_players), dtype=np.int32),
            np.full((self.window,), self.scratch_slot, dtype=np.int32),
            0,
        )

    # ------------------------------------------------------------------

    def upload(self, rows: np.ndarray) -> torch.Tensor:
        """Host rows -> the device, checked first. On CUDA the copy is
        asynchronous from a FRESH pinned buffer: PyTorch's pinned-memory
        allocator hands the block out again only after the copy that read
        it has finished, so repacking the next tick can never race an
        upload still in flight."""
        rows = np.ascontiguousarray(rows, dtype=np.int32)
        check_rows(rows, self)
        if self.device.type == "cpu":
            return torch.from_numpy(rows)
        staged = torch.empty(rows.shape, dtype=torch.int32, pin_memory=True)
        staged.numpy()[...] = rows
        return staged.to(self.device, non_blocking=True)

    def tick_multi(self, rows: np.ndarray, last_active=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Run T packed ticks in one dispatch (one K3 launch on CUDA);
        returns (checksum_hi[T, W], checksum_lo[T, W]) as int32 tensors on
        the core's device holding the uint32 bit patterns, (0, 0) for
        slots that did not save. `last_active` is ignored (the reference's
        Pallas path ignores it too: the kernel's cost does not depend on
        which depth variant would cover the rows)."""
        return self.tick_core.tick_multi(self.carry, self.upload(rows))

    def tick_row(self, row: np.ndarray, last_active=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """One packed tick row as a 1-row dispatch; returns
        (checksum_hi[W], checksum_lo[W])."""
        his, los = self.tick_multi(np.asarray(row)[None, :])
        return his[0], los[0]

    def tick(self, do_load: bool, load_slot: int, inputs: np.ndarray, statuses: np.ndarray,
             save_slots: np.ndarray, advance_count: int,
             start_frame: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
        """Run one fused tick; returns (checksum_hi[W], checksum_lo[W]).
        `start_frame` feeds the device-verify history (slot i saves frame
        start_frame + i)."""
        return self.tick_row(self.pack_tick_row(do_load, load_slot, inputs, statuses,
                                                save_slots, advance_count, start_frame))

    def check_device_verdict(self) -> Tuple[bool, int]:
        """The device-verify latch: (mismatch?, first bad frame). One small
        readback."""
        if not self.device_verify:
            raise ContractViolation("core built without device_verify")
        mismatch, frame = self.carry["flag"].tolist()
        return bool(mismatch), int(frame)

    def reset(self) -> None:
        """Return the core to its initial condition: fresh world, zeroed
        ring and frame tags, an empty verify history."""
        ctx = self.ctx
        i32 = dict(dtype=torch.int32, device=self.device)
        state = pack_planes(ctx.adapter, self.game.init_state(self.device))
        carry = {
            "state": state,
            "state_frame": torch.zeros((), **i32),
            "ring": torch.zeros((self.ring_len + 1,) + tuple(state.shape), **i32),
            "r_frame": torch.zeros(self.ring_len + 1, **i32),
        }
        if self.device_verify:
            carry.update(
                h_tag=torch.full((self.ring_len,), -1, **i32),
                h_hi=torch.zeros(self.ring_len, **i32),
                h_lo=torch.zeros(self.ring_len, **i32),
                flag=torch.tensor([0, -1], **i32),
            )
        self.carry = carry

    def fetch_state(self) -> dict:
        """Device -> host copy of the live state in the reference's layout
        (frame, pos, vel, rot) as numpy."""
        return planes_to_reference(self.carry["state"], np.int32(int(self.carry["state_frame"])))

    def fetch_ring_slot(self, slot: int) -> dict:
        """One ring slot in the reference's layout as numpy."""
        return planes_to_reference(self.carry["ring"][slot], np.int32(int(self.carry["r_frame"][slot])))

