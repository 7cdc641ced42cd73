"""The device snapshot ring and the packed control-word tick: the port of
`ggrs_tpu/tpu/resim.py` `ResimCore`, tick family only.

One tick is an optional ring load, then W = max_prediction + 2 fused
(save?, advance?) slots driven by ONE packed control-word row — 4 header
words (do_load, load_slot, advance_count, start_frame), then
save_slots[W], statuses[W*P], inputs[W*P*I] — byte for byte the
reference's layout (`pack_tick_row`). A save slot of `ring_len` (the
scratch slot) means "no save". The carry is packed SoA planes (K of
them: px, py, vx, vy, rot for ex_game; px, py, vx, vy, hp, energy for
arena; px, py, pz, vx, vy, vz, charge for swarm), updated in place by
every dispatch:

    state       i32[K, N]           the live world
    state_frame i32[]               the live world's own frame
    ring        i32[ring_len+1, K, N]  the last slot is the scratch slot
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
it, as the reference's Pallas path does.

The speculative beam: `speculate` rolls B candidate input scripts out of
one ring slot (one launch of K4, `beam_core.BeamRollout`), and `adopt`
fulfils a rollback tick from a (prefix-)matching member — the reference's
`_adopt_impl`/`_adopt_full_impl`. The served slots are plain data
movement (ring slots and frame tags gathered from the trajectory, the
speculation's checksums, the device-verify history updated as tensor ops
with no host readback); a mispredicted suffix runs as one K3 row from the
member's state at the last matched frame, never as a plain step on a card.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..convert import planes_to_reference, resim_from_reference, resim_to_reference
from ..errors import CheckpointIncompatible, ConfigError, ContractViolation
from ..kernels import launch
from .beam_core import BeamRollout, Speculation
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
        # the whole row (arena's second byte is its throttle): the kernels
        # substitute every byte of a DISCONNECTED player's input
        self.disconnect_input = tuple(game.disconnect_input)
        p, i = num_players, game.input_size
        self.off_save = 4
        self.off_status = self.off_save + self.window
        self.off_input = self.off_status + self.window * p
        self.packed_len = self.off_input + self.window * p * i
        # the adopt row: 6 header words (member, load_slot, advance_count,
        # shift, load_frame, matched), then the tick row's three blocks
        self.aoff_save = 6
        self.aoff_status = self.aoff_save + self.window
        self.aoff_input = self.aoff_status + self.window * p
        self.apacked_len = self.aoff_input + self.window * p * i
        self.tick_core = TickCore(self)
        self.beam_rollout = BeamRollout(self.ctx, self.disconnect_input, self.window)
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

    def upload(self, rows) -> torch.Tensor:
        """Host rows -> the device, checked first. A numpy array goes
        through `launch.stage` (on CUDA asynchronous from a fresh pinned
        buffer, so repacking the next tick can never race an upload still
        in flight); an int32 host tensor (the async pipeline's pooled
        pinned buffer, whose reuse the fence makes safe) is copied without
        waiting."""
        if isinstance(rows, torch.Tensor):
            check_rows(rows.numpy(), self)
            return rows if self.device.type == "cpu" else rows.to(self.device, non_blocking=True)
        rows = np.ascontiguousarray(rows, dtype=np.int32)
        check_rows(rows, self)
        return launch.stage(rows, self.device)

    def tick_multi(self, rows, last_active=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Run T packed ticks (numpy or an int32 host tensor, `upload`) in
        one dispatch (one K3 launch on CUDA);
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

    # ------------------------------------------------------------------
    # the speculative beam

    def speculate(self, anchor_slot: int, beam_inputs: np.ndarray,
                  beam_statuses: np.ndarray) -> Speculation:
        """Roll B candidate futures out of ring slot `anchor_slot`:
        beam_inputs u8[B, L, P, I], beam_statuses i32[B, L, P] (L at most
        the window). Asynchronous on CUDA (one K4 launch); the result holds
        the trajectory [B, L, K, N] (frames anchor + 1 + l), its checksums
        [B, L], the anchor's checksum and the anchor's frame tag."""
        if not 0 <= anchor_slot < self.ring_len:
            raise ConfigError(f"anchor slot {anchor_slot} outside the ring (0..{self.ring_len - 1})")
        br = self.beam_rollout
        return br.rollout(self.carry["ring"], self.carry["r_frame"], anchor_slot,
                          br.script(beam_inputs, beam_statuses))

    def pack_adopt_row(self, member: int, load_slot: int, advance_count: int, shift: int,
                       load_frame: int, matched: int, save_slots: np.ndarray,
                       statuses: Optional[np.ndarray] = None,
                       inputs: Optional[np.ndarray] = None) -> np.ndarray:
        """One adoption's packed control words, the reference's adopt layout
        (`ResimCore.pack_adopt_row`): member, load_slot, advance_count,
        shift, load_frame, matched, then save_slots[W], statuses[W*P],
        inputs[W*P*I] (the suffix's rows)."""
        packed = np.zeros((self.apacked_len,), dtype=np.int32)
        packed[:6] = (member, load_slot, advance_count, shift, load_frame, matched)
        packed[self.aoff_save : self.aoff_status] = save_slots
        if statuses is not None:
            packed[self.aoff_status : self.aoff_input] = np.asarray(statuses).reshape(-1)
        if inputs is not None:
            packed[self.aoff_input :] = np.asarray(inputs).reshape(-1)
        return packed

    def adopt(self, spec: Speculation, member: int, load_slot: int, save_slots: np.ndarray,
              advance_count: int, shift: int = 0, load_frame: int = 0,
              inputs: Optional[np.ndarray] = None, statuses: Optional[np.ndarray] = None,
              matched: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Fulfil a rollback tick from a (prefix-)matching speculation;
        returns (checksum_hi[W], checksum_lo[W]) like tick(). `shift` =
        load_frame - anchor frame (the caller guarantees the member's first
        `shift` rows are the inputs played between anchor and load);
        `matched` (default advance_count, the full hit) is how many
        corrected frames the member's rows cover. Slot i <= matched enters
        on trajectory index shift + i - 1 (the loaded slot itself at -1);
        served saves take the speculation's checksums. A full hit serves
        slots 0..advance_count, the trailing save included, and runs no
        kernel; a partial hit serves 0..matched-1 and resimulates the rest
        as ONE K3 row from the member's state at frame load + matched —
        bit-equal to the reference's `_adopt_impl` and `_adopt_full_impl`
        (ggrs_tpu/tpu/resim.py:1036-1232)."""
        W, R = self.window, self.ring_len
        if matched is None:
            matched = advance_count
        save_slots = np.asarray(save_slots)
        B, L = spec.his.shape
        full = matched == advance_count
        if not 1 <= matched <= advance_count or not 0 <= member < B or shift < 0 or shift + matched > L:
            raise ContractViolation(
                f"adopt of member {member}/{B}, shift {shift}, {matched}/{advance_count} frames "
                f"matched does not fit a {L}-step speculation"
            )
        if not full and inputs is None:
            raise ContractViolation("partial adoption needs the corrected inputs for the suffix")
        if full and (save_slots[advance_count + 1 :] < R).any():
            # the speculation's checksums cover frames up to load + matched
            # only: a real save past advance_count would get a checksum the
            # speculation never computed
            raise ContractViolation(
                "full-hit adoption requires every save slot past advance_count to be scratch"
            )
        row = self.pack_adopt_row(member, load_slot, advance_count, shift, load_frame, matched,
                                  save_slots, statuses=statuses, inputs=inputs)
        served = [i for i in range(matched + 1 if full else matched) if save_slots[i] < R]
        his, los = self._serve(spec, row, served)
        # the live state: the member's state at frame load + matched
        c = self.carry
        c["state"].copy_(spec.traj[member, shift + matched - 1])
        c["state_frame"].copy_(spec.frame + (shift + matched))
        if full:
            return his, los
        # the mispredicted suffix: one K3 row, no load, slots shifted down
        # by `matched` (its slot 0 recomputes the checksum of the state just
        # set — the same function of the same state and frame as the
        # speculation's)
        tick = np.empty((self.packed_len,), dtype=np.int32)
        P, I = self.num_players, self.game.input_size
        rest = W - matched
        suffix_saves = np.full((W,), self.scratch_slot, dtype=np.int32)
        suffix_saves[:rest] = row[self.aoff_save + matched : self.aoff_status]
        suffix_status = np.zeros((W * P,), dtype=np.int32)
        suffix_status[: rest * P] = row[self.aoff_status + matched * P : self.aoff_input]
        suffix_inputs = np.zeros((W * P * I,), dtype=np.int32)
        suffix_inputs[: rest * P * I] = row[self.aoff_input + matched * P * I :]
        self.pack_tick_row_into(tick, False, 0, suffix_inputs, suffix_status, suffix_saves,
                                advance_count - matched, load_frame + matched)
        k_his, k_los = self.tick_row(tick)
        return torch.cat([his[:matched], k_his[:rest]]), torch.cat([los[:matched], k_los[:rest]])

    def _serve(self, spec: Speculation, row: np.ndarray, served) -> Tuple[torch.Tensor, torch.Tensor]:
        """The served slots' saves as data movement: ring slot and frame tag
        from the trajectory (the loaded slot for index -1), the
        speculation's checksums into his/los [W], and the device-verify
        history, all as tensor ops on the core's device (one upload of the
        slot plan, no readback)."""
        c, R, W = self.carry, self.ring_len, self.window
        member, load_slot, shift, load_frame = int(row[0]), int(row[1]), int(row[3]), int(row[4])
        device = c["ring"].device
        his = torch.zeros(W, dtype=torch.int32, device=device)
        los = torch.zeros(W, dtype=torch.int32, device=device)
        if not served:
            return his, los
        slots = row[self.aoff_save : self.aoff_status]
        idx = np.array(served, dtype=np.int64)
        # plan rows (index_copy_ takes int64): slot position i, trajectory
        # index shift + i - 1, ring slot
        plan = launch.stage(np.stack([idx, shift + idx - 1, slots[idx]]).astype(np.int64), self.device)
        # the anchor snapshot itself (shift 0, slot 0) first: the reference
        # reads the loaded slot before any served write
        anchor = int(shift == 0 and served[0] == 0)
        if anchor:
            dst = int(slots[0])
            c["ring"][dst].copy_(c["ring"][load_slot])
            c["r_frame"][dst : dst + 1].copy_(c["r_frame"][load_slot : load_slot + 1])
        pos, src, dst = plan[0, anchor:], plan[1, anchor:], plan[2, anchor:]
        hi = spec.his[member].index_select(0, src)
        lo = spec.los[member].index_select(0, src)
        if len(served) > anchor:
            c["ring"].index_copy_(0, dst, spec.traj[member].index_select(0, src))
            c["r_frame"].index_copy_(0, dst, (spec.frame + 1 + src).to(torch.int32))
        if anchor:
            hi = torch.cat([spec.a_hi.reshape(1), hi])
            lo = torch.cat([spec.a_lo.reshape(1), lo])
        his.index_copy_(0, plan[0], hi)
        los.index_copy_(0, plan[0], lo)
        if self.device_verify:
            self._verify_served((load_frame + plan[0]).to(torch.int32), hi, lo)
        return his, los

    def _verify_served(self, frames: torch.Tensor, hi: torch.Tensor, lo: torch.Tensor) -> None:
        """The first-seen history update (`tick_core.verify_update`) for
        the served saves in slot order, as tensor ops. One adoption's frames
        are distinct modulo ring_len, so every history cell is touched at
        most once and the latch takes the first differing frame."""
        c = self.carry
        h = (frames % self.ring_len).to(torch.int64)
        tag, h_hi, h_lo = c["h_tag"][h], c["h_hi"][h], c["h_lo"][h]
        seen = tag == frames
        differs = seen & ((h_hi != hi) | (h_lo != lo))
        hit = differs.any()
        # gathered, not indexed with a 0-dim tensor (that reads it on the host)
        first = frames.index_select(0, differs.to(torch.int32).argmax().reshape(1)).reshape(())
        flag = c["flag"]
        opened = flag[0] == 0
        flag[1] = torch.where(hit & opened, first, flag[1])
        flag[0] = torch.where(hit, torch.ones_like(flag[0]), flag[0])
        c["h_tag"].index_copy_(0, h, frames)
        c["h_hi"].index_copy_(0, h, torch.where(seen, h_hi, hi))
        c["h_lo"].index_copy_(0, h, torch.where(seen, h_lo, lo))

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

    def checkpoint_tree(self) -> dict:
        """The carry as the reference's `TpuRollbackBackend.save` writes its
        core: {"ring", "state"} in the reference's layout and dtypes, and
        "verify" with device verification."""
        tree = resim_to_reference(self)
        if not self.device_verify:
            del tree["verify"]
        return tree

    def load_checkpoint_tree(self, tree: dict, source: str = "checkpoint") -> None:
        """Replace the carry with a checkpoint_tree of either stack; a tree
        of another world or ring raises CheckpointIncompatible."""
        carry = resim_from_reference(tree["ring"], tree["state"], tree.get("verify", {}) if self.device_verify else {},
                                     self.device)
        for k, v in self.carry.items():
            got = carry.get(k)
            if got is None or got.shape != v.shape:
                raise CheckpointIncompatible(f"{source} holds {k} of another shape than this core's",
                                             found=None if got is None else list(got.shape), expected=list(v.shape))
        self.carry = carry

    def fetch_state(self) -> dict:
        """Device -> host copy of the live state in the reference's layout
        (frame and the game's leaves) as numpy."""
        return planes_to_reference(self.carry["state"], np.int32(int(self.carry["state_frame"])))

    def fetch_ring_slot(self, slot: int) -> dict:
        """One ring slot in the reference's layout as numpy."""
        return planes_to_reference(self.carry["ring"][slot], np.int32(int(self.carry["r_frame"][slot])))

