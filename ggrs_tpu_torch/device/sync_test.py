"""Fully-fused SyncTest on the device: the port of
`ggrs_tpu/tpu/sync_test.py` `TpuSyncTestSession`.

Each tick, once past `check_distance` d, loads the snapshot d frames back,
resimulates forward re-saving each frame, then saves and advances the new
frame. The checksum history records the FIRST checksum seen for a frame;
every later re-save is compared against it and the first disagreement
latches a mismatch flag and frame. Input delay follows the reference:
frame f plays the input submitted at f - delay, frames < delay play the
zero input. T ticks run per `advance_frames` call, on the device, and the
carry (`ggrs_tpu_torch.convert` documents its layout) is updated in place.

Backends:
  "cuda-fused"  K1, the whole-batch kernel (`fused_core`);
  "cuda-tiled"  K2, the entity-tiled kernel plus its verdict post-pass
                (`tiled_core`), as the reference's "pallas-tiled" with no
                mesh; for a game with a cross-entity reduction (arena),
                K2's inline whole-world route: every step reduces from the
                world entering it, giving the reference XLA scan's bits;
  "cuda-tiled-injected"
                arena's injected-reduction route, K5 + K2 one tick per
                launch + the verdict (`injected_core`): the single-device
                stand-in for the reference's "pallas-tiled" on a mesh
                (reduce injection) until `parallel/` is ported;
  "torch"       the plain PyTorch version of the reference's XLA scan
                (`plain_scan`: every step reduces inline);
  "auto"        on CUDA, the port's route for what the reference's
                `_pick_backend` answers on a TPU with no mesh
                (`pick_backend`); on the CPU, "torch".
A kernel backend given a CPU carry runs its plain version; on a CUDA
carry it launches its kernel or raises — it never falls back.
"""

from __future__ import annotations

import numpy as np
import torch

from ..convert import CARRY_KEYS, carry_from_reference, carry_to_reference
from ..errors import CheckpointIncompatible, ConfigError, MismatchedChecksum
from ..utils.checkpoint import load_device_checkpoint, save_device_checkpoint
from .fused_core import FusedSyncTestCore
from .injected_core import InjectedReduceCore
from .planes import VMEM_BUDGET_BYTES, PlaneContext, get_adapter, pack_planes, vmem_estimate
from .tiled_core import TiledSyncTestCore, plain_parts, plain_verdict

BACKENDS = ("auto", "torch", "cuda-fused", "cuda-tiled", "cuda-tiled-injected")


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU; a CUDA request on a host without CUDA raises ConfigError."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise ConfigError(
                "no CUDA device is available; pass device='cpu' to run the plain "
                "PyTorch version on the CPU"
            )
    elif dev.type != "cpu":
        raise ConfigError(f"unsupported device {dev}")
    return dev


# blocks of 128 entities per SM that arena's K1 is built to keep resident
# (csrc/synctest_fused.cu kArenaMinBlocksPerSm)
ARENA_FUSED_BLOCKS_PER_SM = 8


def pick_backend(game, check_distance: int, device: torch.device) -> str:
    """Resolve backend="auto" as the reference's `_pick_backend`
    (ggrs_tpu/tpu/sync_test.py:33-66) answers on a TPU with no mesh,
    mapped to the port's route that gives the same bits:

    - reference "pallas" (K1: inside the whole-batch estimate of 96 MB,
      128-aligned) -> "cuda-fused"; for arena, whose K1 needs its whole
      grid resident for its barriers, "cuda-tiled-injected" where it is
      not (its rolled table keeps the sums K1's cache keeps);
    - reference "pallas-tiled" (beyond the estimate, a tileable model:
      ex_game, swarm) -> "cuda-tiled";
    - reference "xla" (arena beyond the estimate, arena is not tileable;
      or a world that is not 128-aligned) -> for arena "cuda-tiled", the
      inline route, which reduces at every step as the XLA scan does; a
      per-entity model gives the same bits on every route and keeps K1
      inside the estimate and K2 beyond it.
    """
    if device.type != "cuda":
        return "torch"
    inside = vmem_estimate(game, check_distance) <= VMEM_BUDGET_BYTES
    if not get_adapter(game).reduce_len:
        return "cuda-fused" if inside else "cuda-tiled"
    if not inside or game.num_entities % 128:
        return "cuda-tiled"
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    if -(-game.num_entities // 128) > ARENA_FUSED_BLOCKS_PER_SM * sms:
        return "cuda-tiled-injected"
    return "cuda-fused"


def plain_scan(carry, inputs: torch.Tensor, ctx: PlaneContext) -> None:
    """T ticks in plain PyTorch as the reference's XLA scan runs them
    (`TpuSyncTestSession._tick`): every step reduces inline from the state
    entering it."""
    parts_hi, parts_lo = plain_parts(carry, inputs, ctx)
    plain_verdict(carry, parts_hi, parts_lo, ctx)


def initial_carry(ctx: PlaneContext):
    dev = ctx.device
    state = pack_planes(ctx.adapter, ctx.game.init_state(dev))
    i32 = dict(dtype=torch.int32, device=dev)
    return {
        "state": state,
        "ring": torch.zeros((ctx.ring_len,) + tuple(state.shape), **i32),
        "r_frame": torch.zeros(ctx.ring_len, **i32),
        "iring": torch.zeros((ctx.d + 2, ctx.num_players, ctx.input_size), **i32),
        "h_tag": torch.full((ctx.hist_len,), -1, **i32),
        "h_hi": torch.zeros(ctx.hist_len, **i32),
        "h_lo": torch.zeros(ctx.hist_len, **i32),
        "meta": torch.tensor([0, 0, -1], **i32),
    }


class DeviceSyncTestSession:
    def __init__(
        self,
        game,
        num_players: int,
        check_distance: int,
        input_delay: int = 0,
        backend: str = "auto",
        device="cuda",
    ):
        """The determinism verdict is read by explicit `check()` calls: the
        mismatch latch is durable on the device, so checking late loses
        nothing. `device`: "cuda" by default; the CPU only when asked for."""
        if check_distance < 1:
            raise ConfigError("check_distance must be >= 1")
        if backend not in BACKENDS:
            raise ConfigError(f"backend must be one of {BACKENDS}, got {backend!r}")
        self.device = resolve_device(device)
        if backend == "auto":
            backend = pick_backend(game, check_distance, self.device)
        self.backend = backend
        self.game = game
        self.num_players = num_players
        self.check_distance = check_distance
        self.input_delay = input_delay
        self.ctx = PlaneContext(game, num_players, check_distance, self.device)
        self.ring_len = self.ctx.ring_len
        self.hist_len = self.ctx.hist_len
        self.carry = initial_carry(self.ctx)
        if backend == "cuda-tiled-injected" and not self.ctx.reduce_len:
            raise ConfigError(f"{type(game).__name__} has no cross-entity reduction to inject")
        # the kernel wrapper (None for the plain backend)
        self.core = {
            "cuda-fused": FusedSyncTestCore,
            "cuda-tiled": TiledSyncTestCore,
            "cuda-tiled-injected": InjectedReduceCore,
        }.get(backend, lambda ctx: None)(self.ctx)
        self._raw_inputs: list = []  # host-side delay shift buffer
        self.current_frame = 0

    def advance_frames(self, raw_inputs: np.ndarray) -> None:
        """Advance T frames in one batch. raw_inputs: u8[T, P, input_size],
        the inputs submitted at each tick; input delay shifts which frame
        plays them."""
        t = raw_inputs.shape[0]
        start = self.current_frame
        if self.input_delay:
            self._raw_inputs.extend(np.asarray(raw_inputs, dtype=np.uint8))
            blank = np.zeros_like(self._raw_inputs[0])
            eff = np.stack(
                [
                    self._raw_inputs[f - self.input_delay] if f >= self.input_delay else blank
                    for f in range(start, start + t)
                ]
            )
        else:
            eff = np.asarray(raw_inputs, dtype=np.uint8)
        inputs = torch.from_numpy(eff.astype(np.int32)).to(self.device)
        if self.core is None:
            plain_scan(self.carry, inputs, self.ctx)
        elif isinstance(self.core, InjectedReduceCore):
            self.core.batch(self.carry, inputs, frame=start)
        else:
            self.core.batch(self.carry, inputs)
        self.current_frame += t

    def check(self) -> None:
        """Fetch the device verdict; raises MismatchedChecksum on divergence."""
        _, mismatch, frame = self.carry["meta"].tolist()
        if mismatch:
            raise MismatchedChecksum(frame)

    def state_numpy(self):
        """The live world in the reference's layout, as numpy."""
        return carry_to_reference(self.carry)["state"]

    def block_until_ready(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    # durable checkpoint/resume, in the reference's file format
    # ------------------------------------------------------------------

    def save(self, path: str) -> None:
        """Write the session to `path` (".npz" appended when missing) as
        the reference's `TpuSyncTestSession.save` writes it: the carry in
        the reference's layout and dtypes, and its meta, so the reference
        restores this file and this class restores the reference's."""
        meta = {
            "kind": "TpuSyncTestSession",
            "num_players": self.num_players,
            "check_distance": self.check_distance,
            "input_delay": self.input_delay,
            "current_frame": self.current_frame,
            "raw_inputs": [r.tolist() for r in self._raw_inputs],
        }
        save_device_checkpoint(path, carry_to_reference(self.carry), meta)

    @classmethod
    def restore(cls, path: str, game, backend: str = "auto", device="cuda") -> "DeviceSyncTestSession":
        """A session resumed from a checkpoint of either stack. The carry is
        the same on every route, so any backend may resume it. The
        injection route needs no re-arming, as the reference's core does
        on restore (ggrs_tpu/tpu/sync_test.py:408-412): `advance_frames`
        hands it the restored frame, from which it builds its table."""
        tree, meta = load_device_checkpoint(path)
        if meta.get("kind") != "TpuSyncTestSession":
            raise CheckpointIncompatible(f"checkpoint {path!r} is not a SyncTest session's",
                                         found=meta.get("kind"), expected="TpuSyncTestSession")
        sess = cls(game, meta["num_players"], meta["check_distance"], input_delay=meta["input_delay"],
                   backend=backend, device=device)
        carry = carry_from_reference(tree, sess.device)
        for k in CARRY_KEYS:
            if carry[k].shape != sess.carry[k].shape:
                raise CheckpointIncompatible(f"checkpoint {path!r} holds {k} of another shape than this game's",
                                             found=list(carry[k].shape), expected=list(sess.carry[k].shape))
        sess.carry = carry
        sess.current_frame = meta["current_frame"]
        sess._raw_inputs = [np.asarray(r, dtype=np.uint8) for r in meta["raw_inputs"]]
        return sess
