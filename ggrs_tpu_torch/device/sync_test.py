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
                (`tiled_core`); for a game with a cross-entity reduction
                (arena), the injected-reduction route, K5 + K2 one tick
                per launch + the verdict (`injected_core`);
  "torch"       the plain PyTorch version of the reference's XLA scan
                (`plain_scan`: every step reduces inline);
  "auto"        on CUDA, K1 while the reference's VMEM estimate of the
                configuration stays within 96 MB (and, for arena, while
                K1's grid can be resident on the card for its grid
                barriers), K2 beyond, as the reference chooses on a TPU.
                Beyond the envelope the reference answers arena with its
                XLA scan; the port keeps its plain version off the card,
                so it takes the injected-reduction kernel route there.
                On the CPU, "torch".
A kernel backend given a CPU carry runs its plain version; on a CUDA
carry it launches its kernel or raises — it never falls back.
"""

from __future__ import annotations

import numpy as np
import torch

from ..convert import carry_to_reference
from ..errors import ConfigError, MismatchedChecksum
from .fused_core import FusedSyncTestCore
from .injected_core import InjectedReduceCore
from .planes import VMEM_BUDGET_BYTES, PlaneContext, get_adapter, pack_planes, vmem_estimate
from .tiled_core import TiledSyncTestCore, plain_parts, plain_verdict

BACKENDS = ("auto", "torch", "cuda-fused", "cuda-tiled")


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
    """Resolve backend="auto": K1 inside the reference's whole-batch VMEM
    envelope, K2 beyond it (ex_game and swarm are per-entity independent,
    so K2 takes any world size; arena takes it with injected reductions).
    Arena's K1 also needs its whole grid resident at once."""
    if device.type != "cuda":
        return "torch"
    if vmem_estimate(game, check_distance) > VMEM_BUDGET_BYTES:
        return "cuda-tiled"
    if get_adapter(game).reduce_len:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        if -(-game.num_entities // 128) > ARENA_FUSED_BLOCKS_PER_SM * sms:
            return "cuda-tiled"
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
        # the kernel wrapper (None for the plain backend)
        tiled = InjectedReduceCore if self.ctx.reduce_len else TiledSyncTestCore
        self.core = {"cuda-fused": FusedSyncTestCore, "cuda-tiled": tiled}.get(
            backend, lambda ctx: None
        )(self.ctx)
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
