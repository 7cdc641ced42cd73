"""What every kernel wrapper does around a launch: pick the model's entry
point (`ENTRIES`), stage host control data on the device, validate the
tensors it hands to C, pass pointers and PyTorch's current stream, and turn
a nonzero CUDA error into `KernelError`."""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ..device.planes import ArenaPlanes, ExGamePlanes, SwarmPlanes
from ..errors import ConfigError, KernelError

P = ctypes.c_void_p
I = ctypes.c_int


def declare(lib: ctypes.CDLL, fn: str, argtypes):
    """The library function `fn`, its argtypes/restype set once (pointers
    and the stream as c_void_p, or ctypes would cut them to 32 bits)."""
    f = getattr(lib, fn)
    if f.argtypes is None:
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    return f


def check_tensors(device: torch.device, **tensors) -> None:
    for name, (t, shape) in tensors.items():
        if t.device != device:
            raise ConfigError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != torch.int32:
            raise ConfigError(f"{name} has dtype {t.dtype}, expected torch.int32")
        if tuple(t.shape) != tuple(shape):
            raise ConfigError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ConfigError(f"{name} is not contiguous")


def check_carry(carry, ctx, inputs: torch.Tensor) -> None:
    """The carry layout and the batch inputs every SyncTest kernel takes."""
    n, np_, d = ctx.n, ctx.n_planes, ctx.d
    device = carry["state"].device
    if not 1 <= d <= 512:
        raise ConfigError(f"check_distance {d} outside the kernels' range 1..512")
    check_tensors(
        device,
        state=(carry["state"], (np_, n)),
        ring=(carry["ring"], (ctx.ring_len, np_, n)),
        r_frame=(carry["r_frame"], (ctx.ring_len,)),
        iring=(carry["iring"], (d + 2, ctx.num_players, ctx.input_size)),
        h_tag=(carry["h_tag"], (ctx.hist_len,)),
        h_hi=(carry["h_hi"], (ctx.hist_len,)),
        h_lo=(carry["h_lo"], (ctx.hist_len,)),
        meta=(carry["meta"], (3,)),
        inputs=(inputs, (inputs.shape[0], ctx.num_players, ctx.input_size)),
    )


class Entry(NamedTuple):
    """One model's body in a kernel library."""

    symbol: str  # the library's entry point
    substeps: bool  # it takes the game's substeps after the shape ints (ex_game only)
    reduces: bool  # arena's body: a cross-entity reduction, cooperative grid barriers
    # K3's megabatch entry for MultiSessionDeviceCore (rows on slots of the
    # stacked worlds); None: the megabatch runs `symbol` once a row
    stacked: Optional[str] = None


# THE one choice of a kernel body: by the plane adapter's class, never by
# `ctx.reduce_len` (a per-entity model's carry must never reach another
# model's body: ex_game's would read swarm's 7 planes as 5 with no error)
ENTRIES: Dict[str, Dict[type, Entry]] = {
    "synctest_fused": {
        ExGamePlanes: Entry("synctest_fused_launch", True, False),
        SwarmPlanes: Entry("synctest_fused_swarm_launch", False, False),
        ArenaPlanes: Entry("synctest_fused_arena_launch", False, True),
    },
    "synctest_tiled": {
        ExGamePlanes: Entry("synctest_tiled_launch", True, False),
        SwarmPlanes: Entry("synctest_tiled_swarm_launch", False, False),
        # arena: the injection route's one-launch tick on a table
        ArenaPlanes: Entry("synctest_tiled_arena_launch", False, True),
    },
    # K2's inline whole-world route, in the synctest_tiled library: arena only
    "synctest_tiled_inline": {ArenaPlanes: Entry("synctest_tiled_inline_arena_launch", False, True)},
    "resim_tick": {
        ExGamePlanes: Entry("resim_tick_launch", True, False, "resim_tick_stacked_launch"),
        SwarmPlanes: Entry("resim_tick_swarm_launch", False, False, "resim_tick_swarm_stacked_launch"),
        ArenaPlanes: Entry("resim_tick_arena_launch", False, True),
    },
    "beam_rollout": {
        ExGamePlanes: Entry("beam_rollout_launch", True, False),
        SwarmPlanes: Entry("beam_rollout_swarm_launch", False, False),
        ArenaPlanes: Entry("beam_rollout_arena_launch", False, True),
    },
    "reduce_table": {ArenaPlanes: Entry("reduce_table_launch", False, True)},
}


def require_adapter(ctx, kernel: str) -> Entry:
    """The entry point of `kernel` for the context's model; a model the
    library has no body for raises ConfigError."""
    entry = ENTRIES[kernel].get(type(ctx.adapter))
    if entry is None:
        raise ConfigError(
            f"{kernel} has no body for {type(ctx.adapter).__name__}: "
            "that game is not ported to this kernel"
        )
    return entry


def model_ints(entry: Entry, ctx) -> tuple:
    """The ints a body takes after the shape ints: ex_game's substeps."""
    return (ctx.game.substeps,) if entry.substeps else ()


def weights_arg(ctx):
    """The 2K+1 checksum ints the kernels take for K planes: w[K], base[K],
    frame weight (11 for ex_game, 13 for arena, 15 for swarm)."""
    vals = [w for _, w, _ in ctx.cs_entries] + [b for _, _, b in ctx.cs_entries]
    return (ctypes.c_int * (len(vals) + 1))(*vals, ctx.cs_frame_weight)


def disconnect_arg(row):
    """The game's disconnect input row (I ints) as the C array the tick and
    beam kernels substitute for a DISCONNECTED player's inputs."""
    return (ctypes.c_int * len(row))(*row)


NOT_CO_RESIDENT = -1  # csrc/arena_reduce.cuh kNotCoResident


def raise_cooperative(rc: int, kernel: str) -> None:
    """A cooperative (grid-barrier) launch's return code: not one block
    resident, or a CUDA error, raises `KernelError`."""
    if rc == NOT_CO_RESIDENT:
        raise KernelError(f"{kernel}: not one block of its cooperative grid can be resident on this card")
    raise_on(rc, kernel)


def stage(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array -> `device`: as it is for the CPU; for CUDA an
    asynchronous copy from a FRESH pinned buffer (PyTorch's pinned-memory
    allocator hands a block out again only after the copy that read it has
    finished, so the caller may refill its array at once)."""
    if device.type == "cpu":
        return torch.from_numpy(arr)
    staged = torch.empty(arr.shape, dtype=torch.from_numpy(arr[:0]).dtype, pin_memory=True)
    staged.numpy()[...] = arr
    return staged.to(device, non_blocking=True)


def stream_of(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def raise_on(rc: int, kernel: str) -> None:
    if rc != 0:
        raise KernelError(f"{kernel}: CUDA error {rc} at launch")
