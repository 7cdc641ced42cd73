"""K3: ResimCore's packed control-word tick kernel and its plain PyTorch
version.

The port's counterpart of `ggrs_tpu/tpu/pallas_resim.py` `PallasTickCore`:
ONE launch runs T packed tick rows (the layout `ResimCore.pack_tick_row`
builds) on a `ResimCore` carry in place and returns the per-slot checksums
his/los [T, W] (int32 tensors holding the uint32 bit patterns, (0, 0) for
skipped saves) — `csrc/resim_tick.cu`, with one body per model, chosen by
`launch.ENTRIES`: ex_game's and swarm's (one template, `resim_tick_launch`
and `resim_tick_swarm_launch`) and arena's (`resim_tick_arena_launch`, a
whole-world reduction and a grid barrier before every advance).

`plain_tick_multi` is the same dispatch in plain PyTorch with the
semantics of the reference's `ResimCore._tick_impl` (ggrs_tpu/tpu/resim.py
:762-828) row after row, plus `_verify_update` (:736): the state carries
its own frame, a load takes the slot's frame, each save snapshots the
pre-advance state and checksums it with that frame. It is what a CPU
carry runs, what the tests hold against the reference, and what
`chip_smoke.py` holds the kernel against on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from ..errors import ConfigError
from ..kernels import build, launch
from ..ops import fixed_point as fx
from .planes import partial_checksum_planes

VERIFY_KEYS = ("h_tag", "h_hi", "h_lo", "flag")


def check_rows(rows: np.ndarray, core) -> None:
    """Reject control words no session emits and the kernel must not index
    with: the row width, a load slot outside the ring, an advance count
    outside 0..W, a negative save slot (slots >= ring_len mean no save)."""
    if rows.ndim != 2 or rows.shape[1] != core.packed_len or rows.dtype != np.int32:
        raise ConfigError(
            f"tick rows must be int32 [T, {core.packed_len}], got {rows.dtype} {rows.shape}"
        )
    loads = rows[:, 0] != 0
    if (loads & ((rows[:, 1] < 0) | (rows[:, 1] > core.ring_len))).any():
        raise ConfigError("a tick row loads a slot outside the ring")
    if ((rows[:, 2] < 0) | (rows[:, 2] > core.window)).any():
        raise ConfigError(f"a tick row advances outside 0..{core.window}")
    if (rows[:, core.off_save : core.off_status] < 0).any():
        raise ConfigError("a tick row saves to a negative slot")


def plain_tick_multi(carry, rows: torch.Tensor, core):
    """T packed tick rows on the carry in place, in plain PyTorch; returns
    (his, los) int32 [T, W]. The entity work runs on the carry's device;
    the frames, ring-frame tags and the history are host integers, and the
    saves' checksum parts come back in one readback at the end."""
    ctx = core.ctx
    W, R, P, I = core.window, core.ring_len, core.num_players, ctx.input_size
    device = carry["state"].device
    rows_l = rows.tolist()
    ring = carry["ring"]
    r_frame = carry["r_frame"].tolist()
    state = carry["state"]
    frame = int(carry["state_frame"])
    saves = []  # (t, i, state frame, verify frame, (hi part, lo part))
    for t, row in enumerate(rows_l):
        do_load, load_slot, advance_count, start_frame = row[:4]
        if do_load:
            state = ring[load_slot].clone()
            frame = r_frame[load_slot]
        for i in range(W):
            slot = row[core.off_save + i]
            if slot < R:
                ring[slot] = state
                r_frame[slot] = frame
                saves.append((t, i, frame, start_frame + i, partial_checksum_planes(state, ctx.weights)))
            if i < advance_count:
                s = core.off_status + i * P
                x = core.off_input + i * P * I
                inputs = torch.tensor(row[x : x + P * I], dtype=torch.int32, device=device)
                statuses = torch.tensor(row[s : s + P], dtype=torch.int32, device=device)
                state = ctx.adapter.step(state, inputs.reshape(P, I), ctx.owner, statuses)
                frame += 1
    carry["state"].copy_(state)
    carry["state_frame"].fill_(frame)
    carry["r_frame"].copy_(torch.tensor(r_frame, dtype=torch.int32))

    m, fw = fx.MASK32, ctx.cs_frame_weight & fx.MASK32
    his = [[0] * W for _ in rows_l]
    los = [[0] * W for _ in rows_l]
    parts = torch.stack([torch.stack(p) for *_, p in saves]).tolist() if saves else []
    hist = None
    if core.device_verify:
        hist = {k: carry[k].tolist() for k in VERIFY_KEYS}
    for (t, i, f, vf, _), (hp, lp) in zip(saves, parts):
        hi, lo = (hp + f * fw) & m, (lp + f) & m
        his[t][i], los[t][i] = fx.to_i32(hi), fx.to_i32(lo)
        if hist is not None:
            verify_update(hist, vf, hi, lo, R)
    if hist is not None:
        for k, v in hist.items():
            carry[k].copy_(torch.tensor(v, dtype=torch.int32))

    def out(v):
        return torch.tensor(v, dtype=torch.int32, device=device)

    return out(his), out(los)


def verify_update(hist, frame: int, hi: int, lo: int, hist_len: int) -> None:
    """The first-seen history record/compare and mismatch latch on host
    lists (h_hi/h_lo as int32 bit patterns; hi/lo as uint32 values)."""
    h = frame % hist_len
    m = fx.MASK32
    seen = hist["h_tag"][h] == frame
    if seen and (hist["h_hi"][h] & m != hi or hist["h_lo"][h] & m != lo):
        if hist["flag"][0] == 0:
            hist["flag"][1] = frame
        hist["flag"][0] = 1
    hist["h_tag"][h] = frame
    if not seen:
        hist["h_hi"][h], hist["h_lo"][h] = fx.to_i32(hi), fx.to_i32(lo)


class TickCore:
    """K3's wrapper for one ResimCore; counts its launches in `launches`.
    On a CPU carry it runs `plain_tick_multi`; on a CUDA carry it launches
    the kernel or raises — there is no fallback."""

    kernel = "resim_tick"

    def __init__(self, core):
        self.core = core
        self.launches = 0

    def tick_multi(self, carry, rows: torch.Tensor):
        """T rows (int32 [T, L] on the carry's device) in place; returns
        (his, los) int32 [T, W]."""
        if carry["state"].device.type == "cpu":
            return plain_tick_multi(carry, rows, self.core)
        core, ctx = self.core, self.core.ctx
        entry = launch.require_adapter(ctx, self.kernel)
        device = carry["state"].device
        n, W, t_rows = ctx.n, core.window, rows.shape[0]
        shapes = dict(
            state=(carry["state"], (ctx.n_planes, n)),
            state_frame=(carry["state_frame"], ()),
            ring=(carry["ring"], (core.ring_len + 1, ctx.n_planes, n)),
            r_frame=(carry["r_frame"], (core.ring_len + 1,)),
            rows=(rows, (t_rows, core.packed_len)),
        )
        if core.device_verify:
            shapes.update(
                {k: (carry[k], (core.ring_len,)) for k in ("h_tag", "h_hi", "h_lo")},
                flag=(carry["flag"], (2,)),
            )
        launch.check_tensors(device, **shapes)
        if t_rows < 1:
            raise ConfigError("a tick dispatch needs at least one row")
        lib = build.load(self.kernel)
        P, I = launch.P, launch.I
        his = torch.empty((t_rows, W), dtype=torch.int32, device=device)
        los = torch.empty((t_rows, W), dtype=torch.int32, device=device)
        verify = [carry[k].data_ptr() if core.device_verify else None for k in VERIFY_KEYS]
        ptrs = (carry["state"].data_ptr(), carry["state_frame"].data_ptr(), carry["ring"].data_ptr(),
                carry["r_frame"].data_ptr(), *verify, rows.data_ptr(), his.data_ptr(), los.data_ptr())
        disconnect = launch.disconnect_arg(core.disconnect_input)
        if entry.reduces:
            fn = launch.declare(lib, entry.symbol, [P] * 12 + [I] * 5 + [P, P, P])
            # parts_hi [T*W], parts_lo [T*W], the ticket, the grid barrier [2]
            # and one raw reduction row [3P] per (row, slot)
            scratch = torch.empty(2 * t_rows * W + 3 + t_rows * W * ctx.reduce_len,
                                  dtype=torch.int32, device=device)
            rc = fn(*ptrs, scratch.data_ptr(), n, core.num_players, ctx.input_size, W, t_rows,
                    disconnect, launch.weights_arg(ctx), launch.stream_of(device))
            launch.raise_cooperative(rc, self.kernel)
        else:
            extra = launch.model_ints(entry, ctx)
            fn = launch.declare(lib, entry.symbol, [P] * 12 + [I] * (5 + len(extra)) + [P, P, P])
            # parts_hi [T*W], parts_lo [T*W] and the last-block ticket
            scratch = torch.empty(2 * t_rows * W + 1, dtype=torch.int32, device=device)
            rc = fn(*ptrs, scratch.data_ptr(), n, core.num_players, ctx.input_size, W, t_rows, *extra,
                    disconnect, launch.weights_arg(ctx), launch.stream_of(device))
            launch.raise_on(rc, self.kernel)
        self.launches += 1
        return his, los
