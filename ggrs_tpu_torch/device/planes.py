"""The plane scaffold shared by the SyncTest kernels and their plain
versions: the counterpart of the model-generic part of
`ggrs_tpu/tpu/pallas_core.py`.

A world is kept as packed SoA planes, one int32 tensor `[n_planes, N]`
(for ex_game: px, py, vx, vy, rot; for arena: px, py, vx, vy, hp,
energy; for swarm: px, py, pz, vx, vy, vz, charge), and the snapshot ring as
`[ring_len, n_planes, N]`, so a CUDA thread that owns entity e reads each
plane at a coalesced address. The reference packs to `[N/128, 128]` TPU
tiles instead; the port needs no 128-alignment.

Checksum weights are derived once from the game's `checksum_keys`
(`derive_checksum_weights`), exactly as the reference derives them, and
handed both to the plain torch checksum (`weight_planes`) and, as 2K+1
integers for K planes, to the CUDA kernels — one derivation, so kernel and plain
version cannot disagree.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch

from ..errors import ConfigError, RegistryMiss
from ..models import arena, ex_game, swarm
from ..ops import fixed_point as fx

# The reference's VMEM envelope: backend="auto" picks the whole-batch
# kernel while `vmem_estimate` stays inside it, the entity-tiled one beyond.
VMEM_BUDGET_BYTES = 96 * 1024 * 1024


class PlaneAdapter:
    """A game on packed planes. `planes` lists (plane name, state key,
    component) in the order of the game's `checksum_keys`, which is what
    lets the checksum weights be derived generically; `reduce_len` is the
    number of cross-entity int32 sums the step consumes (0: none)."""

    planes: Tuple[Tuple[str, str, object], ...] = ()
    reduce_len = 0

    def __init__(self, game):
        self.game = game
        keys_in_order = []
        for _, key, _ in self.planes:
            if key not in keys_in_order:
                keys_in_order.append(key)
        assert tuple(keys_in_order) == tuple(game.checksum_keys), (
            f"plane order {keys_in_order} must follow checksum_keys {game.checksum_keys}"
        )


class ExGamePlanes(PlaneAdapter):
    """`ggrs_tpu_torch.models.ex_game` on packed planes. Its step is per-entity
    independent and its checksum a per-entity weighted modular sum, which is
    what lets the entity-tiled kernel (K2) run it at any world size."""

    planes = (
        ("px", "pos", 0), ("py", "pos", 1),
        ("vx", "vel", 0), ("vy", "vel", 1),
        ("rot", "rot", None),
    )

    def step(self, planes: torch.Tensor, player_inputs: torch.Tensor, owner: torch.Tensor,
             statuses=None, red=None) -> torch.Tensor:
        """One frame on `[5, N]` planes. `player_inputs`: int32 [P,
        input_size]; `statuses`: int32 [P], a DISCONNECTED player's input
        row replaced by the game's disconnect input (the request path's
        tick), or None for all CONFIRMED (the fused SyncTest's only case).
        With a leading member axis — planes `[5, B, N]`, inputs
        `[B, P, input_size]`, statuses `[B, P]` — it steps B worlds at once
        (the beam rollout's plain version). `red` is unused: the step
        reduces nothing."""
        inp = ex_game.entity_inputs(player_inputs, statuses, owner)
        out = tuple(planes.unbind(0))
        for _ in range(self.game.substeps):
            out = ex_game.substep_planes(*out, inp)
        return torch.stack(out)


class ArenaPlanes(PlaneAdapter):
    """`ggrs_tpu_torch.models.arena` on packed planes (the reference's
    `ArenaPlanes`, pallas_core.py:280). The step needs, per team, the count
    of living entities and their centroid: the contract's reduction phase.
    `reduce_partial` gives the raw sums (they commute across entity tiles,
    so kernels may accumulate them in any order), `reduce_finalize` the
    exact-division post-math, and `step` takes the finalized values as
    `red=` — or reduces inline from the planes it is given when `red` is
    None (whole-world visibility)."""

    planes = (
        ("px", "pos", 0), ("py", "pos", 1),
        ("vx", "vel", 0), ("vy", "vel", 1),
        ("hp", "hp", None), ("energy", "energy", None),
    )

    def __init__(self, game):
        super().__init__(game)
        # the reference's envelope (pallas_core.py:300-317): the centroid
        # divisor, a team's live count, stays below 2^16 and the centroid
        # sums below 2^30, so no int32 sum wraps
        per_team = -(-game.num_entities // game.num_players)
        if per_team >= 1 << 16:
            raise ConfigError(
                f"arena: {per_team} entities per team exceeds the exact-division "
                "envelope (a team's live count must stay below 2^16); use more players"
            )
        if per_team * (arena.ARENA_MASK >> arena.CENTROID_SHIFT) >= 1 << 30:
            raise ConfigError("arena: the centroid sums exceed the 2^30 budget")
        self.reduce_len = 3 * game.num_players  # per team: count, Σx, Σy

    def reduce_partial(self, planes: torch.Tensor, owner: torch.Tensor) -> torch.Tensor:
        """Raw int32 `[..., 3P]` sums over the entities of `[..., n_planes,
        N]` planes: per team, its living count, Σ(px>>6) and Σ(py>>6)."""
        return arena.team_sums(planes[..., 0, :], planes[..., 1, :], planes[..., 4, :], owner,
                               self.game.num_players)

    def reduce_finalize(self, raw: torch.Tensor):
        """Complete raw sums `[..., 3P]` -> (cx, cy, count), each int32
        `[..., P]`."""
        return arena.finalize(raw, self.game.num_players)

    def step(self, planes: torch.Tensor, player_inputs: torch.Tensor, owner: torch.Tensor,
             statuses=None, red=None) -> torch.Tensor:
        """One frame on `[6, N]` planes; `red`: the finalized reduction of
        the state entering the step, or None to reduce inline. With a
        leading member axis — planes `[6, B, N]`, inputs `[B, P, I]`,
        statuses `[B, P]`, `red` None — it steps B worlds at once, each
        reducing its own world (the beam rollout's plain version)."""
        if red is None:
            # the member axis sits after the plane axis: reduce per member
            red = self.reduce_finalize(arena.team_sums(planes[0], planes[1], planes[4], owner,
                                                       self.game.num_players))
        inp, throttle = arena.entity_inputs(player_inputs, statuses, owner, self.game.input_size)
        return torch.stack(arena.step_planes(*planes.unbind(0), inp, throttle, owner, red,
                                             self.game.num_players))


class SwarmPlanes(PlaneAdapter):
    """`ggrs_tpu_torch.models.swarm` on packed planes (the reference's
    `SwarmPlanes`, pallas_core.py:444): pos and vel are `[N, 3]`, three
    planes a key, plus the battery plane. Its step is per-entity
    independent, so every kernel runs it one thread per entity, and K2 at
    any world size."""

    planes = (
        ("px", "pos", 0), ("py", "pos", 1), ("pz", "pos", 2),
        ("vx", "vel", 0), ("vy", "vel", 1), ("vz", "vel", 2),
        ("charge", "charge", None),
    )

    def step(self, planes: torch.Tensor, player_inputs: torch.Tensor, owner: torch.Tensor,
             statuses=None, red=None) -> torch.Tensor:
        """One frame on `[7, N]` planes; `statuses` as `ExGamePlanes.step`
        takes them. With a leading member axis — planes `[7, B, N]`, inputs
        `[B, P, input_size]`, statuses `[B, P]` — it steps B worlds at once.
        `red` is unused: the step reduces nothing."""
        inp = swarm.entity_inputs(player_inputs, statuses, owner)
        return torch.stack(swarm.step_planes(*planes.unbind(0), inp))


_ADAPTERS: Dict[type, Callable] = {
    ex_game.ExGame: ExGamePlanes, arena.Arena: ArenaPlanes, swarm.Swarm: SwarmPlanes,
}


def get_adapter(game) -> PlaneAdapter:
    for cls in type(game).__mro__:
        if cls in _ADAPTERS:
            return _ADAPTERS[cls](game)
    raise RegistryMiss(f"no plane adapter registered for {type(game).__name__}")


def layout_of(keys=None, n_planes=None):
    """The registered adapter class whose planes hold exactly these state
    keys (`keys`, the frame leaf ignored) or this many planes: how a carry
    crosses between the reference's layout and the port's without its game."""
    for cls in dict.fromkeys(_ADAPTERS.values()):
        if keys is not None and {key for _, key, _ in cls.planes} == set(keys) - {"frame"}:
            return cls
        if n_planes is not None and len(cls.planes) == n_planes:
            return cls
    raise RegistryMiss(f"no plane layout for keys {keys} / {n_planes} planes")


def plane_groups(adapter) -> Dict[str, list]:
    """state_key -> ordered [(component, plane index)] for an adapter's
    plane layout; components must be declared 0..w-1."""
    groups: Dict[str, list] = {}
    for idx, (_, key, c) in enumerate(adapter.planes):
        groups.setdefault(key, []).append((c, idx))
    for key, comps in groups.items():
        if not (len(comps) == 1 and comps[0][0] is None):
            assert [c for c, _ in comps] == list(range(len(comps))), (
                f"plane components for {key!r} must be declared in order 0..{len(comps) - 1}"
            )
    return groups


def pack_planes(adapter, source: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Reference-layout leaves `[..., N]` / `[..., N, w]` -> packed planes
    `[..., n_planes, N]` (the plane axis sits just before the entities)."""
    out = []
    for _, key, comp in adapter.planes:
        arr = source[key]
        out.append(arr if comp is None else arr[..., comp])
    return torch.stack(out, dim=-2).to(torch.int32).contiguous()


def rebuild_from_planes(adapter, planes: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Inverse of `pack_planes`: `[..., n_planes, N]` -> reference leaves,
    multi-component keys stacked back into `[..., N, w]`."""
    out = {}
    for key, comps in plane_groups(adapter).items():
        if len(comps) == 1 and comps[0][0] is None:
            out[key] = planes[..., comps[0][1], :]
        else:
            out[key] = torch.stack([planes[..., idx, :] for _, idx in comps], dim=-1)
    return out


def make_gi_owner(n: int, num_players: int, device):
    """Global entity index and owning player (gi % num_players), the rule
    `ExGame.owner` and the CUDA kernels follow too."""
    gi = torch.arange(n, dtype=torch.int32, device=device)
    return gi, gi % num_players


def derive_checksum_weights(game, adapter) -> Tuple[List[Tuple[str, int, int]], int]:
    """For checksum key k of per-entity width w at word offset off_k, plane
    (k, j) element gi sits at global word index off_k + gi*w + j of the
    concatenation the model's checksum flattens, weighted (index+1) *
    GOLDEN32. Returns (entries, frame_weight): entries = [(plane name, w,
    base = off_k + j + 1 as a wrapped int32)], frame_weight = the wrapped
    int32 (total_words + 1) * GOLDEN32."""
    n = game.num_entities
    widths: Dict[str, int] = {}
    for _, key, _ in adapter.planes:
        widths[key] = widths.get(key, 0) + 1
    offs: Dict[str, int] = {}
    off = 0
    for key in game.checksum_keys:
        offs[key] = off
        off += n * widths[key]
    entries = [
        (name, widths[key], fx.to_i32(offs[key] + (comp or 0) + 1))
        for name, key, comp in adapter.planes
    ]
    return entries, fx.to_i32((off + 1) * fx.GOLDEN32)


def weight_planes(entries, gi: torch.Tensor) -> torch.Tensor:
    """int64 `[n_planes, N]` of per-element checksum weights
    ((w * gi + base) * GOLDEN32) mod 2^32."""
    g = gi.to(torch.int64)
    rows = []
    for _, w, base in entries:
        idx = (w * g + base) & fx.MASK32
        rows.append(fx.mul_mod32(idx, torch.full_like(idx, fx.GOLDEN32)))
    return torch.stack(rows)


def partial_checksum_planes(planes: torch.Tensor, weights: torch.Tensor):
    """Entity part of the checksum of `[n_planes, N]` planes (no frame
    term), as 0-dim int32 bit patterns (hi, lo)."""
    words = fx.as_u32(planes)
    hi = fx.mul_mod32(words, weights).sum() & fx.MASK32
    lo = words.sum() & fx.MASK32
    return fx.to_i32(hi), fx.to_i32(lo)


def vmem_estimate(game, check_distance: int) -> int:
    """Bytes of VMEM windows the reference's whole-batch kernel needs
    (state + ring planes of the game's adapter, in and out) — the
    reference's single formula, kept here only as the `backend="auto"`
    switch."""
    return 2 * len(get_adapter(game).planes) * (1 + check_distance + 2) * game.num_entities * 4


class PlaneContext:
    """Loop-invariant data of one (game, players, check_distance) on one
    device: the adapter, ring/history lengths, the checksum weights (as
    ints for the kernels and as an int64 weight tensor for the plain
    versions) and the owner plane."""

    def __init__(self, game, num_players: int, check_distance: int, device):
        self.game = game
        self.adapter = get_adapter(game)
        self.num_players = num_players
        self.input_size = game.input_size
        self.d = check_distance
        self.ring_len = check_distance + 2
        self.hist_len = check_distance + 2
        self.n = game.num_entities
        self.n_planes = len(self.adapter.planes)
        self.reduce_len = self.adapter.reduce_len  # 0, or 3P for arena
        self.device = torch.device(device)
        self.cs_entries, self.cs_frame_weight = derive_checksum_weights(game, self.adapter)
        self._weights = None
        self._owner = None

    @property
    def weights(self) -> torch.Tensor:
        """int64 [n_planes, N] checksum weights (built at first use: only
        the plain versions read them)."""
        if self._weights is None:
            gi, _ = make_gi_owner(self.n, self.num_players, self.device)
            self._weights = weight_planes(self.cs_entries, gi)
        return self._weights

    @property
    def owner(self) -> torch.Tensor:
        if self._owner is None:
            _, self._owner = make_gi_owner(self.n, self.num_players, self.device)
        return self._owner
