"""Load generator for SessionHost (the reference's `serve/loadgen.py`):
scripted 2-4-player matches over a lossy virtual network, driven in
virtual time.

Every peer of every match attaches to ONE SessionHost, so the whole fleet's
simulation runs on the shared device core. The network between peers is
the seeded `InMemoryNetwork` (latency, jitter, loss), the clock a
`FakeClock` advanced one frame interval a host tick: a run is deterministic
per seed. Inputs are scripted per (match, peer, tick) from the seed, with
desync detection on — a zero-desync run certifies that the sessions
multiplexed through one stacked core stay bit-exact replicas of each other.
Left out: `run_loadgen`'s per-link fault `profile` (serve/chaos.py).
"""

from __future__ import annotations

import random
from typing import Any, Dict, List, Optional

from ..errors import ContractViolation
from ..network.sockets import InMemoryNetwork
from ..sessions.builder import SessionBuilder
from ..types import DesyncDetection, PlayerType, SessionState
from ..utils.clock import FakeClock
from .host import SessionHost

FRAME_MS = 16


def build_matches(host: SessionHost, net: InMemoryNetwork, clock, *, sessions: int, players_cycle=(2, 3, 4),
                  max_prediction: int = 8, input_delay: int = 1, desync_interval: int = 10,
                  seed: int = 0) -> List[List[Any]]:
    """Create full P2P constellations (every peer a hosted session) until at
    least `sessions` peers are attached; returns the host keys grouped by
    match. Match m's peer k lives at virtual address (m, k)."""
    matches: List[List[Any]] = []
    total = 0
    m = 0
    while total < sessions:
        n = players_cycle[m % len(players_cycle)]
        n = min(n, host.num_players, max(2, sessions - total))
        keys = []
        for k in range(n):
            b = (SessionBuilder(input_size=host.game.input_size)
                 .with_num_players(n)
                 .with_max_prediction_window(max_prediction)
                 .with_input_delay(input_delay)
                 .with_desync_detection_mode(DesyncDetection.on(interval=desync_interval))
                 .with_clock(clock)
                 .with_rng(random.Random((seed * 7919 + m * 131 + k) & 0xFFFF)))
            for h in range(n):
                b = b.add_player(PlayerType.local() if h == k else PlayerType.remote((m, h)), h)
            keys.append(host.attach(b.start_p2p_session(net.socket((m, k)))))
        matches.append(keys)
        total += n
        m += 1
    return matches


def sync_fleet(host, matches, clock, *, max_ticks: int = 800) -> None:
    """Pump the host until every hosted session reaches RUNNING."""
    for _ in range(max_ticks):
        host.tick()
        clock.advance(FRAME_MS)
        if all(host.session(k).current_state() == SessionState.RUNNING for keys in matches for k in keys):
            return
    raise ContractViolation(f"fleet of {sum(len(m) for m in matches)} sessions failed to synchronize within "
                            f"{max_ticks} ticks")


def make_scripts(matches, ticks: int, seed: int) -> Dict[Any, List[int]]:
    """Deterministic per-(match, peer, tick) input scripts."""
    rng = random.Random(seed ^ 0x5EED)
    return {(m, k): [rng.randrange(0, 16) for _ in range(ticks)]
            for m, keys in enumerate(matches) for k in range(len(keys))}


def held_scripts(matches, ticks: int, seed: int) -> Dict[Any, List[int]]:
    """Hold-shaped per-(match, peer, tick) scripts: runs of held values
    (seeded, 6-18 frames) cycling a fixed per-peer sequence."""
    out: Dict[Any, List[int]] = {}
    for m, keys in enumerate(matches):
        for k in range(len(keys)):
            rng = random.Random(seed * 7919 + m * 131 + k)
            cycle = [1, 4, 2, 8, 5][(m + k) % 3:][:3]
            vals: List[int] = []
            i = 0
            while len(vals) < ticks:
                vals += [cycle[i % len(cycle)]] * rng.randrange(6, 19)
                i += 1
            out[(m, k)] = vals[:ticks]
    return out


def starve_on_tick(net, matches, *, hole_every: int, hole_len: int):
    """A `drive_scripted` on_tick hook forcing input starvation: peer 0 of
    every match goes dark (blackholed) for `hole_len` ticks every
    `hole_every`, which stalls the other peers past the prediction gate."""
    holes = [(m, 0) for m in range(len(matches))]

    def on_tick(t):
        if hole_every and t > 0 and t % hole_every == 0:
            net.set_blackhole(holes, True)
        if hole_every and t % hole_every == hole_len:
            net.set_blackhole(holes, False)

    return on_tick


def drive_scripted(host, matches, clock, scripts, ticks: int, on_tick=None) -> List[Any]:
    """Submit every peer's scripted input and tick the host `ticks` times;
    returns the (key, event) DesyncDetected pairs observed. `on_tick(t)`
    runs at the top of each tick."""
    desyncs: List[Any] = []
    for t in range(ticks):
        if on_tick is not None:
            on_tick(t)
        for m, keys in enumerate(matches):
            for k, key in enumerate(keys):
                host.submit_input(key, k, bytes([scripts[(m, k)][t]]))
        for key, evs in host.tick().items():
            desyncs += [(key, e) for e in evs if type(e).__name__ == "DesyncDetected"]
        clock.advance(FRAME_MS)
    return desyncs


def run_loadgen(*, sessions: int = 64, ticks: int = 120, game=None, entities: int = 16, max_players: int = 4,
                max_prediction: int = 8, latency_ms: int = 20, jitter_ms: int = 10, loss: float = 0.05,
                duplicate: float = 0.0, seed: int = 0, host: Optional[SessionHost] = None,
                max_inflight_rows: Optional[int] = None, idle_timeout_ms: int = 0, warmup: bool = True,
                sync_ticks: int = 400, device="cuda", **host_kw) -> Dict[str, Any]:
    """Spin up >= `sessions` scripted peers in 2-4-player matches on one
    SessionHost over a seeded lossy InMemoryNetwork and drive them `ticks`
    host ticks in virtual time. Returns a JSON-able report (desyncs,
    progress, megabatch shape) and the live host under "_host".
    `host=None` builds one sized to the fleet (ExGame by default; extra
    keywords go to SessionHost, e.g. resident=True)."""
    clock = FakeClock()
    net = InMemoryNetwork(clock, latency_ms=latency_ms, jitter_ms=jitter_ms, loss=loss, duplicate=duplicate,
                          seed=seed)
    if host is None:
        if game is None:
            from ..models.ex_game import ExGame

            game = ExGame(num_players=max_players, num_entities=entities)
        host = SessionHost(game, max_prediction=max_prediction, num_players=max_players,
                           max_sessions=sessions + max_players, max_inflight_rows=max_inflight_rows, clock=clock,
                           idle_timeout_ms=idle_timeout_ms, warmup=warmup, device=device, **host_kw)
    matches = build_matches(host, net, clock, sessions=sessions, max_prediction=max_prediction, seed=seed)
    n_sessions = sum(len(keys) for keys in matches)
    sync_fleet(host, matches, clock, max_ticks=sync_ticks)
    desyncs = drive_scripted(host, matches, clock, make_scripts(matches, ticks, seed), ticks)
    # cooldown: let in-flight inputs and checksum reports land
    for _ in range(3 * max_prediction):
        for key, evs in host.tick().items():
            desyncs += [(key, e) for e in evs if type(e).__name__ == "DesyncDetected"]
        clock.advance(FRAME_MS)
    dev = host.device
    frames = [host._lanes[k].current_frame for keys in matches for k in keys]
    report = {
        "sessions": n_sessions, "matches": len(matches), "ticks": ticks, "seed": seed, "loss": loss,
        "latency_ms": latency_ms, "jitter_ms": jitter_ms, "desyncs": len(desyncs),
        "checksums_published": sum(len(host.session(k).local_checksum_history) for keys in matches for k in keys),
        "min_frame": min(frames), "max_frame": max(frames), "megabatches": dev.megabatches,
        "rows_dispatched": dev.rows_dispatched,
        "mean_megabatch_rows": round(dev.rows_dispatched / dev.megabatches, 3) if dev.megabatches else 0.0,
        "max_bucket": max((bucket for bucket, _, _ in dev.megabatch_programs()), default=0),
        "plan_signatures": len(dev.plan_cache.signatures), "host": host._host_section(),
    }
    report["_host"] = host  # live handle for callers; strip before JSON
    return report
