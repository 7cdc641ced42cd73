"""The port's adaptive speculation gate (`DeviceRollbackBackend(
speculation_gate="adaptive")`, `_launch_width`) against the reference's
`TpuRollbackBackend._launch_width`: on the same injected idle times,
measured costs and value trails, every decision (full width, the width-1
history launch, or none) and the probe-burst streak are equal; and live,
on SyncTest streams with the cost pinned so the budget never vetoes, the
gate's launch, history and gated counts equal the reference's while the
states stay bit-equal to a beam-off backend."""

import numpy as np
import pytest

from ggrs_tpu import SessionBuilder as RefSessionBuilder
from ggrs_tpu.models.ex_game import ExGame as RefExGame
from ggrs_tpu.tpu import TpuRollbackBackend
from ggrs_tpu_torch import DeviceRollbackBackend, ExGame, SessionBuilder
from test_torch_beam_backend import COUNTERS, SCRIPTS, drive, port_backend, ref_backend, session

P, N, MP = 2, 64, 6


def gate_pair(width=4):
    port = DeviceRollbackBackend(ExGame(P, N), MP, P, beam_width=width, speculation_gate="adaptive",
                                 device="cpu")
    ref = TpuRollbackBackend(RefExGame(P, N), max_prediction=MP, num_players=P, beam_width=width,
                             speculation_gate="adaptive", spec_backend="xla", tick_backend="xla")
    return port, ref


def both(pair, **attrs):
    for b in pair:
        for k, v in attrs.items():
            setattr(b, k, v)


def decisions(pair, n):
    out = []
    for _ in range(n):
        got = [b._launch_width() for b in pair]
        out.append(tuple(got))
        assert pair[0]._value_gated_streak == pair[1]._value_gated_streak
    return out


def fill(pair, sample, n):
    for b in pair:
        for _ in range(n):
            b._launch_value.append(sample)


def test_value_gate_regimes_equal_reference():
    """The reference's own walk through the gate's regimes
    (tests/test_beam_backend.py:606), decision for decision."""
    pair = gate_pair()
    both(pair, _spec_cost_s=0.001, _spec_hist_cost_s=0.00025, _idle_ema_s=1.0)
    port = pair[0]
    interval, burst, window = port.VALUE_PROBE_INTERVAL, port.VALUE_PROBE_BURST, port.VALUE_WINDOW
    seq = decisions(pair, 1)
    fill(pair, (0, 0, 4), port.VALUE_MIN_SAMPLES)  # nothing serves: stand down, probe bursts
    seq += decisions(pair, 2 * interval)
    fill(pair, (0, 3, 2), window)  # member 0 serves: width-1 history launches
    both(pair, _value_gated_streak=0)
    seq += decisions(pair, interval)
    fill(pair, (3, 0, 2), window)  # branches serve: full width
    seq += decisions(pair, 2)
    fill(pair, (1, 1, 5), window)  # blended: the total clears the bar
    seq += decisions(pair, 2)
    for idle in (0.0, 0.0005):  # budget: nothing fits, then width 1 only
        both(pair, _idle_ema_s=idle)
        seq += decisions(pair, 2)
    fill(pair, (1, 0, 5), window)
    seq += decisions(pair, 2)
    fill(pair, (0, 3, 2), window)
    seq += decisions(pair, 2)
    both(pair, _idle_ema_s=1.0)  # the soft bar: rare rollbacks at covered cost
    fill(pair, (1, 0, 8), window)
    seq += decisions(pair, 2)
    assert all(a == b for a, b in seq), seq
    widths = [a for a, _ in seq]
    assert {0, 1, 4} <= set(widths)
    assert widths[1 : 1 + 2 * interval].count(4) == 2 * burst


@pytest.mark.parametrize("seed", range(12))
def test_gate_decisions_equal_reference_on_random_trails(seed):
    """Random idle times, measured costs (or none) and value trails."""
    rng = np.random.default_rng(seed)
    pair = gate_pair(width=int(rng.integers(2, 17)))
    for _ in range(6):
        cost = float(rng.choice([1e-4, 1e-3, 5e-3]))
        hist = None if rng.random() < 0.2 else cost * float(rng.uniform(0.1, 1.0))
        idle = None if rng.random() < 0.15 else float(rng.uniform(0.0, 2.5 * cost))
        both(pair, _spec_cost_s=None if rng.random() < 0.1 else cost, _spec_hist_cost_s=hist,
             _idle_ema_s=idle)
        sample = (int(rng.integers(0, 4)), int(rng.integers(0, 4)), int(rng.integers(1, 9)))
        fill(pair, sample, int(rng.integers(0, 12)))
        seq = decisions(pair, int(rng.integers(1, 40)))
        assert all(a == b for a, b in seq), seq


@pytest.mark.parametrize("name", ["varying", "toggle"])
def test_live_adaptive_gate_equals_reference(name):
    """SyncTest streams with the measured costs pinned tiny (the idle
    budget never vetoes): the value trail alone decides, so launches,
    history launches, gated ticks and adoption counters equal the
    reference's, and the states stay equal to a beam-off backend's."""
    script = SCRIPTS[name]
    port = port_backend(8, speculation_gate="adaptive")
    ref = TpuRollbackBackend(RefExGame(P, N), max_prediction=MP, num_players=P, beam_width=8,
                             speculation_gate="adaptive", spec_backend="xla", tick_backend="xla")
    for b in (port, ref):
        b._spec_cost_s = b._spec_hist_cost_s = 1e-9
    twin = port_backend(0)
    got = drive(session(SessionBuilder), port, script, 60)
    assert got == drive(session(RefSessionBuilder), ref, script, 60)
    assert got == drive(session(SessionBuilder), twin, script, 60)
    for k in COUNTERS + ("beam_gated", "beam_history_launches"):
        assert getattr(port, k) == getattr(ref, k), k
    assert list(port._launch_value) == list(ref._launch_value)
    if name == "varying":  # member 0 serves: the gate drops to width-1 launches
        assert port.beam_gated > 0 and port.beam_history_launches > 0


def test_gate_always_launches_full_width():
    port = port_backend(8)
    ref = ref_backend(8)
    for b in (port, ref):
        b._idle_ema_s = 0.0
        b._spec_cost_s = 1.0
    assert port._launch_width() == ref._launch_width() == 8
