"""Deterministic fixed-point primitives on int32 torch tensors.

The port's counterpart of `ggrs_tpu/ops/fixed_point.py`: int32 Q8
subpixels for positions and velocities, a 16-bit angle with a branch-free
integer sine, a branch-free integer square root, and the modular
`(hi, lo)` checksum. Every function gives the reference's bits exactly:

- `>>` on torch int32 is an arithmetic shift, as in numpy and jax;
- floor division goes through `floor_div` (`rounding_mode="floor"`),
  never through C's truncating `/`;
- the checksum's uint32 products are taken in int64 and split so that no
  product leaves the int64 range (`mul_mod32`); nothing relies on int32
  multiply wrapping. Results are int32 tensors holding the uint32 bit
  pattern (`to_i32`), the form the port keeps checksums in.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# Angle space: a full turn is 2^16 units.
ANGLE_BITS = 16
ANGLE_MOD = 1 << ANGLE_BITS
# Sine table: 1024 entries, Q14 scale.
TABLE_BITS = 10
TABLE_SIZE = 1 << TABLE_BITS
TRIG_SCALE_BITS = 14
TRIG_SCALE = 1 << TRIG_SCALE_BITS

# Positions/velocities are Q8 subpixels.
SUBPIX_BITS = 8
SUBPIX = 1 << SUBPIX_BITS

# Knuth multiplicative constant for the checksum weight stream.
GOLDEN32 = 2654435761
MASK32 = 0xFFFFFFFF


def _build_trig_tables() -> tuple[np.ndarray, np.ndarray]:
    idx = np.arange(TABLE_SIZE, dtype=np.float64)
    theta = idx * (2.0 * math.pi / TABLE_SIZE)
    cos_t = np.round(np.cos(theta) * TRIG_SCALE).astype(np.int32)
    sin_t = np.round(np.sin(theta) * TRIG_SCALE).astype(np.int32)
    return cos_t, sin_t


# numpy tables: only the host-side world initialisation reads them
COS_TABLE, SIN_TABLE = _build_trig_tables()


def angle_index(rot):
    """Map a 16-bit angle to a trig-table index."""
    return rot >> (ANGLE_BITS - TABLE_BITS)


def sin16(rot: torch.Tensor) -> torch.Tensor:
    """Branch-free integer sine: sin(2*pi*rot/2^16) in Q14, int32 only.
    Intermediate products stay below 2^28, so int32 never overflows."""
    a = rot & (ANGLE_MOD - 1)
    h = a & 0x7FFF  # half-wave phase
    p = (h * (0x8000 - h)) >> 14  # parabola, peak 16384 at the quarter wave
    refined = p + ((225 * (((p * p) >> 14) - p)) >> 10)
    neg = (a >> 15) & 1  # second half-wave is the mirror
    return torch.where(neg == 1, -refined, refined).to(torch.int32)


def cos16(rot: torch.Tensor) -> torch.Tensor:
    """cos(2*pi*rot/2^16) in Q14 (quarter-turn phase shift of sin16)."""
    return sin16(rot + (ANGLE_MOD // 4))


def isqrt24(n: torch.Tensor) -> torch.Tensor:
    """Exact floor(sqrt(n)) for 0 <= n < 2^24: 12 unrolled digit-by-digit
    iterations, integer only."""
    x = n
    c = torch.zeros_like(n)
    d = 1 << 22
    for _ in range(12):
        cd = c + d
        cond = x >= cd
        x = torch.where(cond, x - cd, x)
        c = torch.where(cond, (c >> 1) + d, c >> 1)
        d >>= 2
    return c


def isqrt24_np(n: np.ndarray) -> np.ndarray:
    """`isqrt24` on numpy arrays, for the models' numpy oracles."""
    x, c, d = n, np.zeros_like(n), 1 << 22
    for _ in range(12):
        cd = c + d
        cond = x >= cd
        x = np.where(cond, x - cd, x)
        c = np.where(cond, (c >> 1) + d, c >> 1)
        d >>= 2
    return c


def floor_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """floor(a / b) on int32 tensors, as numpy's and jax's `//` give it
    (C and CUDA `/` truncate toward zero instead)."""
    return torch.div(a, b, rounding_mode="floor")


def mul_mod32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a * b) mod 2^32 for int64 tensors holding values in [0, 2^32).
    `a` is split into 16-bit halves so every product stays below 2^48."""
    lo = (a & 0xFFFF) * b
    hi = (((a >> 16) * b) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def to_i32(x):
    """The int32 bit pattern of a uint32 value held in an int64 tensor (or
    a Python int)."""
    if isinstance(x, torch.Tensor):
        return (((x & MASK32) ^ 0x80000000) - 0x80000000).to(torch.int32)
    x &= MASK32
    return x - (1 << 32) if x >= (1 << 31) else x


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 (or any integer) tensor -> int64 tensor of its uint32 value."""
    return x.to(torch.int64) & MASK32


def weighted_checksum_parts(parts):
    """`(hi, lo)` over the CONCATENATION of `parts`, computed per part with
    global word offsets: hi = sum(w_i * ((i+1) * GOLDEN32)) mod 2^32,
    lo = sum(w_i) mod 2^32. Returns two 0-dim int32 tensors holding the
    uint32 bit patterns."""
    device = parts[0].device
    hi = torch.zeros((), dtype=torch.int64, device=device)
    lo = torch.zeros((), dtype=torch.int64, device=device)
    off = 0
    for part in parts:
        words = as_u32(part.reshape(-1))
        n = int(words.shape[0])
        idx = torch.arange(off + 1, off + n + 1, dtype=torch.int64, device=device)
        weights = mul_mod32(idx & MASK32, torch.full_like(idx, GOLDEN32))
        hi = (hi + mul_mod32(words, weights).sum()) & MASK32
        lo = (lo + words.sum()) & MASK32
        off += n
    return to_i32(hi), to_i32(lo)


def checksum_np(parts) -> tuple:
    """`weighted_checksum_parts` in numpy, for the models' oracles: (hi, lo)
    as Python ints over the concatenation of `parts`, each word weighted
    (index + 1) * GOLDEN32."""
    words = np.concatenate([np.asarray(p).reshape(-1).astype(np.int64) for p in parts]) & MASK32
    idx = np.arange(1, words.size + 1, dtype=np.int64)
    weights = (idx * GOLDEN32) & MASK32
    lo16 = (words & 0xFFFF) * weights
    hi16 = (((words >> 16) * weights) & 0xFFFF) << 16
    return int(((lo16 + hi16) & MASK32).sum() & MASK32), int(words.sum() & MASK32)


def combine_checksum(hi: int, lo: int) -> int:
    """Fold a (hi, lo) pair of uint32 values into one Python int (the
    reference's 64-bit checksum form)."""
    return ((int(hi) & MASK32) << 32) | (int(lo) & MASK32)
