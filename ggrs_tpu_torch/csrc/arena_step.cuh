// arena's deterministic step, checksum terms and per-team reduction for ONE
// entity, shared by the arena SyncTest kernels (synctest_fused.cu,
// synctest_tiled.cu) and the reduction-table kernel (reduce_table.cu).
//
// The device counterpart of ggrs_tpu_torch/models/arena.py `step_planes`,
// `team_sums` and `finalize`, and of the reference's ArenaPlanes
// (ggrs_tpu/tpu/pallas_core.py:280-441). The step is per entity GIVEN the
// finalized per-team values of the state entering it (`Team`: centroid and
// living count); producing those is a reduction over every entity, which
// each kernel organizes its own way. Bit-exactness rules, as ex_game's:
//  - all step math is signed 32-bit; inside the model's envelope (a team's
//    live count < 2^16, |v| a few thousand) every intermediate stays below
//    2^28;
//  - `>>` on a negative int is an arithmetic shift under nvcc, as numpy's
//    (the rally pull (centroid - pos) >> 10 is often negative);
//  - the speed clamp and the centroid FLOOR (`exg::floor_div_pos`): C's `/`
//    truncates toward zero and a clamp numerator can be negative;
//  - reduction sums and checksums are uint32_t, where wraparound is defined
//    and addition commutes, so atomics give the same bits in any order.
#pragma once

#include <stdint.h>

#include "ex_game_step.cuh"  // exg::isqrt24, exg::floor_div_pos

namespace arena {

constexpr int kPlanes = 6;      // px, py, vx, vy, hp, energy: the port's plane order
constexpr int kTeamChunk = 16;  // teams a block sums per pass through its shared scratch
constexpr int kInputUp = 1, kInputDown = 2, kInputLeft = 4, kInputRight = 8;
constexpr int kInputRally = 16, kInputOverdrive = 32;
constexpr int kArenaBits = 18, kArenaMask = (1 << kArenaBits) - 1, kCentroidShift = 6;
constexpr int kAccel = 48, kFrictionNum = 247, kMaxSpeed = 8 * 256;
constexpr int kRallyShift = 10, kRallyMax = 96, kCombatRange = 120 * 256, kDamage = 1;
constexpr int kEnergyMax = 256, kEnergyDrain = 2, kEnergyRegen = 1, kDefaultThrottle = 4;
constexpr uint32_t kGolden32 = 2654435761u;

struct State {
  int px, py, vx, vy, hp, energy;
};

// a team's finalized reduction: centroid of its living entities, their count
struct Team {
  int cx, cy, count;
};

struct Weights {
  uint32_t w[kPlanes];
  uint32_t base[kPlanes];
  uint32_t frame_weight;
};

// raw sums (count, Σ px>>6, Σ py>>6) -> Team; the reference's reduce_finalize
__device__ __forceinline__ Team finalize(int count, int sx, int sy) {
  const int safe = count > 1 ? count : 1;
  return Team{(int)((uint32_t)exg::floor_div_pos(sx, safe) << kCentroidShift),
              (int)((uint32_t)exg::floor_div_pos(sy, safe) << kCentroidShift), count};
}

// the owner's throttle: byte 1 of a 2-byte input, else 4 (the 1-byte dynamics)
__device__ __forceinline__ int throttle_of(const int* in, int input_size) {
  return input_size >= 2 ? (in[1] & 0x0F) : kDefaultThrottle;
}

// one frame for one entity; `own`/`enemy`: its team's and the next team's
// values for the state entering the step (order as _step_generic's)
__device__ __forceinline__ void step(State& s, int inp, int throttle, const Team& own,
                                     const Team& enemy) {
  const bool alive = s.hp > 0;
  const int ax = ((inp & kInputRight) != 0) - ((inp & kInputLeft) != 0);
  const int ay = ((inp & kInputDown) != 0) - ((inp & kInputUp) != 0);
  const bool over = (inp & kInputOverdrive) != 0 && s.energy > 0;
  const int accel_base = (kAccel * (throttle + 4)) >> 3;
  const int accel = over ? 2 * accel_base : accel_base;
  const int energy = over ? s.energy - kEnergyDrain : min(s.energy + kEnergyRegen, kEnergyMax);
  s.energy = max(energy, 0);
  int vx = s.vx + ax * accel;
  int vy = s.vy + ay * accel;

  // rally: bounded pull toward the own centroid
  if (inp & kInputRally) {
    vx += min(max((own.cx - s.px) >> kRallyShift, -kRallyMax), kRallyMax);
    vy += min(max((own.cy - s.py) >> kRallyShift, -kRallyMax), kRallyMax);
  }

  // friction + speed clamp
  vx = (vx * kFrictionNum) >> 8;
  vy = (vy * kFrictionNum) >> 8;
  const int m2 = vx * vx + vy * vy;
  if (m2 > kMaxSpeed * kMaxSpeed) {
    int mag = exg::isqrt24(m2);
    mag = mag == 0 ? 1 : mag;
    vx = exg::floor_div_pos(vx * kMaxSpeed, mag);
    vy = exg::floor_div_pos(vy * kMaxSpeed, mag);
  }

  // dead entities stop; integrate on the torus
  if (!alive) vx = vy = 0;
  s.vx = vx;
  s.vy = vy;
  s.px = (s.px + vx) & kArenaMask;
  s.py = (s.py + vy) & kArenaMask;

  // combat around the (pre-move) enemy centroid; an extinct team projects no force
  const int half = 1 << (kArenaBits - 1);
  const int dx = ((s.px - enemy.cx + half) & kArenaMask) - half;
  const int dy = ((s.py - enemy.cy + half) & kArenaMask) - half;
  const bool hit = alive && enemy.count > 0 && abs(dx) + abs(dy) < kCombatRange;
  s.hp = max(s.hp - (hit ? kDamage : 0), 0);
}

__device__ __forceinline__ void entity_weights(const Weights& cw, uint32_t gi,
                                               uint32_t (&ew)[kPlanes]) {
#pragma unroll
  for (int k = 0; k < kPlanes; ++k) ew[k] = (cw.w[k] * gi + cw.base[k]) * kGolden32;
}

// this entity's terms of the (hi, lo) checksum, frame term excluded
__device__ __forceinline__ void checksum_terms(const State& s, const uint32_t (&ew)[kPlanes],
                                               uint32_t& hi, uint32_t& lo) {
  const uint32_t v[kPlanes] = {(uint32_t)s.px, (uint32_t)s.py, (uint32_t)s.vx,
                               (uint32_t)s.vy, (uint32_t)s.hp, (uint32_t)s.energy};
  hi = 0;
  lo = 0;
#pragma unroll
  for (int k = 0; k < kPlanes; ++k) {
    hi += v[k] * ew[k];
    lo += v[k];
  }
}

// planes: [kPlanes, n] int32, entity e's column
__device__ __forceinline__ State load(const int* p, size_t n, size_t e) {
  return State{p[e], p[n + e], p[2 * n + e], p[3 * n + e], p[4 * n + e], p[5 * n + e]};
}

__device__ __forceinline__ void store(int* p, size_t n, size_t e, const State& s) {
  p[e] = s.px;
  p[n + e] = s.py;
  p[2 * n + e] = s.vx;
  p[3 * n + e] = s.vy;
  p[4 * n + e] = s.hp;
  p[5 * n + e] = s.energy;
}

// One chunk of block_team_sums: teams first..first+teams-1 (teams <=
// kTeamChunk) through the shared scratch, then a barrier.
template <int kWarps>
__device__ __forceinline__ void team_chunk_sums(uint32_t one, uint32_t sx, uint32_t sy, int team, int first,
                                                int teams, uint32_t* scratch, uint32_t* dst) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int t = 0; t < teams; ++t) {
    const bool mine = team == first + t;
    uint32_t v[3] = {mine ? one : 0u, mine ? sx : 0u, mine ? sy : 0u};
#pragma unroll
    for (int k = 0; k < 3; ++k) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v[k] += __shfl_xor_sync(0xFFFFFFFFu, v[k], off);
      if (lane == 0) scratch[(3 * t + k) * kWarps + warp] = v[k];
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < 3 * teams; j += kWarps * 32) {
    uint32_t sum = 0;
    for (int w = 0; w < kWarps; ++w) sum += scratch[j * kWarps + w];
    if (sum) atomicAdd(&dst[3 * first + j], sum);
  }
  __syncthreads();  // scratch is reused by the next chunk or call
}

// Adds one block's per-team raw sums to dst[3P] (per team: living count,
// Σ px>>6, Σ py>>6) with uint32 atomics. Every thread of the block calls it
// with its entity's px, py, hp and team (`active` false for threads past the
// world). The teams go in chunks of kTeamChunk: warp shuffles per team of
// the chunk, then one pass over the warps' sums in shared memory
// (`scratch`: 3 * kTeamChunk * kWarps words, whatever P is). Up to 16 teams
// take one chunk by a branch of their own, which compiles to the one-pass
// code the kernels had before they took more teams.
template <int kWarps>
__device__ __forceinline__ void block_team_sums(bool active, int px, int py, int hp, int team,
                                                int num_players, uint32_t* scratch, uint32_t* dst) {
  const bool live = active && hp > 0;
  const uint32_t one = live ? 1u : 0u;
  const uint32_t sx = live ? (uint32_t)(px >> kCentroidShift) : 0u;
  const uint32_t sy = live ? (uint32_t)(py >> kCentroidShift) : 0u;
  if (num_players <= kTeamChunk) {
    team_chunk_sums<kWarps>(one, sx, sy, team, 0, num_players, scratch, dst);
    return;
  }
  for (int first = 0; first < num_players; first += kTeamChunk)
    team_chunk_sums<kWarps>(one, sx, sy, team, first, min(kTeamChunk, num_players - first), scratch, dst);
}

// Model traits for the SyncTest body (synctest_body.cuh)
struct Model {
  static constexpr int kPlanes = arena::kPlanes;
  using State = arena::State;
  using Weights = arena::Weights;
  static __device__ __forceinline__ State load(const int* p, size_t n, size_t e) {
    return arena::load(p, n, e);
  }
  static __device__ __forceinline__ void store(int* p, size_t n, size_t e, const State& s) {
    arena::store(p, n, e, s);
  }
  static __device__ __forceinline__ void entity_weights(const Weights& cw, uint32_t gi,
                                                        uint32_t (&ew)[kPlanes]) {
    arena::entity_weights(cw, gi, ew);
  }
  static __device__ __forceinline__ void checksum_terms(const State& s, const uint32_t (&ew)[kPlanes],
                                                        uint32_t& hi, uint32_t& lo) {
    arena::checksum_terms(s, ew, hi, lo);
  }
};

}  // namespace arena
