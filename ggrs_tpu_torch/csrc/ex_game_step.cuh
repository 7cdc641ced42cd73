// ex_game's deterministic step and checksum terms for ONE entity, shared by
// the SyncTest kernels (synctest_fused.cu, synctest_tiled.cu), the request
// path's tick (resim_tick.cu) and the beam rollout (beam_rollout.cu).
//
// The device counterpart of ggrs_tpu_torch/models/ex_game.py
// `substep_planes` and of the reference's ExGamePlanes._substep
// (ggrs_tpu/tpu/pallas_core.py:245). Bit-exactness rules:
//  - all step math is signed 32-bit; every intermediate stays below 2^28,
//    so no signed overflow (undefined behaviour in C++) can occur;
//  - `>>` on a negative int is an arithmetic shift under nvcc, as numpy's;
//  - the speed clamp FLOORS (`floor_div_pos`): C's `/` truncates toward
//    zero and the numerator can be negative;
//  - checksum products and sums are uint32_t, where wraparound is defined.
#pragma once

#include <stdint.h>

namespace exg {

constexpr int kPlanes = 5;  // px, py, vx, vy, rot: the port's plane order
constexpr int kInputUp = 1, kInputDown = 2, kInputLeft = 4, kInputRight = 8;
constexpr int kMaxX = 600 * 256, kMaxY = 800 * 256;  // arena, Q8 subpixels
constexpr int kMoveSpeed = 64, kRotSpeed = 434, kMaxSpeed = 7 * 256;
constexpr int kFrictionNum = 251;
constexpr uint32_t kGolden32 = 2654435761u;

struct State {
  int px, py, vx, vy, rot;
};

// Checksum weights derived on the host (planes.derive_checksum_weights):
// plane k of entity gi weighs ((w[k] * gi + base[k]) * GOLDEN32) mod 2^32;
// the frame word weighs frame_weight.
struct Weights {
  uint32_t w[kPlanes];
  uint32_t base[kPlanes];
  uint32_t frame_weight;
};

__device__ __forceinline__ int sin16(int rot) {
  const int a = rot & 0xFFFF;
  const int h = a & 0x7FFF;                 // half-wave phase
  const int p = (h * (0x8000 - h)) >> 14;   // parabola, peak 16384
  const int refined = p + ((225 * (((p * p) >> 14) - p)) >> 10);
  return ((a >> 15) & 1) ? -refined : refined;
}

__device__ __forceinline__ int cos16(int rot) { return sin16(rot + 0x4000); }

// exact floor(sqrt(n)) for 0 <= n < 2^24, 12 digit-by-digit iterations
__device__ __forceinline__ int isqrt24(int n) {
  int x = n, c = 0, d = 1 << 22;
#pragma unroll
  for (int k = 0; k < 12; ++k) {
    const int cd = c + d;
    const bool take = x >= cd;
    x = take ? x - cd : x;
    c = take ? (c >> 1) + d : (c >> 1);
    d >>= 2;
  }
  return c;
}

// floor(a / b) for b > 0
__device__ __forceinline__ int floor_div_pos(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

__device__ __forceinline__ void substep(State& s, int inp) {
  const bool up = inp & kInputUp, down = inp & kInputDown;
  const bool left = inp & kInputLeft, right = inp & kInputRight;

  // friction
  int vx = (s.vx * kFrictionNum) >> 8;
  int vy = (s.vy * kFrictionNum) >> 8;

  // thrust along the heading before this frame's turn
  const int thrust = (up && !down) ? 1 : ((down && !up) ? -1 : 0);
  vx += thrust * ((kMoveSpeed * cos16(s.rot)) >> 14);
  vy += thrust * ((kMoveSpeed * sin16(s.rot)) >> 14);

  // turn
  const int turn = (left && !right) ? -kRotSpeed : ((right && !left) ? kRotSpeed : 0);
  s.rot = (s.rot + turn) & 0xFFFF;

  // speed clamp
  const int m2 = vx * vx + vy * vy;
  if (m2 > kMaxSpeed * kMaxSpeed) {
    int mag = isqrt24(m2);
    mag = mag == 0 ? 1 : mag;
    vx = floor_div_pos(vx * kMaxSpeed, mag);
    vy = floor_div_pos(vy * kMaxSpeed, mag);
  }
  s.vx = vx;
  s.vy = vy;

  // integrate + clamp to the arena
  s.px = min(max(s.px + vx, 0), kMaxX);
  s.py = min(max(s.py + vy, 0), kMaxY);
}

__device__ __forceinline__ void step(State& s, int inp, int substeps) {
  for (int k = 0; k < substeps; ++k) substep(s, inp);
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
                               (uint32_t)s.vy, (uint32_t)s.rot};
  hi = 0;
  lo = 0;
#pragma unroll
  for (int k = 0; k < kPlanes; ++k) {
    hi += v[k] * ew[k];
    lo += v[k];
  }
}

// planes: [kPlanes, n] int32, entity e's column
__device__ __forceinline__ State load(const int* planes, size_t n, size_t e) {
  return State{planes[e], planes[n + e], planes[2 * n + e], planes[3 * n + e], planes[4 * n + e]};
}

__device__ __forceinline__ void store(int* planes, size_t n, size_t e, const State& s) {
  planes[e] = s.px;
  planes[n + e] = s.py;
  planes[2 * n + e] = s.vx;
  planes[3 * n + e] = s.vy;
  planes[4 * n + e] = s.rot;
}

// Model traits for the per-entity bodies (synctest_body.cuh, resim_tick.cu,
// beam_rollout.cu): the state, its load/store, its checksum terms, and the
// step of one entity on its owner's input byte
struct Model {
  static constexpr int kPlanes = exg::kPlanes;
  using State = exg::State;
  using Weights = exg::Weights;
  static __device__ __forceinline__ State load(const int* p, size_t n, size_t e) {
    return exg::load(p, n, e);
  }
  static __device__ __forceinline__ void store(int* p, size_t n, size_t e, const State& s) {
    exg::store(p, n, e, s);
  }
  static __device__ __forceinline__ void entity_weights(const Weights& cw, uint32_t gi,
                                                        uint32_t (&ew)[kPlanes]) {
    exg::entity_weights(cw, gi, ew);
  }
  static __device__ __forceinline__ void checksum_terms(const State& s, const uint32_t (&ew)[kPlanes],
                                                        uint32_t& hi, uint32_t& lo) {
    exg::checksum_terms(s, ew, hi, lo);
  }
  static __device__ __forceinline__ void step(State& s, int inp, int substeps) {
    exg::step(s, inp, substeps);
  }
};

}  // namespace exg
