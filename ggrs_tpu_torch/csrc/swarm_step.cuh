// swarm's deterministic step and checksum terms for ONE entity, shared by
// the SyncTest kernels (synctest_fused.cu, synctest_tiled.cu), the request
// path's tick (resim_tick.cu) and the beam rollout (beam_rollout.cu).
//
// The device counterpart of ggrs_tpu_torch/models/swarm.py `step_planes`
// and of the reference's SwarmPlanes.step (ggrs_tpu/tpu/pallas_core.py:444):
// a 3-D drone per entity (pos/vel are [N, 3], so three planes a key) with a
// battery (`charge`) that BOOST drains. The step is strictly per entity: no
// reduction, so every kernel runs it one thread per entity as ex_game's.
// Bit-exactness rules, as ex_game's:
//  - all step math is signed 32-bit. Entering a step |v| <= MAX_SPEED per
//    axis, so after friction and thrust |v| <= MAX_SPEED + 2*ACCEL = 1872:
//    m2 = |v|^2 < 3 * 1872^2 < 2^24 (isqrt24's domain) and
//    c * MAX_SPEED < 2^22, so no signed overflow can occur;
//  - `>>` on a negative int is an arithmetic shift under nvcc, as numpy's
//    (friction of a negative velocity);
//  - the speed clamp FLOORS (`exg::floor_div_pos`): C's `/` truncates toward
//    zero and a component can be negative. The reference computes the clamp
//    for every entity and selects it where m2 is over the limit; taking it
//    only there, as ex_game's substep does, gives the same bits;
//  - checksum products and sums are uint32_t, where wraparound is defined.
#pragma once

#include <stdint.h>

#include "ex_game_step.cuh"  // exg::isqrt24, exg::floor_div_pos

namespace swarm {

constexpr int kPlanes = 7;  // px, py, pz, vx, vy, vz, charge: the port's plane order
constexpr int kInputXp = 1, kInputXm = 2, kInputYp = 4, kInputYm = 8, kInputZp = 16,
              kInputZm = 32, kInputBoost = 64;
constexpr int kSpaceMask = (1 << 17) - 1;  // 512-px torus cube in Q8 subpixels
constexpr int kAccel = 40, kMaxSpeed = 7 * 256, kFrictionNum = 248;
constexpr int kChargeMax = 192, kChargeDrain = 6, kChargeRegen = 2;
constexpr uint32_t kGolden32 = 2654435761u;

struct State {
  int px, py, pz, vx, vy, vz, charge;
};

struct Weights {
  uint32_t w[kPlanes];
  uint32_t base[kPlanes];
  uint32_t frame_weight;
};

// the signed unit thrust of a (plus, minus) bit pair
__device__ __forceinline__ int axis(int inp, int plus, int minus) {
  return ((inp & plus) != 0) - ((inp & minus) != 0);
}

// one frame for one entity on its owner's input byte (order as _step_generic's)
__device__ __forceinline__ void step(State& s, int inp) {
  const bool boost = (inp & kInputBoost) != 0 && s.charge > 0;
  const int accel = boost ? 2 * kAccel : kAccel;
  const int charge = boost ? s.charge - kChargeDrain : min(s.charge + kChargeRegen, kChargeMax);
  s.charge = max(charge, 0);

  int vx = ((s.vx * kFrictionNum) >> 8) + axis(inp, kInputXp, kInputXm) * accel;
  int vy = ((s.vy * kFrictionNum) >> 8) + axis(inp, kInputYp, kInputYm) * accel;
  int vz = ((s.vz * kFrictionNum) >> 8) + axis(inp, kInputZp, kInputZm) * accel;

  // 3-D speed clamp
  const int m2 = vx * vx + vy * vy + vz * vz;
  if (m2 > kMaxSpeed * kMaxSpeed) {
    int mag = exg::isqrt24(m2);
    mag = mag == 0 ? 1 : mag;
    vx = exg::floor_div_pos(vx * kMaxSpeed, mag);
    vy = exg::floor_div_pos(vy * kMaxSpeed, mag);
    vz = exg::floor_div_pos(vz * kMaxSpeed, mag);
  }
  s.vx = vx;
  s.vy = vy;
  s.vz = vz;

  // integrate on the torus
  s.px = (s.px + vx) & kSpaceMask;
  s.py = (s.py + vy) & kSpaceMask;
  s.pz = (s.pz + vz) & kSpaceMask;
}

__device__ __forceinline__ void entity_weights(const Weights& cw, uint32_t gi,
                                               uint32_t (&ew)[kPlanes]) {
#pragma unroll
  for (int k = 0; k < kPlanes; ++k) ew[k] = (cw.w[k] * gi + cw.base[k]) * kGolden32;
}

// this entity's terms of the (hi, lo) checksum, frame term excluded
__device__ __forceinline__ void checksum_terms(const State& s, const uint32_t (&ew)[kPlanes],
                                               uint32_t& hi, uint32_t& lo) {
  const uint32_t v[kPlanes] = {(uint32_t)s.px, (uint32_t)s.py, (uint32_t)s.pz, (uint32_t)s.vx,
                               (uint32_t)s.vy, (uint32_t)s.vz, (uint32_t)s.charge};
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
  return State{p[e], p[n + e], p[2 * n + e], p[3 * n + e], p[4 * n + e], p[5 * n + e], p[6 * n + e]};
}

__device__ __forceinline__ void store(int* p, size_t n, size_t e, const State& s) {
  p[e] = s.px;
  p[n + e] = s.py;
  p[2 * n + e] = s.pz;
  p[3 * n + e] = s.vx;
  p[4 * n + e] = s.vy;
  p[5 * n + e] = s.vz;
  p[6 * n + e] = s.charge;
}

// Model traits for the per-entity bodies (synctest_body.cuh, resim_tick.cu,
// beam_rollout.cu); swarm has no substeps, so `substeps` is unused
struct Model {
  static constexpr int kPlanes = swarm::kPlanes;
  using State = swarm::State;
  using Weights = swarm::Weights;
  static __device__ __forceinline__ State load(const int* p, size_t n, size_t e) {
    return swarm::load(p, n, e);
  }
  static __device__ __forceinline__ void store(int* p, size_t n, size_t e, const State& s) {
    swarm::store(p, n, e, s);
  }
  static __device__ __forceinline__ void entity_weights(const Weights& cw, uint32_t gi,
                                                        uint32_t (&ew)[kPlanes]) {
    swarm::entity_weights(cw, gi, ew);
  }
  static __device__ __forceinline__ void checksum_terms(const State& s, const uint32_t (&ew)[kPlanes],
                                                        uint32_t& hi, uint32_t& lo) {
    swarm::checksum_terms(s, ew, hi, lo);
  }
  static __device__ __forceinline__ void step(State& s, int inp, int) { swarm::step(s, inp); }
};

}  // namespace swarm
