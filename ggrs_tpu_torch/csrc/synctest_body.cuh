// The SyncTest batch body shared by the whole-batch kernels
// (synctest_fused.cu) and the entity-tiled kernels (synctest_tiled.cu), for
// every model: the model's state, load/store and checksum terms come in as
// a traits struct (exg::Model, swarm::Model, arena::Model), and
// its step as a stepper object, which also owns whatever the step needs
// besides the entity's own state and its owner's input (arena's per-team
// centroids: cached, inline or injected).
//
// One thread owns one entity for the whole batch of T ticks: its state stays
// in registers, and it reads and writes only its own column of the snapshot
// ring. Per tick it does what the reference's tick does
// (ggrs_tpu/tpu/sync_test.py:261-298): once past check_distance d, load frame
// c-d from the ring, resimulate d frames while re-saving frames c-d+1..c-1,
// then save frame c and step with the new input. A stepper may make blocks
// wait for each other (arena's grid barriers); every thread of the grid then
// runs the same sequence of steps, active or not, which this loop guarantees
// (c, d and T are uniform).
//
// Each save is a checksum EVENT. The event layout is the reference tiled
// kernel's (ggrs_tpu/tpu/pallas_tiled.py:25-28): for tick t (frame c=c0+t)
//   parts[t, j], j < d-1: the re-save of frame c-d+1+j (valid iff c > d)
//   parts[t, d-1]:        the save of frame c          (always valid)
// A block reduces each event's (hi, lo) terms (warp shuffles, then one
// shared-memory pass per tick) and adds them to parts with uint32 atomics;
// uint32 addition commutes, so the sums are exact in any order. Invalid
// events add nothing, so their parts stay 0.
#pragma once

#include "block.cuh"

template <class Weights>
struct SyncTestArgs {
  int* state;          // [planes, n] live world, updated in place
  int* ring;           // [d+2, planes, n] snapshot ring, updated in place
  const int* iring;    // [d+2, P, I] input ring as the batch found it
  const int* inputs;   // [T, P, I] the batch's inputs
  const int* meta;     // meta[0]: frame of the batch's first tick
  uint32_t* parts_hi;  // [T, d] zeroed before launch
  uint32_t* parts_lo;  // [T, d]
  int n, num_players, input_size, d, t_ticks, substeps;
  Weights cw;
};

// The stepper of a model with no reduction (ex_game, swarm): the step of
// one entity reads its owner's input byte; `substeps` is ex_game's
template <class M>
struct EntityStepper {
  int substeps;
  __device__ __forceinline__ void seed(const typename M::State&, bool) {}
  // f: the frame stepped; i: the resim step's index (d: the frontier step)
  __device__ __forceinline__ void step(typename M::State& s, bool, const int* in, int, int) {
    M::step(s, in[0], substeps);
  }
  __device__ __forceinline__ void frontier_done(const typename M::State&, bool, int, int) {}
};

// dynamic shared memory the body needs: red[2 ticks][hi, lo][d][warps]
__host__ __device__ inline size_t body_smem_words(int d) { return (size_t)4 * d * kWarps; }

// One entity's save: its state into a ring slot, and its (hi, lo) checksum
// terms, for the inline arena body (synctest_tiled.cu). synctest_entity_batch
// below keeps its own copy: calling the shared helpers there made K1's
// cached arena batch about 3% slower on an H100 (chip_smoke.py, parent
// against change). A change to one copy belongs in both.
template <class M>
__device__ __forceinline__ void save_entity(int* slot, size_t n, int e, const typename M::State& s,
                                            const uint32_t (&ew)[M::kPlanes], uint32_t& hi, uint32_t& lo) {
  M::store(slot, n, e, s);
  M::checksum_terms(s, ew, hi, lo);
}

template <class M, class Stepper>
__device__ void synctest_entity_batch(const SyncTestArgs<typename M::Weights>& a, uint32_t* red,
                                      Stepper& st) {
  using State = typename M::State;
  const int e = blockIdx.x * kBlock + threadIdx.x;
  const bool active = e < a.n;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int d = a.d, ring_len = d + 2, row = a.num_players * a.input_size;
  const int owner_col = (e % a.num_players) * a.input_size;  // the owner's input bytes
  const int c0 = a.meta[0];
  const size_t n = (size_t)a.n, slot_stride = (size_t)M::kPlanes * n;

  uint32_t ew[M::kPlanes];
  M::entity_weights(a.cw, (uint32_t)e, ew);
  State s = active ? M::load(a.state, n, e) : State{};
  st.seed(s, active);

  // input of frame f: this batch's inputs for f >= c0, else the input ring
  // (it holds frames c0-d-2..c0-1, every frame a rollback can reach back to)
  auto input_of = [&](int f) -> const int* {
    const int* r = f >= c0 ? a.inputs + (size_t)(f - c0) * row : a.iring + (size_t)(f % (d + 2)) * row;
    return r + owner_col;
  };
  auto save = [&](const State& state, int f, int t, int j) {
    uint32_t hi = 0, lo = 0;
    if (active) {
      M::store(a.ring + (size_t)(f % ring_len) * slot_stride, n, e, state);
      M::checksum_terms(state, ew, hi, lo);
    }
    hi = warp_sum(hi);
    lo = warp_sum(lo);
    if (lane == 0) {
      uint32_t* buf = red + (size_t)(t & 1) * 2 * d * kWarps;
      buf[j * kWarps + warp] = hi;
      buf[(d + j) * kWarps + warp] = lo;
    }
  };

  for (int t = 0; t < a.t_ticks; ++t) {
    const int c = c0 + t;
    if (c > d) {  // forced rollback (uniform across the grid: c is shared)
      const int base = c - d;
      if (active) s = M::load(a.ring + (size_t)(base % ring_len) * slot_stride, n, e);
      for (int i = 0; i < d; ++i) {
        const int f = base + i;
        if (i > 0) save(s, f, t, i - 1);
        st.step(s, active, input_of(f), f, i);
      }
    }
    save(s, c, t, d - 1);
    st.step(s, active, a.inputs + (size_t)t * row + owner_col, c, d);
    st.frontier_done(s, active, c, t);

    // one barrier per tick; the double buffer (t & 1) keeps the next tick's
    // writers off the buffer this tick's readers still sum
    __syncthreads();
    const uint32_t* buf = red + (size_t)(t & 1) * 2 * d * kWarps;
    for (int j = threadIdx.x; j < d; j += kBlock) {
      if (j == d - 1 || c > d) {
        uint32_t hi = 0, lo = 0;
        for (int w = 0; w < kWarps; ++w) {
          hi += buf[j * kWarps + w];
          lo += buf[(d + j) * kWarps + w];
        }
        atomicAdd(&a.parts_hi[(size_t)t * d + j], hi);
        atomicAdd(&a.parts_lo[(size_t)t * d + j], lo);
      }
    }
  }
  if (active) M::store(a.state, n, e, s);
}

// Ring-frame tags and the evolved input ring, by ONE thread: replays the
// batch's valid saves in order (r_frame[f % (d+2)] = f) and writes each
// tick's inputs into slot c % (d+2). iring_out may alias iring_in.
__device__ void synctest_bookkeeping(int* r_frame, const int* iring_in, int* iring_out,
                                     const int* inputs, int c0, int t_ticks, int d, int row) {
  const int ring_len = d + 2;
  if (iring_out != iring_in)
    for (int k = 0; k < ring_len * row; ++k) iring_out[k] = iring_in[k];
  for (int t = 0; t < t_ticks; ++t) {
    const int c = c0 + t;
    if (c > d)
      for (int f = c - d + 1; f < c; ++f) r_frame[f % ring_len] = f;
    r_frame[c % ring_len] = c;
    for (int k = 0; k < row; ++k) iring_out[(c % ring_len) * row + k] = inputs[(size_t)t * row + k];
  }
}

// The first-seen checksum history and mismatch latch, by ONE thread, over
// the batch's events in (t, j) order (ggrs_tpu/tpu/pallas_tiled.py:468-523,
// the same compare the whole-batch kernel makes at each save): fold the
// frame term into each valid event's parts, record the first checksum seen
// for a frame, compare every later one against it, latch the first
// disagreement. `sh` holds 3 * (d+2) words of shared memory. Sets meta to
// (c0 + T, mismatch, mismatch_frame).
__device__ void synctest_verdict(const uint32_t* parts_hi, const uint32_t* parts_lo, int t_ticks,
                                 int d, uint32_t frame_weight, int* h_tag, int* h_hi, int* h_lo,
                                 int* meta, int* sh) {
  const int hist = d + 2;
  int* tag = sh;
  int* hhi = sh + hist;
  int* hlo = sh + 2 * hist;
  for (int h = 0; h < hist; ++h) {
    tag[h] = h_tag[h];
    hhi[h] = h_hi[h];
    hlo[h] = h_lo[h];
  }
  const int c0 = meta[0];
  int mismatch = meta[1], mismatch_frame = meta[2];
  for (int t = 0; t < t_ticks; ++t) {
    const int c = c0 + t;
    for (int j = 0; j < d; ++j) {
      if (j < d - 1 && c <= d) continue;  // no rollback: the re-saves did not happen
      const int frame = j < d - 1 ? c - d + 1 + j : c;
      // parts were summed with atomics in L2: read them there
      const uint32_t hi = __ldcg(&parts_hi[(size_t)t * d + j]) + (uint32_t)frame * frame_weight;
      const uint32_t lo = __ldcg(&parts_lo[(size_t)t * d + j]) + (uint32_t)frame;
      const int h = frame % hist;
      const bool seen = tag[h] == frame;
      if (seen && ((uint32_t)hhi[h] != hi || (uint32_t)hlo[h] != lo)) {
        if (!mismatch) mismatch_frame = frame;
        mismatch = 1;
      }
      tag[h] = frame;
      if (!seen) {
        hhi[h] = (int)hi;
        hlo[h] = (int)lo;
      }
    }
  }
  for (int h = 0; h < hist; ++h) {
    h_tag[h] = tag[h];
    h_hi[h] = hhi[h];
    h_lo[h] = hlo[h];
  }
  meta[0] = c0 + t_ticks;
  meta[1] = mismatch;
  meta[2] = mismatch_frame;
}
