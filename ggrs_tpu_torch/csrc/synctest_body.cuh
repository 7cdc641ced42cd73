// What the SyncTest kernels share: the batch's arguments, the steppers'
// interface, the entity-tiled batch body (`synctest_entity_batch`, K2's
// for ex_game, swarm and arena on an injected table, synctest_tiled.cu;
// K1 has a body of its own, synctest_fused.cu, in the same event layout),
// and the bookkeeping and first-seen verdict both run after a batch. The
// model's state, load/store and checksum terms come in as a traits struct
// (exg::Model, swarm::Model, arena::Model), and its step as a stepper
// object, which also owns whatever the step needs besides the entity's own
// state and its owner's input (arena's per-team centroids: cached, inline
// or injected).
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

#include <climits>

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
// below keeps its own copy (calling the shared helpers there once made a
// batch about 3% slower on an H100), as does K1's fused_batch
// (synctest_fused.cu). A change to one copy belongs in all.
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

// Where a batch's events fall, in closed form. Tick t (frame c = c0 + t)
// re-saves frames c-d+1..c-1 when c > d and always saves frame c, so the
// frames a batch saves are the contiguous run [lo_f, c_last]: frame f >= c0
// first appears at tick f - c0 as the frontier save (event index
// (f - c0) d + d - 1), and frame f < c0 at the first rollback tick t1 (frame
// c1 = max(c0, d+1)) as a re-save. The frame below f in f's slot (of d+2),
// f - d - 2, has its last event at tick frame f - 3, before f's first, and
// the one above it its first after f's last (tick frame f + d - 1): no other
// frame takes f's history or ring slot between f's first event and its last.
struct BatchFrames {
  int c0, t_ticks, d, c_last, c1, lo_f;

  __device__ __forceinline__ BatchFrames(int c0_, int t_ticks_, int d_)
      : c0(c0_), t_ticks(t_ticks_), d(d_), c_last(c0_ + t_ticks_ - 1), c1(max(c0_, d_ + 1)) {
    lo_f = c1 <= c_last ? min(c0, c1 - d + 1) : c0;
  }
  // the frame of event (t, j), or -1 when the event did not happen
  __device__ __forceinline__ int frame(int t, int j) const {
    const int c = c0 + t;
    if (j == d - 1) return c;
    return c > d ? c - d + 1 + j : -1;
  }
  // the ordered index t d + j of frame f's first event (f in [lo_f, c_last])
  __device__ __forceinline__ int first_event(int f) const {
    return f >= c0 ? (f - c0) * d + d - 1 : (c1 - c0) * d + (f - (c1 - d + 1));
  }
  // the highest frame the batch saves in slot h of a ring of `len` slots, or
  // -1 when it saves none there
  __device__ __forceinline__ int last_in_slot(int h, int len) const {
    const int g = c_last - (((c_last - h) % len) + len) % len;
    return g >= lo_f ? g : -1;
  }
};

// The same, by the whole block (every thread calls it), in place, for K1's
// tail: slot s takes the highest frame saved there, and input slot s the
// inputs of the batch's last tick c with c % (d+2) == s; slots the batch
// does not touch keep what they held. K2 keeps the one-thread form above,
// run by one thread of block 0 beside the batch, off its critical path:
// the block form there changes K2's code generation (on an H100,
// scripts/kernel_ab.py: 2-3% faster at 1M ex_game entities and on the
// inline route, 0.5% slower at 1M swarm entities).
__device__ void synctest_bookkeeping_block(int* r_frame, int* iring, const int* inputs, int c0, int t_ticks, int d,
                                           int row) {
  const int ring_len = d + 2;
  const BatchFrames b(c0, t_ticks, d);
  for (int s = threadIdx.x; s < ring_len; s += blockDim.x) {
    const int g = b.last_in_slot(s, ring_len);
    if (g >= 0) r_frame[s] = g;
  }
  for (int k = threadIdx.x; k < ring_len * row; k += blockDim.x) {
    const int s = k / row;
    const int c = b.c_last - (((b.c_last - s) % ring_len) + ring_len) % ring_len;  // the last tick in slot s
    if (c >= c0) iring[k] = inputs[(size_t)(c - c0) * row + k % row];
  }
}

// shared memory the verdict needs, in words: the carried history and the
// block's lowest mismatching event
__host__ __device__ inline size_t verdict_smem_words(int d) { return 3 * (size_t)(d + 2) + 1; }

// The first-seen checksum history and mismatch latch over the batch's
// events (ggrs_tpu/tpu/pallas_tiled.py:468-523, the same compare the
// whole-batch kernel makes at each save), by the whole block: every thread
// calls it. It gives the bits of the serial scan in (t, j) order
// (device/tiled_core.py `plain_verdict`) from the closed form of
// `BatchFrames`: an event of frame f is compared with the carried history
// when the carried tag of f's slot is f and no lower frame of that slot is
// in the batch, else with f's first event; the lowest-ordered event that
// differs latches, unless a mismatch is latched already; the final slot
// holds the highest frame that reaches it with that frame's first-seen
// value. A thread an event (strided), a block min over the differing
// events' order, a thread a slot. The frame term is folded into each
// event's parts here. `sh` holds verdict_smem_words(d) words. Sets meta to
// (c0 + T, mismatch, mismatch_frame).
__device__ void synctest_verdict(const uint32_t* parts_hi, const uint32_t* parts_lo, int t_ticks,
                                 int d, uint32_t frame_weight, int* h_tag, int* h_hi, int* h_lo,
                                 int* meta, int* sh) {
  const int hist = d + 2, events = t_ticks * d;
  int* tag = sh;
  int* hhi = sh + hist;
  int* hlo = sh + 2 * hist;
  int* first_bad = sh + 3 * hist;
  const int c0 = meta[0], mismatch = meta[1], mismatch_frame = meta[2];
  for (int h = threadIdx.x; h < hist; h += blockDim.x) {
    tag[h] = h_tag[h];
    hhi[h] = h_hi[h];
    hlo[h] = h_lo[h];
  }
  if (threadIdx.x == 0) *first_bad = INT_MAX;
  __syncthreads();  // every thread has read meta and the history

  const BatchFrames b(c0, t_ticks, d);
  // frame f's reference (hi, lo); `carried`: the history's, which even f's
  // first event is compared with. parts were summed with atomics in L2:
  // read them there
  auto reference = [&](int f, uint32_t& hi, uint32_t& lo) -> bool {
    const int h = f % hist;
    if (tag[h] == f && f - hist < b.lo_f) {
      hi = (uint32_t)hhi[h];
      lo = (uint32_t)hlo[h];
      return true;
    }
    const int e = b.first_event(f);
    hi = __ldcg(&parts_hi[e]) + (uint32_t)f * frame_weight;
    lo = __ldcg(&parts_lo[e]) + (uint32_t)f;
    return false;
  };
  int bad = INT_MAX;
  for (int e = threadIdx.x; e < events; e += blockDim.x) {
    const int f = b.frame(e / d, e % d);
    if (f < 0) continue;
    uint32_t rhi, rlo;
    if (!reference(f, rhi, rlo) && e == b.first_event(f)) continue;
    const uint32_t hi = __ldcg(&parts_hi[e]) + (uint32_t)f * frame_weight;
    const uint32_t lo = __ldcg(&parts_lo[e]) + (uint32_t)f;
    if (hi != rhi || lo != rlo) bad = min(bad, e);
  }
  bad = __reduce_min_sync(0xFFFFFFFFu, bad);
  if ((threadIdx.x & 31) == 0 && bad != INT_MAX) atomicMin(first_bad, bad);
  __syncthreads();

  for (int h = threadIdx.x; h < hist; h += blockDim.x) {
    const int g = b.last_in_slot(h, hist);
    if (g < 0) continue;
    uint32_t rhi, rlo;
    reference(g, rhi, rlo);
    h_tag[h] = g;
    h_hi[h] = (int)rhi;
    h_lo[h] = (int)rlo;
  }
  if (threadIdx.x == 0) {
    const int e = *first_bad;
    meta[0] = c0 + t_ticks;
    meta[1] = mismatch | (e != INT_MAX ? 1 : 0);
    meta[2] = mismatch || e == INT_MAX ? mismatch_frame : b.frame(e / d, e % d);
  }
}
