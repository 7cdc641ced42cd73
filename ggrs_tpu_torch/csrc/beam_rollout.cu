// K4 — the speculative beam rollout for ex_game, swarm and arena on Hopper.
//
// Replaces: ggrs_tpu/tpu/pallas_beam.py, PallasBeamRollout._build (the
// pallas_call at :226) with run_kernel (:253) and finish (:268), and the
// anchor checksum ResimCore._speculate_pallas computes beside it in XLA
// (ggrs_tpu/tpu/resim.py:1013). From ONE anchor snapshot (ring slot
// `anchor_slot`, frame tag r_frame[anchor_slot]) it rolls B candidate
// scripts L frames each: traj[b, l] is member b's state after step l
// (frame anchor + 1 + l), his/los[b, l] its (hi, lo) checksum, and a_hi/a_lo
// the anchor's. A DISCONNECTED cell steps with the game's disconnect input,
// as in the request path's tick (resim_tick.cu), so any statuses work.
//
// Script layout (int32): [B, L, P, 1 + I], per cell its status then its
// input bytes; ex_game reads the first byte.
//
// Design (ex_game and swarm, one template over the model's traits,
// exg::Model or swarm::Model; arena's body is below). The TPU kernel walks
// entity tiles in order and carries the per-(member, step) partial
// checksums across tiles in SMEM. Here blocks run in parallel and in no
// order, so the grid is 2-D: blockIdx.x an entity tile of 128, blockIdx.y a
// member. One thread owns one (entity, member): it loads its anchor column
// once, steps it L times in registers and after each step writes the
// column to traj[b, l] with streaming stores (each plane a coalesced 512 B
// row per block; adoption reads back only part of the trajectory). The
// member axis multiplies the parallelism by B — at 4096 entities one
// thread per entity would leave 32 blocks for 132 SMs — and each thread's
// serial chain is L steps, not B·L. Each step's checksum terms are summed
// per warp by `redux.sync` (`__reduce_add_sync`), one shared-memory word
// per (step, warp), all rows summed after ONE block barrier and added to
// parts[b, l] with uint32 atomics, exact in any order. The member-0 blocks
// add one more row, the anchor's terms. Each member has a ticket: the LAST
// of its blocks folds the frame terms into the member's rows (parts_hi +
// frame * frame_weight, parts_lo + frame; the anchor's row too for member
// 0) and leaves them and the ticket zero, so the folds spread over the
// members and the scratch is the core's, zeroed once: a speculation is one
// launch with no memset and no PyTorch epilogue.
//
// Measured on an H100 (PERF.md, Findings): two or four members a thread (the
// anchor load and the entity weights shared, the members' chains side by
// side) ran 30% and 94% behind one at 4096 ex_game entities (swarm: 4%
// ahead, 41% behind) and level and 4% behind at 65536, so a thread steps
// one member; plain stores instead of streaming ones ran 9% behind at 65536
// and level at 4096; fencing only the threads that added to parts, not
// every thread with its trajectory stores in flight, gains 0.5-3%.
//
// What bounds it on an H100: per entity the anchor is read once (20 B) and
// B·L trajectory columns written (20 B each): 14.5 MB at 4096 entities and
// B·L = 16·11, 0.0043 ms at 3.35 TB/s; its int32 work is 69 ops per step
// and 15 per checksum, B·L·84 per entity, 0.0036 ms on 16.7 Tops/s. At
// 4096 entities each thread's chain of L dependent steps and the launch's
// fixed costs (the ticket, the fold) set the time; at 65536 entities (B =
// 12) the 173 MB of trajectory writes should. Swarm's columns are 28 B (7
// planes), its step 49 ops and its checksum 21: bytes bound it at 4096 as
// well.
#include <cuda_runtime.h>

#include "arena_reduce.cuh"
#include "block.cuh"
#include "ex_game_step.cuh"
#include "swarm_step.cuh"

namespace {

constexpr int kDisconnected = 2;  // InputStatus.DISCONNECTED

template <class Weights>
struct BeamArgs {
  const int* anchor;        // [K, n] ring[anchor_slot] (K planes)
  const int* anchor_frame;  // [1] r_frame[anchor_slot]
  const int* script;        // [B, L, P, 1 + I]
  int* traj;                // [B, L, K, n] out
  int* out;                 // [2*B*L + 3] out: his[B*L], los[B*L], a_hi, a_lo, frame
  uint32_t* parts_hi;       // [B*L + 1], the anchor's row last: zero on entry, left zero
  uint32_t* parts_lo;       // [B*L + 1]
  uint32_t* done;           // [B] the members' tickets: zero on entry, left zero
  int n, num_players, input_size, beam, steps, substeps, disconnect_input;
  Weights cw;
};

// a column into planes [K, n] with streaming stores (evict first)
template <class M>
__device__ __forceinline__ void store_streaming(int* p, size_t n, size_t e, const typename M::State& s) {
  int col[M::kPlanes];
  M::store(col, 1, 0, s);
#pragma unroll
  for (int k = 0; k < M::kPlanes; ++k) __stcs(p + k * n + e, col[k]);
}

template <class M>
__global__ void __launch_bounds__(kBlock) beam_rollout_kernel(BeamArgs<typename M::Weights> a) {
  extern __shared__ int smem[];
  const int L = a.steps, P = a.num_players, I = a.input_size;
  int* inp = smem;                                         // [L][P] resolved input bytes
  uint32_t* red = reinterpret_cast<uint32_t*>(smem + L * P);  // [hi, lo][L + 1][warps]

  const int b = blockIdx.y;
  const int e = blockIdx.x * kBlock + threadIdx.x;
  const bool active = e < a.n;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t n = (size_t)a.n, slot_stride = (size_t)M::kPlanes * n;

  // member b's script, with the disconnect substitution, into shared memory
  for (int k = threadIdx.x; k < L * P; k += kBlock) {
    const int* cell = a.script + ((size_t)b * L * P + k) * (1 + I);
    inp[k] = cell[0] == kDisconnected ? a.disconnect_input : cell[1];
  }

  uint32_t ew[M::kPlanes];
  M::entity_weights(a.cw, (uint32_t)e, ew);
  typename M::State s = active ? M::load(a.anchor, n, e) : typename M::State{};
  const int owner = e % P;
  // a warp's sums of one row's checksum terms (row L: the anchor's)
  auto put = [&](int row, uint32_t hi, uint32_t lo) {
    hi = __reduce_add_sync(0xFFFFFFFFu, hi);
    lo = __reduce_add_sync(0xFFFFFFFFu, lo);
    if (lane == 0) {
      red[row * kWarps + warp] = hi;
      red[(L + 1 + row) * kWarps + warp] = lo;
    }
  };

  const bool anchor_row = b == 0;
  if (anchor_row) {
    uint32_t hi = 0, lo = 0;
    if (active) M::checksum_terms(s, ew, hi, lo);
    put(L, hi, lo);
  }
  __syncthreads();  // the staged script

  int* traj_b = a.traj + (size_t)b * L * slot_stride;
  for (int l = 0; l < L; ++l) {
    uint32_t hi = 0, lo = 0;
    if (active) {
      M::step(s, inp[l * P + owner], a.substeps);
      store_streaming<M>(traj_b + (size_t)l * slot_stride, n, e, s);
      M::checksum_terms(s, ew, hi, lo);
    }
    put(l, hi, lo);
  }
  __syncthreads();
  const int rows = L + (anchor_row ? 1 : 0);
  for (int j = threadIdx.x; j < rows; j += kBlock) {
    uint32_t hi = 0, lo = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      hi += red[j * kWarps + w];
      lo += red[(L + 1 + j) * kWarps + w];
    }
    const size_t k = j < L ? (size_t)b * L + j : (size_t)a.beam * L;
    atomicAdd(&a.parts_hi[k], hi);
    atomicAdd(&a.parts_lo[k], lo);
  }

  // member b's ticket: the threads that added to parts fence their atomics
  // (only they: a fence in every thread would wait for its trajectory
  // stores to drain), then one ticket a block; the block that draws the
  // member's last sees its parts
  __shared__ bool is_last;
  if ((int)threadIdx.x < rows) __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(&a.done[b], 1u) == gridDim.x - 1;
  __syncthreads();
  if (!is_last) return;
  if ((int)threadIdx.x < rows) __threadfence();
  // finish (pallas_beam.py:268): fold the frame terms into member b's rows
  // (and the anchor's), and leave them and the ticket zero
  const int frame = *a.anchor_frame;
  const int bl = a.beam * L;
  for (int j = threadIdx.x; j < rows; j += kBlock) {
    const size_t k = j < L ? (size_t)b * L + j : (size_t)bl;
    // parts were summed with atomics in L2: read them there
    const uint32_t f = j < L ? (uint32_t)(frame + 1 + j) : (uint32_t)frame;
    const uint32_t hi = __ldcg(&a.parts_hi[k]) + f * a.cw.frame_weight;
    const uint32_t lo = __ldcg(&a.parts_lo[k]) + f;
    a.parts_hi[k] = 0;
    a.parts_lo[k] = 0;
    if (j < L) {
      a.out[k] = (int)hi;
      a.out[bl + k] = (int)lo;
    } else {
      a.out[2 * bl] = (int)hi;
      a.out[2 * bl + 1] = (int)lo;
      a.out[2 * bl + 2] = frame;
    }
  }
  if (threadIdx.x == 0) a.done[b] = 0;
}

// ---------------------------------------------------------------------------
// Arena. Before every step each member reduces its OWN world (per team: the
// living count, Σ px>>6, Σ py>>6), as the reference's single-tile rollout
// does inline (pallas_beam.py:69-103); the reference sends B·L windows past
// its single tile to XLA (resim.py:958-1000), this kernel runs them itself.
// The members are independent, so each has a group of `group` blocks of its
// own, each block owning a contiguous run of the member's entities (a
// thread an entity in whole warps, up to 1024), and only a member's blocks
// wait for each other: a reduction is block sums -> uint32 atomics into the
// member's raw row [L][3P] in global memory -> a barrier on the member's
// own arrival counter (grid_arrive / grid_wait: release, acquire) -> a
// finalize in every block of the group. The grid is cooperative (its
// blocks co-resident: at most one an SM) and holds `members` groups; a
// group serves members g, g + members, ... in turn, so any B runs. The
// layout comes from the host (device/beam_core.py `beam_plan`).
//
// A block keeps its run's states in shared memory from step to step while
// they fit (kOnChip), else it reads each step's state back from the
// trajectory it wrote (traj[b, l-1], from L2). Every step's state goes to
// traj[b, l]: adoption reads it. Each member reduces the anchor itself; the
// anchor's checksum is member 0's. Team sums are O(1) an entity
// (`arena::warp_team_add`). Each warp keeps its sums of each step's
// checksum terms in shared memory, and a block adds them to parts once a
// member: one atomic a block and step. The LAST block to finish (a ticket)
// folds the frame terms (`finish`, pallas_beam.py:268) and leaves the
// parts, the ticket, the counters and the raw rows zero: the scratch is the
// core's, zeroed once, and a call is one launch.
//
// A thread-block cluster a member (the group's sums through distributed
// shared memory, a cluster barrier a step; a block a member as its group of
// one) was measured beside this layout and removed: on an H100 it trailed
// at 4096 entities (0.0382 against 0.0357 ms at 16 x 11) and by far at
// 65536 (0.226 against 0.123: about two waves of clusters, though how many
// clusters of 8 blocks of 1024 threads fit the card at once was not
// measured); a block a member took 0.071 and 0.798 ms.
//
// What bounds it on an H100: per entity-member-step 64 int32 ops of step, 6
// of reduction and 18 of checksum, and 24 B written to the trajectory. At
// 65536 entities x 16 members x 11 steps the 277 MB trajectory bounds a
// launch at ~0.08 ms of HBM writes; at 4096 entities each step's chain of
// pass, block sums, barrier and finalize sets the time.
namespace beam_arena {

constexpr int kThreads = 1024;  // at most, a block (64 registers a thread: one such block an SM)
constexpr int kMaxWarps = kThreads / 32;
constexpr int kMaxGroup = 8;  // blocks a member at most

struct Args {
  const int* anchor;            // [6, n] ring[anchor_slot]
  const int* anchor_frame;      // [1] r_frame[anchor_slot]
  const int* script;            // [B, L, P, 1 + I]
  int* traj;                    // [B, L, 6, n] out
  int* out;                     // [2*B*L + 3] out: his[B*L], los[B*L], a_hi, a_lo, frame
  uint32_t* parts_hi;           // [B*L + 1], the anchor's row last: zero on entry, left zero
  uint32_t* parts_lo;           // [B*L + 1]
  uint32_t* done;               // last-block ticket, zero on entry, left zero
  unsigned long long* arrived;  // [B] the members' arrival counters, zero on entry, left zero
  uint32_t* raw;                // [B, L, 3P] the members' raw team sums, zero on entry, left zero
  int n, num_players, input_size, beam, steps, group, per_block;
  int disc_input, disc_throttle;  // the disconnect row: input byte, throttle
  arena::Weights cw;
};

// The block's dynamic shared memory, in words, in this order (device/
// beam_core.py `beam_smem_bytes` mirrors it): finalized teams [3P], the
// team rows [nrows][3P], the member's resolved script [L][P][2], each
// warp's checksum sums [L + 1][kMaxWarps][2] (the anchor's last), then the
// block's states [6][per_block] when they stay on chip.
template <bool kOnChip>
__global__ void __launch_bounds__(kThreads, 1) rollout_kernel(Args a) {
  extern __shared__ int smem_words[];
  uint32_t* smem = reinterpret_cast<uint32_t*>(smem_words);
  const int L = a.steps, P = a.num_players, I = a.input_size, B = a.beam, G = a.group;
  const bool own_row = P <= arena::kRowTeams;
  arena::Team* fin = reinterpret_cast<arena::Team*>(smem);
  uint32_t* rows = smem + 3 * P;
  int* inp = reinterpret_cast<int*>(rows + (own_row ? kMaxWarps : 1) * 3 * P);
  uint32_t* evs = reinterpret_cast<uint32_t*>(inp + 2 * L * P);
  int* st = reinterpret_cast<int*>(evs + 2 * (L + 1) * kMaxWarps);
  const int words = (int)(reinterpret_cast<uint32_t*>(st) - smem);

  const int rank = blockIdx.x % G, members = gridDim.x / G;  // a group's blocks are consecutive
  const int per_block = a.per_block, bd = blockDim.x;
  const int lo = rank * per_block;
  const int count = max(0, min(per_block, a.n - lo));
  const int rounds = (count + bd - 1) / bd;
  const int warps = min(kMaxWarps, (count + 31) / 32);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warp0 = threadIdx.x & ~31;
  const int team0 = (lo + (int)threadIdx.x) % P, team_stride = bd % P;
  const bool fixed = team_stride == 0;  // every round of this thread is the same team: sum in registers
  const size_t n = (size_t)a.n, slot_stride = (size_t)arena::kPlanes * n;
  for (int j = threadIdx.x; j < words; j += bd) smem[j] = 0;

  auto next_team = [&](int team) { return team + team_stride >= P ? team + team_stride - P : team + team_stride; };
  // a warp's team terms of one round into the rows (the whole warp calls it
  // when it holds an entity this round), or, with `fixed`, kept in registers
  auto add_terms = [&](int r, uint32_t o, uint32_t x, uint32_t y, int team, uint32_t (&acc)[3]) {
    if (fixed) {
      acc[0] += o;
      acc[1] += x;
      acc[2] += y;
    } else if (r * bd + warp0 < count) {
      arena::warp_team_add(o, x, y, team, P, false, rows, own_row);
    }
  };
  auto flush_terms = [&](const uint32_t (&acc)[3]) {
    if (fixed && warp0 < count) arena::warp_team_add(acc[0], acc[1], acc[2], team0, P, true, rows, own_row);
  };
  // a warp's sums of one step's checksum terms
  auto put_sums = [&](int row, uint32_t hi, uint32_t lo_sum) {
    hi = warp_sum(hi);
    lo_sum = warp_sum(lo_sum);
    if (lane == 0) {
      evs[(row * kMaxWarps + warp) * 2] = hi;
      evs[(row * kMaxWarps + warp) * 2 + 1] = lo_sum;
    }
  };

  for (int b = blockIdx.x / G; b < B; b += members) {
    // member b's script, with the disconnect substitution (the previous
    // member's last reads of it came before its last block barrier)
    for (int k = threadIdx.x; k < L * P; k += bd) {
      const int* cell = a.script + ((size_t)b * L * P + k) * (1 + I);
      const bool off = cell[0] == kDisconnected;
      inp[2 * k] = off ? a.disc_input : cell[1];
      inp[2 * k + 1] = off ? a.disc_throttle : arena::throttle_of(cell + 1, I);
    }
    // the member's teams for reduction k (0: the anchor; l: the state
    // entering step l) -> fin
    auto reduce = [&](int k) {
      __syncthreads();  // every warp's row adds are in
      uint32_t* row = a.raw + ((size_t)b * L + k) * 3 * P;
      for (int j = threadIdx.x; j < 3 * P; j += bd) {
        const uint32_t v = arena::warp_rows_sum(rows, own_row ? warps : 1, 3 * P, j);
        if (v) atomicAdd(&row[j], v);
      }
      grid_arrive(a.arrived + b);
      grid_wait(a.arrived + b, (unsigned long long)(k + 1) * G);
      for (int t = threadIdx.x; t < P; t += bd) {
        const uint32_t* r = row + 3 * t;  // atomics live in L2: read there
        fin[t] = inline_arena::finalize_sums(__ldcg(r), __ldcg(r + 1), __ldcg(r + 2));
      }
      __syncthreads();
    };

    {  // the anchor: kept, its team terms, and member 0's checksum terms
      uint32_t acc[3] = {0, 0, 0}, hi = 0, lo_sum = 0;
      int team = team0;
      for (int r = 0; r < rounds; ++r, team = next_team(team)) {
        const int i = r * bd + threadIdx.x;
        uint32_t o = 0, x = 0, y = 0;
        if (i < count) {
          const int e = lo + i;
          const arena::State s = arena::load(a.anchor, n, e);
          if (kOnChip) arena::store(st, (size_t)per_block, i, s);
          arena::team_terms(s, o, x, y);
          if (b == 0) {
            uint32_t ew[arena::kPlanes], h, l;
            arena::entity_weights(a.cw, (uint32_t)e, ew);
            arena::checksum_terms(s, ew, h, l);
            hi += h;
            lo_sum += l;
          }
        }
        add_terms(r, o, x, y, team, acc);
      }
      flush_terms(acc);
      if (b == 0) put_sums(L, hi, lo_sum);
      reduce(0);
    }

    for (int l = 0; l < L; ++l) {
      int* traj_l = a.traj + ((size_t)b * L + l) * slot_stride;
      const int* prev = l == 0 ? a.anchor : traj_l - slot_stride;
      const int* in = inp + 2 * l * P;
      const bool terms = l + 1 < L;  // the reduction step l+1 will need
      uint32_t acc[3] = {0, 0, 0}, hi = 0, lo_sum = 0;
      int team = team0;
      for (int r = 0; r < rounds; ++r, team = next_team(team)) {
        const int i = r * bd + threadIdx.x;
        uint32_t o = 0, x = 0, y = 0;
        if (i < count) {
          const int e = lo + i;
          arena::State s = kOnChip ? arena::load(st, (size_t)per_block, i) : arena::load(prev, n, e);
          arena::step(s, in[2 * team], in[2 * team + 1], fin[team], fin[team + 1 == P ? 0 : team + 1]);
          arena::store(traj_l, n, e, s);
          if (kOnChip) arena::store(st, (size_t)per_block, i, s);
          uint32_t ew[arena::kPlanes], h, l2;
          arena::entity_weights(a.cw, (uint32_t)e, ew);
          arena::checksum_terms(s, ew, h, l2);
          hi += h;
          lo_sum += l2;
          if (terms) arena::team_terms(s, o, x, y);
        }
        if (terms) add_terms(r, o, x, y, team, acc);
      }
      if (terms) flush_terms(acc);
      put_sums(l, hi, lo_sum);
      if (terms) reduce(l + 1);
    }

    // the block's checksum sums, one atomic a (member, step)
    __syncthreads();
    for (int j = threadIdx.x; j < 2 * (L + 1); j += bd) {
      const int row = j >> 1, word = j & 1;
      if (row == L && b != 0) continue;
      uint32_t v = 0;
      for (int w = 0; w < warps; ++w) v += evs[(row * kMaxWarps + w) * 2 + word];
      if (v) atomicAdd((word == 0 ? a.parts_hi : a.parts_lo) + (row < L ? (size_t)b * L + row : (size_t)B * L), v);
    }
    __syncthreads();  // evs and inp are the next member's
  }

  // the ticket; the last block folds the frame terms (finish,
  // pallas_beam.py:268) and leaves the scratch zero
  __shared__ bool is_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(a.done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const int frame = *a.anchor_frame;
  const int bl = B * L;
  for (int k = threadIdx.x; k <= bl; k += bd) {
    const uint32_t f = k < bl ? (uint32_t)(frame + 1 + k % L) : (uint32_t)frame;
    const uint32_t hi = __ldcg(&a.parts_hi[k]) + f * a.cw.frame_weight;
    const uint32_t lo_sum = __ldcg(&a.parts_lo[k]) + f;
    a.parts_hi[k] = 0;
    a.parts_lo[k] = 0;
    if (k < bl) {
      a.out[k] = (int)hi;
      a.out[bl + k] = (int)lo_sum;
    } else {
      a.out[2 * bl] = (int)hi;
      a.out[2 * bl + 1] = (int)lo_sum;
      a.out[2 * bl + 2] = frame;
    }
  }
  for (int k = threadIdx.x; k < B; k += bd) a.arrived[k] = 0;
  for (size_t k = threadIdx.x; k < (size_t)B * L * 3 * P; k += bd) a.raw[k] = 0;
  if (threadIdx.x == 0) *a.done = 0;
}

const void* kernel_of(int on_chip) {
  return on_chip ? (const void*)rollout_kernel<true> : (const void*)rollout_kernel<false>;
}

}  // namespace beam_arena

}  // namespace

namespace {

// The rollout of a model with no reduction: one launch. Returns the CUDA
// error of the shared-memory attribute or the launch (0 on success).
template <class M>
int launch_beam(const int* ring, int anchor_slot, const int* r_frame, const int* script, int* traj,
                int* out, uint32_t* scratch, int n, int num_players, int input_size, int beam, int steps,
                int substeps, const int* disconnect_row, const int* cs, void* stream) {
  const size_t rows = (size_t)beam * steps + 1;
  BeamArgs<typename M::Weights> a;
  a.anchor = ring + (size_t)anchor_slot * M::kPlanes * (size_t)n;
  a.anchor_frame = r_frame + anchor_slot;
  a.script = script;
  a.traj = traj;
  a.out = out;
  a.parts_hi = scratch;
  a.parts_lo = scratch + rows;
  a.done = scratch + 2 * rows;
  a.n = n;
  a.num_players = num_players;
  a.input_size = input_size;
  a.beam = beam;
  a.steps = steps;
  a.substeps = substeps;
  a.disconnect_input = disconnect_row[0];  // the step reads byte 0
  a.cw = weights_from<typename M::Weights, M::kPlanes>(cs);
  const size_t smem = ((size_t)steps * num_players + 2 * ((size_t)steps + 1) * kWarps) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(beam_rollout_kernel<M>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((n + kBlock - 1) / kBlock, beam);
  beam_rollout_kernel<M><<<grid, kBlock, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// ring: [slots, K, n]; r_frame: [slots]; scratch: parts_hi [B*L+1],
// parts_lo [B*L+1], the members' tickets [B]: zero before the core's first
// launch, and every launch leaves it so. disconnect_row: the game's disconnect input, I
// ints in host memory.
// ex_game. cs: 11 int32 — checksum w[5], base[5], frame weight.
extern "C" int beam_rollout_launch(const int* ring, int anchor_slot, const int* r_frame,
                                   const int* script, int* traj, int* out, uint32_t* scratch,
                                   int n, int num_players, int input_size, int beam, int steps,
                                   int substeps, const int* disconnect_row, const int* cs,
                                   void* stream) {
  return launch_beam<exg::Model>(ring, anchor_slot, r_frame, script, traj, out, scratch, n, num_players,
                                 input_size, beam, steps, substeps, disconnect_row, cs, stream);
}

// swarm. cs: 15 int32 — checksum w[7], base[7], frame weight.
extern "C" int beam_rollout_swarm_launch(const int* ring, int anchor_slot, const int* r_frame,
                                         const int* script, int* traj, int* out, uint32_t* scratch,
                                         int n, int num_players, int input_size, int beam, int steps,
                                         const int* disconnect_row, const int* cs, void* stream) {
  return launch_beam<swarm::Model>(ring, anchor_slot, r_frame, script, traj, out, scratch, n, num_players,
                                   input_size, beam, steps, 1, disconnect_row, cs, stream);
}

// The card's limits the arena rollout's plan is made from: out[0] the SM
// count, out[1] the shared memory a block may opt in to (bytes).
extern "C" int beam_rollout_arena_limits(int* out) { return (int)card_limits(out); }

// Once per plan (device/beam_core.py `beam_plan`): the shared-memory
// attribute, then the occupancy query: kNotCoResident when the grid of
// `blocks` blocks of `threads` threads cannot be resident at once; else 0
// or a CUDA error.
extern "C" int beam_rollout_arena_prepare(int on_chip, int group, int blocks, int threads, int smem_bytes) {
  if (group < 1 || group > beam_arena::kMaxGroup || blocks % group || threads < 32 ||
      threads > beam_arena::kThreads || threads % 32)
    return (int)cudaErrorInvalidValue;
  return co_resident(beam_arena::kernel_of(on_chip), blocks, threads, smem_bytes);
}

// The arena rollout on the plan `prepare` accepted: a cooperative grid of
// `blocks` blocks of `threads` threads, `group` blocks a member in flight,
// `per_block` entities and `smem_bytes` of dynamic shared memory each.
// ring: [slots, 6, n]; scratch: the members' arrival counters [B] (u64),
// the ticket, parts_hi [B*L+1], parts_lo [B*L+1] and the members' raw rows
// [B, L, 3P]; zero before the core's first launch, and every launch leaves
// it so. Returns the CUDA error of the launch (0 on success).
// disconnect_row: I ints in host memory. cs: 13 int32 — checksum w[6],
// base[6], frame weight.
extern "C" int beam_rollout_arena_launch(const int* ring, int anchor_slot, const int* r_frame,
                                         const int* script, int* traj, int* out, uint32_t* scratch,
                                         int n, int num_players, int input_size, int beam, int steps,
                                         int on_chip, int group, int blocks, int threads, int per_block,
                                         int smem_bytes, const int* disconnect_row, const int* cs, void* stream) {
  const size_t rows = (size_t)beam * steps + 1;
  beam_arena::Args a;
  a.anchor = ring + (size_t)anchor_slot * arena::kPlanes * (size_t)n;
  a.anchor_frame = r_frame + anchor_slot;
  a.script = script;
  a.traj = traj;
  a.out = out;
  a.arrived = reinterpret_cast<unsigned long long*>(scratch);
  a.done = scratch + 2 * (size_t)beam;
  a.parts_hi = a.done + 1;
  a.parts_lo = a.parts_hi + rows;
  a.raw = a.parts_lo + rows;
  a.n = n;
  a.num_players = num_players;
  a.input_size = input_size;
  a.beam = beam;
  a.steps = steps;
  a.group = group;
  a.per_block = per_block;
  a.disc_input = disconnect_row[0];
  a.disc_throttle = input_size >= 2 ? (disconnect_row[1] & 0x0F) : arena::kDefaultThrottle;
  a.cw = weights_from<arena::Weights, arena::kPlanes>(cs);
  void* args[] = {&a};
  const cudaError_t err = cudaLaunchCooperativeKernel(beam_arena::kernel_of(on_chip), dim3(blocks), dim3(threads),
                                                      args, smem_bytes, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
