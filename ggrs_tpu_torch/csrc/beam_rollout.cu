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
// exg::Model or swarm::Model; arena's body is below). The TPU kernel walks entity
// tiles in order and carries the per-(member, step) partial checksums
// across tiles in SMEM. Here blocks run
// in parallel and in no order, so the grid is 2-D: blockIdx.x an entity
// tile of 128, blockIdx.y a member. One thread owns one (entity, member):
// it loads its anchor column once (ex_game: 5 planes, 20 B), steps it L times in
// registers and, after each step, writes the column to traj[b, l] (each
// plane a coalesced 512 B row per block). The member axis multiplies the
// parallelism by B — at 4096 entities one thread per entity would leave
// 32 blocks for 132 SMs — and each thread's serial chain is L steps, not
// B·L. Each step's checksum terms are reduced in the block (warp shuffles,
// one shared-memory row per step, all rows summed after ONE barrier) and
// added to parts[b, l] with uint32 atomics, exact in any order. The
// member-0 blocks add one more row, the anchor's terms. The LAST block to
// finish (a done-counter ticket, as in resim_tick.cu) folds in the frame
// terms (parts_hi + frame * frame_weight, parts_lo + frame): one launch per
// speculation, no PyTorch epilogue.
//
// What bounds it on an H100: per entity the anchor is read once (20 B) and
// B·L trajectory columns written (20 B each): 14.5 MB at 4096 entities and
// B·L = 16·11, 0.0043 ms at 3.35 TB/s; its int32 work is 69 ops per step
// and 15 per checksum, B·L·84 per entity, 0.0036 ms on 16.7 Tops/s. At
// 4096 entities the grid is 512 blocks of 128 and each thread's chain of
// L dependent steps sets the time (latency, as for resim_tick at that
// size); at 65536 entities (B = 12) the 173 MB of trajectory writes should
// set it. Swarm's columns are 28 B (7 planes), its step 49 ops and its
// checksum 21: bytes bound it at 4096 as well.
//
// Left for later: several members per thread (the anchor load and the
// entity weights amortised); streaming stores that bypass L2 for the
// trajectory, which the adoption reads back only in part.
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
  uint32_t* parts_hi;       // [B*L + 1] zeroed before launch; the anchor's row last
  uint32_t* parts_lo;       // [B*L + 1]
  uint32_t* done;           // last-block ticket, zeroed before launch
  int n, num_players, input_size, beam, steps, substeps, disconnect_input;
  Weights cw;
};

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

  const bool anchor_row = b == 0;
  if (anchor_row) {
    uint32_t hi = 0, lo = 0;
    if (active) M::checksum_terms(s, ew, hi, lo);
    hi = warp_sum(hi);
    lo = warp_sum(lo);
    if (lane == 0) {
      red[L * kWarps + warp] = hi;
      red[(L + 1 + L) * kWarps + warp] = lo;
    }
  }
  __syncthreads();  // the staged script

  int* traj_b = a.traj + (size_t)b * L * slot_stride;
  for (int l = 0; l < L; ++l) {
    uint32_t hi = 0, lo = 0;
    if (active) {
      M::step(s, inp[l * P + owner], a.substeps);
      M::store(traj_b + (size_t)l * slot_stride, n, e, s);
      M::checksum_terms(s, ew, hi, lo);
    }
    hi = warp_sum(hi);
    lo = warp_sum(lo);
    if (lane == 0) {
      red[l * kWarps + warp] = hi;
      red[(L + 1 + l) * kWarps + warp] = lo;
    }
  }
  __syncthreads();
  const int rows = L + (anchor_row ? 1 : 0);
  for (int j = threadIdx.x; j < rows; j += kBlock) {
    uint32_t hi = 0, lo = 0;
    for (int w = 0; w < kWarps; ++w) {
      hi += red[j * kWarps + w];
      lo += red[(L + 1 + j) * kWarps + w];
    }
    const size_t k = j < L ? (size_t)b * L + j : (size_t)a.beam * L;
    atomicAdd(&a.parts_hi[k], hi);
    atomicAdd(&a.parts_lo[k], lo);
  }

  // last-block-done: every thread fences its own parts atomics, then one
  // ticket per block; the block that draws the last ticket sees all parts
  __shared__ bool is_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(a.done, 1u) == gridDim.x * gridDim.y - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // finish (pallas_beam.py:268): fold the frame terms, once per member x step
  const int frame = *a.anchor_frame;
  const int bl = a.beam * L;
  for (int k = threadIdx.x; k <= bl; k += kBlock) {
    // parts were summed with atomics in L2: read them there
    const uint32_t f = k < bl ? (uint32_t)(frame + 1 + k % L) : (uint32_t)frame;
    const uint32_t hi = __ldcg(&a.parts_hi[k]) + f * a.cw.frame_weight;
    const uint32_t lo = __ldcg(&a.parts_lo[k]) + f;
    if (k < bl) {
      a.out[k] = (int)hi;
      a.out[bl + k] = (int)lo;
    } else {
      a.out[2 * bl] = (int)hi;
      a.out[2 * bl + 1] = (int)lo;
      a.out[2 * bl + 2] = frame;
    }
  }
}

// ---------------------------------------------------------------------------
// Arena. Before every step each member reduces its OWN world (per team: the
// living count, Σ px>>6, Σ py>>6), as the reference's single-tile rollout
// does inline (pallas_beam.py:69-103). The grid is persistent and
// co-resident (cooperative launch, sized by the occupancy query); its blocks
// loop over (member, entity tile) work items, so any B·N runs — the
// reference sends B·L windows past its single tile to XLA
// (resim.py:958-1000), this kernel runs them itself. Step l reads member
// b's world from traj[b, l-1] (from the anchor when l = 0) and writes
// traj[b, l]: no state lives in registers across a barrier. The reduction
// of the state entering step l+1 is taken right after step l, from the
// values just computed, into raw row (l+1, b) of a table the launch zeroed
// ([1 + (L-1)·B, 3P]: the anchor's row serves every member at l = 0); one
// grid barrier before each step makes the rows complete, so a launch waits
// at L barriers. The anchor's reduction and checksum are taken once, by the
// work items of member 0. Per-(member, step) checksum partials go to parts
// with uint32 atomics and the last block folds the frame terms, as for
// ex_game.
//
// What bounds it on an H100: per entity-member-step 64 int32 ops of step,
// 3 + 3P of reduction and 18 of checksum, and 24 B written to the
// trajectory (read back once by the next step, from L2 while a step's
// 24·B·N bytes fit in it). At 65536 entities x 16 members a step writes
// 25 MB; the 277 MB trajectory bounds a launch at ~0.08 ms of HBM writes.

struct ArenaBeamArgs {
  const int* anchor;        // [6, n] ring[anchor_slot]
  const int* anchor_frame;  // [1] r_frame[anchor_slot]
  const int* script;        // [B, L, P, 1 + I]
  int* traj;                // [B, L, 6, n] out
  int* out;                 // [2*B*L + 3] out: his[B*L], los[B*L], a_hi, a_lo, frame
  uint32_t* parts_hi;       // [B*L + 1] zeroed before launch; the anchor's row last
  uint32_t* parts_lo;       // [B*L + 1]
  uint32_t* done;           // last-block ticket, zeroed before launch
  uint32_t* raw;            // [1 + (L-1)*B, 3P] raw team sums, zeroed before launch
  unsigned int* bar;        // [2] grid barrier, zeroed before launch
  int n, num_players, input_size, beam, steps;
  int disc_input, disc_throttle;  // the disconnect row: input byte, throttle
  arena::Weights cw;
};

// this block's sum of (hi, lo) added to parts[k]; `red`: 2 * kWarps words
__device__ __forceinline__ void block_checksum_add(uint32_t hi, uint32_t lo, uint32_t* red,
                                                   uint32_t* parts_hi, uint32_t* parts_lo, size_t k) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  hi = warp_sum(hi);
  lo = warp_sum(lo);
  if (lane == 0) {
    red[warp] = hi;
    red[kWarps + warp] = lo;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t h = 0, l = 0;
    for (int w = 0; w < kWarps; ++w) {
      h += red[w];
      l += red[kWarps + w];
    }
    atomicAdd(&parts_hi[k], h);
    atomicAdd(&parts_lo[k], l);
  }
  __syncthreads();  // red is reused by the next call
}

// dynamic shared memory of the arena rollout, in words: finalized teams
// [B][P], block-sum scratch, checksum sums [2][warps]
__host__ __device__ inline size_t arena_beam_smem_words(int beam, int p) {
  return 3 * (size_t)beam * p + 3 * (size_t)arena::kTeamChunk * kWarps + 2 * (size_t)kWarps;
}

__global__ void __launch_bounds__(kBlock, kArenaMinBlocksPerSm) beam_rollout_arena_kernel(ArenaBeamArgs a) {
  extern __shared__ int smem[];
  const int L = a.steps, P = a.num_players, I = a.input_size, B = a.beam;
  arena::Team* fin = reinterpret_cast<arena::Team*>(smem);           // [B][P]
  uint32_t* scratch = reinterpret_cast<uint32_t*>(fin + (size_t)B * P);  // 3 * kTeamChunk * kWarps
  uint32_t* red = scratch + 3 * arena::kTeamChunk * kWarps;           // [2][warps]

  const int tiles = (a.n + kBlock - 1) / kBlock;
  const int items = B * tiles;  // item = b * tiles + tile
  const size_t n = (size_t)a.n, slot_stride = (size_t)arena::kPlanes * n;
  const size_t raw_row = 3 * (size_t)P;

  // the anchor: its reduction (raw row 0) and its checksum, once per tile
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int e = tile * kBlock + threadIdx.x;
    const bool active = e < a.n;
    const arena::State s = active ? arena::load(a.anchor, n, e) : arena::State{};
    arena::block_team_sums<kWarps>(active, s.px, s.py, s.hp, e % P, P, scratch, a.raw);
    uint32_t hi = 0, lo = 0;
    if (active) {
      uint32_t ew[arena::kPlanes];
      arena::entity_weights(a.cw, (uint32_t)e, ew);
      arena::checksum_terms(s, ew, hi, lo);
    }
    block_checksum_add(hi, lo, red, a.parts_hi, a.parts_lo, (size_t)B * L);
  }

  for (int l = 0; l < L; ++l) {
    grid_sync(a.bar);
    // every member's teams for the state entering step l
    for (int k = threadIdx.x; k < B * P; k += kBlock) {
      const int b = k / P, t = k % P;
      const uint32_t* r = a.raw + (l == 0 ? 0 : (1 + (size_t)(l - 1) * B + b) * raw_row) + 3 * t;
      fin[k] = arena::finalize((int)__ldcg(r), (int)__ldcg(r + 1), (int)__ldcg(r + 2));  // L2
    }
    __syncthreads();
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int b = item / tiles, tile = item % tiles;
      const int e = tile * kBlock + threadIdx.x;
      const bool active = e < a.n;
      const int own = e % P;
      arena::State s{};
      uint32_t hi = 0, lo = 0;
      if (active) {
        const int* src = l == 0 ? a.anchor : a.traj + ((size_t)b * L + l - 1) * slot_stride;
        s = arena::load(src, n, e);
        const int* cell = a.script + (((size_t)b * L + l) * P + own) * (1 + I);
        const bool off = cell[0] == kDisconnected;
        arena::step(s, off ? a.disc_input : cell[1], off ? a.disc_throttle : arena::throttle_of(cell + 1, I),
                    fin[b * P + own], fin[b * P + (own + 1) % P]);
        arena::store(a.traj + ((size_t)b * L + l) * slot_stride, n, e, s);
        uint32_t ew[arena::kPlanes];
        arena::entity_weights(a.cw, (uint32_t)e, ew);
        arena::checksum_terms(s, ew, hi, lo);
      }
      block_checksum_add(hi, lo, red, a.parts_hi, a.parts_lo, (size_t)b * L + l);
      if (l + 1 < L)  // the reduction step l+1 will need
        arena::block_team_sums<kWarps>(active, s.px, s.py, s.hp, own, P, scratch,
                                       a.raw + (1 + (size_t)l * B + b) * raw_row);
    }
  }

  // last-block-done, then the frame terms (finish, pallas_beam.py:268)
  __shared__ bool is_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(a.done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const int frame = *a.anchor_frame;
  const int bl = B * L;
  for (int k = threadIdx.x; k <= bl; k += kBlock) {
    const uint32_t f = k < bl ? (uint32_t)(frame + 1 + k % L) : (uint32_t)frame;
    const uint32_t hi = __ldcg(&a.parts_hi[k]) + f * a.cw.frame_weight;
    const uint32_t lo = __ldcg(&a.parts_lo[k]) + f;
    if (k < bl) {
      a.out[k] = (int)hi;
      a.out[bl + k] = (int)lo;
    } else {
      a.out[2 * bl] = (int)hi;
      a.out[2 * bl + 1] = (int)lo;
      a.out[2 * bl + 2] = frame;
    }
  }
}

}  // namespace

namespace {

// The rollout of a model with no reduction. Returns the CUDA error of the
// scratch reset, the shared-memory attribute or the launch (0 on success).
template <class M>
int launch_beam(const int* ring, int anchor_slot, const int* r_frame, const int* script, int* traj,
                int* out, uint32_t* scratch, int n, int num_players, int input_size, int beam, int steps,
                int substeps, const int* disconnect_row, const int* cs, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t rows = (size_t)beam * steps + 1;
  cudaError_t err = cudaMemsetAsync(scratch, 0, (2 * rows + 1) * sizeof(uint32_t), st);
  if (err != cudaSuccess) return (int)err;
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
    err = cudaFuncSetAttribute(beam_rollout_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((n + kBlock - 1) / kBlock, beam);
  beam_rollout_kernel<M><<<grid, kBlock, smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// ring: [slots, K, n]; r_frame: [slots]; scratch: parts_hi [B*L+1],
// parts_lo [B*L+1], done [1]. disconnect_row: the game's disconnect input, I
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

// The arena rollout, launched cooperatively on as many blocks as can be
// resident (at most one per (member, 128-entity tile) work item). ring:
// [slots, 6, n]; scratch: parts_hi [B*L+1], parts_lo [B*L+1], done [1],
// barrier [2], raw [(1 + (L-1)*B) * 3P]. Returns the CUDA error of the
// reset, the occupancy query, the shared-memory attribute or the launch, or
// kNotCoResident when not one block fits. disconnect_row: I ints in host
// memory. cs: 13 int32 — checksum w[6], base[6], frame weight.
extern "C" int beam_rollout_arena_launch(const int* ring, int anchor_slot, const int* r_frame,
                                         const int* script, int* traj, int* out, uint32_t* scratch,
                                         int n, int num_players, int input_size, int beam, int steps,
                                         const int* disconnect_row, const int* cs, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t rows = (size_t)beam * steps + 1;
  const size_t raw_rows = 1 + (size_t)(steps - 1) * beam;
  const size_t words = 2 * rows + 3 + raw_rows * 3 * num_players;
  cudaError_t err = cudaMemsetAsync(scratch, 0, words * sizeof(uint32_t), st);
  if (err != cudaSuccess) return (int)err;
  ArenaBeamArgs a;
  a.anchor = ring + (size_t)anchor_slot * arena::kPlanes * (size_t)n;
  a.anchor_frame = r_frame + anchor_slot;
  a.script = script;
  a.traj = traj;
  a.out = out;
  a.parts_hi = scratch;
  a.parts_lo = scratch + rows;
  a.done = scratch + 2 * rows;
  a.bar = scratch + 2 * rows + 1;
  a.raw = scratch + 2 * rows + 3;
  a.n = n;
  a.num_players = num_players;
  a.input_size = input_size;
  a.beam = beam;
  a.steps = steps;
  a.disc_input = disconnect_row[0];
  a.disc_throttle = input_size >= 2 ? (disconnect_row[1] & 0x0F) : arena::kDefaultThrottle;
  a.cw = weights_from<arena::Weights, arena::kPlanes>(cs);
  const size_t smem = arena_beam_smem_words(beam, num_players) * sizeof(int);
  const void* fn = (const void*)beam_rollout_arena_kernel;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  long long resident = 0;
  if ((err = resident_blocks(fn, smem, &resident)) != cudaSuccess) return (int)err;
  if (resident < 1) return kNotCoResident;
  const long long items = (long long)beam * ((n + kBlock - 1) / kBlock);
  const int blocks = (int)(items < resident ? items : resident);
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(kBlock), args, smem, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
