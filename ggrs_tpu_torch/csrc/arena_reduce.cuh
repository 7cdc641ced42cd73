// What the arena kernels that reduce the whole world before a step share:
// the whole-batch SyncTest kernel (synctest_fused.cu, K1), the request
// path's tick (resim_tick.cu, K3), the beam rollout (beam_rollout.cu, K4),
// K2's inline route (synctest_tiled.cu) and the reduction table
// (reduce_table.cu, K5). An arena step needs, per team, the living count and
// centroid of the state entering it; the world is spread over blocks that
// cannot see each other, so a reduction is: team sums at O(1) an entity
// (`arena::warp_team_add`; K1 past 64 teams walks every team,
// `arena::block_team_sums`) -> block sums -> uint32 atomics into a raw row in
// global memory -> a barrier across the blocks that hold the world -> every
// block finalizes the row itself (P teams of scalar work, exact floor
// division). A barrier across blocks needs them resident at once: K1, K2's
// inline route and K3 launch cooperatively after an occupancy query and use
// the split grid barrier `grid_arrive` / `grid_wait`, which lets a block work
// between its arrival and its wait (K2 and K3 share `inline_arena`'s
// rotating raw rows below); K4 gives each member its own blocks and
// barrier (beam_rollout.cu).
#pragma once

#include <cuda_runtime.h>

#include "arena_step.cuh"
#include "block.cuh"

// returned when arena's grid cannot be resident at once (no CUDA error has
// this value): the caller raises instead of launching a kernel that would
// wait forever at its first grid barrier
constexpr int kNotCoResident = -1;
// blocks per SM the arena kernel is built for (<= 64 registers a thread)
constexpr int kArenaMinBlocksPerSm = 8;

__device__ __forceinline__ unsigned long long ld_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The grid barrier, split so that a block works between its
// arrival and its wait. `arrived` counts every arrival ever made (it only
// grows, so it needs no reset between barriers); the g-th barrier a block
// waits on completes when it reaches (g + 1) * gridDim.x. Thread 0 arrives
// with a release atomic, after a block barrier, so the block's writes
// before it are released; it waits with acquire loads, with no sleep for
// the first spins; a block that waits ~10 s traps, so the launch fails
// instead of hanging the card.
__device__ __forceinline__ void grid_arrive(unsigned long long* arrived) {
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long old;
    asm volatile("atom.release.gpu.global.add.u64 %0, [%1], 1;" : "=l"(old) : "l"(arrived) : "memory");
  }
}

__device__ __forceinline__ void grid_wait(const unsigned long long* arrived, unsigned long long target) {
  if (threadIdx.x == 0) {
    unsigned long long since = 0;
    for (unsigned spins = 0; ld_acquire(arrived) < target; ++spins) {
      if (spins < 2048) continue;
      __nanosleep(64);
      if ((spins & 1023) == 0) {
        const unsigned long long now = globaltimer();
        if (since == 0) since = now;
        else if (now - since > 10000000000ull) __trap();
      }
    }
  }
  __syncthreads();
}

// The team sums at O(1) an entity, whatever P is (K1, synctest_fused.cu;
// K2's inline route, synctest_tiled.cu; K3, resim_tick.cu; K4,
// beam_rollout.cu; K5, reduce_table.cu). Each warp sums its lanes' raw
// terms — the living count and the sums of px >> 6 and py >> 6 of the
// entities a lane holds for `team` (zeros for a lane with none) — into a
// row of 3P words in shared memory: its own row, with plain adds (no other
// warp writes it, and each team has one writer a call), or, past kRowTeams
// teams, a row the block's warps share, with shared atomics. A block then
// sums its warps' rows (warp_rows_sum).
namespace arena {

constexpr int kRowTeams = 64;  // teams up to which each warp has its own row (32 x 3P words)

template <bool kShared>
__device__ __forceinline__ void row_add(uint32_t* row, int team, uint32_t one, uint32_t sx, uint32_t sy) {
  if (kShared) {
    atomicAdd(&row[3 * team], one);
    atomicAdd(&row[3 * team + 1], sx);
    atomicAdd(&row[3 * team + 2], sy);
  } else {
    row[3 * team] += one;
    row[3 * team + 1] += sx;
    row[3 * team + 2] += sy;
  }
}

// Every lane of the warp calls it. The lanes are grouped by team
// (`__match_any_sync`), each group sums its three words with one
// `redux.sync` each (`__reduce_add_sync`, sm_80 and later), and the group's
// leader adds them to `row`.
template <bool kShared>
__device__ __forceinline__ void team_accumulate(uint32_t one, uint32_t sx, uint32_t sy, int team, uint32_t* row) {
  const unsigned peers = __match_any_sync(0xFFFFFFFFu, team);
  one = __reduce_add_sync(peers, one);
  sx = __reduce_add_sync(peers, sx);
  sy = __reduce_add_sync(peers, sy);
  if ((int)(threadIdx.x & 31) == __ffs(peers) - 1 && one) row_add<kShared>(row, team, one, sx, sy);  // the dead add nothing
}

// The same where lanes l and l ^ off hold the same team for every off of
// P up to 16 (P a power of two up to 32, the lanes consecutive entities):
// xor shuffles sum over those lanes, and lane l < P adds its team. For any
// other P they would merge lanes of different teams.
template <bool kShared>
__device__ __forceinline__ void team_accumulate_periodic(uint32_t one, uint32_t sx, uint32_t sy, int team, int P,
                                                         uint32_t* row) {
  for (int off = 16; off >= P; off >>= 1) {
    one += __shfl_xor_sync(0xFFFFFFFFu, one, off);
    sx += __shfl_xor_sync(0xFFFFFFFFu, sx, off);
    sy += __shfl_xor_sync(0xFFFFFFFFu, sy, off);
  }
  if ((int)(threadIdx.x & 31) < P && one) row_add<kShared>(row, team, one, sx, sy);
}

// A warp's terms into the block's rows [32 or 1][3P]: its own row when
// `own_row`, else the shared one. `consecutive`: the warp's lanes hold
// consecutive entities, lane l the team (team of lane 0 + l) % P; then,
// where P is a power of two up to 32, team_accumulate_periodic sums them.
__device__ __forceinline__ void warp_team_add(uint32_t one, uint32_t sx, uint32_t sy, int team, int P,
                                              bool consecutive, uint32_t* rows, bool own_row) {
  const bool periodic = consecutive && P <= 32 && (P & (P - 1)) == 0;
  if (own_row) {
    uint32_t* row = rows + (threadIdx.x >> 5) * 3 * P;
    if (periodic) team_accumulate_periodic<false>(one, sx, sy, team, P, row);
    else team_accumulate<false>(one, sx, sy, team, row);
  } else if (periodic) {
    team_accumulate_periodic<true>(one, sx, sy, team, P, rows);
  } else {
    team_accumulate<true>(one, sx, sy, team, rows);
  }
}

// Word j of the block's sums: the rows' word j, which it leaves zero for
// the next accumulation (after a barrier that follows every add).
__device__ __forceinline__ uint32_t warp_rows_sum(uint32_t* rows, int nrows, int words, int j) {
  uint32_t v = 0;
  for (int w0 = 0; w0 < nrows; w0 += 8) {  // eight rows' loads in flight, then their zeroing
    uint32_t x[8];
#pragma unroll
    for (int w = 0; w < 8; ++w) x[w] = w0 + w < nrows ? rows[(w0 + w) * words + j] : 0u;
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      v += x[w];
      if (w0 + w < nrows) rows[(w0 + w) * words + j] = 0;
    }
  }
  return v;
}

// One entity's raw terms: 1, px >> 6, py >> 6 if it lives.
__device__ __forceinline__ void team_terms(const State& s, uint32_t& one, uint32_t& sx, uint32_t& sy) {
  const bool live = s.hp > 0;
  one = live ? 1u : 0u;
  sx = live ? (uint32_t)(s.px >> kCentroidShift) : 0u;
  sy = live ? (uint32_t)(s.py >> kCentroidShift) : 0u;
}

}  // namespace arena

// The pieces of the persistent grids of K2's inline route and K3's arena
// body (one block an SM, each owning a contiguous run of entities).
namespace inline_arena {

constexpr int kThreads = 1024;  // at most, a block (64 registers a thread: one such block an SM)
constexpr int kMaxWarps = kThreads / 32;

// What a block of a persistent grid that owns a contiguous run of entities
// keeps in its dynamic shared memory (K2's inline route, synctest_tiled.cu,
// and K3's arena body, resim_tick.cu, each lay it out): the pending step's
// finalized teams [3P], each warp's save sums, the team rows [nrows][3P] (a
// row a warp up to arena::kRowTeams teams, else one shared row), and, when
// the states stay on chip, the block's states [6][per_block].
struct Shared {
  arena::Team* fin;
  uint32_t* ev;
  uint32_t* rows;
  int* st;
  int warps;     // the block's warps that hold an entity: the rows and save sums to add up
  bool own_row;  // a row a warp (else the warps share rows[0])
};

// arena::finalize for the sums these kernels make. In the model's envelope
// they are non-negative as int32 (18-bit positions, a team under 2^16), so
// an unsigned division floors as exg::floor_div_pos does, at less cost;
// any other value takes arena::finalize itself.
__device__ __forceinline__ arena::Team finalize_sums(uint32_t count, uint32_t sx, uint32_t sy) {
  if ((int)(count | sx | sy) < 0) return arena::finalize((int)count, (int)sx, (int)sy);
  const uint32_t safe = count > 1 ? count : 1;
  return arena::Team{(int)((sx / safe) << arena::kCentroidShift), (int)((sy / safe) << arena::kCentroidShift),
                     (int)count};
}

// Word j of the block's team sums: its warps' rows, left zero
__device__ __forceinline__ uint32_t block_sum(const Shared& sh, int words, int j) {
  return arena::warp_rows_sum(sh.rows, sh.own_row ? sh.warps : 1, words, j);
}

// The reduction: block sums -> three rotating raw rows in
// global memory -> the grid barrier -> every block finalizes the row. `g0`,
// the barriers completed before this launch, numbers the steps across
// launches: step g adds to row g % 3 while block 0 zeroes row (g + 1) % 3
// (last read before barrier g - 1), so the rows need no reset between
// launches.
struct GridReduce {
  uint32_t* raw;                // global [3][3P]
  unsigned long long* arrived;  // global, the barrier's counter
  unsigned long long g0;

  __device__ __forceinline__ void arrive(const Shared& sh, int P, int k) const {
    __syncthreads();  // every warp's row adds are in
    const unsigned long long g = g0 + k;
    uint32_t* row = raw + (size_t)(g % 3) * 3 * P;
    for (int j = threadIdx.x; j < 3 * P; j += blockDim.x) {
      const uint32_t v = block_sum(sh, 3 * P, j);
      if (v) atomicAdd(&row[j], v);
    }
    if (blockIdx.x == 0) {
      uint32_t* next = raw + (size_t)((g + 1) % 3) * 3 * P;
      for (int j = threadIdx.x; j < 3 * P; j += blockDim.x) next[j] = 0;
    }
    grid_arrive(arrived);
  }
  __device__ __forceinline__ void wait(const Shared& sh, int P, int k) const {
    const unsigned long long g = g0 + k;
    grid_wait(arrived, (g + 1) * gridDim.x);
    const uint32_t* row = raw + (size_t)(g % 3) * 3 * P;
    for (int t = threadIdx.x; t < P; t += blockDim.x) {
      const uint32_t* r = row + 3 * t;  // atomics live in L2: read there
      sh.fin[t] = finalize_sums(__ldcg(r), __ldcg(r + 1), __ldcg(r + 2));
    }
  }
};

}  // namespace inline_arena

// Blocks of `fn` (kBlock threads, `smem` bytes of dynamic shared memory)
// that can be resident at once on the current device: what a cooperative
// launch may ask for.
inline cudaError_t resident_blocks(const void* fn, size_t smem, long long* out) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kBlock, smem)) != cudaSuccess)
    return err;
  *out = (long long)per_sm * sms;
  return cudaSuccess;
}

// The card's limits a persistent grid's plan is made from: out[0] the SM
// count, out[1] the shared memory a block may opt in to (bytes).
inline cudaError_t card_limits(int* out) {
  int device = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&out[0], cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) return err;
  return cudaDeviceGetAttribute(&out[1], cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

// A plan's one-time set-up for kernel `fn`: the shared-memory attribute,
// then the occupancy query. kNotCoResident when `blocks` blocks of
// `threads` threads cannot be resident at once; else 0 or a CUDA error.
inline int co_resident(const void* fn, int blocks, int threads, int smem_bytes) {
  cudaError_t err;
  if (smem_bytes > 48 * 1024 &&
      (err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes)) != cudaSuccess)
    return (int)err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, smem_bytes)) != cudaSuccess)
    return (int)err;
  return (long long)per_sm * sms >= blocks ? 0 : kNotCoResident;
}
