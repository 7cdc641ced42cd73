// What the arena kernels that reduce the whole world before a step share:
// the whole-batch SyncTest kernel (synctest_fused.cu, K1), the request
// path's tick (resim_tick.cu, K3), the beam rollout (beam_rollout.cu, K4),
// K2's inline route (synctest_tiled.cu) and the reduction table
// (reduce_table.cu, K5). An arena step needs, per team, the living count and
// centroid of the state entering it; the world is spread over blocks that
// cannot see each other, so a reduction is: block sums -> uint32 atomics
// into a raw row in global memory -> a GRID barrier -> every block
// finalizes the row itself (P teams of scalar work, exact floor division).
// The barrier needs every block of the grid resident at once, so these
// kernels are launched cooperatively after an occupancy query
// (`resident_blocks`).
//
// Two barriers: `grid_sync` (K3, K4), and the split `grid_arrive` /
// `grid_wait` (K1, K2's inline route), which lets a block work between its
// arrival and its wait. Two ways to sum teams: `arena::block_team_sums`
// (K3, K4), which walks every team, and `arena::warp_team_add` (K1, K2's
// inline route, K5), O(1) an entity.
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

// A grid-wide barrier for a cooperatively launched grid: bar[0] counts the
// blocks arrived, bar[1] is the generation; both zeroed before the launch.
// The fences make every write a block made before the barrier (its
// reduction atomics, its zeroing of a table row) visible to every block
// after it. A block that waits more than ~10 s traps: the launch then fails
// with an error instead of hanging the card.
__device__ __forceinline__ void grid_sync(unsigned int* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned int* gen = bar + 1;
    const unsigned int g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      for (long long spins = 0; *gen == g; ++spins) {
        __nanosleep(100);
        if (spins > (1ll << 27)) __trap();
      }
    }
    __threadfence();
  }
  __syncthreads();
}

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
// K2's inline route, synctest_tiled.cu; K5, reduce_table.cu). Each warp sums its lanes' raw
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
