// What the arena kernels that reduce the whole world before a step share:
// the whole-batch SyncTest kernel (synctest_fused.cu, K1), the request
// path's tick (resim_tick.cu, K3) and the beam rollout (beam_rollout.cu,
// K4). An arena step needs, per team, the living count and centroid of the
// state entering it; the world is spread over blocks that cannot see each
// other, so a reduction is: block sums (warp shuffles,
// arena::block_team_sums) -> uint32 atomics into a raw row in global
// memory -> a GRID barrier -> every block finalizes the row itself (P
// teams of scalar work, exact floor division). The barrier needs every
// block of the grid resident at once, so these kernels are launched
// cooperatively after an occupancy query (`resident_blocks`).
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

// What arena's grid-wide reduction steppers share: this entity's team and
// the next team (its enemy), shared-memory scratch for block sums, the raw
// table in global memory and the barrier.
struct ArenaReduce {
  arena::Team* fin;   // shared: finalized teams, [slots * P]
  uint32_t* scratch;  // shared: 3 * kTeamChunk * kWarps words
  uint32_t* raw;      // global: raw sums, [slots * 3P], zeroed before launch
  unsigned int* bar;  // global: grid barrier
  int num_players, input_size, team, enemy;

  // add this block's sums of `s` to raw row `slot`
  __device__ __forceinline__ void add(const arena::State& s, bool active, int slot) {
    arena::block_team_sums<kWarps>(active, s.px, s.py, s.hp, team, num_players, scratch,
                                   raw + (size_t)slot * 3 * num_players);
  }
  // after a grid barrier: finalize raw row `slot` into fin row `slot`
  __device__ __forceinline__ void finalize(int slot) {
    const int P = num_players;
    for (int t = threadIdx.x; t < P; t += kBlock) {
      const uint32_t* r = raw + (size_t)slot * 3 * P + 3 * t;  // atomics live in L2: read there
      fin[slot * P + t] = arena::finalize((int)__ldcg(r), (int)__ldcg(r + 1), (int)__ldcg(r + 2));
    }
  }
  // zero raw row `slot` (block 0 only)
  __device__ __forceinline__ void zero(int slot) {
    if (blockIdx.x == 0)
      for (int j = threadIdx.x; j < 3 * num_players; j += kBlock) raw[(size_t)slot * 3 * num_players + j] = 0;
  }
  __device__ __forceinline__ void step(arena::State& s, const int* in, int slot) {
    const int P = num_players;
    arena::step(s, in[0], arena::throttle_of(in, input_size), fin[slot * P + team], fin[slot * P + enemy]);
  }
};

// T == 1: the reference reduces inline from the state entering every step.
// Three raw rows rotate: while step k adds to row k % 3, block 0 zeroes row
// (k+1) % 3 and slower blocks may still read row (k-1) % 3. A step is three
// phases — gather (this block's sums of the state entering it), reduce (the
// grid barrier and the finalize), apply (the step on the finalized row) —
// which a block that owns several entity tiles runs once per tile, once,
// and once per tile again (synctest_tiled.cu's persistent inline body).
struct ArenaInlineStepper : ArenaReduce {
  int k;

  // this entity's team and its enemy, for a block that walks several tiles
  __device__ __forceinline__ void at(int e) {
    team = e % num_players;
    enemy = (team + 1) % num_players;
  }
  __device__ __forceinline__ void gather(const arena::State& s, bool active) {
    zero((k + 1) % 3);
    add(s, active, k % 3);
  }
  __device__ __forceinline__ void reduce() {
    grid_sync(bar);
    finalize(k % 3);
    __syncthreads();
  }
  __device__ __forceinline__ void apply(arena::State& s, const int* in) { ArenaReduce::step(s, in, k % 3); }

  __device__ __forceinline__ void seed(const arena::State&, bool) {}
  __device__ void step(arena::State& s, bool active, const int* in, int, int) {
    gather(s, active);
    reduce();
    apply(s, in);
    ++k;
  }
  __device__ __forceinline__ void frontier_done(const arena::State&, bool, int, int) {}
};

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
