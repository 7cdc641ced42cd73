// K5 — the reduction table: arena's raw per-team sums over S plane sources.
//
// Replaces: ggrs_tpu/tpu/pallas_tiled.py,
// PallasTiledSyncTestCore._build_reduce_table (the pallas_call at :612),
// which feeds reduce_sources_kernel (:642) and frontier_partial_kernel
// (:666), i.e. K2's external_reduce route. For each source s and team t it
// computes the count of living entities (hp > 0) that t owns (entity e is
// owned by e % P), and their sums of px >> 6 and py >> 6: out [S, 3P] int32,
// the reference's ArenaPlanes.reduce_partial. A source is a ring slot
// (slots[s] >= 0) or the live state (slots[s] < 0), so the boot table
// (d ring slots and the state) needs no copy of the planes.
//
// Design: one pass over the entities; a 2-D grid of (128-entity blocks) x
// (sources). Each thread reads its entity's px, py and hp, each block sums
// per team (warp shuffles, then its warps in shared memory) and adds to
// out with uint32 atomics, exact in any order (the output is zeroed first).
//
// What bounds it on an H100: it reads 12 B per entity and source and does
// a few int ops per team on each; at the worlds it serves (4096 to 65536
// entities, S = 1 or d+1) that is microseconds of bytes, so the launch and
// the reduction's latency set its time. Left for later: folding the frontier
// row into K2's launch (each block adds its reduction of the new state),
// which removes one launch per tick of the injection route.
#include <cuda_runtime.h>

#include "arena_step.cuh"

constexpr int kBlock = 128;
constexpr int kWarps = kBlock / 32;

__global__ void __launch_bounds__(kBlock) reduce_table_kernel(const int* ring, const int* state,
                                                              const int* slots, size_t slot_stride,
                                                              int n, int num_players, uint32_t* out) {
  __shared__ uint32_t scratch[3 * arena::kTeamChunk * kWarps];
  const int s = blockIdx.y;
  const int e = blockIdx.x * kBlock + threadIdx.x;
  const bool active = e < n;
  const int slot = slots[s];
  const int* src = slot < 0 ? state : ring + (size_t)slot * slot_stride;
  int px = 0, py = 0, hp = 0;
  if (active) {
    px = src[e];
    py = src[(size_t)n + e];
    hp = src[(size_t)4 * n + e];
  }
  arena::block_team_sums<kWarps>(active, px, py, hp, e % num_players, num_players, scratch,
                                 out + (size_t)s * 3 * num_players);
}

// ring: [*, n_planes, n] (slot k at k * n_planes * n); state: [n_planes, n];
// slots: S int32 on the device; out: [S, 3P] int32, overwritten.
// Returns the CUDA error of the reset or the launch (0 on success).
extern "C" int reduce_table_launch(const int* ring, const int* state, const int* slots, int num_sources,
                                   int n, int n_planes, int num_players, int* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t words = (size_t)num_sources * 3 * num_players;
  cudaError_t err = cudaMemsetAsync(out, 0, words * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + kBlock - 1) / kBlock, num_sources);
  reduce_table_kernel<<<grid, kBlock, 0, st>>>(ring, state, slots, (size_t)n_planes * n, n, num_players,
                                               reinterpret_cast<uint32_t*>(out));
  return (int)cudaGetLastError();
}
