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
// Design: ONE launch a call and nothing else on the stream. A 2-D grid of
// (chunks of entities) x (sources); each thread reads the px, py and hp of
// up to kPerThread entities, all loads issued before the sums. A
// block sums per team at O(1) an entity (arena_reduce.cuh: lanes grouped
// by team, one redux.sync a word, each group's leader adding to its warp's
// row in shared memory; with P dividing the block each thread's team is
// fixed, so it sums its entities in registers first and, P a power of
// two, the warp sums by xor shuffles), then over its warps' rows. A source of one chunk (n <=
// kSmallWorld) is one block, which writes its row of `out` with plain stores.
// Past that the blocks of a source add their non-zero words to a scratch
// row with uint32 atomics (exact in any order), take a ticket, and the
// last block of the source moves the row into `out` with atomicExch, which
// leaves the scratch zero, and resets the ticket: the scratch is zero for
// the next launch, and `out` is overwritten whatever it held.
//
// What bounds it on an H100: launch latency, at every shape the port runs.
// It reads 12 B an entity and source (0.00002-0.002 ms of bytes at 4096 to
// 65536 entities, S = 1 or d+1) and does 6 int32 ops an entity and source
// of the function's, so a call is the launch, one round of loads and, past
// one chunk, an atomic round trip for the ticket.
#include <cuda_runtime.h>

#include "arena_reduce.cuh"

constexpr int kPerThread = 4;  // entities a thread sums, their loads issued together
// A world of up to kSmallWorld entities is one block of 1024 threads a
// source; a larger one takes chunks of 1024 entities, 256 threads a block,
// so that its loads spread over the card (on an H100 at 65536 entities:
// 0.0045 ms a call at S = 1 where 1024-thread blocks took 0.0072).
constexpr int kSmallWorld = 1024 * kPerThread;

template <int kReduceThreads>
__global__ void __launch_bounds__(kReduceThreads) reduce_table_kernel(const int* ring, const int* state,
                                                                      const int* slots, size_t slot_stride, int n,
                                                                      int num_players, int* out, uint32_t* scratch,
                                                                      unsigned int* tickets) {
  constexpr int kChunk = kReduceThreads * kPerThread;  // entities a block sums
  extern __shared__ uint32_t rows[];  // [nrows][3P]
  __shared__ bool last;
  const int P = num_players, words = 3 * P;
  const bool own_row = P <= arena::kRowTeams;
  const int nrows = own_row ? kReduceThreads / 32 : 1;
  const int s = blockIdx.y;
  const int slot = slots[s];
  const int* src = slot < 0 ? state : ring + (size_t)slot * slot_stride;
  for (int j = threadIdx.x; j < nrows * words; j += kReduceThreads) rows[j] = 0;

  const int first = blockIdx.x * kChunk + threadIdx.x;
  arena::State st[kPerThread];
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const int e = first + r * kReduceThreads;
    st[r] = arena::State{};
    if (e < n) {
      st[r].px = src[e];
      st[r].py = src[(size_t)n + e];
      st[r].hp = src[(size_t)4 * n + e];
    }
  }
  __syncthreads();  // the rows are zero
  const bool any = first - (int)(threadIdx.x & 31) < n;  // warp-uniform: the warp holds an entity
  if (kReduceThreads % P == 0) {  // this thread's team is fixed: sum in registers, accumulate once
    uint32_t one = 0, sx = 0, sy = 0;
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) {
      uint32_t o, x, y;
      arena::team_terms(st[r], o, x, y);
      one += o;
      sx += x;
      sy += y;
    }
    if (any) arena::warp_team_add(one, sx, sy, first % P, P, true, rows, own_row);
  } else {
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) {
      const int e = first + r * kReduceThreads;
      if (e - (int)(threadIdx.x & 31) < n) {  // warp-uniform
        uint32_t o, x, y;
        arena::team_terms(st[r], o, x, y);
        arena::warp_team_add(o, x, y, e % P, P, false, rows, own_row);
      }
    }
  }
  __syncthreads();

  int* row = out + (size_t)s * words;
  if (gridDim.x == 1) {
    for (int j = threadIdx.x; j < words; j += kReduceThreads) row[j] = (int)arena::warp_rows_sum(rows, nrows, words, j);
    return;
  }
  uint32_t* part = scratch + (size_t)s * words;
  for (int j = threadIdx.x; j < words; j += kReduceThreads) {
    const uint32_t v = arena::warp_rows_sum(rows, nrows, words, j);
    if (v) atomicAdd(&part[j], v);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&tickets[s], 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int j = threadIdx.x; j < words; j += kReduceThreads) row[j] = (int)atomicExch(&part[j], 0u);
  if (threadIdx.x == 0) tickets[s] = 0;
}

// ring: [*, n_planes, n] (slot k at k * n_planes * n); state: [n_planes, n];
// slots: S int32 on the device; out: [S, 3P] int32, overwritten; scratch:
// [S, 3P] partial rows then S tickets, zero before the first launch and
// left zero by each. Returns the CUDA error of the launch (0 on success).
namespace {

template <int kReduceThreads>
int launch(const int* ring, const int* state, const int* slots, int num_sources, int n, int n_planes,
           int num_players, int* out, uint32_t* scratch, cudaStream_t st) {
  const size_t words = 3 * (size_t)num_players;
  const size_t nrows = num_players <= arena::kRowTeams ? kReduceThreads / 32 : 1;
  const size_t smem = nrows * words * sizeof(uint32_t);
  if (smem > 48 * 1024) {  // many teams: the rows outgrow the default
    cudaError_t err = cudaFuncSetAttribute(reduce_table_kernel<kReduceThreads>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  constexpr int kChunk = kReduceThreads * kPerThread;
  const dim3 grid((n + kChunk - 1) / kChunk, num_sources);
  unsigned int* tickets = scratch + (size_t)num_sources * words;
  reduce_table_kernel<kReduceThreads><<<grid, kReduceThreads, smem, st>>>(ring, state, slots, (size_t)n_planes * n,
                                                                          n, num_players, out, scratch, tickets);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int reduce_table_launch(const int* ring, const int* state, const int* slots, int num_sources, int n,
                                   int n_planes, int num_players, int* out, uint32_t* scratch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return n <= kSmallWorld
             ? launch<1024>(ring, state, slots, num_sources, n, n_planes, num_players, out, scratch, st)
             : launch<256>(ring, state, slots, num_sources, n, n_planes, num_players, out, scratch, st);
}
