// K1 — the whole-batch fused SyncTest kernel on Hopper, for ex_game, swarm
// and arena.
//
// Replaces: ggrs_tpu/tpu/pallas_core.py, PallasSyncTestCore._build (the
// pallas_call at :979). One launch runs T SyncTest ticks: the masked load of
// frame c-d, d resimulated steps with re-saves of frames c-d+1..c-1, the
// unconditional save of frame c, the input-ring write at c % (d+2), the
// frontier step, the ring-frame tags, and the first-seen checksum history
// with its mismatch latch. State, ring, input ring, history and meta are
// all updated in place.
//
// Design: one thread per entity for the whole batch (synctest_body.cuh); the
// per-event checksums are block-reduced and added to a [T, d] scratch with
// uint32 atomics. The LAST block to finish (a done-counter ticket) then runs
// the history compare serially over the events in (t, j) order, with no
// host round trip and no second launch. ex_game and swarm (7 planes: a
// 3-D position and velocity and a battery) are one template over the
// model's traits (exg::Model, swarm::Model), each behind its own entry point.
//
// Arena adds a cross-entity reduction to every step: per team, the living
// count and centroid of the state entering it. The reference's K1 computes
// them as the whole-world sums its single VMEM-resident program can take;
// here the world is spread over blocks that cannot see each other, so each
// reduction is block sums, atomics, a GRID barrier and a finalize in every
// block (arena_reduce.cuh). The barrier needs every block resident at once,
// and K1 keeps one entity per thread in registers, so arena's K1 is
// launched cooperatively, after checking co-residency, and raises (nonzero
// return) when the grid does not fit rather than deadlocking. With the reference's
// per-frame cache (T > 1, pallas_core.py:789-801, :863-887, :936-944) a
// batch pays 1 + (T-1) barriers: the seed (d+1 cached frames, from the ring
// slots and the live state) and one per tick after the frontier step. With
// T == 1 the reference reduces inline before every step, so does this
// (d+1 barriers). A thread-block cluster with distributed shared memory
// would replace the global round trip and the barrier for worlds of up to
// 16 blocks (2048 entities) only; the headline world (4096) already needs
// 32 blocks, so the simple grid-wide form is taken first.
//
// What bounds it on an H100: per batch each entity streams its state and
// ring column once in and once out (4 B x planes x (1 + d+2) x 2), which
// is ~1.8 MB at 4096 entities, d=8 — microseconds at 3.35 TB/s. The work is
// int32 ALU: ~T*(d+1) steps of ~100 dependent integer ops per entity, and
// the d*T step chain is serial inside each thread. At 4096 entities only 32
// blocks of 4 warps exist, a quarter of the 132 SMs with one block each, so
// the kernel is bound by that serial chain's latency, not by any peak rate;
// arena adds a grid barrier (a few microseconds of L2 round trips) per tick.
//
// Left for later: keeping each block's ring columns in shared memory (as
// the reference tiled kernel keeps its tile in VMEM) instead of re-reading
// them through L2/HBM every tick; splitting small worlds over more blocks
// (fewer entities per block, or several threads per entity-step) to fill
// the 132 SMs at 4096 entities; capturing the batch loop in a CUDA graph.
#include <cuda_runtime.h>

#include "arena_reduce.cuh"
#include "swarm_step.cuh"
#include "synctest_body.cuh"

// The last block to finish runs the bookkeeping and the verdict: every
// thread fences its own parts atomics, then one ticket per block; the block
// that draws the last ticket sees all parts.
template <class Weights>
__device__ void finish_batch(const SyncTestArgs<Weights>& a, int c0, int* r_frame, int* iring,
                             int* h_tag, int* h_hi, int* h_lo, int* meta, uint32_t* done, int* sh) {
  __shared__ bool is_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!is_last || threadIdx.x != 0) return;
  __threadfence();
  // every other block has finished reading iring and meta: update in place
  synctest_bookkeeping(r_frame, iring, iring, a.inputs, c0, a.t_ticks, a.d,
                       a.num_players * a.input_size);
  synctest_verdict(a.parts_hi, a.parts_lo, a.t_ticks, a.d, a.cw.frame_weight, h_tag, h_hi, h_lo,
                   meta, sh);
}

// a model with no reduction (ex_game, swarm)
template <class M>
__global__ void __launch_bounds__(kBlock) synctest_fused_kernel(
    SyncTestArgs<typename M::Weights> a, int* r_frame, int* iring, int* h_tag, int* h_hi, int* h_lo,
    int* meta, uint32_t* done) {
  extern __shared__ uint32_t smem[];
  const int c0 = a.meta[0];
  EntityStepper<M> st{a.substeps};
  synctest_entity_batch<M>(a, smem, st);
  finish_batch(a, c0, r_frame, iring, h_tag, h_hi, h_lo, meta, done,
               reinterpret_cast<int*>(smem + body_smem_words(a.d)));
}

// T > 1: the reference's per-frame cache. Frame f's reduction sits in row
// f % M, M = d+3 rows (one more than the reference's d+2, so that the row
// of frame c+2 can be zeroed during tick c while no block reads or adds to
// it: tick c reads rows of frames c-d..c and adds to frame c+1's). Seeded
// from ring slot f % (d+2) for frames c0-d..c0-1 and from the live state
// for frame c0 — zero-initialised slots early in a session included, as
// the reference seeds them; after each tick's frontier step the new state
// is reduced into frame c+1's row. A resim step of frame f reads row f % M.
struct ArenaCacheStepper : ArenaReduce {
  const int* ring;
  size_t n, slot_stride;
  int e, d, c0, t_ticks, rows;

  __device__ void seed(const arena::State& s, bool active) {
    const int first = c0 - d > 0 ? c0 - d : 0;
    for (int f = first; f <= c0; ++f) {
      arena::State src = s;
      if (f < c0 && active) src = arena::load(ring + (size_t)(f % (d + 2)) * slot_stride, n, e);
      add(src, active, f % rows);
    }
    grid_sync(bar);
    for (int f = first; f <= c0; ++f) finalize(f % rows);
    __syncthreads();
  }
  __device__ __forceinline__ void step(arena::State& s, bool, const int* in, int f, int) {
    ArenaReduce::step(s, in, f % rows);
  }
  __device__ void frontier_done(const arena::State& s, bool active, int c, int t) {
    if (t == t_ticks - 1) return;  // no tick of this batch reads frame c+1's row
    zero((c + 2) % rows);
    add(s, active, (c + 1) % rows);
    grid_sync(bar);
    finalize((c + 1) % rows);
    __syncthreads();
  }
};

// dynamic shared memory of the arena kernel, in words: the body's, the
// verdict's, the finalized teams and the block-sum scratch
__host__ __device__ inline size_t arena_smem_words(int d, int rows, int num_players) {
  return body_smem_words(d) + 3 * (size_t)(d + 2) + 3 * (size_t)rows * num_players +
         3 * (size_t)arena::kTeamChunk * kWarps;
}

template <bool kCache>
__global__ void __launch_bounds__(kBlock, kArenaMinBlocksPerSm) synctest_fused_arena_kernel(
    SyncTestArgs<arena::Weights> a, int* r_frame, int* iring, int* h_tag, int* h_hi, int* h_lo,
    int* meta, uint32_t* done, uint32_t* raw, unsigned int* bar, int rows) {
  extern __shared__ uint32_t smem[];
  const int c0 = a.meta[0];
  const int e = blockIdx.x * kBlock + threadIdx.x;
  const int P = a.num_players;
  int* verdict_sh = reinterpret_cast<int*>(smem + body_smem_words(a.d));
  uint32_t* fin_words = smem + body_smem_words(a.d) + 3 * (size_t)(a.d + 2);
  ArenaReduce r{reinterpret_cast<arena::Team*>(fin_words), fin_words + 3 * (size_t)rows * P, raw,
                bar, P, a.input_size, e % P, (e % P + 1) % P};
  if (kCache) {
    const size_t n = (size_t)a.n;
    ArenaCacheStepper st{r, a.ring, n, (size_t)arena::kPlanes * n, e, a.d, c0, a.t_ticks, rows};
    synctest_entity_batch<arena::Model>(a, smem, st);
  } else {
    ArenaInlineStepper st{r, 0};
    synctest_entity_batch<arena::Model>(a, smem, st);
  }
  finish_batch(a, c0, r_frame, iring, h_tag, h_hi, h_lo, meta, done, verdict_sh);
}

namespace {

// The batch of a model with no reduction. Returns the CUDA error of the
// scratch reset or the launch (0 on success).
template <class M>
int launch_fused(int* state, int* ring, int* r_frame, int* iring, int* h_tag, int* h_hi, int* h_lo,
                 int* meta, const int* inputs, uint32_t* scratch, int n, int num_players,
                 int input_size, int d, int t_ticks, int substeps, const int* cs, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t events = (size_t)t_ticks * d;
  // scratch: parts_hi [T*d], parts_lo [T*d], done counter [1]
  cudaError_t err = cudaMemsetAsync(scratch, 0, (2 * events + 1) * sizeof(uint32_t), st);
  if (err != cudaSuccess) return (int)err;
  SyncTestArgs<typename M::Weights> a{state, ring, iring, inputs, meta, scratch, scratch + events,
                                      n, num_players, input_size, d, t_ticks, substeps,
                                      weights_from<typename M::Weights, M::kPlanes>(cs)};
  const int blocks = (n + kBlock - 1) / kBlock;
  const size_t smem = (body_smem_words(d) + 3 * (size_t)(d + 2)) * sizeof(uint32_t);
  synctest_fused_kernel<M><<<blocks, kBlock, smem, st>>>(a, r_frame, iring, h_tag, h_hi, h_lo, meta,
                                                         scratch + 2 * events);
  return (int)cudaGetLastError();
}

}  // namespace

// ex_game. cs: 11 int32 — checksum w[5], base[5], frame weight.
extern "C" int synctest_fused_launch(int* state, int* ring, int* r_frame, int* iring, int* h_tag,
                                     int* h_hi, int* h_lo, int* meta, const int* inputs,
                                     uint32_t* scratch, int n, int num_players, int input_size,
                                     int d, int t_ticks, int substeps, const int* cs,
                                     void* stream) {
  return launch_fused<exg::Model>(state, ring, r_frame, iring, h_tag, h_hi, h_lo, meta, inputs, scratch,
                                  n, num_players, input_size, d, t_ticks, substeps, cs, stream);
}

// swarm. cs: 15 int32 — checksum w[7], base[7], frame weight.
extern "C" int synctest_fused_swarm_launch(int* state, int* ring, int* r_frame, int* iring, int* h_tag,
                                           int* h_hi, int* h_lo, int* meta, const int* inputs,
                                           uint32_t* scratch, int n, int num_players, int input_size,
                                           int d, int t_ticks, const int* cs, void* stream) {
  return launch_fused<swarm::Model>(state, ring, r_frame, iring, h_tag, h_hi, h_lo, meta, inputs, scratch,
                                    n, num_players, input_size, d, t_ticks, 1, cs, stream);
}

// Number of rows of arena's raw reduction table for a batch of t_ticks.
extern "C" int synctest_fused_arena_rows(int d, int t_ticks) { return t_ticks > 1 ? d + 3 : 3; }

// The arena batch, launched cooperatively. scratch: parts_hi [T*d],
// parts_lo [T*d], done counter [1], barrier [2], raw table
// [rows * 3P] (rows from synctest_fused_arena_rows). Returns the CUDA error
// of the reset, the shared-memory attribute, the occupancy query or the
// launch, or kNotCoResident.
// cs: 13 int32 — checksum w[6], base[6], frame weight.
extern "C" int synctest_fused_arena_launch(int* state, int* ring, int* r_frame, int* iring,
                                           int* h_tag, int* h_hi, int* h_lo, int* meta,
                                           const int* inputs, uint32_t* scratch, int n,
                                           int num_players, int input_size, int d, int t_ticks,
                                           const int* cs, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t events = (size_t)t_ticks * d;
  const int rows = synctest_fused_arena_rows(d, t_ticks);
  const size_t words = 2 * events + 3 + (size_t)rows * 3 * num_players;
  cudaError_t err = cudaMemsetAsync(scratch, 0, words * sizeof(uint32_t), st);
  if (err != cudaSuccess) return (int)err;
  SyncTestArgs<arena::Weights> a{state, ring, iring, inputs, meta, scratch, scratch + events,
                                 n, num_players, input_size, d, t_ticks, 1,
                                 weights_from<arena::Weights, arena::kPlanes>(cs)};
  uint32_t* done = scratch + 2 * events;
  unsigned int* bar = scratch + 2 * events + 1;
  uint32_t* raw = scratch + 2 * events + 3;
  const int blocks = (n + kBlock - 1) / kBlock;
  const size_t smem = arena_smem_words(d, rows, num_players) * sizeof(uint32_t);
  const void* fn = t_ticks > 1 ? (const void*)synctest_fused_arena_kernel<true>
                               : (const void*)synctest_fused_arena_kernel<false>;
  if (smem > 48 * 1024) {  // many teams: the finalized table outgrows the default
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  long long resident = 0;
  if ((err = resident_blocks(fn, smem, &resident)) != cudaSuccess) return (int)err;
  if (resident < blocks) return kNotCoResident;
  void* args[] = {&a, &r_frame, &iring, &h_tag, &h_hi, &h_lo, &meta, &done, &raw, &bar,
                  const_cast<int*>(&rows)};
  err = cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(kBlock), args, smem, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
