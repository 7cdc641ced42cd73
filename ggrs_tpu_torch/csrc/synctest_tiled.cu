// K2 — the entity-tiled SyncTest kernel on Hopper (ex_game and swarm, and
// arena with an injected reduction table), and the small kernel that runs
// its first-seen history post-pass.
//
// Replaces: ggrs_tpu/tpu/pallas_tiled.py, PallasTiledSyncTestCore._build
// (the pallas_call at :428), for worlds past the whole-batch envelope. On
// the TPU the grid walks entity tiles in order, each tile running all T
// ticks inside VMEM and adding its partial checksums to a revisit buffer.
// Here each 128-entity block is a tile; blocks run in parallel in any order,
// and their partial sums meet in parts_hi/parts_lo [T, d] through uint32
// atomics (exact in any order). Outputs, as the reference's: state and ring
// in place, the ring-frame tags, the evolved input ring (to a separate
// buffer — every block still reads the old one), and the partial sums
// WITHOUT the frame term, zero for events that did not happen.
//
// The history compare is the reference's jnp post-pass `_verdict`
// (pallas_tiled.py:468); here it is `synctest_verdict_kernel`, one thread,
// the same function the whole-batch kernel runs in its last block.
//
// What bounds it on an H100: at 1M entities, d=8, the state and ring are
// 220 MB, streamed once in and once out per batch (~0.13 ms at 3.35 TB/s),
// but every tick re-reads one ring slot and re-writes d slots per entity
// through the 50 MB L2, so HBM traffic grows with T*d. The int32 ALU work,
// ~T*(d+1) steps of ~100 integer ops for each of 1M entities, is the larger
// bound; 8192 blocks fill the card, and the serial d*T chain per thread is
// hidden by the other warps.
//
// Arena runs here in the reference's external_reduce mode
// (pallas_tiled.py:66-106, red_for :285): ONE tick per launch, with the
// complete raw reduction table red_raw [d+1, 3P] as an input (row i: the
// resim step of frame base+i; row d: the frontier step), built by K5
// (reduce_table.cu) from the ring slots and the live state. Each block
// finalizes the table into shared memory (scalar work for (d+1) x P teams)
// before its entities step, so blocks stay independent.
//
// Arena also runs here as the reference's unsharded whole-world tile
// (pallas_tiled.py:94-130: external_reduce off, `red_for` None at :285-293,
// so the adapter reduces from the tile, which is the whole world): any T
// in one launch, and every step — the d resim steps and the frontier step
// alike — reduces inline from the whole world entering it. Here that is
// block team sums, a grid barrier and a finalize in every block
// (arena_reduce.cuh's ArenaInlineStepper), so the grid is launched
// cooperatively. The grid is persistent: a block owns tiles b, b + grid,
// b + 2 grid, ... and the live world sits in `state` in global memory
// between barriers, so any world arena admits runs, however many tiles it
// has. A batch pays T * (d+1) grid barriers once past frame d. The
// reference's 96 MB single-tile budget is a VMEM limit and is not copied.
// What bounds it on an H100: at 4096 entities its 32 blocks wait on those
// barriers (~4 us each, a few L2 round trips), far above the int32 work;
// at 512k entities (16 teams) the kernel's own int32 work sets it — 64 ops
// a step plus 3 + 3P of block team sums an entity-step, where the function
// needs 6 for an entity's share of a reduction — and the state, read twice
// and written once a step, stays in the 50 MB L2.
//
// Left for later: holding each block's ring tile in shared memory for the
// whole batch (10 slots x 5 planes x 128 entities x 4 B = 25.6 KB), so HBM
// sees each byte exactly once, as the reference's VMEM tile does; a CUDA
// graph around the two launches; keeping the inline route's states in
// registers when every tile fits the card at once.
#include <cuda_runtime.h>

#include "arena_reduce.cuh"
#include "swarm_step.cuh"
#include "synctest_body.cuh"

// a model with no reduction (ex_game, swarm): one template over its traits
template <class M>
__global__ void __launch_bounds__(kBlock) synctest_tiled_kernel(SyncTestArgs<typename M::Weights> a,
                                                                int* r_frame, int* iring_out) {
  extern __shared__ uint32_t smem[];
  if (blockIdx.x == 0 && threadIdx.x == 0)
    synctest_bookkeeping(r_frame, a.iring, iring_out, a.inputs, a.meta[0], a.t_ticks, a.d,
                         a.num_players * a.input_size);
  EntityStepper<M> st{a.substeps};
  synctest_entity_batch<M>(a, smem, st);
}

// arena's step from the injected table: the resim step i (and the frontier
// step, i = d) reads finalized row i
struct ArenaTableStepper {
  const arena::Team* fin;  // shared: [(d+1) * P]
  int num_players, input_size, team, enemy;

  __device__ __forceinline__ void seed(const arena::State&, bool) {}
  __device__ __forceinline__ void step(arena::State& s, bool, const int* in, int, int i) {
    const int P = num_players;
    arena::step(s, in[0], arena::throttle_of(in, input_size), fin[i * P + team], fin[i * P + enemy]);
  }
  __device__ __forceinline__ void frontier_done(const arena::State&, bool, int, int) {}
};

__global__ void __launch_bounds__(kBlock) synctest_tiled_arena_kernel(
    SyncTestArgs<arena::Weights> a, int* r_frame, int* iring_out, const int* red_raw) {
  extern __shared__ uint32_t smem[];
  if (blockIdx.x == 0 && threadIdx.x == 0)
    synctest_bookkeeping(r_frame, a.iring, iring_out, a.inputs, a.meta[0], a.t_ticks, a.d,
                         a.num_players * a.input_size);
  const int P = a.num_players;
  arena::Team* fin = reinterpret_cast<arena::Team*>(smem + body_smem_words(a.d));
  for (int k = threadIdx.x; k < (a.d + 1) * P; k += kBlock) {
    const int* r = red_raw + (size_t)(k / P) * 3 * P + 3 * (k % P);
    fin[k] = arena::finalize(r[0], r[1], r[2]);
  }
  __syncthreads();
  const int e = blockIdx.x * kBlock + threadIdx.x;
  ArenaTableStepper st{fin, P, a.input_size, e % P, (e % P + 1) % P};
  synctest_entity_batch<arena::Model>(a, smem, st);
}

// The inline route's batch over the block's tiles, in the event layout of
// synctest_entity_batch (synctest_body.cuh), with the state in global
// memory: every step is one pass over the block's tiles reading the state
// entering it (a save first, when the step has one, then the block's team
// sums), the grid barrier and the finalize, and a second pass that steps
// each tile and stores it. `src` is the ring slot a rollback loads for its
// first step and the live state after it; a pass touches only its own
// entities' columns, so stepping in place is safe.
__device__ void arena_inline_tiles_batch(const SyncTestArgs<arena::Weights>& a, uint32_t* red,
                                         ArenaInlineStepper& st) {
  const int d = a.d, ring_len = d + 2, P = a.num_players, I = a.input_size, row = P * I;
  const int tiles = (a.n + kBlock - 1) / kBlock;
  const int c0 = a.meta[0];
  const size_t n = (size_t)a.n, slot_stride = (size_t)arena::kPlanes * n;

  // the input row of frame f: this batch's inputs for f >= c0, else the input ring
  auto input_of = [&](int f) -> const int* {
    return f >= c0 ? a.inputs + (size_t)(f - c0) * row : a.iring + (size_t)(f % (d + 2)) * row;
  };
  // the step of frame f from `src` into the live state; j >= 0: first save
  // the state entering it as event (t, j)
  auto step = [&](const int* src, int f, int t, int j) {
    const int* in = input_of(f);
    int* dst = a.ring + (size_t)(f % ring_len) * slot_stride;
    uint32_t hi = 0, lo = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int e = tile * kBlock + threadIdx.x;
      const bool active = e < a.n;
      const arena::State s = active ? arena::load(src, n, e) : arena::State{};
      if (j >= 0 && active) {
        uint32_t ew[arena::kPlanes], h, l;
        arena::Model::entity_weights(a.cw, (uint32_t)e, ew);
        save_entity<arena::Model>(dst, n, e, s, ew, h, l);
        hi += h;
        lo += l;
      }
      st.at(e);
      st.gather(s, active);
    }
    if (j >= 0) block_event_terms(red, d, t, j, hi, lo);
    st.reduce();
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int e = tile * kBlock + threadIdx.x;
      if (e < a.n) {
        arena::State s = arena::load(src, n, e);
        st.at(e);
        st.apply(s, in + (e % P) * I);
        arena::store(a.state, n, e, s);
      }
    }
    ++st.k;
  };

  for (int t = 0; t < a.t_ticks; ++t) {
    const int c = c0 + t;
    if (c > d) {  // forced rollback (uniform across the grid: c is shared)
      const int base = c - d;
      step(a.ring + (size_t)(base % ring_len) * slot_stride, base, t, -1);
      for (int i = 1; i < d; ++i) step(a.state, base + i, t, i - 1);
    }
    step(a.state, c, t, d - 1);
    add_tick_events(a.parts_hi, a.parts_lo, red, d, t, c);
  }
}

// dynamic shared memory of the inline route, in words: the body's event
// sums, the three rotating finalized rows and the block-sum scratch
__host__ __device__ inline size_t arena_inline_smem_words(int d, int num_players) {
  return body_smem_words(d) + 3 * 3 * (size_t)num_players + 3 * (size_t)arena::kTeamChunk * kWarps;
}

__global__ void __launch_bounds__(kBlock, kArenaMinBlocksPerSm) synctest_tiled_arena_inline_kernel(
    SyncTestArgs<arena::Weights> a, int* r_frame, int* iring_out, uint32_t* raw, unsigned int* bar) {
  extern __shared__ uint32_t smem[];
  if (blockIdx.x == 0 && threadIdx.x == 0)
    synctest_bookkeeping(r_frame, a.iring, iring_out, a.inputs, a.meta[0], a.t_ticks, a.d,
                         a.num_players * a.input_size);
  const int P = a.num_players;
  uint32_t* fin_words = smem + body_smem_words(a.d);
  ArenaInlineStepper st{{reinterpret_cast<arena::Team*>(fin_words), fin_words + 3 * 3 * (size_t)P, raw, bar,
                         P, a.input_size, 0, 1 % P},
                        0};
  arena_inline_tiles_batch(a, smem, st);
}

__global__ void synctest_verdict_kernel(const uint32_t* parts_hi, const uint32_t* parts_lo,
                                        int t_ticks, int d, uint32_t frame_weight, int* h_tag,
                                        int* h_hi, int* h_lo, int* meta) {
  extern __shared__ int sh[];
  if (threadIdx.x == 0)
    synctest_verdict(parts_hi, parts_lo, t_ticks, d, frame_weight, h_tag, h_hi, h_lo, meta, sh);
}

namespace {

template <class M>
int launch_tiled(int* state, int* ring, int* r_frame, const int* iring, int* iring_out, const int* meta,
                 const int* inputs, uint32_t* parts, int n, int num_players, int input_size, int d,
                 int t_ticks, int substeps, const int* cs, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t events = (size_t)t_ticks * d;
  // parts: parts_hi [T*d] then parts_lo [T*d]
  cudaError_t err = cudaMemsetAsync(parts, 0, 2 * events * sizeof(uint32_t), st);
  if (err != cudaSuccess) return (int)err;
  SyncTestArgs<typename M::Weights> a{state, ring, iring, inputs, meta, parts, parts + events,
                                      n, num_players, input_size, d, t_ticks, substeps,
                                      weights_from<typename M::Weights, M::kPlanes>(cs)};
  const int blocks = (n + kBlock - 1) / kBlock;
  const size_t smem = body_smem_words(d) * sizeof(uint32_t);
  synctest_tiled_kernel<M><<<blocks, kBlock, smem, st>>>(a, r_frame, iring_out);
  return (int)cudaGetLastError();
}

}  // namespace

// The entry points return the CUDA error of their launch (0 on success).
// ex_game. cs: 11 int32 — checksum w[5], base[5], frame weight.
extern "C" int synctest_tiled_launch(int* state, int* ring, int* r_frame, const int* iring,
                                     int* iring_out, const int* meta, const int* inputs,
                                     uint32_t* parts, int n, int num_players, int input_size,
                                     int d, int t_ticks, int substeps, const int* cs,
                                     void* stream) {
  return launch_tiled<exg::Model>(state, ring, r_frame, iring, iring_out, meta, inputs, parts, n,
                                  num_players, input_size, d, t_ticks, substeps, cs, stream);
}

// swarm. cs: 15 int32 — checksum w[7], base[7], frame weight.
extern "C" int synctest_tiled_swarm_launch(int* state, int* ring, int* r_frame, const int* iring,
                                           int* iring_out, const int* meta, const int* inputs,
                                           uint32_t* parts, int n, int num_players, int input_size,
                                           int d, int t_ticks, const int* cs, void* stream) {
  return launch_tiled<swarm::Model>(state, ring, r_frame, iring, iring_out, meta, inputs, parts, n,
                                    num_players, input_size, d, t_ticks, 1, cs, stream);
}

// Arena, one tick (t_ticks must be 1) on the injected red_raw [d+1, 3P].
// cs: 13 int32 — checksum w[6], base[6], frame weight.
extern "C" int synctest_tiled_arena_launch(int* state, int* ring, int* r_frame, const int* iring,
                                           int* iring_out, const int* meta, const int* inputs,
                                           const int* red_raw, uint32_t* parts, int n,
                                           int num_players, int input_size, int d, int t_ticks,
                                           const int* cs, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t events = (size_t)t_ticks * d;
  cudaError_t err = cudaMemsetAsync(parts, 0, 2 * events * sizeof(uint32_t), st);
  if (err != cudaSuccess) return (int)err;
  SyncTestArgs<arena::Weights> a{state, ring, iring, inputs, meta, parts, parts + events,
                                 n, num_players, input_size, d, t_ticks, 1,
                                 weights_from<arena::Weights, arena::kPlanes>(cs)};
  const int blocks = (n + kBlock - 1) / kBlock;
  const size_t smem = (body_smem_words(d) + 3 * (size_t)(d + 1) * num_players) * sizeof(uint32_t);
  if (smem > 48 * 1024) {  // many teams: the finalized table outgrows the default
    err = cudaFuncSetAttribute(synctest_tiled_arena_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  synctest_tiled_arena_kernel<<<blocks, kBlock, smem, st>>>(a, r_frame, iring_out, red_raw);
  return (int)cudaGetLastError();
}

// Arena inline, T ticks, launched cooperatively on min(tiles, resident)
// blocks. scratch: barrier [2], then three raw rows [3 * 3P]; both zeroed
// here. Returns the CUDA error of a reset, the shared-memory attribute, the
// occupancy query or the launch, or kNotCoResident when not one block fits.
// cs: 13 int32 — checksum w[6], base[6], frame weight.
extern "C" int synctest_tiled_inline_arena_launch(int* state, int* ring, int* r_frame, const int* iring,
                                                  int* iring_out, const int* meta, const int* inputs,
                                                  uint32_t* parts, uint32_t* scratch, int n,
                                                  int num_players, int input_size, int d, int t_ticks,
                                                  const int* cs, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t events = (size_t)t_ticks * d;
  cudaError_t err = cudaMemsetAsync(parts, 0, 2 * events * sizeof(uint32_t), st);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(scratch, 0, (2 + 9 * (size_t)num_players) * sizeof(uint32_t), st);
  if (err != cudaSuccess) return (int)err;
  SyncTestArgs<arena::Weights> a{state, ring, iring, inputs, meta, parts, parts + events,
                                 n, num_players, input_size, d, t_ticks, 1,
                                 weights_from<arena::Weights, arena::kPlanes>(cs)};
  unsigned int* bar = scratch;
  uint32_t* raw = scratch + 2;
  const void* fn = (const void*)synctest_tiled_arena_inline_kernel;
  const size_t smem = arena_inline_smem_words(d, num_players) * sizeof(uint32_t);
  if (smem > 48 * 1024) {  // many teams: the finalized rows outgrow the default
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  long long resident = 0;
  if ((err = resident_blocks(fn, smem, &resident)) != cudaSuccess) return (int)err;
  if (resident < 1) return kNotCoResident;
  const long long tiles = ((long long)n + kBlock - 1) / kBlock;
  const int blocks = (int)(tiles < resident ? tiles : resident);
  void* args[] = {&a, &r_frame, &iring_out, &raw, &bar};
  err = cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(kBlock), args, smem, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" int synctest_verdict_launch(const uint32_t* parts_hi, const uint32_t* parts_lo,
                                       int t_ticks, int d, int frame_weight, int* h_tag,
                                       int* h_hi, int* h_lo, int* meta, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = 3 * (size_t)(d + 2) * sizeof(int);
  synctest_verdict_kernel<<<1, 32, smem, st>>>(parts_hi, parts_lo, t_ticks, d,
                                               (uint32_t)frame_weight, h_tag, h_hi, h_lo, meta);
  return (int)cudaGetLastError();
}
