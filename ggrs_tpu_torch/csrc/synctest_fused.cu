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
// Design: one thread per entity for the whole batch, its state in
// registers (`fused_batch` below). Each tick's rollback load is frame c-d,
// which the tick before saved as its first re-save (or, at d = 1, as its
// frontier save): the thread keeps that state in registers and reads the
// ring only at the batch's first rollback. A save reaches the ring only if
// it is what the ring holds when the batch ends, or that first load: no
// later save of the batch writes its slot. So the ring costs each entity
// about d+2 column stores and one load a batch, not d stores and a load a
// tick. The per-event checksum sums are warp sums (`redux.sync`), kept a
// warp a word in shared memory for a chunk of ticks, then summed per block
// and added to a [T, d] scratch with uint32 atomics: one block barrier a
// chunk, not a tick. The LAST block to finish (a done-counter ticket) then
// runs the ring tags, the input ring (`synctest_bookkeeping_block`) and the
// history compare (`synctest_verdict`) with all its threads: the verdict's
// closed form makes every event's compare independent, so the tail is a
// few strided passes, with no host round trip and no second launch. ex_game
// and swarm (7 planes: a 3-D position and velocity and a battery) are one
// template over the model's traits (exg::Model, swarm::Model), each behind
// its own entry point.
//
// Arena adds a cross-entity reduction to every step: per team, the living
// count and centroid of the state entering it. The reference's K1 computes
// them as the whole-world sums its single VMEM-resident program can take;
// here the world is spread over blocks that cannot see each other, so each
// reduction is team sums at O(1) an entity into a row a warp or a shared
// row (`arena::warp_team_add`; past 64 teams the walk of every team), block
// sums, atomics, a GRID barrier and a finalize in every block
// (arena_reduce.cuh). The barrier needs every block
// resident at once, and K1 keeps one entity per thread in registers, so
// arena's K1 is launched cooperatively, after checking co-residency, and
// raises (nonzero return) when the grid does not fit rather than
// deadlocking. With the reference's per-frame cache (T > 1,
// pallas_core.py:789-801, :863-887, :936-944) a batch pays 1 + (T-1)
// barriers: the seed (d+1 cached frames, from the ring slots and the live
// state) and one a tick after the frontier step. A block arrives at that
// barrier at the end of tick c and waits on it only before tick c+1's
// frontier step, the first step that reads frame c+1's row: the d resim
// steps between hide the barrier. With T == 1 the reference reduces inline
// before every step, so does this (d+1 barriers, arrival and wait back to
// back).
//
// What bounds it on an H100: per batch each entity streams its state and
// ring column once in and once out (4 B x planes x (1 + d+2) x 2), ~1.8 MB
// at 4096 entities, d=8 — microseconds at 3.35 TB/s. The work is int32 ALU:
// ~T*(d+1) steps of ~70-100 integer ops per entity, and the chain of
// T*(d+1) steps is serial inside each thread. At 4096 entities only 32
// blocks of 4 warps exist, a quarter of the 132 SMs with one warp a
// scheduler, so the kernel is bound by that chain's latency, not by any
// peak rate; arena adds a grid barrier (L2 round trips) a tick, most of it
// hidden. At 65536 entities, d=16, four blocks an SM share the schedulers
// and the ALU work comes within ~2x of the bound.
//
// Not done: splitting one entity's step over several threads to shorten the
// chain at 4096 entities (the step is serial inside an entity); a CUDA
// graph around the batch loop.
#include <cuda_runtime.h>

#include "arena_reduce.cuh"
#include "swarm_step.cuh"
#include "synctest_body.cuh"

// ticks whose warp sums a block keeps before it adds them to parts (a
// chunk's [2][d][kWarps] words, double-buffered): up to 64 events a chunk.
// Arena's kernel takes chunks of one tick: its grid barrier already holds
// a block barrier a tick, and its shared memory stays what the resident
// grid allows.
__host__ __device__ inline int chunk_ticks(int d) { return d >= 64 ? 1 : (d > 8 ? 64 / d : 8); }

// dynamic shared memory of fused_batch, in words: also what the tail's
// verdict takes (verdict_smem_words(d) <= 16 d), once the batch is done
__host__ __device__ inline size_t fused_smem_words(int d, int chunk) { return (size_t)2 * chunk * 2 * d * kWarps; }

// The batch of one entity a thread (the event layout of synctest_body.cuh),
// for K1, summing events in chunks of `chunk` ticks. `red` holds
// fused_smem_words(d, chunk) words.
template <class M, class Stepper>
__device__ void fused_batch(const SyncTestArgs<typename M::Weights>& a, uint32_t* red, int chunk, Stepper& st) {
  using State = typename M::State;
  const int e = blockIdx.x * kBlock + threadIdx.x;
  const bool active = e < a.n;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int d = a.d, ring_len = d + 2, row = a.num_players * a.input_size;
  const int owner_col = (e % a.num_players) * a.input_size;  // the owner's input bytes
  const int c0 = a.meta[0], c_last = c0 + a.t_ticks - 1;
  const int c1 = max(c0, d + 1);  // the batch's first rollback tick, if c1 <= c_last
  const int chunk_words = 2 * d * kWarps;
  const size_t n = (size_t)a.n, slot_stride = (size_t)M::kPlanes * n;

  uint32_t ew[M::kPlanes];
  M::entity_weights(a.cw, (uint32_t)e, ew);
  State s = active ? M::load(a.state, n, e) : State{};
  State next_load{};  // frame c-d+1 as this tick saved it: the next tick's load
  st.seed(s, active);

  // input of frame f: this batch's inputs for f >= c0, else the input ring
  // (it holds frames c0-d-2..c0-1, every frame a rollback can reach back to)
  auto input_of = [&](int f) -> const int* {
    const int* r = f >= c0 ? a.inputs + (size_t)(f - c0) * row : a.iring + (size_t)(f % (d + 2)) * row;
    return r + owner_col;
  };
  // an input's bytes into registers, a step ahead of the step that uses
  // them (the step reads byte 0, and arena byte 1 when input_size > 1)
  auto fetch = [&](const int* p, int (&v)[2]) {
    v[0] = p[0];
    v[1] = a.input_size > 1 ? p[1] : 0;
  };
  // A save of frame f at tick frame c reaches the ring only when no later
  // save of the batch writes its slot: no later tick re-saves f (a tick
  // c' > max(c, d) does when c' <= f + d - 1) and frame f + d + 2 is not
  // saved — or when f is the first rollback's load, c1 - d, which the ring
  // serves (every later load comes from next_load)
  auto reaches_ring = [&](int f, int c) {
    return min(f + d - 1, c_last) <= max(c, d) && (f + ring_len > c_last || f == c1 - d);
  };
  uint32_t* tick_buf = red;  // this tick's [2][d][kWarps] words of warp sums
  auto save = [&](const State& state, int f, int c, int j) {
    uint32_t hi = 0, lo = 0;
    if (active) {
      if (reaches_ring(f, c)) M::store(a.ring + (size_t)(f % ring_len) * slot_stride, n, e, state);
      M::checksum_terms(state, ew, hi, lo);
    }
    hi = __reduce_add_sync(0xFFFFFFFFu, hi);
    lo = __reduce_add_sync(0xFFFFFFFFu, lo);
    if (lane == 0) {
      tick_buf[j * kWarps + warp] = hi;
      tick_buf[(d + j) * kWarps + warp] = lo;
    }
  };

  int in_chunk = 0, half = 0;  // this tick's place in its chunk, and the chunk's buffer
  int cur[2], next[2];
  for (int t = 0; t < a.t_ticks; ++t) {
    const int c = c0 + t;
    const int* frontier_in = a.inputs + (size_t)t * row + owner_col;
    if (c > d) {  // forced rollback (uniform across the grid: c is shared)
      const int base = c - d;
      if (active) s = c > c1 ? next_load : M::load(a.ring + (size_t)(base % ring_len) * slot_stride, n, e);
      fetch(input_of(base), cur);
      for (int i = 0; i < d; ++i) {
        const int f = base + i;
        fetch(i + 1 < d ? input_of(f + 1) : frontier_in, next);
        if (i > 0) save(s, f, c, i - 1);
        if (i == 1) next_load = s;
        st.step(s, active, cur, f, i);
        cur[0] = next[0];
        cur[1] = next[1];
      }
    } else {
      fetch(frontier_in, cur);
    }
    save(s, c, c, d - 1);
    if (d == 1) next_load = s;
    st.step(s, active, cur, c, d);
    st.frontier_done(s, active, c, t);

    // the chunk's block sums: one barrier a chunk; the double buffer keeps
    // the next chunk's writers off the buffer this chunk's readers still sum
    if (in_chunk == chunk - 1 || t == a.t_ticks - 1) {
      __syncthreads();
      const int t_first = t - in_chunk;
      const uint32_t* buf = red + (size_t)half * chunk * chunk_words;
      for (int k = threadIdx.x; k < (in_chunk + 1) * d; k += kBlock) {
        const int tt = t_first + k / d, j = k % d;
        if (j == d - 1 || c0 + tt > d) {
          const uint32_t* b = buf + (size_t)(tt - t_first) * chunk_words;
          uint32_t hi = 0, lo = 0;
          for (int w = 0; w < kWarps; ++w) {
            hi += b[j * kWarps + w];
            lo += b[(d + j) * kWarps + w];
          }
          atomicAdd(&a.parts_hi[(size_t)tt * d + j], hi);
          atomicAdd(&a.parts_lo[(size_t)tt * d + j], lo);
        }
      }
    }
    if (++in_chunk == chunk) {
      in_chunk = 0;
      half ^= 1;
    }
    tick_buf = red + (size_t)(half * chunk + in_chunk) * chunk_words;
  }
  if (active) M::store(a.state, n, e, s);
}

// The last block to finish runs the bookkeeping and the verdict with all
// its threads: every thread fences its own parts atomics, then one ticket
// per block; the block that draws the last ticket sees all parts. `sh`:
// fused_batch's shared memory, free again.
template <class Weights>
__device__ void finish_batch(const SyncTestArgs<Weights>& a, int c0, int* r_frame, int* iring,
                             int* h_tag, int* h_hi, int* h_lo, int* meta, uint32_t* done, int* sh) {
  __shared__ bool is_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // every other block has finished reading iring and meta: update in place
  synctest_bookkeeping_block(r_frame, iring, a.inputs, c0, a.t_ticks, a.d, a.num_players * a.input_size);
  synctest_verdict(a.parts_hi, a.parts_lo, a.t_ticks, a.d, a.cw.frame_weight, h_tag, h_hi, h_lo, meta, sh);
}

// a model with no reduction (ex_game, swarm)
template <class M>
__global__ void __launch_bounds__(kBlock) synctest_fused_kernel(
    SyncTestArgs<typename M::Weights> a, int* r_frame, int* iring, int* h_tag, int* h_hi, int* h_lo,
    int* meta, uint32_t* done) {
  extern __shared__ uint32_t smem[];
  const int c0 = a.meta[0];
  EntityStepper<M> st{a.substeps};
  fused_batch<M>(a, smem, chunk_ticks(a.d), st);
  finish_batch(a, c0, r_frame, iring, h_tag, h_hi, h_lo, meta, done, reinterpret_cast<int*>(smem));
}

// K1's team sums: a row a warp up to kOwnRowTeams teams
// (arena::warp_team_add), one row the warps share up to kSharedRowTeams,
// past that arena::block_team_sums' walk of every team. Each takes no more
// shared memory than that walk's scratch, so every world K1 held resident
// before still fits.
constexpr int kOwnRowTeams = 16, kSharedRowTeams = 64;

__host__ __device__ inline size_t team_row_words(int num_players) {
  if (num_players <= kOwnRowTeams) return (size_t)kWarps * 3 * num_players;
  return num_players <= kSharedRowTeams ? 3 * (size_t)num_players : 3 * (size_t)arena::kTeamChunk * kWarps;
}

// What arena's reduction steppers share: this entity's team and the next
// team (its enemy), the finalized rows and the team rows in shared memory,
// the raw table in global memory and the split grid barrier.
struct ArenaReduce {
  arena::Team* fin;              // shared: finalized teams, [slots * P]
  uint32_t* rows;                // shared: team_row_words(P), zero between uses
  uint32_t* raw;                 // global: raw sums, [slots * 3P], zeroed before launch
  unsigned long long* arrived;   // global: the barrier's counter, zeroed before launch
  int num_players, input_size, team, enemy;
  unsigned long long waited;     // barriers this block has waited on

  // add this block's sums of `s` to raw row `slot`: each warp's into its
  // row or the shared one, then the rows' sums, one atomic per non-zero
  // word; past kSharedRowTeams, block_team_sums
  __device__ void add(const arena::State& s, bool active, int slot) {
    const int P = num_players;
    if (P > kSharedRowTeams) {
      arena::block_team_sums<kWarps>(active, s.px, s.py, s.hp, team, P, rows, raw + (size_t)slot * 3 * P);
      return;
    }
    const bool own_row = P <= kOwnRowTeams;
    uint32_t one = 0, sx = 0, sy = 0;
    if (active) arena::team_terms(s, one, sx, sy);
    arena::warp_team_add(one, sx, sy, team, P, true, rows, own_row);
    __syncthreads();
    uint32_t* dst = raw + (size_t)slot * 3 * P;
    for (int j = threadIdx.x; j < 3 * P; j += kBlock) {
      const uint32_t v = arena::warp_rows_sum(rows, own_row ? kWarps : 1, 3 * P, j);
      if (v) atomicAdd(&dst[j], v);
    }
  }
  __device__ __forceinline__ void arrive() { grid_arrive(arrived); }
  // wait on the oldest barrier arrived at and not waited on, then
  // finalize raw row `slot` into fin row `slot`
  __device__ void wait_and_finalize(int slot) {
    grid_wait(arrived, ++waited * gridDim.x);
    const int P = num_players;
    for (int t = threadIdx.x; t < P; t += kBlock) {
      const uint32_t* r = raw + (size_t)slot * 3 * P + 3 * t;  // atomics live in L2: read there
      fin[slot * P + t] = arena::finalize((int)__ldcg(r), (int)__ldcg(r + 1), (int)__ldcg(r + 2));
    }
    __syncthreads();
  }
  // zero raw row `slot` (block 0 only)
  __device__ __forceinline__ void zero(int slot) {
    if (blockIdx.x == 0)
      for (int j = threadIdx.x; j < 3 * num_players; j += kBlock) raw[(size_t)slot * 3 * num_players + j] = 0;
  }
  __device__ __forceinline__ void apply(arena::State& s, const int* in, int slot) {
    const int P = num_players;
    arena::step(s, in[0], arena::throttle_of(in, input_size), fin[slot * P + team], fin[slot * P + enemy]);
  }
};

// T > 1: the reference's per-frame cache. Frame f's reduction sits in row
// f % M, M = d+3 rows (one more than the reference's d+2, so that the row
// of frame c+2 can be zeroed during tick c while no block reads or adds to
// it: tick c reads rows of frames c-d..c and adds to frame c+1's). Seeded
// from ring slot f % (d+2) for frames c0-d..c0-1 and from the live state
// for frame c0 — zero-initialised slots early in a session included, as
// the reference seeds them; after each tick's frontier step the new state
// is reduced into frame c+1's row and the block arrives; it waits and
// finalizes that row just before the next tick's frontier step, the first
// to read it. A resim step of frame f reads row f % M.
struct ArenaCacheStepper : ArenaReduce {
  const int* ring;
  size_t n, slot_stride;
  int e, d, c0, t_ticks, rows;
  bool pending;          // arrived at the barrier of the next frontier step's row
  int next_f, next_row;  // the frame stepped after the last one, and its row

  __device__ void seed(const arena::State& s, bool active) {
    const int first = c0 - d > 0 ? c0 - d : 0;
    for (int f = first; f <= c0; ++f) {
      arena::State src = s;
      if (f < c0 && active) src = arena::load(ring + (size_t)(f % (d + 2)) * slot_stride, n, e);
      add(src, active, f % rows);
      __syncthreads();  // the team rows are zero again
    }
    arrive();
    grid_wait(arrived, ++waited * gridDim.x);
    const int P = num_players;
    for (int f = first; f <= c0; ++f)
      for (int t = threadIdx.x; t < P; t += kBlock) {
        const uint32_t* r = raw + (size_t)(f % rows) * 3 * P + 3 * t;
        fin[(f % rows) * P + t] = arena::finalize((int)__ldcg(r), (int)__ldcg(r + 1), (int)__ldcg(r + 2));
      }
    __syncthreads();
  }
  // f % rows, with one division a tick: a tick steps frames c-d..c in order
  __device__ __forceinline__ int row_of(int f) {
    int r = next_row;
    if (f != next_f) r = f % rows;
    next_f = f + 1;
    next_row = r + 1 == rows ? 0 : r + 1;
    return r;
  }
  __device__ __forceinline__ void step(arena::State& s, bool, const int* in, int f, int i) {
    const int row = row_of(f);
    if (i == d && pending) {  // the frontier step: its row's barrier
      wait_and_finalize(row);
      pending = false;
    }
    apply(s, in, row);
  }
  __device__ void frontier_done(const arena::State& s, bool active, int c, int t) {
    if (t == t_ticks - 1) return;  // no tick of this batch reads frame c+1's row
    zero((c + 2) % rows);
    add(s, active, (c + 1) % rows);
    arrive();  // its block barrier also keeps the team rows' zeroing before the next adds
    pending = true;
  }
};

// T == 1: the reference reduces inline from the state entering every step.
// Three raw rows rotate: while step k adds to row k % 3, block 0 zeroes row
// (k+1) % 3 and slower blocks may still read row (k-1) % 3.
struct ArenaInlineStepper : ArenaReduce {
  int k;

  __device__ __forceinline__ void seed(const arena::State&, bool) {}
  __device__ void step(arena::State& s, bool active, const int* in, int, int) {
    zero((k + 1) % 3);
    add(s, active, k % 3);
    arrive();
    wait_and_finalize(k % 3);
    apply(s, in, k % 3);
    ++k;
  }
  __device__ __forceinline__ void frontier_done(const arena::State&, bool, int, int) {}
};

// dynamic shared memory of the arena kernel, in words: the body's (the
// verdict's after it), the finalized teams and the team rows
__host__ __device__ inline size_t arena_smem_words(int d, int rows, int num_players) {
  return fused_smem_words(d, 1) + 3 * (size_t)rows * num_players + team_row_words(num_players);
}

template <bool kCache>
__global__ void __launch_bounds__(kBlock, kArenaMinBlocksPerSm) synctest_fused_arena_kernel(
    SyncTestArgs<arena::Weights> a, int* r_frame, int* iring, int* h_tag, int* h_hi, int* h_lo,
    int* meta, uint32_t* done, uint32_t* raw, unsigned long long* arrived, int rows) {
  extern __shared__ uint32_t smem[];
  const int c0 = a.meta[0];
  const int e = blockIdx.x * kBlock + threadIdx.x;
  const int P = a.num_players;
  uint32_t* fin_words = smem + fused_smem_words(a.d, 1);
  uint32_t* team_rows = fin_words + 3 * (size_t)rows * P;
  for (size_t j = threadIdx.x; j < team_row_words(P); j += kBlock) team_rows[j] = 0;
  __syncthreads();
  ArenaReduce r{reinterpret_cast<arena::Team*>(fin_words), team_rows, raw, arrived, P, a.input_size, e % P,
                (e % P + 1) % P, 0};
  if (kCache) {
    const size_t n = (size_t)a.n;
    ArenaCacheStepper st{r, a.ring, n, (size_t)arena::kPlanes * n, e, a.d, c0, a.t_ticks, rows, false, -1, 0};
    fused_batch<arena::Model>(a, smem, 1, st);
  } else {
    ArenaInlineStepper st{r, 0};
    fused_batch<arena::Model>(a, smem, 1, st);
  }
  finish_batch(a, c0, r_frame, iring, h_tag, h_hi, h_lo, meta, done, reinterpret_cast<int*>(smem));
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
  const size_t smem = fused_smem_words(d, chunk_ticks(d)) * sizeof(uint32_t);
  if (smem > 48 * 1024) {  // a long check distance
    err = cudaFuncSetAttribute(synctest_fused_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
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

// The arena batch, launched cooperatively. scratch: the barrier counter
// (u64) [2], done counter [1], parts_hi [T*d], parts_lo [T*d], raw table
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
  const size_t words = 3 + 2 * events + (size_t)rows * 3 * num_players;
  cudaError_t err = cudaMemsetAsync(scratch, 0, words * sizeof(uint32_t), st);
  if (err != cudaSuccess) return (int)err;
  auto* arrived = reinterpret_cast<unsigned long long*>(scratch);  // the caller's buffer is 8-byte aligned
  uint32_t* done = scratch + 2;
  uint32_t* parts = scratch + 3;
  uint32_t* raw = parts + 2 * events;
  SyncTestArgs<arena::Weights> a{state, ring, iring, inputs, meta, parts, parts + events,
                                 n, num_players, input_size, d, t_ticks, 1,
                                 weights_from<arena::Weights, arena::kPlanes>(cs)};
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
  void* args[] = {&a, &r_frame, &iring, &h_tag, &h_hi, &h_lo, &meta, &done, &raw, &arrived,
                  const_cast<int*>(&rows)};
  err = cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(kBlock), args, smem, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
