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
// (pallas_tiled.py:468); here it is `synctest_verdict_kernel`, one block of
// a thread an event (up to 1024), the same function the whole-batch kernel
// runs in its last block (synctest_body.cuh).
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
// alike — reduces inline from the whole world entering it: T * (d+1)
// reductions a batch once past frame d, each a barrier across every block
// that holds a part of the world (the inline route below). The
// reference's 96 MB single-tile budget is a VMEM limit and is not copied.
// What bounds it on an H100: the function is int32 work (64 ops an
// entity-step, 18 a save, 6 an entity's share of a reduction); the kernel
// adds a barrier a step. Each SM's block keeps its run of states in its
// shared memory (kOnChip) while the world fits there, and pays a grid
// barrier of one arrival an SM a step. A save reaches the ring only when
// no later tick of the batch saves that frame again (one save a tick past
// frame d, and the last tick's), which keeps the ring traffic near the
// bytes bound: at 524,288 entities a save is 12.6 MB of HBM writes.
//
// Left for later: a CUDA graph around the two launches.
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

// ---------------------------------------------------------------------------
// K2's inline whole-world arena route: one body on a persistent cooperative
// grid of one block an SM, each block owning a contiguous run of entities.
// The layout is chosen on the host (device/tiled_core.py `inline_plan`)
// from the world's size and team count and the card's SM count and shared
// memory:
//
//  - kOnChip: each block holds its run's states in shared memory for the
//    whole batch, while the world fits the card's shared memory;
//  - otherwise the states stay in `state` in global memory, for worlds past
//    that.
// Block sums go to rotating raw rows in global memory (one atomic per
// non-zero team word and block), then a grid barrier (grid_arrive /
// grid_wait) and a finalize in every block. A block has a thread an
// entity, in whole warps, up to kThreads, so a small world's step waits on
// the warps it needs and not on 32.
//
// One thread-block cluster holding a small world was tried as a third
// layout (team sums through distributed shared memory, a cluster barrier a
// step) and dropped: on an H100 it led this grid only at 1024 entities and
// fewer, where the repo runs no configuration, and fell behind from 2048
// on, the more so the larger the world, since its ranks each do more of
// the step's work and its barrier and DSMEM traffic grow with its ranks.
//
// A step is: pass A over the block's entities (apply the pending step, its
// reduction finalized after the last barrier — or, for a rollback's first
// step, load the ring slot this same thread saved in an earlier tick or
// launch — keep the state, add its team terms to the warp's row in shared
// memory: arena_reduce.cuh, O(1) an entity); the block's sums and the
// barrier's ARRIVAL; pass B, the step's save if it has one (its checksum
// terms summed per warp, and the state stored to its ring slot unless the
// batch saves that frame again before anything reads it), which so runs
// while the other blocks arrive and adds nothing to what the arrival
// releases; the barrier's WAIT and the finalize; then the save's event
// sums, one atomic per block into parts. parts is zeroed in the kernel by
// block 0 before its first barrier. The state is written back once, by the
// last pass.
namespace inline_arena {

// The batch, in the event layout of synctest_entity_batch
// (synctest_body.cuh). The block owns entities [lo, lo + count); thread
// tid walks lo + tid, lo + tid + blockDim, ... with its team stepped
// along. kOnChip: the state entering the pending step lives in sh.st,
// else in `state`.
template <bool kOnChip>
__device__ void inline_batch(const SyncTestArgs<arena::Weights>& a, const Shared& sh, const GridReduce& rd,
                             int per_block) {
  const int d = a.d, ring_len = d + 2, P = a.num_players, I = a.input_size, row = P * I;
  const int c0 = a.meta[0];
  const size_t n = (size_t)a.n, slot_stride = (size_t)arena::kPlanes * n;
  const int bd = blockDim.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lo = blockIdx.x * per_block;
  const int count = max(0, min(per_block, a.n - lo));
  const int rounds = (count + bd - 1) / bd;
  const int team0 = (lo + (int)threadIdx.x) % P, team_stride = bd % P;
  const bool fixed = team_stride == 0;  // every round of this thread is the same team: sum in registers
  const int warp0 = threadIdx.x & ~31;
  int k = 0;  // steps reduced in this launch

  auto input_of = [&](int f) -> const int* {
    return f >= c0 ? a.inputs + (size_t)(f - c0) * row : a.iring + (size_t)(f % (d + 2)) * row;
  };
  auto slot = [&](int f) { return a.ring + (size_t)(f % ring_len) * slot_stride; };
  auto keep = [&](int i, int e, const arena::State& s) {
    if (kOnChip) arena::store(sh.st, (size_t)per_block, i, s);
    else arena::store(a.state, n, e, s);
  };
  auto kept = [&](int i, int e) {
    return kOnChip ? arena::load(sh.st, (size_t)per_block, i) : arena::load(a.state, n, e);
  };
  auto accumulate = [&](uint32_t one, uint32_t sx, uint32_t sy, int team, bool consecutive) {
    arena::warp_team_add(one, sx, sy, team, P, consecutive, sh.rows, sh.own_row);
  };

  // Pass A: apply the pending step of frame pf (pf < 0: none) unless `src`
  // replaces the state (a rollback's first step loads ring slot `src`);
  // then keep the state and add its team terms, or, when `last`, store it
  // as the batch's final state.
  auto pass_a = [&](int pf, const int* src, bool last) {
    const int* in = pf >= 0 ? input_of(pf) : nullptr;
    uint32_t one = 0, sx = 0, sy = 0;
    int team = team0;
    for (int r = 0; r < rounds; ++r, team = team + team_stride >= P ? team + team_stride - P : team + team_stride) {
      const int i = r * bd + threadIdx.x;
      uint32_t o = 0, x = 0, y = 0;
      if (i < count) {
        const int e = lo + i;
        arena::State s;
        if (src != nullptr) {
          s = arena::load(src, n, e);
        } else {
          s = pf >= 0 ? kept(i, e) : arena::load(a.state, n, e);
          if (pf >= 0) {
            const int* own = in + team * I;
            arena::step(s, own[0], arena::throttle_of(own, I), sh.fin[team], sh.fin[team + 1 == P ? 0 : team + 1]);
          }
        }
        if (last) {
          arena::store(a.state, n, e, s);
        } else {
          keep(i, e, s);
          arena::team_terms(s, o, x, y);
        }
      }
      if (last) continue;
      if (fixed) {
        one += o;
        sx += x;
        sy += y;
      } else if (r * bd + warp0 < count) {  // warp-uniform: the warp holds an entity this round
        accumulate(o, x, y, team, false);
      }
    }
    if (!last && fixed && warp0 < count) accumulate(one, sx, sy, team0, true);
  };

  // Pass B: the save of the kept states: their checksum terms, each warp's
  // sums to sh.ev, and the states into ring slot `dst` unless it is null
  // (a save this batch saves again before anything reads it)
  auto pass_b = [&](int* dst) {
    uint32_t hi = 0, lo_sum = 0;
    for (int r = 0; r < rounds; ++r) {
      const int i = r * bd + threadIdx.x;
      if (i < count) {
        const int e = lo + i;
        uint32_t ew[arena::kPlanes], h, l;
        arena::Model::entity_weights(a.cw, (uint32_t)e, ew);
        const arena::State s = kept(i, e);
        if (dst != nullptr) save_entity<arena::Model>(dst, n, e, s, ew, h, l);
        else arena::checksum_terms(s, ew, h, l);
        hi += h;
        lo_sum += l;
      }
    }
    hi = warp_sum(hi);
    lo_sum = warp_sum(lo_sum);
    if (lane == 0) {
      sh.ev[2 * warp] = hi;
      sh.ev[2 * warp + 1] = lo_sum;
    }
  };

  // A save of frame f at tick frame c reaches the ring only if no later
  // tick of this batch saves f again: a tick c' > c re-saves f when it rolls
  // back (c' > d) over it (c' <= f + d - 1). Every ring read — a rollback's
  // load of frame c - d, saved last at tick c - 1 — and the ring the batch
  // leaves behind see only such last saves, so the others are dead stores;
  // their checksum terms still count.
  const int c_last = c0 + a.t_ticks - 1;
  auto ring_of = [&](int f, int c) { return min(f + d - 1, c_last) <= max(c, d) ? slot(f) : nullptr; };

  // One step: pass A, arrive, pass B when the step saves as event (t, j),
  // wait and finalize; then the save's sums into parts.
  auto step = [&](int pf, const int* src, int t, int j, int* dst) {
    pass_a(pf, src, false);
    rd.arrive(sh, P, k);
    if (j >= 0) pass_b(dst);
    rd.wait(sh, P, k);
    __syncthreads();  // fin and ev are in
    const int word = (int)threadIdx.x - (bd - 2);  // the last warp's last two lanes: idle in small worlds
    if (j >= 0 && word >= 0) {
      uint32_t v = 0;
      for (int w = 0; w < sh.warps; ++w) v += sh.ev[2 * w + word];
      if (v) atomicAdd((word == 0 ? a.parts_hi : a.parts_lo) + (size_t)t * d + j, v);
    }
    ++k;
  };

  int pf = -1;  // the pending step's frame
  for (int t = 0; t < a.t_ticks; ++t) {
    const int c = c0 + t;
    if (c > d) {  // forced rollback (uniform across the grid: c is shared)
      const int base = c - d;
      step(pf, slot(base), t, -1, nullptr);
      for (int i = 1; i < d; ++i) step(base + i - 1, nullptr, t, i - 1, ring_of(base + i, c));
      pf = c - 1;
    }
    step(pf, nullptr, t, d - 1, ring_of(c, c));
    pf = c;
  }
  pass_a(pf, nullptr, true);
}

}  // namespace inline_arena

// scratch: the barrier counter (u64), then three raw rows [3, 3P]; zero
// before the core's first launch, kept consistent by each
template <bool kOnChip>
__global__ void __launch_bounds__(inline_arena::kThreads, 1) synctest_tiled_arena_inline_kernel(
    SyncTestArgs<arena::Weights> a, int* r_frame, int* iring_out, uint32_t* scratch, int per_block) {
  using namespace inline_arena;
  extern __shared__ uint32_t smem[];
  const int d = a.d, P = a.num_players;
  const bool own_row = P <= arena::kRowTeams;
  uint32_t* rows = smem + 3 * P + 2 * kMaxWarps;
  const int words = (int)(rows + (own_row ? kMaxWarps : 1) * 3 * P - smem);  // all but the states
  const int count = max(0, min(per_block, a.n - (int)blockIdx.x * per_block));
  const Shared sh{reinterpret_cast<arena::Team*>(smem), smem + 3 * P, rows, reinterpret_cast<int*>(smem + words),
                  min(kMaxWarps, (count + 31) / 32), own_row};
  for (int j = threadIdx.x; j < words; j += blockDim.x) smem[j] = 0;
  if (blockIdx.x == 0) {  // parts (hi then lo) are zero before this block's first barrier
    for (size_t j = threadIdx.x; j < 2 * (size_t)a.t_ticks * d; j += blockDim.x) a.parts_hi[j] = 0;
    if (threadIdx.x == 0)
      synctest_bookkeeping(r_frame, a.iring, iring_out, a.inputs, a.meta[0], a.t_ticks, d, P * a.input_size);
  }
  __syncthreads();
  auto* arrived = reinterpret_cast<unsigned long long*>(scratch);
  // no block of this launch can have passed its first barrier yet
  const GridReduce rd{scratch + 2, arrived, ld_acquire(arrived) / gridDim.x};
  inline_batch<kOnChip>(a, sh, rd, per_block);
}

__global__ void synctest_verdict_kernel(const uint32_t* parts_hi, const uint32_t* parts_lo,
                                        int t_ticks, int d, uint32_t frame_weight, int* h_tag,
                                        int* h_hi, int* h_lo, int* meta) {
  extern __shared__ int sh[];
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

namespace {

const void* inline_kernel(int on_chip) {
  return on_chip ? (const void*)synctest_tiled_arena_inline_kernel<true>
                 : (const void*)synctest_tiled_arena_inline_kernel<false>;
}

}  // namespace

// The card's limits the inline route's plan is made from: out[0] the SM
// count, out[1] the shared memory a block may opt in to (bytes).
extern "C" int synctest_tiled_inline_arena_limits(int* out) { return (int)card_limits(out); }

// Once per plan (the core's first inline launch): the shared-memory
// attribute, then the occupancy query: kNotCoResident when the grid of
// `blocks` blocks of `threads` threads cannot be resident at once; else 0
// or a CUDA error. on_chip: the states in shared memory (else in `state`).
extern "C" int synctest_tiled_inline_arena_prepare(int on_chip, int blocks, int threads, int smem_bytes) {
  if (blocks < 1 || threads < 32 || threads > inline_arena::kThreads || threads % 32) return (int)cudaErrorInvalidValue;
  return co_resident(inline_kernel(on_chip), blocks, threads, smem_bytes);
}

// Arena inline, T ticks in one launch, on the plan `prepare` accepted:
// `blocks` blocks of `threads` threads and `per_block` entities each,
// `smem_bytes` of dynamic shared memory, a cooperative grid. parts [2, T,
// d] is zeroed in the kernel. scratch: the barrier counter and three raw
// rows, zero before the core's first launch. Returns the CUDA error of the
// launch (0 on success).
// cs: 13 int32 — checksum w[6], base[6], frame weight.
extern "C" int synctest_tiled_inline_arena_launch(int* state, int* ring, int* r_frame, const int* iring,
                                                  int* iring_out, const int* meta, const int* inputs,
                                                  uint32_t* parts, uint32_t* scratch, int n, int num_players,
                                                  int input_size, int d, int t_ticks, int on_chip, int blocks,
                                                  int threads, int per_block, int smem_bytes, const int* cs,
                                                  void* stream) {
  const size_t events = (size_t)t_ticks * d;
  SyncTestArgs<arena::Weights> a{state, ring, iring, inputs, meta, parts, parts + events,
                                 n, num_players, input_size, d, t_ticks, 1,
                                 weights_from<arena::Weights, arena::kPlanes>(cs)};
  void* args[] = {&a, &r_frame, &iring_out, &scratch, &per_block};
  const cudaError_t err = cudaLaunchCooperativeKernel(inline_kernel(on_chip), dim3(blocks), dim3(threads), args,
                                                      smem_bytes, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" int synctest_verdict_launch(const uint32_t* parts_hi, const uint32_t* parts_lo,
                                       int t_ticks, int d, int frame_weight, int* h_tag,
                                       int* h_hi, int* h_lo, int* meta, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = verdict_smem_words(d) * sizeof(int);
  // one block, a thread an event up to 1024 (whole warps)
  const int threads = min(1024, 32 * max(1, (t_ticks * d + 31) / 32));
  synctest_verdict_kernel<<<1, threads, smem, st>>>(parts_hi, parts_lo, t_ticks, d,
                                                    (uint32_t)frame_weight, h_tag, h_hi, h_lo, meta);
  return (int)cudaGetLastError();
}
