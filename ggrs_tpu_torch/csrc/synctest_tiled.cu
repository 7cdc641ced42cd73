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
// (pallas_tiled.py:66-106, red_for :285) on a body of its own, one launch a
// tick of the injection route: see namespace injected_arena below.
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

// ---------------------------------------------------------------------------
// Arena on an injected reduction table: ONE launch a tick of the injection
// route (device/injected_core.py), the reference's ShardedPallasTiledCore
// tick (pallas_tiled.py:870-895) on one device, where its psum is the
// identity. The launch does what that tick does, in its order:
//
//  - the tick on the table red [d+1, 3P] (row i: the raw sums the resim
//    step of frame base+i reduces from; row d: the frontier step's): load
//    slot c-d, d resim steps with their re-saves, the frontier save and
//    step, a thread an entity;
//  - the NEXT tick's table (`roll`, :858-867): rows 1..d of this one moved
//    up into next, and next's row d the raw sums of the new live state.
//    Each block sums its entities' final states by team at O(1) an entity
//    (arena::warp_team_add) and adds its sums to next's row d with uint32
//    atomics; the caller leaves that row zero (the last block zeroes red's
//    row d, and the caller alternates the two tables). Before frame d the
//    caller rebuilds the next table in full with K5 instead (the
//    reference's boot branch) and this row goes unused;
//  - the verdict (`_verdict`, :468), in the LAST block by ticket:
//    `synctest_verdict` of synctest_body.cuh, as K1's tail runs it; it then
//    leaves parts and the ticket zero. Block 0 brings the ring-frame tags
//    and the input ring up to date in place as it starts
//    (synctest_bookkeeping_block): no block reads the tags, and slot
//    c % (d+2) of the input ring, the one it writes, holds frame c-d-2,
//    which no step of this tick reads.
//
// So a tick is one launch with no memset, no PyTorch copy and no K5 call.
// Each block finalizes the whole table into shared memory (the steps read
// any row), so the blocks stay independent until the ticket. A save that
// a later tick of the same batch makes again before anything reads it
// (`later` ticks follow this one) skips its ring store, as K2's inline
// route does: the ring between two launches of one batch is read only by
// the rollback loads, and the batch ends with every frame's last save
// stored. Before frame d every save is stored: K5 reads the ring then.
//
// What bounds it on an H100: latency at every size the port runs: each
// thread's chain of d+1 dependent arena steps (64 int32 ops each, 18 a
// save), then the block sums, the ticket and the serial tail (bookkeeping
// and verdict, one block). At 65536 entities a tick that stores every
// save writes d ring columns of 24 B an entity (12.6 MB at d = 8).
namespace injected_arena {

constexpr int kThreads = 128;  // a block's entities

struct Args {
  int* state;         // [6, n] live world, in place
  int* ring;          // [d+2, 6, n] in place
  int* r_frame;       // [d+2] in place
  int* iring;         // [d+2, P, I] in place
  const int* inputs;  // [P, I] this tick's
  int* meta;          // [3] (c, mismatch, mismatch frame), in place
  int* h_tag;         // [d+2] the first-seen history, in place
  int* h_hi;
  int* h_lo;
  int* red;         // [d+1, 3P] this tick's raw table; its row d is left zero
  int* next;        // [d+1, 3P] the next tick's: rows 0..d-1 written, row d summed into (zero on entry)
  uint32_t* parts;  // [2, d] the events' (hi, lo) sums: zero on entry, left zero
  uint32_t* done;   // the last-block ticket: zero on entry, left zero
  int n, num_players, input_size, d, later;
  arena::Weights cw;
};

// dynamic shared memory, in words: finalized table [(d+1) P] Teams, each
// warp's event sums [2][d][warps], team rows [nrows][3P], the verdict's
__host__ __device__ inline size_t tick_smem_words(int d, int P, int warps) {
  const int nrows = P <= arena::kRowTeams ? warps : 1;
  return 3 * (size_t)(d + 1) * P + 2 * (size_t)d * warps + (size_t)nrows * 3 * P + verdict_smem_words(d);
}

__global__ void __launch_bounds__(kThreads) tick_kernel(Args a) {
  extern __shared__ uint32_t smem[];
  const int d = a.d, P = a.num_players, I = a.input_size, row = P * I, ring_len = d + 2, words = 3 * P;
  const int bd = blockDim.x, warps = bd / 32, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool own_row = P <= arena::kRowTeams;
  const int nrows = own_row ? warps : 1;
  arena::Team* fin = reinterpret_cast<arena::Team*>(smem);
  uint32_t* ev = smem + 3 * (d + 1) * P;
  uint32_t* rows = ev + 2 * d * warps;
  int* vsh = reinterpret_cast<int*>(rows + nrows * words);
  const int c0 = a.meta[0];
  const int c_last = c0 + a.later;

  const int e = blockIdx.x * bd + threadIdx.x;
  const bool active = e < a.n;
  const int team = e % P, enemy = team + 1 == P ? 0 : team + 1;
  const size_t n = (size_t)a.n, slot_stride = (size_t)arena::kPlanes * n;
  arena::State s{};  // its load in flight while the block finalizes the table
  if (active) s = arena::load(c0 > d ? a.ring + (size_t)((c0 - d) % ring_len) * slot_stride : a.state, n, e);
  uint32_t ew[arena::kPlanes];
  arena::entity_weights(a.cw, (uint32_t)e, ew);

  for (int j = threadIdx.x; j < nrows * words; j += bd) rows[j] = 0;
  // the next table's rows 0..d-1: this one's rows 1..d, spread over the grid
  for (int k = blockIdx.x * bd + threadIdx.x; k < d * words; k += gridDim.x * bd) a.next[k] = a.red[words + k];
  for (int k = threadIdx.x; k < (d + 1) * P; k += bd) {
    const int* r = a.red + (size_t)(k / P) * words + 3 * (k % P);
    fin[k] = inline_arena::finalize_sums((uint32_t)r[0], (uint32_t)r[1], (uint32_t)r[2]);
  }
  if (blockIdx.x == 0) synctest_bookkeeping_block(a.r_frame, a.iring, a.inputs, c0, 1, d, row);
  __syncthreads();  // fin and the zeroed rows

  // frame f's inputs: this tick's for f = c, else the input ring (frames c-d-2..c-1)
  auto step = [&](int f, int i) {
    const int* own = (f >= c0 ? a.inputs : a.iring + (size_t)(f % ring_len) * row) + team * I;
    arena::step(s, own[0], arena::throttle_of(own, I), fin[i * P + team], fin[i * P + enemy]);
  };
  // the save of frame f as event j: into the ring unless a later tick of
  // the batch saves f again before anything reads it; its terms per warp
  auto save = [&](int f, int j) {
    uint32_t hi = 0, lo = 0;
    if (active) {
      if (c0 <= d || min(f + d - 1, c_last) <= c0) arena::store(a.ring + (size_t)(f % ring_len) * slot_stride, n, e, s);
      arena::checksum_terms(s, ew, hi, lo);
    }
    hi = __reduce_add_sync(0xFFFFFFFFu, hi);
    lo = __reduce_add_sync(0xFFFFFFFFu, lo);
    if (lane == 0) {
      ev[j * warps + warp] = hi;
      ev[(d + j) * warps + warp] = lo;
    }
  };

  if (c0 > d) {  // forced rollback
    const int base = c0 - d;
    for (int i = 0; i < d; ++i) {
      if (i > 0) save(base + i, i - 1);
      if (active) step(base + i, i);
    }
  }
  save(c0, d - 1);
  uint32_t one = 0, sx = 0, sy = 0;
  if (active) {
    step(c0, d);
    arena::store(a.state, n, e, s);
    arena::team_terms(s, one, sx, sy);
  }
  arena::warp_team_add(one, sx, sy, team, P, true, rows, own_row);
  __syncthreads();  // the event sums and team rows are in

  // the block's event sums into parts, its team sums into next's row d
  uint32_t* next_row = reinterpret_cast<uint32_t*>(a.next) + (size_t)d * words;
  for (int k = threadIdx.x; k < 2 * d + words; k += bd) {
    uint32_t v = 0;
    if (k < 2 * d) {
      const int j = k % d;
      if (j < d - 1 && c0 <= d) continue;  // no rollback: the re-saves did not happen
      for (int w = 0; w < warps; ++w) v += ev[k * warps + w];
      if (v) atomicAdd(a.parts + k, v);
    } else {
      v = arena::warp_rows_sum(rows, nrows, words, k - 2 * d);
      if (v) atomicAdd(next_row + (k - 2 * d), v);
    }
  }

  // last-block-done: every thread fences its own atomics, then one ticket
  // a block; the block that draws the last ticket sees every block's parts
  __shared__ bool is_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(a.done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  synctest_verdict(a.parts, a.parts + d, 1, d, a.cw.frame_weight, a.h_tag, a.h_hi, a.h_lo, a.meta, vsh);
  __syncthreads();  // the verdict's reads of parts are done
  for (int k = threadIdx.x; k < 2 * d; k += bd) a.parts[k] = 0;
  for (int k = threadIdx.x; k < words; k += bd) a.red[(size_t)d * words + k] = 0;  // every block has read it
  if (threadIdx.x == 0) *a.done = 0;
}

}  // namespace injected_arena

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

// Arena, one tick of the injection route on the table red [d+1, 3P], the
// next table into next and the verdict, in one launch. scratch: parts [2d]
// then the ticket, zero before the core's first launch and left zero by
// each; next's row d zero on entry; red's row d is left zero. later: the
// ticks of the same batch after this one. Returns the CUDA error of the
// launch (0 on success). cs: 13 int32 — checksum w[6], base[6], frame weight.
extern "C" int synctest_tiled_arena_launch(int* state, int* ring, int* r_frame, int* iring, int* meta,
                                                    const int* inputs, int* h_tag, int* h_hi, int* h_lo, int* red,
                                                    int* next, uint32_t* scratch, int n, int num_players,
                                                    int input_size, int d, int later, const int* cs,
                                                    void* stream) {
  using namespace injected_arena;
  const Args a{state, ring, r_frame, iring, inputs, meta, h_tag, h_hi, h_lo, red, next, scratch, scratch + 2 * d,
               n, num_players, input_size, d, later, weights_from<arena::Weights, arena::kPlanes>(cs)};
  const size_t smem = tick_smem_words(d, num_players, kThreads / 32) * sizeof(uint32_t);
  if (smem > 48 * 1024) {  // many teams: the finalized table outgrows the default
    const cudaError_t err = cudaFuncSetAttribute(tick_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  tick_kernel<<<(n + kThreads - 1) / kThreads, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
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
