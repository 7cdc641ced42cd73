// K3 — ResimCore's packed control-word tick for ex_game, swarm and arena on
// Hopper.
//
// Replaces: ggrs_tpu/tpu/pallas_resim.py, PallasTickCore._build (the
// pallas_call at :324) and its scalar post-pass _scalar_pass (:356). One
// launch runs T packed tick rows (the layout ResimCore.pack_tick_row builds):
// per row an optional ring load, then W (save?, advance?) slots with
// per-player disconnect substitution, the per-slot (hi, lo) checksums with
// their frame terms, the ring-frame tags, the state's own frame and the
// device-verify first-seen history with its mismatch latch. State, ring,
// ring-frame tags and history are updated in place; his/los [T, W] come out.
//
// Row layout (int32): do_load, load_slot, advance_count, start_frame, then
// save_slots[W], statuses[W*P], inputs[W*P*I]. A save slot >= W (the ring's
// scratch slot, index W) means "no save"; the ring has W+1 slots and the
// scratch slot is never written. W == ring_len == max_prediction + 2.
//
// Design (ex_game and swarm, one template over the model's traits,
// exg::Model or swarm::Model; arena's body is below): one thread owns one
// entity for all T rows, as in the SyncTest kernels (synctest_body.cuh): its state
// stays in registers and it reads
// and writes only its own ring column, so a row may load the slot an
// earlier row of the same launch saved. Every thread reads the same control
// words, staged per row in shared memory, so the branches on do_load, on a
// slot's save and on i < advance_count are uniform; unused slots are
// skipped outright where the TPU kernel masks them (the same bits: its
// masked write puts slot 0's old value back). Each save's entity terms are
// reduced in the block (warp shuffles, then shared memory) and added to
// parts_hi/lo [T, W] with uint32 atomics, exact in any order; a skipped save
// adds nothing and keeps its part at 0. The LAST block to finish (a
// done-counter ticket, as the whole-batch SyncTest kernel) then runs the
// scalar pass serially in one thread: no host round trip, one launch per
// dispatch.
//
// What bounds it on an H100: per entity a row moves 20 B per load and per
// save, plus the state once in and once out per launch — a lone d=8
// SyncTest tick (1 load, 8 saves, 9 advances) is ~220 B per entity, 220 MB
// at 1M entities, ~0.066 ms at 3.35 TB/s; its int32 work is 69 ops per
// advance and 15 per save, 741 per entity, ~0.044 ms at 1M entities on
// 16.7 Tops/s. So large worlds are bound by the ring bytes (swarm: 28 B a
// column, 49 ops an advance and 21 a save). At 4096
// entities only 32 blocks exist, and each thread's serial chain of steps
// plus the serial scalar pass set the time, not any peak rate.
//
// Left for later: keeping a block's ring columns in shared memory for the
// whole launch (each row's loads and saves then never leave the SM);
// splitting small worlds over more blocks; a parallel scalar pass.
#include <cuda_runtime.h>

#include "arena_reduce.cuh"
#include "block.cuh"
#include "ex_game_step.cuh"
#include "swarm_step.cuh"

namespace {

constexpr int kDisconnected = 2;  // InputStatus.DISCONNECTED

template <class Weights>
struct TickArgs {
  int* state;          // [K, n] live world (K planes)
  int* state_frame;    // [1] the live world's own frame
  int* ring;           // [W+1, K, n]
  int* r_frame;        // [W+1] ring-frame tags
  int* h_tag;          // [W] device-verify history, null when verification is off
  int* h_hi;           // [W]
  int* h_lo;           // [W]
  int* flag;           // [2] mismatch latch, first mismatching frame
  const int* rows;     // [T, L] packed control words
  int* his;            // [T, W] out: per-slot checksums (uint32 bit patterns)
  int* los;            // [T, W]
  uint32_t* parts_hi;  // [T, W] zeroed before launch
  uint32_t* parts_lo;  // [T, W]
  uint32_t* done;      // last-block ticket, zeroed before launch
  int n, num_players, input_size, window, t_rows, substeps, disconnect_input;
  Weights cw;
};

__host__ __device__ inline int row_len(int w, int p, int i) { return 4 + w + w * p + w * p * i; }

// The scalar lanes (pallas_resim.py:356-424), in one thread, over the
// launch's T x W save events in row order: the state's own frame (a load
// takes the loaded slot's frame) drives each save's frame term,
// frame_i = state_frame + min(i, advance_count); the history keys on
// start_frame + i; a skipped save outputs (0, 0) and touches nothing.
template <class Args>
__device__ void tick_scalar_pass(const Args& a) {
  const int W = a.window, P = a.num_players;
  const int off_save = 4, L = row_len(W, P, a.input_size);
  int sf = *a.state_frame;
  for (int t = 0; t < a.t_rows; ++t) {
    const int* row = a.rows + (size_t)t * L;
    if (row[0] != 0) sf = a.r_frame[row[1]];
    const int adv = row[2], start = row[3];
    for (int i = 0; i < W; ++i) {
      const int slot = row[off_save + i];
      const size_t k = (size_t)t * W + i;
      uint32_t hi = 0, lo = 0;
      if (slot < W) {
        const int frame_i = sf + min(i, adv);
        // parts were summed with atomics in L2: read them there
        hi = __ldcg(&a.parts_hi[k]) + (uint32_t)frame_i * a.cw.frame_weight;
        lo = __ldcg(&a.parts_lo[k]) + (uint32_t)frame_i;
        a.r_frame[slot] = frame_i;
        if (a.h_tag != nullptr) {
          const int frame = start + i;
          const int h = ((frame % W) + W) % W;  // Python's floor modulo
          const bool seen = a.h_tag[h] == frame;
          if (seen && ((uint32_t)a.h_hi[h] != hi || (uint32_t)a.h_lo[h] != lo)) {
            if (a.flag[0] == 0) a.flag[1] = frame;
            a.flag[0] = 1;
          }
          a.h_tag[h] = frame;
          if (!seen) {
            a.h_hi[h] = (int)hi;
            a.h_lo[h] = (int)lo;
          }
        }
      }
      a.his[k] = (int)hi;
      a.los[k] = (int)lo;
    }
    sf += adv;
  }
  *a.state_frame = sf;
}

template <class M>
__global__ void __launch_bounds__(kBlock) resim_tick_kernel(TickArgs<typename M::Weights> a) {
  extern __shared__ int smem[];
  const int W = a.window, P = a.num_players, I = a.input_size;
  const int off_save = 4, off_status = 4 + W, off_input = off_status + W * P;
  const int L = row_len(W, P, I);
  int* staged = smem;                                       // [2][L] rows, double-buffered
  uint32_t* red = reinterpret_cast<uint32_t*>(smem + 2 * L);  // [hi, lo][W][warps]

  const int e = blockIdx.x * kBlock + threadIdx.x;
  const bool active = e < a.n;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int owner = e % P;
  const size_t n = (size_t)a.n, slot_stride = (size_t)M::kPlanes * n;

  uint32_t ew[M::kPlanes];
  M::entity_weights(a.cw, (uint32_t)e, ew);
  typename M::State s = active ? M::load(a.state, n, e) : typename M::State{};

  for (int t = 0; t < a.t_rows; ++t) {
    // row t into its buffer: the other buffer may still be read by the
    // previous row's reduction in slower threads
    int* row = staged + (t & 1) * L;
    for (int k = threadIdx.x; k < L; k += kBlock) row[k] = a.rows[(size_t)t * L + k];
    __syncthreads();

    if (row[0] != 0 && active) s = M::load(a.ring + (size_t)row[1] * slot_stride, n, e);
    const int adv = row[2];
    for (int i = 0; i < W; ++i) {
      const int slot = row[off_save + i];
      if (slot < W) {  // save-then-advance: slot i snapshots the pre-advance state
        uint32_t hi = 0, lo = 0;
        if (active) {
          M::store(a.ring + (size_t)slot * slot_stride, n, e, s);
          M::checksum_terms(s, ew, hi, lo);
        }
        hi = warp_sum(hi);
        lo = warp_sum(lo);
        if (lane == 0) {
          red[i * kWarps + warp] = hi;
          red[(W + i) * kWarps + warp] = lo;
        }
      }
      if (i < adv && active) {
        // a DISCONNECTED owner's input row becomes the game's disconnect input
        const int status = row[off_status + i * P + owner];
        const int inp = status == kDisconnected ? a.disconnect_input
                                                : row[off_input + (i * P + owner) * I];
        M::step(s, inp, a.substeps);
      }
    }

    // red is rewritten only after the next row's first barrier, which every
    // thread reaches after finishing this reduction
    __syncthreads();
    for (int j = threadIdx.x; j < W; j += kBlock) {
      if (row[off_save + j] < W) {
        uint32_t hi = 0, lo = 0;
        for (int w = 0; w < kWarps; ++w) {
          hi += red[j * kWarps + w];
          lo += red[(W + j) * kWarps + w];
        }
        atomicAdd(&a.parts_hi[(size_t)t * W + j], hi);
        atomicAdd(&a.parts_lo[(size_t)t * W + j], lo);
      }
    }
  }
  if (active) M::store(a.state, n, e, s);

  // last-block-done: every thread fences its own parts atomics, then one
  // ticket per block; the block that draws the last ticket sees all parts
  __shared__ bool is_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(a.done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!is_last || threadIdx.x != 0) return;
  __threadfence();
  tick_scalar_pass(a);
}

// ---------------------------------------------------------------------------
// Arena. Every advance first reduces the WHOLE current world (per team: the
// living count, Σ px>>6, Σ py>>6) and finalizes it into centroids, as the
// reference's single-tile kernel does inline (pallas_resim.py:74-121; no
// per-frame cache: P2P resim states are fresh). The world is spread over
// blocks, so each advance is: block sums -> uint32 atomics into the raw row
// of this (row, slot), which the launch zeroed (T·W·3P words: no barrier is
// spent on zeroing) -> one grid barrier -> every block finalizes the row
// into shared memory -> the step. A 16-row dispatch of SyncTest rows at
// check distance 8 therefore waits at 144 grid barriers.
//
// The grid is persistent and co-resident (cooperative launch, sized by the
// occupancy query): each block loops over entity tiles of 128, so any world
// runs, up to and past the reference's whole_world_fits envelope (161,280
// entities at max_prediction 9). Between barriers an entity's state lives in
// the carry's `state` buffer, not in registers — a thread may own several
// entities — so a load copies the ring slot into `state`, a save copies
// `state` into the slot, and each step reads and writes `state`: 24 B each
// way per entity-step, from L2 at the worlds the request path runs (a
// 4096-entity world is 96 KB). A thread reads and writes only the columns
// of the entities it owns, so no barrier is needed between a row's loads,
// saves and steps beyond the reduction's own.
//
// A DISCONNECTED owner steps with the game's whole disconnect row (input
// byte and throttle byte), resolved once per row into shared memory.
//
// What bounds it on an H100: per entity an advance is 64 int32 ops of step
// and 3 + 3P of reduction, a save 18; the bytes a dispatch must move are
// the ring slots it loads and saves and the state (24 B per entity column).
// At 4096 entities the 32 tiles leave most of the card idle and the serial
// chain of barriers (a few microseconds each) sets the time.

struct ArenaTickArgs {
  int* state;          // [6, n] live world: every entity's state between barriers
  int* state_frame;    // [1]
  int* ring;           // [W+1, 6, n]
  int* r_frame;        // [W+1]
  int* h_tag;          // [W] device-verify history, null when verification is off
  int* h_hi;           // [W]
  int* h_lo;           // [W]
  int* flag;           // [2]
  const int* rows;     // [T, L]
  int* his;            // [T, W] out
  int* los;            // [T, W]
  uint32_t* parts_hi;  // [T, W] zeroed before launch
  uint32_t* parts_lo;  // [T, W]
  uint32_t* done;      // last-block ticket, zeroed before launch
  uint32_t* raw;       // [T, W, 3P] raw team sums, one row per advance, zeroed before launch
  unsigned int* bar;   // [2] grid barrier, zeroed before launch
  int n, num_players, input_size, window, t_rows;
  int disc_input, disc_throttle;  // the disconnect row: input byte, throttle
  arena::Weights cw;
};

// dynamic shared memory of the arena tick, in words: staged rows [2][L],
// resolved (input, throttle) [W*P][2], save sums [hi, lo][W][warps],
// finalized teams [P], block-sum scratch
__host__ __device__ inline size_t arena_tick_smem_words(int w, int p, int i) {
  return 2 * (size_t)row_len(w, p, i) + 2 * (size_t)w * p + 2 * (size_t)w * kWarps + 3 * (size_t)p +
         3 * (size_t)arena::kTeamChunk * kWarps;
}

__global__ void __launch_bounds__(kBlock, kArenaMinBlocksPerSm) resim_tick_arena_kernel(ArenaTickArgs a) {
  extern __shared__ int smem[];
  const int W = a.window, P = a.num_players, I = a.input_size;
  const int off_save = 4, off_status = 4 + W, off_input = off_status + W * P;
  const int L = row_len(W, P, I);
  int* staged = smem;                                          // [2][L], double-buffered
  int* resolved = staged + 2 * L;                              // [W*P][2]
  uint32_t* red = reinterpret_cast<uint32_t*>(resolved + 2 * W * P);  // [hi, lo][W][warps]
  arena::Team* fin = reinterpret_cast<arena::Team*>(red + 2 * W * kWarps);  // [P]
  uint32_t* scratch = reinterpret_cast<uint32_t*>(fin + P);   // 3 * kTeamChunk * kWarps

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tiles = (a.n + kBlock - 1) / kBlock;
  const size_t n = (size_t)a.n, slot_stride = (size_t)arena::kPlanes * n;

  for (int t = 0; t < a.t_rows; ++t) {
    // row t into its buffer (the other one may still be read by the
    // previous row's save reduction in slower threads), then every slot's
    // inputs with the disconnect substitution; `resolved` was last read by
    // the previous row's steps, which every thread finished before that
    // row's closing barrier
    int* row = staged + (t & 1) * L;
    for (int k = threadIdx.x; k < L; k += kBlock) row[k] = a.rows[(size_t)t * L + k];
    __syncthreads();
    for (int k = threadIdx.x; k < W * P; k += kBlock) {
      const bool off = row[off_status + k] == kDisconnected;
      const int* in = row + off_input + k * I;
      resolved[2 * k] = off ? a.disc_input : in[0];
      resolved[2 * k + 1] = off ? a.disc_throttle : arena::throttle_of(in, I);
    }
    __syncthreads();

    if (row[0] != 0) {
      const int* src = a.ring + (size_t)row[1] * slot_stride;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int e = tile * kBlock + threadIdx.x;
        if (e < a.n) arena::store(a.state, n, e, arena::load(src, n, e));
      }
    }
    const int adv = row[2];
    for (int i = 0; i < W; ++i) {
      const int slot = row[off_save + i];
      if (slot < W) {  // save-then-advance: slot i snapshots the pre-advance state
        uint32_t hi = 0, lo = 0;
        int* dst = a.ring + (size_t)slot * slot_stride;
        for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
          const int e = tile * kBlock + threadIdx.x;
          if (e < a.n) {
            const arena::State s = arena::load(a.state, n, e);
            arena::store(dst, n, e, s);
            uint32_t ew[arena::kPlanes], h, l;
            arena::entity_weights(a.cw, (uint32_t)e, ew);
            arena::checksum_terms(s, ew, h, l);
            hi += h;
            lo += l;
          }
        }
        hi = warp_sum(hi);
        lo = warp_sum(lo);
        if (lane == 0) {
          red[i * kWarps + warp] = hi;
          red[(W + i) * kWarps + warp] = lo;
        }
      }
      if (i < adv) {
        // the whole world's reduction, then the step on it
        uint32_t* raw = a.raw + ((size_t)t * W + i) * 3 * P;
        for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
          const int e = tile * kBlock + threadIdx.x;
          const bool active = e < a.n;
          const arena::State s = active ? arena::load(a.state, n, e) : arena::State{};
          arena::block_team_sums<kWarps>(active, s.px, s.py, s.hp, e % P, P, scratch, raw);
        }
        grid_sync(a.bar);
        for (int k = threadIdx.x; k < P; k += kBlock)  // atomics live in L2: read there
          fin[k] = arena::finalize((int)__ldcg(raw + 3 * k), (int)__ldcg(raw + 3 * k + 1),
                                   (int)__ldcg(raw + 3 * k + 2));
        __syncthreads();
        for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
          const int e = tile * kBlock + threadIdx.x;
          if (e < a.n) {
            arena::State s = arena::load(a.state, n, e);
            const int own = e % P;
            const int* in = resolved + 2 * (i * P + own);
            arena::step(s, in[0], in[1], fin[own], fin[(own + 1) % P]);
            arena::store(a.state, n, e, s);
          }
        }
      }
    }

    // the row's save sums: red is rewritten only after the next row's first
    // barrier, which every thread reaches after finishing this reduction
    __syncthreads();
    for (int j = threadIdx.x; j < W; j += kBlock) {
      if (row[off_save + j] < W) {
        uint32_t hi = 0, lo = 0;
        for (int w = 0; w < kWarps; ++w) {
          hi += red[j * kWarps + w];
          lo += red[(W + j) * kWarps + w];
        }
        atomicAdd(&a.parts_hi[(size_t)t * W + j], hi);
        atomicAdd(&a.parts_lo[(size_t)t * W + j], lo);
      }
    }
  }

  // last-block-done, then the scalar pass, as for ex_game
  __shared__ bool is_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(a.done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!is_last || threadIdx.x != 0) return;
  __threadfence();
  tick_scalar_pass(a);
}

}  // namespace

namespace {

// The tick of a model with no reduction. Returns the CUDA error of the
// scratch reset, the shared-memory attribute or the launch (0 on success).
template <class M>
int launch_tick(int* state, int* state_frame, int* ring, int* r_frame, int* h_tag, int* h_hi, int* h_lo,
                int* flag, const int* rows, int* his, int* los, uint32_t* scratch, int n, int num_players,
                int input_size, int window, int t_rows, int substeps, const int* disconnect_row,
                const int* cs, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t events = (size_t)t_rows * window;
  // scratch: parts_hi [T*W], parts_lo [T*W], done counter [1]
  cudaError_t err = cudaMemsetAsync(scratch, 0, (2 * events + 1) * sizeof(uint32_t), st);
  if (err != cudaSuccess) return (int)err;
  TickArgs<typename M::Weights> a;
  a.state = state;
  a.state_frame = state_frame;
  a.ring = ring;
  a.r_frame = r_frame;
  a.h_tag = h_tag;
  a.h_hi = h_hi;
  a.h_lo = h_lo;
  a.flag = flag;
  a.rows = rows;
  a.his = his;
  a.los = los;
  a.parts_hi = scratch;
  a.parts_lo = scratch + events;
  a.done = scratch + 2 * events;
  a.n = n;
  a.num_players = num_players;
  a.input_size = input_size;
  a.window = window;
  a.t_rows = t_rows;
  a.substeps = substeps;
  a.disconnect_input = disconnect_row[0];  // the step reads byte 0
  a.cw = weights_from<typename M::Weights, M::kPlanes>(cs);
  const size_t smem =
      (2 * (size_t)row_len(window, num_players, input_size) + 2 * (size_t)window * kWarps) *
      sizeof(int);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(resim_tick_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (n + kBlock - 1) / kBlock;
  resim_tick_kernel<M><<<blocks, kBlock, smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// h_tag/h_hi/h_lo/flag are null when device verification is off.
// disconnect_row: the game's disconnect input, I ints in host memory.
// ex_game. cs: 11 int32 — checksum w[5], base[5], frame weight.
extern "C" int resim_tick_launch(int* state, int* state_frame, int* ring, int* r_frame, int* h_tag,
                                 int* h_hi, int* h_lo, int* flag, const int* rows, int* his,
                                 int* los, uint32_t* scratch, int n, int num_players,
                                 int input_size, int window, int t_rows, int substeps,
                                 const int* disconnect_row, const int* cs, void* stream) {
  return launch_tick<exg::Model>(state, state_frame, ring, r_frame, h_tag, h_hi, h_lo, flag, rows, his,
                                 los, scratch, n, num_players, input_size, window, t_rows, substeps,
                                 disconnect_row, cs, stream);
}

// swarm. cs: 15 int32 — checksum w[7], base[7], frame weight.
extern "C" int resim_tick_swarm_launch(int* state, int* state_frame, int* ring, int* r_frame, int* h_tag,
                                       int* h_hi, int* h_lo, int* flag, const int* rows, int* his,
                                       int* los, uint32_t* scratch, int n, int num_players,
                                       int input_size, int window, int t_rows,
                                       const int* disconnect_row, const int* cs, void* stream) {
  return launch_tick<swarm::Model>(state, state_frame, ring, r_frame, h_tag, h_hi, h_lo, flag, rows, his,
                                   los, scratch, n, num_players, input_size, window, t_rows, 1,
                                   disconnect_row, cs, stream);
}

// The arena tick, launched cooperatively on as many blocks as can be
// resident (at most one per 128-entity tile). scratch: parts_hi [T*W],
// parts_lo [T*W], done [1], barrier [2], raw [T*W*3P]. Returns the CUDA
// error of the reset, the occupancy query, the shared-memory attribute or
// the launch, or kNotCoResident when not one block fits. disconnect_row: I
// ints in host memory. cs: 13 int32 — checksum w[6], base[6], frame weight.
extern "C" int resim_tick_arena_launch(int* state, int* state_frame, int* ring, int* r_frame,
                                       int* h_tag, int* h_hi, int* h_lo, int* flag,
                                       const int* rows, int* his, int* los, uint32_t* scratch,
                                       int n, int num_players, int input_size, int window,
                                       int t_rows, const int* disconnect_row, const int* cs,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t events = (size_t)t_rows * window;
  const size_t words = 2 * events + 3 + events * 3 * num_players;
  cudaError_t err = cudaMemsetAsync(scratch, 0, words * sizeof(uint32_t), st);
  if (err != cudaSuccess) return (int)err;
  ArenaTickArgs a;
  a.state = state;
  a.state_frame = state_frame;
  a.ring = ring;
  a.r_frame = r_frame;
  a.h_tag = h_tag;
  a.h_hi = h_hi;
  a.h_lo = h_lo;
  a.flag = flag;
  a.rows = rows;
  a.his = his;
  a.los = los;
  a.parts_hi = scratch;
  a.parts_lo = scratch + events;
  a.done = scratch + 2 * events;
  a.bar = scratch + 2 * events + 1;
  a.raw = scratch + 2 * events + 3;
  a.n = n;
  a.num_players = num_players;
  a.input_size = input_size;
  a.window = window;
  a.t_rows = t_rows;
  a.disc_input = disconnect_row[0];
  a.disc_throttle = input_size >= 2 ? (disconnect_row[1] & 0x0F) : arena::kDefaultThrottle;
  a.cw = weights_from<arena::Weights, arena::kPlanes>(cs);
  const size_t smem = arena_tick_smem_words(window, num_players, input_size) * sizeof(int);
  const void* fn = (const void*)resim_tick_arena_kernel;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  long long resident = 0;
  if ((err = resident_blocks(fn, smem, &resident)) != cudaSuccess) return (int)err;
  if (resident < 1) return kNotCoResident;
  const long long tiles = (n + kBlock - 1) / kBlock;
  const int blocks = (int)(tiles < resident ? tiles : resident);
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(kBlock), args, smem, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
