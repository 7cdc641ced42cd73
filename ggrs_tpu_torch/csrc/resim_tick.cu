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
// The megabatch entry (resim_tick_stacked_launch, resim_tick_swarm_stacked_
// launch) replaces the reference's vmapped XLA megabatch (ggrs_tpu/tpu/
// backend.py:2058-2152, `MultiSessionDeviceCore._dispatch_impl` and its
// zero-rollback fast program): the same per-entity template on a grid of
// (entity tiles x live rows), each row on its own slot of the stacked
// worlds in place (no gather, no scatter), bounded by the depth bucket.
//
// The resident entry (resim_tick_resident_launch, resim_tick_swarm_resident_
// launch) replaces the reference's virtual-tick driver (ggrs_tpu/tpu/
// backend.py:2714-2823, a lax.while_loop over the vmapped per-row tick,
// `MultiSessionDeviceCore._driver_impl` and `_driver_fast_impl`): ONE launch
// consumes a whole fill cycle of the device mailbox [S, K, L]. The grid is
// (entity tiles x live lanes); block (tile, lane) runs that lane's rows
// 0 .. marks-1 in order on its slot of the stacked worlds with the same
// tick_tile, each thread keeping its entity's state in registers across
// the lane's rows, so a row may load a slot an earlier virtual tick of the
// launch saved. Lanes are independent sessions, so no grid barrier is
// needed between virtual ticks. The last tile of a lane runs the lane's
// scalar pass over its rows and writes his/los [K, S, W] at (t*S + slot)*W
// + i, the reference's flat index; rows above a watermark and lanes with no
// rows are not run, and their entries are written (0, 0), what the
// reference's masked pad rows give.
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
// done-counter ticket) then runs the scalar pass with all its threads
// (`tick_scalar_pass`): no host round trip, and one launch per dispatch —
// the parts and the ticket live in a scratch the core zeroes once, which
// the last block leaves zero again.
//
// The scalar pass, parallel: a state frame per row (a load takes the frame
// the loaded slot holds, which may be one an earlier row of the launch
// saved; else the previous row's frame plus its advance count) by one short
// scan over the rows; then a thread an event for the frames, the checksums,
// the ring-frame tags (the last write to a slot wins) and the first-seen
// history keyed on start_frame + i: an event is seen when the latest
// earlier write to its key carries its frame, and is compared with the
// first write of that run (the carried value when the run reaches back
// past the launch); the lowest-ordered mismatch latches. A row's W keys
// are W consecutive frames, so no two events of a row share a key, and an
// event finds the earlier writes of its key by one look a row.
//
// What bounds it on an H100: per entity a row moves 20 B per load and per
// save, plus the state once in and once out per launch — a lone d=8
// SyncTest tick (1 load, 8 saves, 9 advances) is ~220 B per entity, 220 MB
// at 1M entities, ~0.066 ms at 3.35 TB/s; its int32 work is 69 ops per
// advance and 15 per save, 741 per entity, ~0.044 ms at 1M entities on
// 16.7 Tops/s. So large worlds are bound by the ring bytes (swarm: 28 B a
// column, 49 ops an advance and 21 a save). At 4096
// entities only 32 blocks exist, and each thread's serial chain of steps
// sets the time, not any peak rate.
//
// Left for later: keeping a block's ring columns in shared memory for the
// whole launch (each row's loads and saves then never leave the SM);
// splitting small worlds over more blocks.
#include <climits>
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
  int* his;            // [T, out_stride] out: per-slot checksums (uint32 bit patterns)
  int* los;            // [T, out_stride]
  uint32_t* parts_hi;  // [T, W] zero on entry, left zero
  uint32_t* parts_lo;  // [T, W]
  uint32_t* done;      // last-block ticket, zero on entry, left zero
  int n, num_players, input_size, window, t_rows, substeps, disconnect_input;
  int out_stride;      // words from one row's his/los to the next: W, or S*W for the resident drive
  Weights cw;
};

__host__ __device__ inline int row_len(int w, int p, int i) { return 4 + w + w * p + w * p * i; }

// The scalar pass takes the rows in chunks of scalar_rows(W) rows, about
// kScalarEvents events, so its shared memory does not grow with T
// (device/tick_core.py `scalar_smem_words` mirrors this).
constexpr int kScalarEvents = 256;
__host__ __device__ inline int scalar_rows(int w) { return w >= kScalarEvents ? 1 : kScalarEvents / w; }
__host__ __device__ inline size_t scalar_smem_words(int w) {
  const size_t tc = scalar_rows(w), events = tc * w;
  return tc * (4 + w) + 2 * tc + 4 * events + 2 * ((size_t)w + 1) + 4 * (size_t)w + 4;
}

__device__ __forceinline__ int floor_mod(int x, int m) {
  const int r = x % m;
  return r < 0 ? r + m : r;
}

// The scalar lanes (pallas_resim.py:356-424) by the whole block, over the
// launch's T x W save events in row order, in chunks of rows: each row's
// state frame (a load takes the loaded slot's frame) drives each save's
// frame term, frame_i = state_frame + min(i, advance_count); the history
// keys on start_frame + i; a skipped save outputs (0, 0) and touches
// nothing. Only the first `nslots` slots of a row run (the windowed
// program of the reference's megabatch): a save past them is skipped and
// the advance count is clamped to them; nslots == W is the whole row.
// `sm` holds scalar_smem_words(W) words. Leaves the parts zero.
template <class Args>
__device__ void tick_scalar_pass(const Args& a, int* sm, int nslots) {
  const int W = a.window, L = row_len(W, a.num_players, a.input_size), C = 4 + W;
  const int TC = scalar_rows(W), E = TC * W;
  const int tid = threadIdx.x, bd = blockDim.x;
  const bool verify = a.h_tag != nullptr;
  const uint32_t fw = a.cw.frame_weight;
  int* ctl = sm;                                          // [TC][4 + W] the chunk's control words
  int* sf = ctl + TC * C;                                 // [TC] each row's frame after its load
  int* src = sf + TC;                                     // [TC] a load's source event in the chunk, or -1
  uint32_t* ehi = reinterpret_cast<uint32_t*>(src + TC);  // [E] each event's checksum
  uint32_t* elo = ehi + E;
  uint32_t* rhi = elo + E;  // [E] the value a save's history holds after it
  uint32_t* rlo = rhi + E;
  int* rf = reinterpret_cast<int*>(rlo + E);  // [W+1] ring-frame tags as the chunk found them
  int* last_slot = rf + W + 1;                // [W+1] the chunk's last save to each slot
  int* tag = last_slot + W + 1;               // [W] the history as the chunk found it
  int* hhi = tag + W;
  int* hlo = hhi + W;
  int* last_key = hlo + W;  // [W] the chunk's last save to each history key
  int* misc = last_key + W;  // lowest mismatching event, latch, latched frame, state frame
  auto frame_of = [&](int e) { return sf[e / W] + min(e % W, ctl[(e / W) * C + 2]); };
  auto key_frame = [&](int e) { return ctl[(e / W) * C + 3] + e % W; };

  for (int s = tid; s <= W; s += bd) rf[s] = a.r_frame[s];
  if (verify)
    for (int h = tid; h < W; h += bd) {
      tag[h] = a.h_tag[h];
      hhi[h] = a.h_hi[h];
      hlo[h] = a.h_lo[h];
    }
  if (tid == 0) {
    misc[1] = verify ? a.flag[0] : 0;
    misc[2] = verify ? a.flag[1] : 0;
    misc[3] = *a.state_frame;
  }
  for (int t0 = 0; t0 < a.t_rows; t0 += TC) {
    const int tc = min(TC, a.t_rows - t0), events = tc * W;
    for (int k = tid; k < tc * C; k += bd) {
      const int c = k % C, v = a.rows[(size_t)(t0 + k / C) * L + c];
      ctl[k] = c == 2 ? min(v, nslots) : c >= 4 + nslots ? W : v;
    }
    for (int s = tid; s <= W; s += bd) last_slot[s] = -1;
    for (int h = tid; h < W; h += bd) last_key[h] = -1;
    if (tid == 0) misc[0] = INT_MAX;
    __syncthreads();

    // a load's source: the chunk's last save to its slot before its row
    for (int t = tid; t < tc; t += bd) {
      const int slot = ctl[t * C + 1];
      int found = -1;
      if (ctl[t * C] != 0 && slot < W)
        for (int t2 = t - 1; t2 >= 0 && found < 0; --t2)
          for (int i = W - 1; i >= 0; --i)
            if (ctl[t2 * C + 4 + i] == slot) {
              found = t2 * W + i;
              break;
            }
      src[t] = found;
    }
    __syncthreads();
    if (tid == 0) {  // the rows' state frames: one short scan
      int f = misc[3];
      for (int t = 0; t < tc; ++t) {
        if (ctl[t * C] != 0) f = src[t] >= 0 ? frame_of(src[t]) : rf[ctl[t * C + 1]];
        sf[t] = f;
        f += ctl[t * C + 2];
      }
      misc[3] = f;
    }
    __syncthreads();

    // a thread an event: its checksum (the parts read in L2, where their
    // atomics live, and left zero), the last saves to each slot and key
    for (int e = tid; e < events; e += bd) {
      const int slot = ctl[(e / W) * C + 4 + e % W];
      const size_t k = (size_t)t0 * W + e;
      uint32_t hi = 0, lo = 0;
      if (slot < W) {
        const int f = frame_of(e);
        hi = __ldcg(&a.parts_hi[k]) + (uint32_t)f * fw;
        lo = __ldcg(&a.parts_lo[k]) + (uint32_t)f;
        a.parts_hi[k] = 0;
        a.parts_lo[k] = 0;
        atomicMax(&last_slot[slot], e);
        if (verify) atomicMax(&last_key[floor_mod(key_frame(e), W)], e);
      }
      ehi[e] = hi;
      elo[e] = lo;
      const size_t o = (size_t)(t0 + e / W) * a.out_stride + e % W;
      a.his[o] = (int)hi;
      a.los[o] = (int)lo;
    }
    __syncthreads();

    if (verify) {
      // each save's history: walk back over the earlier saves of its key
      // (one a row at most) while they carry its frame
      for (int e = tid; e < events; e += bd) {
        const int t = e / W;
        if (ctl[t * C + 4 + e % W] >= W) continue;
        const int vf = key_frame(e), key = floor_mod(vf, W);
        int first = e, t2 = t;
        bool carried = false;
        for (;;) {
          int prev = -1;
          while (--t2 >= 0) {
            const int i2 = floor_mod(key - ctl[t2 * C + 3], W);
            if (ctl[t2 * C + 4 + i2] < W) {
              prev = t2 * W + i2;
              break;
            }
          }
          if (prev < 0) {
            carried = tag[key] == vf;
            break;
          }
          if (key_frame(prev) != vf) break;
          first = prev;
        }
        const uint32_t r_hi = carried ? (uint32_t)hhi[key] : ehi[first];
        const uint32_t r_lo = carried ? (uint32_t)hlo[key] : elo[first];
        rhi[e] = r_hi;
        rlo[e] = r_lo;
        if ((carried || first != e) && (r_hi != ehi[e] || r_lo != elo[e])) atomicMin(&misc[0], e);
      }
      __syncthreads();
    }

    // what the chunk leaves: each slot's and key's last write, the latch
    for (int s = tid; s < W; s += bd)
      if (last_slot[s] >= 0) rf[s] = frame_of(last_slot[s]);
    if (verify) {
      for (int h = tid; h < W; h += bd) {
        const int e = last_key[h];
        if (e < 0) continue;
        tag[h] = key_frame(e);
        hhi[h] = (int)rhi[e];
        hlo[h] = (int)rlo[e];
      }
      if (tid == 0 && misc[0] != INT_MAX && misc[1] == 0) {
        misc[1] = 1;
        misc[2] = key_frame(misc[0]);
      }
    }
    __syncthreads();
  }
  for (int s = tid; s < W; s += bd) a.r_frame[s] = rf[s];
  if (verify)
    for (int h = tid; h < W; h += bd) {
      a.h_tag[h] = tag[h];
      a.h_hi[h] = hhi[h];
      a.h_lo[h] = hlo[h];
    }
  if (tid == 0) {
    *a.state_frame = misc[3];
    if (verify) {
      a.flag[0] = misc[1];
      a.flag[1] = misc[2];
    }
  }
}

// Every block: fence its parts atomics and draw a ticket (one of gridDim.x
// a ticket word). The block that draws the last one sees all parts; it
// resets the ticket and runs the scalar pass, and returns true. `sm`: the
// dynamic shared memory, free again.
template <class Args>
__device__ __forceinline__ bool last_block_scalar_pass(const Args& a, int* sm, int nslots) {
  __shared__ bool is_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(a.done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!is_last) return false;
  __threadfence();
  if (threadIdx.x == 0) *a.done = 0;
  tick_scalar_pass(a, sm, nslots);
  return true;
}

// One block's entity tile (blockIdx.x) through the rows of `a`, the first
// `nslots` slots of each (advances clamped to them): loads, saves into the
// ring, steps, and each save's block sums added to the parts.
template <class M>
__device__ __forceinline__ void tick_tile(const TickArgs<typename M::Weights>& a, int nslots, int* smem) {
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
    const int adv = min(row[2], nslots);
    for (int i = 0; i < nslots; ++i) {
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
    for (int j = threadIdx.x; j < nslots; j += kBlock) {
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
}

template <class M>
__global__ void __launch_bounds__(kBlock) resim_tick_kernel(TickArgs<typename M::Weights> a) {
  extern __shared__ int smem_words[];
  tick_tile<M>(a, a.window, smem_words);
  last_block_scalar_pass(a, smem_words, a.window);
}

// The megabatch (MultiSessionDeviceCore): row r of the launch (blockIdx.y)
// ticks the world of slot idx[r] in place — its state, state frame, ring
// and ring-frame tags at that slot's stride in the stacked tensors — with
// the first `nslots` slots of the row, and has its own ticket and parts,
// so the last tile of row r runs row r's scalar pass. Rows must name
// distinct slots. `a` holds the stacked bases, t_rows the live rows; pad
// rows [t_rows, b_rows) are not launched, and their his/los read (0, 0).
template <class M>
__global__ void __launch_bounds__(kBlock) resim_tick_stacked_kernel(TickArgs<typename M::Weights> a, const int* idx,
                                                                     int nslots, int b_rows) {
  extern __shared__ int smem_words[];
  const int r = blockIdx.y, slot = idx[r], W = a.window;
  const size_t world = (size_t)M::kPlanes * a.n;
  TickArgs<typename M::Weights> ra = a;
  ra.state = a.state + (size_t)slot * world;
  ra.state_frame = a.state_frame + slot;
  ra.ring = a.ring + (size_t)slot * (W + 1) * world;
  ra.r_frame = a.r_frame + (size_t)slot * (W + 1);
  ra.rows = a.rows + (size_t)r * row_len(W, a.num_players, a.input_size);
  ra.his = a.his + (size_t)r * W;
  ra.los = a.los + (size_t)r * W;
  ra.parts_hi = a.parts_hi + (size_t)r * W;
  ra.parts_lo = a.parts_lo + (size_t)r * W;
  ra.done = a.done + r;
  ra.t_rows = 1;
  tick_tile<M>(ra, nslots, smem_words);
  if (!last_block_scalar_pass(ra, smem_words, nslots)) return;
  for (int p = a.t_rows + r; p < b_rows; p += a.t_rows)
    for (int j = threadIdx.x; j < W; j += blockDim.x) {
      a.his[(size_t)p * W + j] = 0;
      a.los[(size_t)p * W + j] = 0;
    }
}

// The resident drive (the device mailbox's fill cycle): block (tile, lane l)
// ticks the world of slot lanes[l] with that lane's rows 0 .. marks[l]-1 of
// the mailbox (rows [S, depth, L]), the first `nslots` slots of each, and
// has the lane's own ticket and parts [depth, W]; the last tile of the lane
// runs its scalar pass, writing his/los [depth, S, W] (out_stride S*W), then
// writes (0, 0) into the lane's rows past its watermark and into every row
// of the dead lanes lanes[n_live + l], lanes[n_live + l + n_live], ...
// (lanes: the n_live live slots, then the other S - n_live).
template <class M>
__global__ void __launch_bounds__(kBlock) resim_tick_resident_kernel(TickArgs<typename M::Weights> a,
                                                                      const int* lanes, const int* marks,
                                                                      int n_live, int stack_slots, int depth,
                                                                      int nslots) {
  extern __shared__ int smem_words[];
  const int l = blockIdx.y, slot = lanes[l], W = a.window;
  const size_t world = (size_t)M::kPlanes * a.n;
  TickArgs<typename M::Weights> ra = a;
  ra.state = a.state + (size_t)slot * world;
  ra.state_frame = a.state_frame + slot;
  ra.ring = a.ring + (size_t)slot * (W + 1) * world;
  ra.r_frame = a.r_frame + (size_t)slot * (W + 1);
  ra.rows = a.rows + (size_t)slot * depth * row_len(W, a.num_players, a.input_size);
  ra.his = a.his + (size_t)slot * W;
  ra.los = a.los + (size_t)slot * W;
  ra.parts_hi = a.parts_hi + (size_t)l * depth * W;
  ra.parts_lo = a.parts_lo + (size_t)l * depth * W;
  ra.done = a.done + l;
  ra.t_rows = marks[l];
  tick_tile<M>(ra, nslots, smem_words);
  if (!last_block_scalar_pass(ra, smem_words, nslots)) return;
  const size_t os = a.out_stride;
  for (int k = ra.t_rows * W + threadIdx.x; k < depth * W; k += blockDim.x) {
    ra.his[(size_t)(k / W) * os + k % W] = 0;
    ra.los[(size_t)(k / W) * os + k % W] = 0;
  }
  for (int d = n_live + l; d < stack_slots; d += n_live) {
    const size_t base = (size_t)lanes[d] * W;
    for (int k = threadIdx.x; k < depth * W; k += blockDim.x) {
      a.his[base + (size_t)(k / W) * os + k % W] = 0;
      a.los[base + (size_t)(k / W) * os + k % W] = 0;
    }
  }
}

// ---------------------------------------------------------------------------
// Arena. Every advance first reduces the WHOLE current world (per team: the
// living count, Σ px>>6, Σ py>>6) and finalizes it into centroids, as the
// reference's single-tile kernel does inline (pallas_resim.py:74-121; no
// per-frame cache: P2P resim states are fresh). A 16-row dispatch of
// SyncTest rows at check distance 8 therefore reduces 144 times.
//
// The body runs on K2's inline machinery (arena_reduce.cuh, namespace
// inline_arena): a persistent cooperative grid of one block an SM, each
// block owning a contiguous run of entities, a thread an entity in whole
// warps up to 1024. The layout comes from the host (device/tick_core.py
// `arena_tick_plan`): the run's states stay in the block's shared memory
// for the whole launch while the world fits the card's shared memory, else
// in the carry's `state` buffer (the global layout). An advance is: pass A
// over the block's entities (bring each state up to date — apply the
// pending step with the teams finalized after the last barrier, or take
// the row's load — keep it, add its team terms to the warp's row, O(1) an
// entity); the block's sums into a rotating raw row and the barrier's
// ARRIVAL (grid_arrive); the slot's save, if any, from the kept states,
// while the other blocks arrive; the barrier's WAIT and the finalize; then
// the save's event sums, one atomic per block. The step itself waits for
// the next pass, so a save after the last advance of a row, and the next
// row's load, take no extra pass. A thread reads and writes only the ring
// columns of its own entities, so a row may load a slot an earlier row of
// the launch saved. Every save still reaches the ring: the ring is the
// carry's output. The state goes back to `state` once, at the end.
//
// A DISCONNECTED owner steps with the game's whole disconnect row (input
// byte and throttle byte), resolved once per row into shared memory.
//
// What bounds it on an H100: per entity an advance is 64 int32 ops of step
// and 6 of reduction, a save 18; the bytes a dispatch must move are the
// ring slots it loads before saving them, the slots it saves and the state
// (24 B per entity column). At the request path's worlds neither bound is
// near: the chain of barriers, one an advance, sets the time.

struct ArenaTickArgs {
  int* state;          // [6, n] live world
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
  uint32_t* parts_hi;  // [T, W] zero on entry, left zero
  uint32_t* parts_lo;  // [T, W]
  uint32_t* done;      // last-block ticket, zero on entry, left zero
  int n, num_players, input_size, window, t_rows;
  int out_stride;                 // W: his/los rows are contiguous
  int disc_input, disc_throttle;  // the disconnect row: input byte, throttle
  arena::Weights cw;
};

// The block's dynamic shared memory, in words, in this order (device/
// tick_core.py `arena_tick_smem_bytes` mirrors it): finalized teams [3P],
// each warp's save sums [2][kMaxWarps][2], the team rows [nrows][3P], the
// staged rows [2][L + 2WP] (control words, then each slot's resolved
// (input, throttle) pairs), the pending step's pairs [P][2], then the
// block's states [6][per_block] when they stay on chip. The scalar pass
// reuses it from word 0 at the end.

namespace tick_arena {

using inline_arena::GridReduce;
using inline_arena::kMaxWarps;
using inline_arena::Shared;

enum Pending { kNone, kStep, kLoad, kInit };  // what a kept state still needs

template <bool kOnChip>
__device__ void tick_rows(const ArenaTickArgs& a, const Shared& sh, const GridReduce& rd, int per_block,
                          int* stage, int* pend) {
  const int W = a.window, P = a.num_players, I = a.input_size, L = row_len(W, P, I);
  const int off_save = 4, off_status = 4 + W, off_input = off_status + W * P, stride = L + 2 * W * P;
  const size_t n = (size_t)a.n, slot_stride = (size_t)arena::kPlanes * n;
  const int bd = blockDim.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lo = blockIdx.x * per_block;
  const int count = max(0, min(per_block, a.n - lo));
  const int rounds = (count + bd - 1) / bd;
  const int team0 = (lo + (int)threadIdx.x) % P, team_stride = bd % P;
  const bool fixed = team_stride == 0;  // every round of this thread is the same team: sum in registers
  const int warp0 = threadIdx.x & ~31;
  int k = 0, saves = 0;  // barriers and saves so far in this launch
  int pending = kOnChip ? kInit : kNone;
  const int* src = nullptr;  // the ring slot of a pending load

  auto next_team = [&](int team) { return team + team_stride >= P ? team + team_stride - P : team + team_stride; };
  auto kept = [&](int i, int e) {
    return kOnChip ? arena::load(sh.st, (size_t)per_block, i) : arena::load(a.state, n, e);
  };
  auto keep = [&](int i, int e, const arena::State& s) {
    if (kOnChip) arena::store(sh.st, (size_t)per_block, i, s);
    else arena::store(a.state, n, e, s);
  };
  // entity e (the block's i-th) with what is pending applied
  auto current = [&](int i, int e, int team) {
    if (pending == kLoad) return arena::load(src, n, e);
    if (pending == kInit) return arena::load(a.state, n, e);
    arena::State s = kept(i, e);
    if (pending == kStep)
      arena::step(s, pend[2 * team], pend[2 * team + 1], sh.fin[team], sh.fin[team + 1 == P ? 0 : team + 1]);
    return s;
  };
  // a warp's save sums into ev
  auto put_sums = [&](uint32_t hi, uint32_t lo_sum, uint32_t* ev) {
    hi = warp_sum(hi);
    lo_sum = warp_sum(lo_sum);
    if (lane == 0) {
      ev[2 * warp] = hi;
      ev[2 * warp + 1] = lo_sum;
    }
  };
  // Pass A: bring every state up to date and keep it; `terms`: add its team
  // terms to the warp rows; `dst`: save it there too (checksum terms to ev)
  auto pass = [&](bool terms, int* dst, uint32_t* ev) {
    uint32_t one = 0, sx = 0, sy = 0, hi = 0, lo_sum = 0;
    int team = team0;
    for (int r = 0; r < rounds; ++r, team = next_team(team)) {
      const int i = r * bd + threadIdx.x;
      uint32_t o = 0, x = 0, y = 0;
      if (i < count) {
        const int e = lo + i;
        const arena::State s = current(i, e, team);
        keep(i, e, s);
        if (terms) arena::team_terms(s, o, x, y);
        if (dst != nullptr) {
          uint32_t ew[arena::kPlanes], h, l;
          arena::entity_weights(a.cw, (uint32_t)e, ew);
          arena::store(dst, n, e, s);
          arena::checksum_terms(s, ew, h, l);
          hi += h;
          lo_sum += l;
        }
      }
      if (!terms) continue;
      if (fixed) {
        one += o;
        sx += x;
        sy += y;
      } else if (r * bd + warp0 < count) {  // warp-uniform: the warp holds an entity this round
        arena::warp_team_add(o, x, y, team, P, false, sh.rows, sh.own_row);
      }
    }
    if (terms && fixed && warp0 < count) arena::warp_team_add(one, sx, sy, team0, P, true, sh.rows, sh.own_row);
    if (dst != nullptr) put_sums(hi, lo_sum, ev);
    pending = kNone;
  };
  // Pass B: the kept states (nothing pending) saved to dst
  auto save_pass = [&](int* dst, uint32_t* ev) {
    uint32_t hi = 0, lo_sum = 0;
    for (int r = 0; r < rounds; ++r) {
      const int i = r * bd + threadIdx.x;
      if (i < count) {
        const int e = lo + i;
        uint32_t ew[arena::kPlanes], h, l;
        arena::entity_weights(a.cw, (uint32_t)e, ew);
        const arena::State s = kept(i, e);
        arena::store(dst, n, e, s);
        arena::checksum_terms(s, ew, h, l);
        hi += h;
        lo_sum += l;
      }
    }
    put_sums(hi, lo_sum, ev);
  };
  // event (t, i)'s block sums (after a block barrier): one atomic a word,
  // by the last warp's last two lanes
  auto event_add = [&](int t, int i, const uint32_t* ev) {
    const int word = (int)threadIdx.x - (bd - 2);
    if (word < 0) return;
    uint32_t v = 0;
    for (int w = 0; w < sh.warps; ++w) v += ev[2 * w + word];
    if (v) atomicAdd((word == 0 ? a.parts_hi : a.parts_lo) + (size_t)t * W + i, v);
  };

  for (int t = 0; t < a.t_rows; ++t) {
    // row t into its buffer (the other one holds row t-1, which no thread
    // reads once past this row's barrier), its slots' inputs resolved with
    // the disconnect substitution
    int* row = stage + (t & 1) * stride;
    int* res = row + L;
    const int* g = a.rows + (size_t)t * L;
    for (int j = threadIdx.x; j < L; j += bd) row[j] = g[j];
    for (int j = threadIdx.x; j < W * P; j += bd) {
      const bool off = g[off_status + j] == kDisconnected;
      const int* in = g + off_input + j * I;
      res[2 * j] = off ? a.disc_input : in[0];
      res[2 * j + 1] = off ? a.disc_throttle : arena::throttle_of(in, I);
    }
    __syncthreads();

    if (row[0] != 0) {
      pending = kLoad;
      src = a.ring + (size_t)row[1] * slot_stride;
    }
    const int adv = row[2];
    for (int i = 0; i < W; ++i) {
      const int slot = row[off_save + i];
      int* dst = slot < W ? a.ring + (size_t)slot * slot_stride : nullptr;
      // save sums alternate between two buffers: a buffer is written again
      // only after a barrier that follows every read of it
      uint32_t* ev = sh.ev + (saves & 1) * 2 * kMaxWarps;
      if (i < adv) {  // save-then-advance: slot i snapshots the pre-advance state
        pass(true, nullptr, nullptr);
        rd.arrive(sh, P, k);
        if (dst != nullptr) save_pass(dst, ev);
        rd.wait(sh, P, k);
        for (int j = threadIdx.x; j < P; j += bd) {
          pend[2 * j] = res[2 * (i * P + j)];
          pend[2 * j + 1] = res[2 * (i * P + j) + 1];
        }
        __syncthreads();  // fin, pend and ev are in
        pending = kStep;
        ++k;
      } else if (dst != nullptr) {
        if (pending == kNone) save_pass(dst, ev);
        else pass(false, dst, ev);
        __syncthreads();
      }
      if (dst != nullptr) {
        event_add(t, i, ev);
        ++saves;
      }
    }
  }
  if (kOnChip || pending != kNone) {  // the state goes back once
    int team = team0;
    for (int r = 0; r < rounds; ++r, team = next_team(team)) {
      const int i = r * bd + threadIdx.x;
      if (i < count) arena::store(a.state, n, lo + i, current(i, lo + i, team));
    }
  }
}

}  // namespace tick_arena

// scratch: the barrier counter (u64) and three raw rows [3, 3P], then the
// ticket and parts_hi, parts_lo [T, W]: zero before the core's first
// launch, and every launch leaves them so
template <bool kOnChip>
__global__ void __launch_bounds__(inline_arena::kThreads, 1) resim_tick_arena_kernel(
    ArenaTickArgs a, uint32_t* scratch, int per_block) {
  using namespace inline_arena;
  extern __shared__ int smem_words[];
  uint32_t* smem = reinterpret_cast<uint32_t*>(smem_words);
  const int W = a.window, P = a.num_players;
  const bool own_row = P <= arena::kRowTeams;
  uint32_t* ev = smem + 3 * P;
  uint32_t* rows = ev + 4 * kMaxWarps;
  int* stage = reinterpret_cast<int*>(rows + (own_row ? kMaxWarps : 1) * 3 * P);
  int* pend = stage + 2 * (row_len(W, P, a.input_size) + 2 * W * P);
  int* st = pend + 2 * P;
  const int words = (int)(reinterpret_cast<uint32_t*>(st) - smem);  // all but the states
  const int count = max(0, min(per_block, a.n - (int)blockIdx.x * per_block));
  const Shared sh{reinterpret_cast<arena::Team*>(smem), ev, rows, st, min(kMaxWarps, (count + 31) / 32), own_row};
  for (int j = threadIdx.x; j < words; j += blockDim.x) smem[j] = 0;
  __syncthreads();
  auto* arrived = reinterpret_cast<unsigned long long*>(scratch);
  // no block of this launch can have passed its first barrier yet
  const GridReduce rd{scratch + 2, arrived, ld_acquire(arrived) / gridDim.x};
  tick_arena::tick_rows<kOnChip>(a, sh, rd, per_block, stage, pend);
  last_block_scalar_pass(a, smem_words, a.window);
}

}  // namespace

namespace {

// The per-entity tick's dynamic shared memory (the staged rows and the
// block sums, or the scalar pass, whichever is larger), with the kernel's
// attribute raised past 48 KB.
inline cudaError_t tick_smem(const void* kernel, int window, int num_players, int input_size, size_t* out) {
  const size_t body = 2 * (size_t)row_len(window, num_players, input_size) + 2 * (size_t)window * kWarps;
  const size_t words = body > scalar_smem_words(window) ? body : scalar_smem_words(window);
  *out = words * sizeof(int);
  if (*out > 48 * 1024) return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*out);
  return cudaSuccess;
}

// The tick of a model with no reduction: the T rows in order on one world,
// or, with `idx` (device memory, T distinct slots), row r on the world of
// slot idx[r] of the stacked tensors, the first `nslots` slots of each
// (the megabatch). Returns the CUDA error of the shared-memory attribute or
// the launch (0 on success).
template <class M>
int launch_tick(int* state, int* state_frame, int* ring, int* r_frame, int* h_tag, int* h_hi, int* h_lo,
                int* flag, const int* idx, const int* rows, int* his, int* los, uint32_t* scratch, int n,
                int num_players, int input_size, int window, int t_rows, int nslots, int b_rows, int substeps,
                const int* disconnect_row, const int* cs, void* stream) {
  const size_t events = (size_t)t_rows * window, tickets = idx != nullptr ? t_rows : 1;
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
  a.done = scratch;
  a.parts_hi = scratch + tickets;
  a.parts_lo = scratch + tickets + events;
  a.n = n;
  a.num_players = num_players;
  a.input_size = input_size;
  a.window = window;
  a.t_rows = t_rows;
  a.substeps = substeps;
  a.disconnect_input = disconnect_row[0];  // the step reads byte 0
  a.out_stride = window;
  a.cw = weights_from<typename M::Weights, M::kPlanes>(cs);
  const void* kernel = idx != nullptr ? (const void*)resim_tick_stacked_kernel<M> : (const void*)resim_tick_kernel<M>;
  size_t smem;
  const cudaError_t err = tick_smem(kernel, window, num_players, input_size, &smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + kBlock - 1) / kBlock;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (idx != nullptr)
    resim_tick_stacked_kernel<M><<<dim3(blocks, t_rows), kBlock, smem, st>>>(a, idx, nslots, b_rows);
  else
    resim_tick_kernel<M><<<blocks, kBlock, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// The resident drive of a model with no reduction: the mailbox's fill cycle
// (rows [S, depth, L]) on the stacked worlds in one launch, a grid of
// (entity tiles x n_live lanes). lanes_marks (device memory): lanes [S] (the
// n_live live slots first, then the rest), marks [n_live]. scratch: a
// ticket per lane, then parts_hi [S*depth*W], parts_lo [S*depth*W]; zero
// before the first launch, and every launch leaves it so.
template <class M>
int launch_resident(int* states, int* state_frames, int* rings, int* r_frames, const int* mbox_rows,
                    const int* lanes_marks, int* his, int* los, uint32_t* scratch, int n, int num_players,
                    int input_size, int window, int stack_slots, int depth, int n_live, int nslots, int substeps,
                    const int* disconnect_row, const int* cs, void* stream) {
  if (nslots < 1 || nslots > window || depth < 1 || n_live < 1 || n_live > stack_slots || n_live > 65535)
    return (int)cudaErrorInvalidValue;  // a lane a grid row: gridDim.y is at most 65535
  const size_t events = (size_t)stack_slots * depth * window;
  TickArgs<typename M::Weights> a;
  a.state = states;
  a.state_frame = state_frames;
  a.ring = rings;
  a.r_frame = r_frames;
  a.h_tag = a.h_hi = a.h_lo = a.flag = nullptr;
  a.rows = mbox_rows;
  a.his = his;
  a.los = los;
  a.done = scratch;
  a.parts_hi = scratch + stack_slots;
  a.parts_lo = scratch + stack_slots + events;
  a.n = n;
  a.num_players = num_players;
  a.input_size = input_size;
  a.window = window;
  a.t_rows = 0;  // each lane's own: marks[lane]
  a.substeps = substeps;
  a.disconnect_input = disconnect_row[0];
  a.out_stride = stack_slots * window;
  a.cw = weights_from<typename M::Weights, M::kPlanes>(cs);
  const void* kernel = (const void*)resim_tick_resident_kernel<M>;
  size_t smem;
  const cudaError_t err = tick_smem(kernel, window, num_players, input_size, &smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + kBlock - 1) / kBlock;
  resim_tick_resident_kernel<M><<<dim3(blocks, n_live), kBlock, smem, static_cast<cudaStream_t>(stream)>>>(
      a, lanes_marks, lanes_marks + stack_slots, n_live, stack_slots, depth, nslots);
  return (int)cudaGetLastError();
}

const void* arena_kernel(int on_chip) {
  return on_chip ? (const void*)resim_tick_arena_kernel<true> : (const void*)resim_tick_arena_kernel<false>;
}

}  // namespace

// h_tag/h_hi/h_lo/flag are null when device verification is off.
// disconnect_row: the game's disconnect input, I ints in host memory.
// scratch: the ticket, then parts_hi [T*W], parts_lo [T*W]; zero before
// the core's first launch, and every launch leaves it so.
// ex_game. cs: 11 int32 — checksum w[5], base[5], frame weight.
extern "C" int resim_tick_launch(int* state, int* state_frame, int* ring, int* r_frame, int* h_tag,
                                 int* h_hi, int* h_lo, int* flag, const int* rows, int* his,
                                 int* los, uint32_t* scratch, int n, int num_players,
                                 int input_size, int window, int t_rows, int substeps,
                                 const int* disconnect_row, const int* cs, void* stream) {
  return launch_tick<exg::Model>(state, state_frame, ring, r_frame, h_tag, h_hi, h_lo, flag, nullptr, rows, his,
                                 los, scratch, n, num_players, input_size, window, t_rows, window, t_rows,
                                 substeps, disconnect_row, cs, stream);
}

// swarm. cs: 15 int32 — checksum w[7], base[7], frame weight.
extern "C" int resim_tick_swarm_launch(int* state, int* state_frame, int* ring, int* r_frame, int* h_tag,
                                       int* h_hi, int* h_lo, int* flag, const int* rows, int* his,
                                       int* los, uint32_t* scratch, int n, int num_players,
                                       int input_size, int window, int t_rows,
                                       const int* disconnect_row, const int* cs, void* stream) {
  return launch_tick<swarm::Model>(state, state_frame, ring, r_frame, h_tag, h_hi, h_lo, flag, nullptr, rows,
                                   his, los, scratch, n, num_players, input_size, window, t_rows, window,
                                   t_rows, 1, disconnect_row, cs, stream);
}

// The megabatch of MultiSessionDeviceCore (K3's stacked entry): one launch
// ticks n_rows session worlds of the stacked tensors in place — states
// [S, K, n], state_frames [S], rings [S, W+1, K, n], r_frames [S, W+1] —
// row r (rows [n_rows, L]) on slot idx[r] (idx: n_rows distinct slots, in
// device memory), through the first `nslots` window slots of each row (the
// depth bucket; the fast zero-rollback rows at 2). No device verification.
// his/los [b_rows, W] out, the pad rows past n_rows (0, 0). scratch: a
// ticket per row, then parts_hi [n_rows*W], parts_lo [n_rows*W]; zero
// before the core's first launch, and every launch leaves it so.
// ex_game. cs: 11 int32 — checksum w[5], base[5], frame weight.
extern "C" int resim_tick_stacked_launch(int* states, int* state_frames, int* rings, int* r_frames,
                                         const int* idx, const int* rows, int* his, int* los,
                                         uint32_t* scratch, int n, int num_players, int input_size,
                                         int window, int n_rows, int nslots, int b_rows, int substeps,
                                         const int* disconnect_row, const int* cs, void* stream) {
  if (nslots < 1 || nslots > window || n_rows < 1 || n_rows > 65535 || b_rows < n_rows)
    return (int)cudaErrorInvalidValue;  // a row a grid row: gridDim.y is at most 65535
  return launch_tick<exg::Model>(states, state_frames, rings, r_frames, nullptr, nullptr, nullptr, nullptr, idx,
                                 rows, his, los, scratch, n, num_players, input_size, window, n_rows, nslots,
                                 b_rows, substeps, disconnect_row, cs, stream);
}

// swarm's megabatch. cs: 15 int32 — checksum w[7], base[7], frame weight.
extern "C" int resim_tick_swarm_stacked_launch(int* states, int* state_frames, int* rings, int* r_frames,
                                               const int* idx, const int* rows, int* his, int* los,
                                               uint32_t* scratch, int n, int num_players, int input_size,
                                               int window, int n_rows, int nslots, int b_rows,
                                               const int* disconnect_row, const int* cs, void* stream) {
  if (nslots < 1 || nslots > window || n_rows < 1 || n_rows > 65535 || b_rows < n_rows)
    return (int)cudaErrorInvalidValue;
  return launch_tick<swarm::Model>(states, state_frames, rings, r_frames, nullptr, nullptr, nullptr, nullptr, idx,
                                   rows, his, los, scratch, n, num_players, input_size, window, n_rows, nslots,
                                   b_rows, 1, disconnect_row, cs, stream);
}

// The resident drive of MultiSessionDeviceCore (K3's resident entry): one
// launch consumes the device mailbox's fill cycle — lane lanes[l] (l <
// n_live) runs its rows 0 .. marks[l]-1 of mbox_rows [S, depth, L] in order
// on its slot of the stacked tensors (states [S, K, n], state_frames [S],
// rings [S, W+1, K, n], r_frames [S, W+1]) in place, through the first
// `nslots` window slots of each row. No device verification. his/los
// [depth, S, W] out, (0, 0) for every row not run. lanes_marks: lanes [S]
// then marks [n_live], in device memory. scratch: S tickets, then parts_hi
// and parts_lo [S*depth*W] each; zero before the first launch, and every
// launch leaves it so. ex_game. cs: 11 int32.
extern "C" int resim_tick_resident_launch(int* states, int* state_frames, int* rings, int* r_frames,
                                          const int* mbox_rows, const int* lanes_marks, int* his, int* los,
                                          uint32_t* scratch, int n, int num_players, int input_size, int window,
                                          int stack_slots, int depth, int n_live, int nslots, int substeps,
                                          const int* disconnect_row, const int* cs, void* stream) {
  return launch_resident<exg::Model>(states, state_frames, rings, r_frames, mbox_rows, lanes_marks, his, los,
                                     scratch, n, num_players, input_size, window, stack_slots, depth, n_live,
                                     nslots, substeps, disconnect_row, cs, stream);
}

// swarm's resident drive. cs: 15 int32.
extern "C" int resim_tick_swarm_resident_launch(int* states, int* state_frames, int* rings, int* r_frames,
                                                const int* mbox_rows, const int* lanes_marks, int* his, int* los,
                                                uint32_t* scratch, int n, int num_players, int input_size,
                                                int window, int stack_slots, int depth, int n_live, int nslots,
                                                const int* disconnect_row, const int* cs, void* stream) {
  return launch_resident<swarm::Model>(states, state_frames, rings, r_frames, mbox_rows, lanes_marks, his, los,
                                       scratch, n, num_players, input_size, window, stack_slots, depth, n_live,
                                       nslots, 1, disconnect_row, cs, stream);
}

// The card's limits the arena tick's plan is made from: out[0] the SM
// count, out[1] the shared memory a block may opt in to (bytes).
extern "C" int resim_tick_arena_limits(int* out) { return (int)card_limits(out); }

// Once per plan (the core's first arena launch): the shared-memory
// attribute, then the occupancy query: kNotCoResident when the grid of
// `blocks` blocks of `threads` threads cannot be resident at once; else 0
// or a CUDA error. on_chip: the states in shared memory (else in `state`).
extern "C" int resim_tick_arena_prepare(int on_chip, int blocks, int threads, int smem_bytes) {
  if (blocks < 1 || threads < 32 || threads > inline_arena::kThreads || threads % 32) return (int)cudaErrorInvalidValue;
  return co_resident(arena_kernel(on_chip), blocks, threads, smem_bytes);
}

// The arena tick, T rows in one launch on the plan `prepare` accepted: a
// cooperative grid of `blocks` blocks of `threads` threads, `per_block`
// entities and `smem_bytes` of dynamic shared memory each. scratch: the
// barrier counter (u64) and three raw rows [3, 3P], the ticket, parts_hi
// [T*W], parts_lo [T*W]; zero before the core's first launch, and every
// launch leaves it so. Returns the CUDA error of the launch (0 on success).
// disconnect_row: I ints in host memory. cs: 13 int32 — checksum w[6],
// base[6], frame weight.
extern "C" int resim_tick_arena_launch(int* state, int* state_frame, int* ring, int* r_frame,
                                       int* h_tag, int* h_hi, int* h_lo, int* flag,
                                       const int* rows, int* his, int* los, uint32_t* scratch,
                                       int n, int num_players, int input_size, int window,
                                       int t_rows, int on_chip, int blocks, int threads, int per_block,
                                       int smem_bytes, const int* disconnect_row, const int* cs,
                                       void* stream) {
  const size_t events = (size_t)t_rows * window, fixed = 2 + 9 * (size_t)num_players;
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
  a.done = scratch + fixed;
  a.parts_hi = scratch + fixed + 1;
  a.parts_lo = scratch + fixed + 1 + events;
  a.n = n;
  a.num_players = num_players;
  a.input_size = input_size;
  a.window = window;
  a.t_rows = t_rows;
  a.out_stride = window;
  a.disc_input = disconnect_row[0];
  a.disc_throttle = input_size >= 2 ? (disconnect_row[1] & 0x0F) : arena::kDefaultThrottle;
  a.cw = weights_from<arena::Weights, arena::kPlanes>(cs);
  void* args[] = {&a, &scratch, &per_block};
  const cudaError_t err = cudaLaunchCooperativeKernel(arena_kernel(on_chip), dim3(blocks), dim3(threads), args,
                                                      smem_bytes, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
