// K3 — ResimCore's packed control-word tick for ex_game on Hopper.
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
// Design: one thread owns one entity for all T rows, as in the SyncTest
// kernels (synctest_body.cuh): its state stays in registers and it reads
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
// 16.7 Tops/s. So large worlds are bound by the ring bytes. At 4096
// entities only 32 blocks exist, and each thread's serial chain of steps
// plus the serial scalar pass set the time, not any peak rate.
//
// Left for later: keeping a block's ring columns in shared memory for the
// whole launch (each row's loads and saves then never leave the SM);
// splitting small worlds over more blocks; a parallel scalar pass.
#include <cuda_runtime.h>

#include "ex_game_step.cuh"

namespace {

constexpr int kBlock = 128;  // entities per block
constexpr int kWarps = kBlock / 32;
constexpr int kDisconnected = 2;  // InputStatus.DISCONNECTED

struct TickArgs {
  int* state;          // [5, n] live world
  int* state_frame;    // [1] the live world's own frame
  int* ring;           // [W+1, 5, n]
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
  exg::Weights cw;
};

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, off);
  return v;
}

__host__ __device__ inline int row_len(int w, int p, int i) { return 4 + w + w * p + w * p * i; }

// The scalar lanes (pallas_resim.py:356-424), in one thread, over the
// launch's T x W save events in row order: the state's own frame (a load
// takes the loaded slot's frame) drives each save's frame term,
// frame_i = state_frame + min(i, advance_count); the history keys on
// start_frame + i; a skipped save outputs (0, 0) and touches nothing.
__device__ void tick_scalar_pass(const TickArgs& a) {
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

__global__ void __launch_bounds__(kBlock) resim_tick_kernel(TickArgs a) {
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
  const size_t n = (size_t)a.n, slot_stride = (size_t)exg::kPlanes * n;

  uint32_t ew[exg::kPlanes];
  exg::entity_weights(a.cw, (uint32_t)e, ew);
  exg::State s = active ? exg::load(a.state, n, e) : exg::State{0, 0, 0, 0, 0};

  for (int t = 0; t < a.t_rows; ++t) {
    // row t into its buffer: the other buffer may still be read by the
    // previous row's reduction in slower threads
    int* row = staged + (t & 1) * L;
    for (int k = threadIdx.x; k < L; k += kBlock) row[k] = a.rows[(size_t)t * L + k];
    __syncthreads();

    if (row[0] != 0 && active) s = exg::load(a.ring + (size_t)row[1] * slot_stride, n, e);
    const int adv = row[2];
    for (int i = 0; i < W; ++i) {
      const int slot = row[off_save + i];
      if (slot < W) {  // save-then-advance: slot i snapshots the pre-advance state
        uint32_t hi = 0, lo = 0;
        if (active) {
          exg::store(a.ring + (size_t)slot * slot_stride, n, e, s);
          exg::checksum_terms(s, ew, hi, lo);
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
        exg::step(s, inp, a.substeps);
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
  if (active) exg::store(a.state, n, e, s);

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

}  // namespace

// Returns the CUDA error of the scratch reset, the shared-memory attribute or
// the launch (0 on success). h_tag/h_hi/h_lo/flag are null when device
// verification is off. cs: 11 int32 — checksum w[5], base[5], frame weight.
extern "C" int resim_tick_launch(int* state, int* state_frame, int* ring, int* r_frame, int* h_tag,
                                 int* h_hi, int* h_lo, int* flag, const int* rows, int* his,
                                 int* los, uint32_t* scratch, int n, int num_players,
                                 int input_size, int window, int t_rows, int substeps,
                                 int disconnect_input, const int* cs, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t events = (size_t)t_rows * window;
  // scratch: parts_hi [T*W], parts_lo [T*W], done counter [1]
  cudaError_t err = cudaMemsetAsync(scratch, 0, (2 * events + 1) * sizeof(uint32_t), st);
  if (err != cudaSuccess) return (int)err;
  TickArgs a;
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
  a.disconnect_input = disconnect_input;
  for (int k = 0; k < exg::kPlanes; ++k) {
    a.cw.w[k] = (uint32_t)cs[k];
    a.cw.base[k] = (uint32_t)cs[exg::kPlanes + k];
  }
  a.cw.frame_weight = (uint32_t)cs[2 * exg::kPlanes];
  const size_t smem =
      (2 * (size_t)row_len(window, num_players, input_size) + 2 * (size_t)window * kWarps) *
      sizeof(int);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(resim_tick_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (n + kBlock - 1) / kBlock;
  resim_tick_kernel<<<blocks, kBlock, smem, st>>>(a);
  return (int)cudaGetLastError();
}
