// The block shape the port's SyncTest, tick and beam kernels launch with,
// the warp sum their block reductions start from, and the checksum weights
// their launchers unpack.
#pragma once

#include <stdint.h>

constexpr int kBlock = 128;  // entities per block
constexpr int kWarps = kBlock / 32;

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, off);
  return v;
}

// checksum weights from the launchers' int32 array: w[K], base[K], frame weight
template <class Weights, int K>
inline Weights weights_from(const int* cs) {
  Weights cw;
  for (int k = 0; k < K; ++k) {
    cw.w[k] = (uint32_t)cs[k];
    cw.base[k] = (uint32_t)cs[K + k];
  }
  cw.frame_weight = (uint32_t)cs[2 * K];
  return cw;
}
