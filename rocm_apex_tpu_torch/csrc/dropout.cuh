// The port's one dropout keep-mask function, shared by every kernel that
// drops (the LayerNorm residual forward and backward, the flash-attention
// forward and both backward passes).
//
// The TPU kernels seed the hardware PRNG per (batch, q-block, k-block)
// (rocm_apex_tpu/ops/flash_attention.py:85 `_keep_mask`), so their bits
// depend on the tiling and cannot be reproduced here. The port instead
// hashes each element's own coordinates:
//
//   keep(seed, stream, row, col)  iff  hash32(seed, stream, row, col) >= thr
//   thr = min(round(rate * 2^32), 2^32 - 1)
//
// hash32 folds (stream, row, col) into the seed with murmur3's block
// mix and finishes with its fmix32 avalanche. The coordinates are per
// element, not per tile, so a forward and a backward with different
// tilings still draw the same bits. `stream` is batch*heads + head for
// attention and 0 for LayerNorm; row/col index the (rows, cols) matrix
// the kernel drops. ops/_dropout.py computes the same function in
// PyTorch for the plain versions, so a kernel with dropout on matches
// its plain version exactly.
#pragma once

#include <stdint.h>

namespace apex_port {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ uint32_t hash_mix(uint32_t h, uint32_t k) {
  k *= 0xCC9E2D51u;
  k = rotl32(k, 15);
  k *= 0x1B873593u;
  h ^= k;
  h = rotl32(h, 13);
  return h * 5u + 0xE6546B64u;
}

__device__ __forceinline__ uint32_t hash_fmix(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// The part of the hash that depends on the row only: computed once per
// row, then `keep_bit` costs one mix and one fmix per element.
__device__ __forceinline__ uint32_t dropout_row_key(uint32_t seed,
                                                    uint32_t stream,
                                                    uint32_t row) {
  return hash_mix(hash_mix(seed, stream), row);
}

__device__ __forceinline__ bool keep_bit(uint32_t row_key, uint32_t col,
                                         uint32_t thr) {
  return hash_fmix(hash_mix(row_key, col)) >= thr;
}

}  // namespace apex_port
