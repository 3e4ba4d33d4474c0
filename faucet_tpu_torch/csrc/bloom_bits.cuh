// Blocked-Bloom bit addressing shared by the probe and cascade kernels.
//
// Layout (must match faucet_tpu_torch/core/bloom.py and the reference
// faucet_tpu/core/bloom.py): a filter is an array of uint32 words cut into
// 512-bit blocks of 16 words (64 bytes). Probe bit j of a key is
//   (h1r + (j + 1) * h2) & 511
// inside the key's block. Keys arrive as the port's int64 words holding
// uint32 values (faucet_tpu_torch/core/u32x2.py); the filter is read and
// written as uint32.
#pragma once

#include <cstdint>

#define FT_SENTINEL 0xFFFFFFFFu
#define FT_BLOCK_WORDS 16

__device__ __forceinline__ uint32_t ft_bit(uint32_t h1r, uint32_t h2,
                                           int j) {
  return (h1r + (uint32_t)(j + 1) * h2) & 511u;
}

// All n_hash bits of a key set in its block? Stops at the first clear bit
// (about half of all negatives stop at bit 0).
__device__ __forceinline__ bool ft_block_has(const uint32_t* words,
                                             uint32_t block, uint32_t h1r,
                                             uint32_t h2, int n_hash) {
  const uint32_t* row = words + (size_t)block * FT_BLOCK_WORDS;
  for (int j = 0; j < n_hash; ++j) {
    uint32_t bit = ft_bit(h1r, h2, j);
    if (!((row[bit >> 5] >> (bit & 31u)) & 1u)) return false;
  }
  return true;
}

// OR a key's n_hash bits into its block. atomicOr commutes, so the result
// does not depend on which thread lands first.
__device__ __forceinline__ void ft_block_or(uint32_t* words, uint32_t block,
                                            uint32_t h1r, uint32_t h2,
                                            int n_hash) {
  uint32_t* row = words + (size_t)block * FT_BLOCK_WORDS;
  for (int j = 0; j < n_hash; ++j) {
    uint32_t bit = ft_bit(h1r, h2, j);
    atomicOr(row + (bit >> 5), 1u << (bit & 31u));
  }
}
