// Device hashing of k-mer codes, shared by the Bloom kernels and the wide
// scan's extension keys (wide_ext.cu).
//
// Bit for bit the torch functions faucet_tpu_torch/core/hashing.py
// hash_pair and kernels/probe.py block_address (after the reference's
// faucet_tpu/core/hashing.py and core/bloom.py _block_h1r_h2): murmur3's
// 32-bit finalizer chained over the code's two words gives (h1, h2), h2
// forced odd; the key's 512-bit block takes h1's low bits (and, sharded,
// its top bits), and its probe bits start from h1 rotated by 16. All in
// uint32 registers: what the torch path spends ~30 int64 launches on is
// a few dozen integer instructions here.
#pragma once

#include <cstdint>

__device__ __forceinline__ uint32_t ft_fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  return x ^ (x >> 16);
}

struct FtAddr {
  uint32_t h1, h2;  // the key's two hashes (h2 odd)
  uint32_t h1r;     // h1 rotated by 16: the first probe bit's base
};

__device__ __forceinline__ FtAddr ft_hash(uint32_t hi, uint32_t lo) {
  FtAddr a;
  a.h1 = ft_fmix32(lo ^ ft_fmix32(hi ^ 0x9E3779B9u));
  a.h2 = ft_fmix32(hi ^ ft_fmix32(lo ^ 0x85EBCA77u)) | 1u;
  a.h1r = (a.h1 >> 16) | (a.h1 << 16);
  return a;
}

// Block index of a key in a filter of 2**(local_bits + shard_bits + 9)
// bits; local_bits = log2_bits - shard_bits - 9.
__device__ __forceinline__ uint32_t ft_block(uint32_t h1, int local_bits,
                                             int shard_bits) {
  uint32_t b = h1 & ((1u << local_bits) - 1u);
  if (shard_bits) b |= (h1 >> (32 - shard_bits)) << local_bits;
  return b;
}
