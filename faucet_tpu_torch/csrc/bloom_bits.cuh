// Blocked-Bloom bit addressing shared by the probe, cascade and scatter
// kernels.
//
// Layout (the twin of faucet_tpu_torch/kernels/probe.py block_address and
// block_bits, after the reference's faucet_tpu/core/bloom.py): a filter is
// an array of uint32 words cut into 512-bit blocks of 16 words (64 bytes).
// Probe bit j of a key is
//   (h1r + (j + 1) * h2) & 511
// inside the key's block. The filter is read and written as uint32; the
// wrappers pass it 16-byte aligned, so a block is four uint4. Kernels that
// probe with ft_warp_probe need thread blocks of whole warps.
#pragma once

#include <cstdint>

#include "hash.cuh"

#define FT_SENTINEL 0xFFFFFFFFu
#define FT_BLOCK_WORDS 16

__device__ __forceinline__ uint32_t ft_bit(uint32_t h1r, uint32_t h2,
                                           int j) {
  return (h1r + (uint32_t)(j + 1) * h2) & 511u;
}

// Word c (0..3) of a uint4, by selects: registers cannot be indexed at run
// time without a trip through local memory.
__device__ __forceinline__ uint32_t ft_pick(const uint4& q, uint32_t c) {
  const uint32_t x = (c & 1u) ? q.y : q.x;
  const uint32_t y = (c & 1u) ? q.w : q.z;
  return (c & 2u) ? y : x;
}

// Blocks are read by quads: the four lanes 4k..4k+3 of a warp share one
// key, lane q loads the block's q-th 16 bytes and tests the bits that fall
// in them, and the quad ANDs the answers with two shuffles. One warp
// instruction so reads eight whole blocks, one L1 wavefront and two 32-byte
// sectors each, where a thread per key reading its block in four 16-byte
// loads costs four wavefronts per key (the L1 serves a warp's distinct
// lines one per cycle). The read-only path is safe: no thread of the same
// launch writes the filter.

// This lane's quarter of the block (zero when `live` is false: nothing is
// read).
__device__ __forceinline__ uint4 ft_quad_load(const uint32_t* words,
                                              bool live, uint32_t block) {
  if (!live) return make_uint4(0u, 0u, 0u, 0u);
  return __ldg(reinterpret_cast<const uint4*>(words) +
               (size_t)block * (FT_BLOCK_WORDS / 4) + (threadIdx.x & 3u));
}

// All n_hash (1..16) bits of the quad's key set in its block, given each
// lane's quarter v? All four lanes must reach this call together; `live`
// false answers false.
__device__ __forceinline__ bool ft_quad_has(const uint4& v, bool live,
                                            uint32_t h1r, uint32_t h2,
                                            int n_hash) {
  const uint32_t q = threadIdx.x & 3u;
  const unsigned quad = 0xFu << (threadIdx.x & 28u);
  uint32_t ok = live;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if (j < n_hash) {
      const uint32_t bit = ft_bit(h1r, h2, j);
      if ((bit >> 7) == q)
        ok &= ft_pick(v, (bit >> 5) & 3u) >> (bit & 31u);
    }
  }
  ok &= __shfl_xor_sync(quad, ok, 1);
  ok &= __shfl_xor_sync(quad, ok, 2);
  return ok & 1u;
}

struct FtFilter {
  const uint32_t* words;
  uint64_t n_blocks;
  int local_bits;  // log2 of the filter's bits - shard_bits - 9
  int n_hash;
};

// Membership of each live lane's code (hi, lo) in filter f1 (bit 0 of the
// answer) and, when `two`, in f2 (bit 1), asked by the whole warp: every
// thread of the warp must call it together. The warp gathers its live
// lanes with a ballot and serves them eight at a time, quad k taking the
// k-th live lane not yet served; the lane takes the quad's answer back. A
// dead lane costs no read, and a warp with no live lane none at all.
__device__ __forceinline__ uint32_t ft_warp_probe(bool live, uint32_t hi,
                                                  uint32_t lo, FtFilter f1,
                                                  FtFilter f2, bool two,
                                                  int shard_bits) {
  const uint32_t lane = threadIdx.x & 31u;
  const uint32_t quad = lane >> 2;
  uint32_t todo = __ballot_sync(0xFFFFFFFFu, live);
  uint32_t answer = 0u;
  while (todo) {
    uint32_t t = todo;
    for (uint32_t k = 0; k < quad; ++k) t &= t - 1u;
    const bool have = t != 0u;
    const uint32_t src = have ? (uint32_t)(__ffs(t) - 1) : 0u;
    const FtAddr h = ft_hash(__shfl_sync(0xFFFFFFFFu, hi, src),
                             __shfl_sync(0xFFFFFFFFu, lo, src));
    const uint32_t b1 = ft_block(h.h1, f1.local_bits, shard_bits);
    const uint32_t b2 = ft_block(h.h1, f2.local_bits, shard_bits);
    const bool q1 = have && b1 < f1.n_blocks;
    const bool q2 = two && have && b2 < f2.n_blocks;
    const uint4 v1 = ft_quad_load(f1.words, q1, b1);  // both loads issued
    const uint4 v2 = ft_quad_load(f2.words, q2, b2);  // before either test
    const uint32_t r = ft_quad_has(v1, q1, h.h1r, h.h2, f1.n_hash) |
                       (ft_quad_has(v2, q2, h.h1r, h.h2, f2.n_hash) << 1);
    const uint32_t rank = __popc(todo & ((1u << lane) - 1u));
    const uint32_t got = __shfl_sync(0xFFFFFFFFu, r, (rank & 7u) * 4u);
    if (((todo >> lane) & 1u) && rank < 8u) answer = got;
    for (int k = 0; k < 8; ++k) todo &= todo - 1u;
  }
  return answer;
}

// OR a key's n_hash bits into its block. atomicOr commutes, so the result
// does not depend on which thread lands first; its result is unused, so it
// is a reduction that the thread does not wait for.
__device__ __forceinline__ void ft_block_or(uint32_t* words, uint32_t block,
                                            uint32_t h1r, uint32_t h2,
                                            int n_hash) {
  uint32_t* row = words + (size_t)block * FT_BLOCK_WORDS;
  for (int j = 0; j < n_hash; ++j) {
    uint32_t bit = ft_bit(h1r, h2, j);
    atomicOr(row + (bit >> 5), 1u << (bit & 31u));
  }
}
