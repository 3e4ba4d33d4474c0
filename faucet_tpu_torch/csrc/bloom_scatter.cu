// Bit-scatter-OR into a blocked Bloom filter for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of faucet_tpu/kernels/bloom_scatter.py:
//   scatter_or_keys (body _kernel_keys): OR each key's n_hash blocked bits
//     into its 512-bit block;
//   scatter_or_bits (body _kernel): OR raw global bit positions.
// The TPU kernels stream filter tiles through VMEM and replay the whole key
// (or position) list against each tile with a scalar loop; the grid runs in
// order on one core, so their read-modify-writes need no atomics. On the
// card the filter stays in HBM (a 4 MB filter also sits in the 50 MB L2)
// and every key is its own thread.
//
// Bound: one random 64-byte read-modify-write per key (latency and L2
// atomics), no arithmetic to speak of. Design: one thread per key in a
// grid-stride loop, enough keys in flight to hide the latency. A key's
// bits are gathered per word in registers first (a block is 16 words and
// n_hash <= 16, so the per-word masks are a fully unrolled register array)
// and each touched word takes one atomicOr, instead of one per bit.
// atomicOr commutes, so the result does not depend on the order in which
// the atomics land: it is deterministic and equals the plain version's.
//
// Keys and positions arrive as the port's int64 words holding uint32
// values; a block (or word) at or past the filter's end is skipped, which
// covers the SENTINEL 0xFFFFFFFF.
#include <cuda_runtime.h>

#include "bloom_bits.cuh"

__global__ void ft_scatter_or_keys_kernel(uint32_t* __restrict__ words,
                                          uint64_t n_blocks,
                                          const int64_t* __restrict__ block,
                                          const int64_t* __restrict__ h1r,
                                          const int64_t* __restrict__ h2,
                                          int64_t n, int n_hash) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const uint64_t b = (uint64_t)block[i];
    if (b >= n_blocks) continue;
    const uint32_t r1 = (uint32_t)h1r[i];
    const uint32_t r2 = (uint32_t)h2[i];
    uint32_t m[FT_BLOCK_WORDS];
#pragma unroll
    for (int w = 0; w < FT_BLOCK_WORDS; ++w) m[w] = 0u;
    for (int j = 0; j < n_hash; ++j) {
      const uint32_t bit = ft_bit(r1, r2, j);
      const uint32_t one = 1u << (bit & 31u);
      // compare against every word index so m stays in registers
#pragma unroll
      for (int w = 0; w < FT_BLOCK_WORDS; ++w)
        m[w] |= ((bit >> 5) == (uint32_t)w) ? one : 0u;
    }
    uint32_t* row = words + (size_t)b * FT_BLOCK_WORDS;
#pragma unroll
    for (int w = 0; w < FT_BLOCK_WORDS; ++w)
      if (m[w]) atomicOr(row + w, m[w]);
  }
}

__global__ void ft_scatter_or_bits_kernel(uint32_t* __restrict__ words,
                                          uint64_t n_words,
                                          const int64_t* __restrict__ pos,
                                          int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const uint64_t p = (uint64_t)pos[i];
    if (p == FT_SENTINEL || (p >> 5) >= n_words) continue;
    atomicOr(words + (p >> 5), 1u << (uint32_t)(p & 31u));
  }
}

static unsigned ft_grid(int64_t n, int threads) {
  int64_t grid = (n + threads - 1) / threads;
  if (grid > (1 << 20)) grid = 1 << 20;
  return (unsigned)grid;
}

extern "C" int ft_scatter_or_keys(void* words, int64_t n_words,
                                  const void* block, const void* h1r,
                                  const void* h2, int64_t n, int n_hash,
                                  void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  ft_scatter_or_keys_kernel<<<ft_grid(n, threads), threads, 0,
                              (cudaStream_t)stream>>>(
      (uint32_t*)words, (uint64_t)(n_words / FT_BLOCK_WORDS),
      (const int64_t*)block, (const int64_t*)h1r, (const int64_t*)h2, n,
      n_hash);
  return (int)cudaGetLastError();
}

extern "C" int ft_scatter_or_bits(void* words, int64_t n_words,
                                  const void* pos, int64_t n, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  ft_scatter_or_bits_kernel<<<ft_grid(n, threads), threads, 0,
                              (cudaStream_t)stream>>>(
      (uint32_t*)words, (uint64_t)n_words, (const int64_t*)pos, n);
  return (int)cudaGetLastError();
}
