// Batched blocked-Bloom membership probe for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel faucet_tpu/kernels/probe.py
// (bloom_probe_keys, body _kernel). That kernel held the filter in VMEM and
// tiled it when it outgrew the budget; on the card the filter stays in HBM
// (a 4 MB filter also fits the 50 MB L2), so there is no tiling and no
// result accumulation across tiles.
//
// Bound: one random 64-byte block read per key, i.e. memory latency and
// 32-byte sectors, not arithmetic. Design: one thread per key, a
// grid-stride loop, and hundreds of thousands of independent keys per
// launch so that enough loads are in flight to hide the latency. Hashing
// (block, h1r, h2) stays in torch ops, as in the reference's split
// (core/bloom.py _block_h1r_h2).
//
// out[i] = all n_hash bits of key i set in block[i]; a block index at or
// past the filter's end (SENTINEL = 0xFFFFFFFF included) reads as absent.
#include <cuda_runtime.h>

#include "bloom_bits.cuh"

__global__ void ft_probe_kernel(const uint32_t* __restrict__ words,
                                uint64_t n_blocks,
                                const int64_t* __restrict__ block,
                                const int64_t* __restrict__ h1r,
                                const int64_t* __restrict__ h2,
                                bool* __restrict__ out, int64_t n,
                                int n_hash) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const uint64_t b = (uint64_t)block[i];
    out[i] = b < n_blocks &&
             ft_block_has(words, (uint32_t)b, (uint32_t)h1r[i],
                          (uint32_t)h2[i], n_hash);
  }
}

extern "C" int ft_bloom_probe(const void* words, int64_t n_words,
                              const void* block, const void* h1r,
                              const void* h2, void* out, int64_t n,
                              int n_hash, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  int64_t grid = (n + threads - 1) / threads;
  if (grid > (1 << 20)) grid = 1 << 20;
  ft_probe_kernel<<<(unsigned)grid, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, (uint64_t)(n_words / FT_BLOCK_WORDS),
      (const int64_t*)block, (const int64_t*)h1r, (const int64_t*)h2,
      (bool*)out, n, n_hash);
  return (int)cudaGetLastError();
}

extern "C" const char* ft_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
