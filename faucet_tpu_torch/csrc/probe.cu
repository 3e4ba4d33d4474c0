// Blocked-Bloom membership of k-mer codes for Hopper (sm_90a), hashing
// fused in.
//
// Replaces the Pallas TPU kernel faucet_tpu/kernels/probe.py
// (bloom_probe_keys, body _kernel) together with the XLA hashing and block
// addressing around it (faucet_tpu/core/bloom.py bloom_contains and
// _block_h1r_h2). The TPU kernel held the filter in VMEM and tiled it when
// it outgrew the budget; on the card the filter stays in HBM (a 4 MB
// filter also fits the 50 MB L2), so there is no tiling.
//
// Bound: bytes. Per code 16 bytes of (hi, lo), one mask byte, one output
// byte and one random 64-byte block of the filter; the hashing is a few
// dozen integer instructions, far under the card's integer rate. Before
// this kernel the torch path wrote (block, h1r, h2) as three int64 arrays
// in ~30 launches and the kernel read them back; at the walk's 32,768
// codes those launches, not the bytes, were the cost. Design: a thread
// per code, grid-stride; each warp gathers its live codes and probes them
// eight at a time, four threads per code, each hashing in registers
// (hash.cuh) and reading one 16-byte quarter of the block (bloom_bits.cuh
// ft_warp_probe), so a warp instruction fetches eight whole blocks and the
// L1 spends one wavefront per code, not the four of a thread that reads
// its block alone; hundreds of thousands of codes in flight hide the
// latency. A masked code reads nothing but its mask byte. Shared memory
// and TMA buy nothing here: the accesses are single random blocks with no
// reuse inside a thread block.
//
// out[i] = mask[i % mask_period] && all n_hash bits of code i set in its
// block; a block at or past the filter's end reads as absent. The mask is
// indexed modulo its period so that a mask broadcast along leading
// dimensions (the walk's four extensions of one frontier) needs no copy.
#include <cuda_runtime.h>

#include "bloom_bits.cuh"

__global__ void ft_contains_kernel(const uint32_t* __restrict__ words,
                                   uint64_t n_blocks,
                                   const int64_t* __restrict__ khi,
                                   const int64_t* __restrict__ klo,
                                   const bool* __restrict__ mask,
                                   int64_t mask_period,
                                   bool* __restrict__ out, int64_t n,
                                   int n_hash, int local_bits,
                                   int shard_bits) {
  // a warp takes 32 consecutive codes; the loop bound is the same for all
  // its threads, as ft_warp_probe needs
  const uint32_t lane = threadIdx.x & 31u;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const FtFilter f = {words, n_blocks, local_bits, n_hash};
  for (int64_t base = (int64_t)blockIdx.x * blockDim.x + (threadIdx.x - lane);
       base < n; base += stride) {
    const int64_t i = base + lane;
    const bool live =
        i < n && mask[mask_period == n ? i : i % mask_period];
    const uint32_t hi = live ? (uint32_t)khi[i] : 0u;
    const uint32_t lo = live ? (uint32_t)klo[i] : 0u;
    const uint32_t hit = ft_warp_probe(live, hi, lo, f, f, false,
                                       shard_bits);
    if (i < n) out[i] = hit & 1u;
  }
}

extern "C" int ft_bloom_contains(const void* words, int64_t n_words,
                                 const void* khi, const void* klo,
                                 const void* mask, int64_t mask_period,
                                 void* out, int64_t n, int n_hash,
                                 int local_bits, int shard_bits,
                                 void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  int64_t grid = (n + threads - 1) / threads;
  if (grid > (1 << 20)) grid = 1 << 20;
  ft_contains_kernel<<<(unsigned)grid, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, (uint64_t)(n_words / FT_BLOCK_WORDS),
      (const int64_t*)khi, (const int64_t*)klo, (const bool*)mask,
      mask_period, (bool*)out, n, n_hash, local_bits, shard_bits);
  return (int)cudaGetLastError();
}

extern "C" const char* ft_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
