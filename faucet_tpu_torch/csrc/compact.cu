// Stream compaction (indices of set mask lanes) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel faucet_tpu/kernels/compact.py
// (mask_indices, body _kernel). That kernel walks the packed mask words in
// SMEM with one scalar cursor, in order, on one core. The card has no such
// sequential core, so this is the classic three-pass parallel compaction:
//   1. count:   each block counts the set lanes of its chunk
//               (__ballot_sync + __popc per warp);
//   2. scan:    one block turns the chunk counts into exclusive offsets and
//               writes the total;
//   3. scatter: each block recounts its chunk warp by warp and writes the
//               index of every set lane whose output slot is below cap.
// Output slots follow lane order: chunks in order, and inside a chunk
// iterations, warps and lanes in order. Blocks whose offset is already at
// or past cap exit at once. Slots at or past min(total, cap) are left as
// they were (don't-care, as in the reference); total may exceed cap.
//
// Bound: one pass over N mask bytes twice (573 KB to 1 MB on the main
// path), a few microseconds of DRAM time; three launches. The scatter
// writes at most cap indices.
#include <cuda_runtime.h>

#include <cstdint>

#define FT_CP_THREADS 256
#define FT_CP_ITERS 8
#define FT_CP_CHUNK (FT_CP_THREADS * FT_CP_ITERS)  // lanes per block
#define FT_CP_WARPS (FT_CP_THREADS / 32)
#define FT_CP_SCAN_THREADS 1024

__global__ void ft_compact_count_kernel(const bool* __restrict__ mask,
                                        int64_t n,
                                        int64_t* __restrict__ chunk_cnt) {
  __shared__ int64_t warp_cnt[FT_CP_WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t base = (int64_t)blockIdx.x * FT_CP_CHUNK;
  int64_t c = 0;
  for (int it = 0; it < FT_CP_ITERS; ++it) {
    const int64_t i = base + it * FT_CP_THREADS + threadIdx.x;
    const bool p = i < n && mask[i];
    c += __popc(__ballot_sync(0xFFFFFFFFu, p));
  }
  if (lane == 0) warp_cnt[warp] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int64_t s = 0;
    for (int w = 0; w < FT_CP_WARPS; ++w) s += warp_cnt[w];
    chunk_cnt[blockIdx.x] = s;
  }
}

// One block: chunk_cnt -> exclusive offsets (in place), total -> *total.
__global__ void ft_compact_scan_kernel(int64_t* __restrict__ chunk_cnt,
                                       int64_t n_chunks,
                                       int64_t* __restrict__ total) {
  __shared__ int64_t buf[FT_CP_SCAN_THREADS];
  int64_t carry = 0;
  for (int64_t t0 = 0; t0 < n_chunks; t0 += FT_CP_SCAN_THREADS) {
    const int64_t i = t0 + threadIdx.x;
    const int64_t v = i < n_chunks ? chunk_cnt[i] : 0;
    buf[threadIdx.x] = v;
    __syncthreads();
    // Hillis-Steele inclusive scan over the tile
    for (int off = 1; off < FT_CP_SCAN_THREADS; off <<= 1) {
      const int64_t add = threadIdx.x >= off ? buf[threadIdx.x - off] : 0;
      __syncthreads();
      buf[threadIdx.x] += add;
      __syncthreads();
    }
    if (i < n_chunks) chunk_cnt[i] = carry + buf[threadIdx.x] - v;
    carry += buf[FT_CP_SCAN_THREADS - 1];
    __syncthreads();
  }
  if (threadIdx.x == 0) *total = carry;
}

__global__ void ft_compact_scatter_kernel(const bool* __restrict__ mask,
                                          int64_t n,
                                          const int64_t* __restrict__ off,
                                          int64_t* __restrict__ idx,
                                          int64_t cap) {
  __shared__ int warp_cnt[FT_CP_WARPS];
  int64_t run = off[blockIdx.x];
  if (run >= cap) return;  // uniform across the block
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const int64_t base = (int64_t)blockIdx.x * FT_CP_CHUNK;
  for (int it = 0; it < FT_CP_ITERS; ++it) {
    const int64_t i = base + it * FT_CP_THREADS + threadIdx.x;
    const bool p = i < n && mask[i];
    const unsigned bal = __ballot_sync(0xFFFFFFFFu, p);
    if (lane == 0) warp_cnt[warp] = __popc(bal);
    __syncthreads();
    int64_t before = run;
    int64_t all = 0;
    for (int w = 0; w < FT_CP_WARPS; ++w) {
      if (w < warp) before += warp_cnt[w];
      all += warp_cnt[w];
    }
    const int64_t slot = before + __popc(bal & lt);
    if (p && slot < cap) idx[slot] = i;
    run += all;
    __syncthreads();  // warp_cnt is rewritten by the next iteration
  }
}

extern "C" int ft_mask_indices(const void* mask, int64_t n, void* idx,
                               int64_t cap, void* total, void* scratch,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t n_chunks = n > 0 ? (n + FT_CP_CHUNK - 1) / FT_CP_CHUNK : 0;
  if (n_chunks == 0) {
    return (int)cudaMemsetAsync(total, 0, sizeof(int64_t), s);
  }
  int64_t* cnt = (int64_t*)scratch;
  ft_compact_count_kernel<<<(unsigned)n_chunks, FT_CP_THREADS, 0, s>>>(
      (const bool*)mask, n, cnt);
  ft_compact_scan_kernel<<<1, FT_CP_SCAN_THREADS, 0, s>>>(cnt, n_chunks,
                                                          (int64_t*)total);
  ft_compact_scatter_kernel<<<(unsigned)n_chunks, FT_CP_THREADS, 0, s>>>(
      (const bool*)mask, n, cnt, (int64_t*)idx, cap);
  return (int)cudaGetLastError();
}

extern "C" int64_t ft_mask_indices_chunk() { return FT_CP_CHUNK; }
