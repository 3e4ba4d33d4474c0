// Bloom-cascade insert (A = seen once, B = solid) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel faucet_tpu/kernels/cascade.py
// cascade_insert_fused in all three of its bodies: dense _kernel_v2,
// sparse _kernel_sparse and multi-tile _kernel. Those walk the keys one by
// one in VMEM. This port computes the sort+count formulation that the
// reference runs on its CPU backend (faucet_tpu/core/bloom.py
// cascade_insert_nbs): the TPU kernel's filter words equal that
// formulation's bit for bit and so do its new_b key multisets, while its
// solid flags are a superset by under 3% (it probes B mid-batch;
// tests/unit/test_cascade_kernel.py). The port reproduces the
// formulation exactly, so its CPU and CUDA runs agree bit for bit.
//
// The wrapper (faucet_tpu_torch/kernels/cascade.py) sorts the batch by key
// with a stable torch sort, which packs live lanes in front (so the sparse
// node-endpoint inserts need no kernel of their own: dead lanes exit at
// once), and probes pre-batch A and B for each key's first occurrence with
// the probe kernel. This kernel then runs one thread per sorted lane:
//   first occurrence of a key:  not in A      -> OR its bits into A
//                               in A or dup   -> OR its bits into B
//                               new_b = added to B and not in B before
//   every lane:                 solid = in B or in A before the batch, or
//                               not the key's first occurrence
// and writes new_b / solid back to the lane's original position (sidx).
// Two launches keep it deterministic: the probe reads only pre-batch
// state, and OR does not depend on the order the atomics land in.
//
// Bound: random 64-byte read-modify-writes into 16 MB / 4 MB filters
// (latency, L2 atomics); one thread per lane keeps them all in flight.
#include <cuda_runtime.h>

#include "bloom_bits.cuh"

__global__ void ft_cascade_apply_kernel(
    uint32_t* __restrict__ a_words, uint64_t n_blocks_a,
    uint32_t* __restrict__ b_words, uint64_t n_blocks_b,
    const int64_t* __restrict__ block_a, const int64_t* __restrict__ block_b,
    const int64_t* __restrict__ h1r, const int64_t* __restrict__ h2,
    const int64_t* __restrict__ seg_start, const bool* __restrict__ in_a,
    const bool* __restrict__ in_b, const int64_t* __restrict__ sidx,
    bool* __restrict__ new_b, bool* __restrict__ solid, int64_t n,
    int n_hash_a, int n_hash_b) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const uint64_t ba = (uint64_t)block_a[i];
    const bool live = ba < n_blocks_a;  // SENTINEL marks masked lanes
    const int64_t s = seg_start[i];
    const bool pa = in_a[s];
    const bool pb = in_b[s];
    bool nb = false;
    if (live && s == i) {
      const bool dup = i + 1 < n && seg_start[i + 1] == i;
      const bool add_b = pa || dup;
      const uint32_t r1 = (uint32_t)h1r[i];
      const uint32_t r2 = (uint32_t)h2[i];
      if (!pa) ft_block_or(a_words, (uint32_t)ba, r1, r2, n_hash_a);
      const uint64_t bb = (uint64_t)block_b[i];
      if (add_b && bb < n_blocks_b)
        ft_block_or(b_words, (uint32_t)bb, r1, r2, n_hash_b);
      nb = add_b && !pb;
    }
    const int64_t o = sidx[i];
    new_b[o] = nb;
    solid[o] = live && (pb || pa || i > s);
  }
}

extern "C" int ft_cascade_apply(void* a_words, int64_t n_words_a,
                                void* b_words, int64_t n_words_b,
                                const void* block_a, const void* block_b,
                                const void* h1r, const void* h2,
                                const void* seg_start, const void* in_a,
                                const void* in_b, const void* sidx,
                                void* new_b, void* solid, int64_t n,
                                int n_hash_a, int n_hash_b, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  int64_t grid = (n + threads - 1) / threads;
  if (grid > (1 << 20)) grid = 1 << 20;
  ft_cascade_apply_kernel<<<(unsigned)grid, threads, 0,
                            (cudaStream_t)stream>>>(
      (uint32_t*)a_words, (uint64_t)(n_words_a / FT_BLOCK_WORDS),
      (uint32_t*)b_words, (uint64_t)(n_words_b / FT_BLOCK_WORDS),
      (const int64_t*)block_a, (const int64_t*)block_b,
      (const int64_t*)h1r, (const int64_t*)h2, (const int64_t*)seg_start,
      (const bool*)in_a, (const bool*)in_b, (const int64_t*)sidx,
      (bool*)new_b, (bool*)solid, n, n_hash_a, n_hash_b);
  return (int)cudaGetLastError();
}
