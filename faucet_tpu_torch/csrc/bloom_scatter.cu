// Bit-scatter-OR into a blocked Bloom filter for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of faucet_tpu/kernels/bloom_scatter.py:
//   scatter_or_keys (body _kernel_keys): OR each key's n_hash blocked bits
//     into its 512-bit block; here together with the XLA hashing and block
//     addressing in front of it (faucet_tpu/core/bloom.py bloom_insert and
//     _block_h1r_h2): the kernel takes the codes themselves;
//   scatter_or_bits (body _kernel): OR raw global bit positions.
// The TPU kernels stream filter tiles through VMEM and replay the whole key
// (or position) list against each tile with a scalar loop; the grid runs in
// order on one core, so their read-modify-writes need no atomics. On the
// card the filter stays in HBM (a 4 MB filter also sits in the 50 MB L2)
// and the updates are atomics.
//
// Codes (ft_insert_codes_kernel). Bound: bytes. Per live code 16 bytes of
// (hi, lo), per lane one mask byte, and one random 64-byte block of the
// filter read and, where a bit is new, written; the hashing is a few dozen
// integer instructions. Before this kernel the torch path wrote (block,
// h1r, h2) as three int64 arrays in ~30 launches and the kernel read them
// back. Design: a thread per code, grid-stride; each thread hashes its
// code in registers (hash.cuh), then the warp gathers its live codes with
// a ballot and serves them eight at a time, one quad of threads per code
// (the scheme of bloom_bits.cuh ft_warp_probe), the quad taking the
// code's block and probe bases by shuffle. Lane q owns the block's q-th
// 16 bytes, builds the OR masks of the code's bits that fall in them and
// issues one atomicOr per word that gains a bit (a reduction: the result
// is unused, so the thread does not wait for it). A dead lane costs its
// mask byte, a warp with no live lane nothing more, and a block at or
// past the filter's end is skipped. atomicOr commutes, so the result does
// not depend on the order in which the atomics land: it equals the plain
// version's bit for bit. Each thread hashes once and the quad loops over
// the n_hash bits only: hashing in every quad lane and testing all 16
// slots per code made the kernel bound by its instructions (34 us at
// 573,440 codes on an H100, the same with every atomic skipped). The
// quad does not read its quarter first to OR only the bits not yet set:
// on filters with an eighth of their bits set that was 8-10% slower on
// an H100 (the read costs more than the few atomics it saves), and on a
// filter holding every bit it won 0-4%.
//
// Positions (ft_scatter_or_bits_kernel): one thread per position, one
// atomicOr each; a SENTINEL (0xFFFFFFFF) position or one past the filter's
// end is skipped. Two redesigns were slower on an H100 (PERF.md, B6): four
// positions per thread in 16-byte loads before any `red.global.or`, and
// binning by 64 KB tile with shared-memory ORs. Each random OR is a
// read-modify-write of a 32-byte L2 sector, which paces every design that
// ORs in place.
#include <cuda_runtime.h>

#include "bloom_bits.cuh"

// OR the bits of the quad's code that fall in this lane's quarter of
// `block` (see above); lanes of one quad may call it apart.
__device__ __forceinline__ void ft_quad_or(uint32_t* words, uint32_t block,
                                           uint32_t h1r, uint32_t h2,
                                           int n_hash) {
  const uint32_t q = threadIdx.x & 3u;
  uint32_t m0 = 0u, m1 = 0u, m2 = 0u, m3 = 0u;
  for (int j = 0; j < n_hash; ++j) {
    const uint32_t bit = ft_bit(h1r, h2, j);
    const uint32_t one = (bit >> 7) == q ? 1u << (bit & 31u) : 0u;
    const uint32_t c = (bit >> 5) & 3u;
    m0 |= c == 0u ? one : 0u;
    m1 |= c == 1u ? one : 0u;
    m2 |= c == 2u ? one : 0u;
    m3 |= c == 3u ? one : 0u;
  }
  uint32_t* w = words + (size_t)block * FT_BLOCK_WORDS + 4u * q;
  if (m0) atomicOr(w, m0);
  if (m1) atomicOr(w + 1, m1);
  if (m2) atomicOr(w + 2, m2);
  if (m3) atomicOr(w + 3, m3);
}

__global__ void ft_insert_codes_kernel(uint32_t* __restrict__ words,
                                       uint64_t n_blocks,
                                       const int64_t* __restrict__ khi,
                                       const int64_t* __restrict__ klo,
                                       const bool* __restrict__ mask,
                                       int64_t n, int n_hash, int local_bits,
                                       int shard_bits) {
  // a warp takes 32 consecutive codes; the loop bound is the same for all
  // its threads, as the shuffles need
  const uint32_t lane = threadIdx.x & 31u;
  const uint32_t quad = lane >> 2;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t base = (int64_t)blockIdx.x * blockDim.x + (threadIdx.x - lane);
       base < n; base += stride) {
    const int64_t i = base + lane;
    FtAddr h = {0u, 0u, 0u};
    uint32_t b = 0u;
    bool live = i < n && mask[i];
    if (live) {
      h = ft_hash((uint32_t)khi[i], (uint32_t)klo[i]);
      b = ft_block(h.h1, local_bits, shard_bits);
      live = b < n_blocks;
    }
    uint32_t todo = __ballot_sync(0xFFFFFFFFu, live);
    while (todo) {
      // quad k serves the k-th live lane not yet served
      uint32_t t = todo;
      for (uint32_t k = 0; k < quad; ++k) t &= t - 1u;
      const uint32_t src = t ? (uint32_t)(__ffs(t) - 1) : 0u;
      const uint32_t qb = __shfl_sync(0xFFFFFFFFu, b, src);
      const uint32_t q1 = __shfl_sync(0xFFFFFFFFu, h.h1r, src);
      const uint32_t q2 = __shfl_sync(0xFFFFFFFFu, h.h2, src);
      if (t) ft_quad_or(words, qb, q1, q2, n_hash);
      for (int k = 0; k < 8; ++k) todo &= todo - 1u;
    }
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

extern "C" int ft_bloom_insert_codes(void* words, int64_t n_words,
                                     const void* khi, const void* klo,
                                     const void* mask, int64_t n, int n_hash,
                                     int local_bits, int shard_bits,
                                     void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  ft_insert_codes_kernel<<<ft_grid(n, threads), threads, 0,
                           (cudaStream_t)stream>>>(
      (uint32_t*)words, (uint64_t)(n_words / FT_BLOCK_WORDS),
      (const int64_t*)khi, (const int64_t*)klo, (const bool*)mask, n, n_hash,
      local_bits, shard_bits);
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
