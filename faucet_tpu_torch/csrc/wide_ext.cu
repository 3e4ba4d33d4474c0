// The eight extension keys of wide k-mer windows (31 < k <= 63) for
// Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference computes these keys as
// XLA-fused jnp (faucet_tpu/core/wide.py slot_ext_keys_wide). The port's
// plain version (faucet_tpu_torch/kernels/wide_ext.py slot_ext_keys_plain)
// spells the same arithmetic as int64 torch ops over [4, B, P] word
// planes: ~586 launches and ~10.7 GB of traffic in a k = 55 stream batch
// of 8,192 reads. Here the whole function is one launch.
//
// Bound: bytes. Per window the kernel reads the 8 words of canon and
// other (64 B as int64) and writes 8 (hi, lo) keys (128 B): at a stream
// batch's 8,192 x 46 windows 72.4 MB, 21.6 us at 3.35 TB/s. Its ~500
// integer instructions a window (~3 us there at 67 T op/s) are far under
// the card's integer rate.
// Design: a thread per window, grid-stride; each of the 8 loads is
// coalesced over a word plane. The code is held as two 64-bit halves in
// registers, so one base's shift is two shifts and an OR, the added base
// an OR at bit 2(k-1) or 0 and the 2k-bit mask one AND of the high half.
// A slot's canonical form is a 128-bit compare and select, then hash.cuh's
// finalizers give its fingerprint. Each window's 8 keys go out as 16-byte
// stores, 64 consecutive bytes in each output. No tables, no scratch.
//
// Output, bit for bit the plain version's: his[i*8 + s], los[i*8 + s] the
// fingerprint (hi & 0x3FFFFFFF, lo) of the canonical form of window i
// extended on the right by base s (s < 4) or on the left by base s - 4.
#include <cuda_runtime.h>

#include <cstdint>

#include "hash.cuh"

struct FtCode {  // 128 bits: hi = word 0 << 32 | word 1, lo = 2, 3
  uint64_t hi, lo;
};

__device__ __forceinline__ FtCode ft_load_code(const int64_t* __restrict__ w,
                                               int64_t n, int64_t i) {
  return {((uint64_t)(uint32_t)w[i] << 32) | (uint32_t)w[n + i],
          ((uint64_t)(uint32_t)w[2 * n + i] << 32) | (uint32_t)w[3 * n + i]};
}

// one base to the left; bits past 128 dropped
__device__ __forceinline__ FtCode ft_shl2(FtCode x) {
  return {(x.hi << 2) | (x.lo >> 62), x.lo << 2};
}

__device__ __forceinline__ FtCode ft_shr2(FtCode x) {
  return {x.hi >> 2, (x.lo >> 2) | (x.hi << 62)};
}

// OR the 2-bit base v at the even bit offset pos (< 126)
__device__ __forceinline__ FtCode ft_or_at(FtCode x, uint64_t v, int pos) {
  if (pos >= 64) {
    x.hi |= v << (pos - 64);
  } else {
    x.lo |= v << pos;
  }
  return x;
}

// fingerprint of the canonical (lexicographically smaller) of f and r
__device__ __forceinline__ void ft_canon_key(FtCode f, FtCode r, int64_t* hi,
                                             int64_t* lo) {
  const bool fwd = f.hi < r.hi || (f.hi == r.hi && f.lo <= r.lo);
  const FtCode c = fwd ? f : r;
  const FtAddr a = ft_hash((uint32_t)(c.hi >> 32), (uint32_t)c.hi);
  const FtAddr b = ft_hash((uint32_t)(c.lo >> 32), (uint32_t)c.lo);
  *hi = ft_fmix32(a.h1 + 3u * b.h1) & 0x3FFFFFFFu;
  *lo = ft_fmix32(a.h2 ^ (b.h2 * 5u));
}

__global__ void ft_wide_ext_kernel(const int64_t* __restrict__ canon,
                                   const int64_t* __restrict__ other,
                                   int64_t n, int k,
                                   int64_t* __restrict__ his,
                                   int64_t* __restrict__ los) {
  const int top = 2 * (k - 1);  // bit offset of the code's first base
  const uint64_t hi_mask = (1ull << (2 * k - 64)) - 1ull;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const FtCode f = ft_load_code(canon, n, i);
    const FtCode r = ft_load_code(other, n, i);
    const FtCode fl = ft_shl2(f), fr = ft_shr2(f);
    const FtCode rl = ft_shl2(r), rr = ft_shr2(r);
    int64_t hi[8], lo[8];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      // right by b: f gains b at its end, r gains 3 - b at its front
      FtCode nf = ft_or_at(fl, b, 0);
      nf.hi &= hi_mask;
      ft_canon_key(nf, ft_or_at(rr, 3 - b, top), &hi[b], &lo[b]);
      // left by b: f gains b at its front, r gains 3 - b at its end
      FtCode nr = ft_or_at(rl, 3 - b, 0);
      nr.hi &= hi_mask;
      ft_canon_key(ft_or_at(fr, b, top), nr, &hi[4 + b], &lo[4 + b]);
    }
    longlong2* oh = reinterpret_cast<longlong2*>(his + 8 * i);
    longlong2* ol = reinterpret_cast<longlong2*>(los + 8 * i);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      oh[q] = make_longlong2(hi[2 * q], hi[2 * q + 1]);
      ol[q] = make_longlong2(lo[2 * q], lo[2 * q + 1]);
    }
  }
}

extern "C" int ft_wide_ext_keys(const void* canon, const void* other,
                                int64_t n, int k, void* his, void* los,
                                void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  int64_t grid = (n + threads - 1) / threads;
  if (grid > (1 << 20)) grid = 1 << 20;
  ft_wide_ext_kernel<<<(unsigned)grid, threads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)canon, (const int64_t*)other, n, k, (int64_t*)his,
      (int64_t*)los);
  return (int)cudaGetLastError();
}
