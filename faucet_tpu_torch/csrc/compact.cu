// Stream compaction (indices of set mask lanes) for Hopper (sm_90a):
// one launch, one pass over the mask.
//
// Replaces the Pallas TPU kernel faucet_tpu/kernels/compact.py
// (mask_indices, body _kernel). That kernel walks the packed mask words in
// SMEM with one scalar cursor, in order, on one core. The card has no such
// sequential core; this is a single-pass scan with decoupled look-back
// (Merrill and Garland, 2016):
//   - a block takes a tile of 4,096 lanes, 16 mask bytes per thread in one
//     uint4 load, and counts its live lanes (popc, warp shuffle scan);
//   - it publishes the tile's count, then its inclusive prefix, in a 64-bit
//     status word per tile (epoch | flag | count), stored with release and
//     read with acquire; its first warp looks back over earlier tiles 32 at
//     a time, adding counts until it meets a published prefix;
//   - each thread then writes the indices of its live lanes from its slot
//     on, in lane order, while the slot is below cap.
// Tile ids come from an atomicAdd ticket, so a tile waits only on tiles
// whose blocks are already running: progress does not depend on the order
// in which the card schedules blocks. The block that takes the last ticket
// resets the counter for the next call and writes total. Status words
// carry the wrapper's epoch, bumped on every call, so words of an earlier
// call read as not ready and the scratch needs no memset launch per call
// (kernels/compact.py keeps the scratch per device and stream, and zeroes
// it when the epoch would wrap).
//
// Bound: bytes. The call must read N mask bytes and write 8 bytes per
// index below min(total, cap), plus the 8-byte total: at the scan's
// 573,440 lanes 0.2-0.6 us at 3.35 TB/s (1.5% to 30% live, every live
// index written). One launch costs a few microseconds on its own, so a
// single launch is the practical floor; the design's point is to be one
// launch (the classic parallel compaction takes three: count, scan,
// scatter) and to read the mask once. The look-back adds status round
// trips through L2, mostly hidden behind the other tiles' loads.
//
// Alignment: the mask may be any view. The kernel reads it as 16-byte
// chunks from the pointer rounded down to 16 bytes; lanes before the view
// (head) and past its end are dead, and the first and last chunk, which
// hold them, are read byte by byte, so no byte outside the view is read.
#include <cuda_runtime.h>

#include <cstdint>

#define FT_CP_THREADS 256
#define FT_CP_WARPS (FT_CP_THREADS / 32)
#define FT_CP_TILE (FT_CP_THREADS * 16)  // lanes per tile

// status word: epoch (30 bits) << 34 | flag (2 bits) << 32 | count
#define FT_ST_AGGREGATE 1ull  // count of this tile alone
#define FT_ST_PREFIX 2ull     // count of this tile and all before it

__device__ __forceinline__ unsigned long long ft_status(
    uint32_t epoch, unsigned long long flag, uint32_t count) {
  return ((unsigned long long)epoch << 34) | (flag << 32) | count;
}

__device__ __forceinline__ void ft_store_release(unsigned long long* p,
                                                 unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long ft_load_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

// Bit j (0..3) set when byte j of x is not zero. After the compare each
// byte is 0 or 1; the product moves byte j's bit to bit 28 + j with no
// carries between the partial products.
__device__ __forceinline__ uint32_t ft_nonzero_bytes(uint32_t x) {
  return ((__vcmpne4(x, 0u) & 0x01010101u) * 0x10204080u) >> 28;
}

__global__ void __launch_bounds__(FT_CP_THREADS)
    ft_compact_kernel(const uint8_t* __restrict__ bytes, int64_t head,
                      int64_t end, int64_t* __restrict__ idx, int64_t cap,
                      int64_t* __restrict__ total,
                      unsigned long long* __restrict__ counter,
                      unsigned long long* __restrict__ status, uint32_t epoch,
                      uint32_t n_tiles) {
  __shared__ uint32_t s_tile;
  __shared__ uint32_t s_warp[FT_CP_WARPS];
  __shared__ int64_t s_prefix;
  const uint32_t lane = threadIdx.x & 31u, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    const uint32_t t = (uint32_t)atomicAdd(counter, 1ull);
    // the last ticket: every other block has taken its own already
    if (t == n_tiles - 1) atomicExch(counter, 0ull);
    s_tile = t;
  }
  __syncthreads();
  const uint32_t tile = s_tile;

  // this thread's 16 lanes: bytes [v0, v0 + 16) of the rounded-down view;
  // live lanes are the non-zero bytes in [head, end)
  const int64_t v0 = ((int64_t)tile * FT_CP_THREADS + threadIdx.x) * 16;
  uint32_t bits = 0;
  if (v0 >= head && v0 + 16 <= end) {
    const uint4 q = *reinterpret_cast<const uint4*>(bytes + v0);
    bits = ft_nonzero_bytes(q.x) | ft_nonzero_bytes(q.y) << 4 |
           ft_nonzero_bytes(q.z) << 8 | ft_nonzero_bytes(q.w) << 12;
  } else if (v0 < end) {  // the view's first or last chunk
    for (int j = 0; j < 16; ++j) {
      const int64_t v = v0 + j;
      if (v >= head && v < end && bytes[v]) bits |= 1u << j;
    }
  }
  const uint32_t cnt = __popc(bits);

  // exclusive offset of this thread's lanes inside the tile
  uint32_t incl = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(0xFFFFFFFFu, incl, o);
    if (lane >= (uint32_t)o) incl += y;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  uint32_t before = 0, aggregate = 0;
#pragma unroll
  for (int w = 0; w < FT_CP_WARPS; ++w) {
    const uint32_t s = s_warp[w];
    before += (uint32_t)w < warp ? s : 0u;
    aggregate += s;
  }

  // the tile's exclusive prefix: warp 0 publishes and looks back
  if (warp == 0) {
    int64_t prefix = 0;
    if (tile == 0) {
      if (lane == 0)
        ft_store_release(status, ft_status(epoch, FT_ST_PREFIX, aggregate));
    } else {
      if (lane == 0)
        ft_store_release(status + tile,
                         ft_status(epoch, FT_ST_AGGREGATE, aggregate));
      int64_t last = (int64_t)tile - 1;  // window [last - 31, last]
      while (true) {
        const int64_t j = last - lane;
        // lanes before tile 0 read as a zero prefix (tile 0 always
        // publishes its prefix, so the window stops there)
        const unsigned long long s =
            j >= 0 ? ft_load_acquire(status + j)
                   : ft_status(epoch, FT_ST_PREFIX, 0u);
        const unsigned long long flag = (s >> 32) & 3ull;
        const bool ready = (uint32_t)(s >> 34) == epoch && flag != 0ull;
        if (!__all_sync(0xFFFFFFFFu, ready)) {
          __nanosleep(32);
          continue;  // a predecessor has not published yet: read again
        }
        const uint32_t pre =
            __ballot_sync(0xFFFFFFFFu, flag == FT_ST_PREFIX);
        // sum the window up to and including the nearest prefix
        const uint32_t stop = pre ? (uint32_t)(__ffs(pre) - 1) : 31u;
        int64_t v = lane <= stop ? (int64_t)(uint32_t)s : 0;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
        prefix += v;
        if (pre) break;
        last -= 32;
      }
      if (lane == 0)
        ft_store_release(status + tile,
                         ft_status(epoch, FT_ST_PREFIX,
                                   (uint32_t)(prefix + aggregate)));
    }
    if (lane == 0) {
      s_prefix = prefix;
      if (tile == n_tiles - 1) *total = prefix + aggregate;
    }
  }
  __syncthreads();

  int64_t slot = s_prefix + before + incl - cnt;
  const int64_t first = v0 - head;  // lane index of the chunk's byte 0
  while (bits && slot < cap) {
    idx[slot++] = first + (__ffs(bits) - 1);
    bits &= bits - 1u;
  }
}

// mask: bool[n] (any alignment); idx: int64[cap]; total: int64[1];
// scratch: uint64[1 + scratch_tiles], word 0 the ticket counter (0 between
// calls), then one status word per tile; epoch in [1, 2**30), different
// from every earlier call's on this scratch since it was zeroed.
extern "C" int ft_mask_indices(const void* mask, int64_t n, void* idx,
                               int64_t cap, void* total, void* scratch,
                               int64_t scratch_tiles, int epoch,
                               void* stream) {
  const int64_t head = (int64_t)((uintptr_t)mask & 15u);
  const int64_t end = head + n;
  const int64_t tiles = end > 0 ? (end + FT_CP_TILE - 1) / FT_CP_TILE : 1;
  if (n < 0 || cap < 0 || end >= (1ll << 31) || tiles > scratch_tiles ||
      epoch <= 0 || epoch >= (1 << 30))
    return (int)cudaErrorInvalidValue;
  unsigned long long* s = (unsigned long long*)scratch;
  ft_compact_kernel<<<(unsigned)tiles, FT_CP_THREADS, 0,
                      (cudaStream_t)stream>>>(
      (const uint8_t*)mask - head, head, end, (int64_t*)idx, cap,
      (int64_t*)total, s, s + 1, (uint32_t)epoch, (uint32_t)tiles);
  return (int)cudaGetLastError();
}
