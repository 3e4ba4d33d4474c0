// The probe rounds of a hash-table upsert (core/table.py upsert) for
// Hopper (sm_90a): every round of one call in one launch.
//
// Replaces no Pallas kernel: the reference keeps its table in XLA jnp
// (faucet_tpu/core/table.py upsert, a while_loop of scatter rounds). The
// port's torch rounds (kernels/upsert.py probe_rounds_plain) spend ~31-40
// launches a round (probe index, key gathers, the claim scatter-max and
// read-back, key and value index_put_, the winners' sum), a `claim` fill
// of the whole table's size a call, and a blocking read of the pending
// lanes every 4 rounds. Here the batch's rounds run inside the kernel,
// which ends when no lane is pending; count and dropped are summed on the
// device.
//
// Bound: a call's lanes (8,192 on the scan's path) touch little: at round
// r each pending lane reads its slot's two key words, empty lanes write
// and max their claim word and read it back, and each writer reads and
// writes its value rows and the winner its key words, a few MB at most
// (chip_smoke.py counts them). Each round is a chain of dependent random
// reads into the table, three barriers apart: latency, and the memory
// throughput of the SMs the lanes are spread over. One block (one SM of
// an H100) ran a round of the scan's 8,192 lanes in ~45 us; so the grid
// spreads the lanes over blocks of FT_UP_THREADS, one lane a thread, as
// many blocks as the card holds at once, and synchronizes with
// grid.sync() (a cooperative launch). Past that many lanes, threads take
// several in turn.
//
// Design, round for round the torch step (identical slot arrays):
//   (a) each pending lane hashes its key (hash.cuh, bit for bit
//       hash_pair), takes its round-r slot, reads the slot's keys as they
//       stood at the round's start, and notes empty or match; an empty
//       lane stores -1 into claim[slot];
//   (b) after a barrier, empty lanes atomicMax(claim[slot], ticket), the
//       ticket being the lane's index in the sorted batch, as torch's;
//   (c) after a barrier, an empty lane whose ticket stands in claim[slot]
//       won the slot and writes the keys; every writer (match or winner)
//       combines each value row as the torch step does (add or max, the
//       table's dtype); written lanes leave the pending set.
// A slot is claimed in at most one round of a call (its winner fills it
// in that round), and claim is read only at slots that empty lanes probed
// in the same round, so the claim words need no fill: step (a) sets every
// word that (c) reads. Matches and winners never share a slot in one
// round (a slot is empty or holds a key), and the batch's keys are unique
// (deduplicated before the call), so every slot has one writer a round.
// Nothing is written to the TRASH row `cap`.
//
// A lane's key, hashes and state (pending, empty, match) stay in
// registers when each thread holds at most one lane; past that the state
// lives in the caller's representative mask, one byte a lane, which the
// kernel then overwrites. claim[cap + 1] carries the grid's pending-lane
// counter.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "hash.cuh"

namespace cg = cooperative_groups;

#define FT_UP_THREADS 256
#define FT_UP_MAX_VALS 3

#define FT_ST_PENDING 1u
#define FT_ST_EMPTY 2u
#define FT_ST_MATCH 4u

struct FtUpVal {
  void* tab;       // [cap + 1, width] the table's value rows
  const void* in;  // [n, width] the batch's combined rows
  int width;       // 1, 4 or 8
  int is64;        // int64 (else int32)
  int is_max;      // max (else add)
};

struct FtUpArgs {
  int32_t* keys_hi;
  int32_t* keys_lo;
  const int64_t* khi;  // [n] the sorted batch's keys, uint32 words
  const int64_t* klo;
  uint8_t* state;                // [n] representatives on entry
  long long* claim;              // [cap + 2]
  unsigned long long* pend_ctr;  // claim + cap + 1
  const int64_t* count_in;
  const int64_t* dropped_in;
  int64_t* count_out;
  int64_t* dropped_out;
  int64_t n;
  uint32_t local_mask;  // (cap >> shard_bits) - 1
  int local_bits;       // log2(cap >> shard_bits)
  int shard_bits;
  int max_rounds;
  int n_vals;
  FtUpVal v[FT_UP_MAX_VALS];
};

struct FtLane {
  int64_t i;        // the ticket: the lane's index in the sorted batch
  uint32_t hi, lo;  // its key
  FtAddr h;         // its hashes
  uint32_t st;      // FT_ST_* bits
};

__device__ __forceinline__ FtLane ft_lane(const FtUpArgs& a, int64_t i,
                                          uint32_t st) {
  FtLane l;
  l.i = i;
  l.hi = (uint32_t)a.khi[i];
  l.lo = (uint32_t)a.klo[i];
  l.h = ft_hash(l.hi, l.lo);
  l.st = st;
  return l;
}

// kernels/upsert.py probe_idx, in uint32: only the low 32 bits of
// h1 + r * h2 reach the mask
__device__ __forceinline__ uint32_t ft_slot(const FtUpArgs& a,
                                            const FtLane& l, int r) {
  uint32_t s = (l.h.h1 + (uint32_t)r * l.h.h2) & a.local_mask;
  if (a.shard_bits) s |= (l.h.h1 >> (32 - a.shard_bits)) << a.local_bits;
  return s;
}

template <typename T>
__device__ __forceinline__ T ft_combine(T cur, T c, int is_max) {
  typedef typename std::conditional<sizeof(T) == 8, unsigned long long,
                                    uint32_t>::type U;
  if (is_max) return cur > c ? cur : c;
  return (T)((U)cur + (U)c);  // two's complement wrap, as torch's
}

// one value row: all its words read, then combined and written
template <typename T>
__device__ __forceinline__ void ft_write_row(const FtUpVal& v, int64_t slot,
                                             int64_t i) {
  T* tab = (T*)v.tab + slot * v.width;
  const T* in = (const T*)v.in + i * v.width;
  T cur[8], c[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j < v.width) {
      cur[j] = tab[j];
      c[j] = in[j];
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (j < v.width) tab[j] = ft_combine<T>(cur[j], c[j], v.is_max);
}

// f(lane) for each of this thread's lanes. kRegs: at most one, held in
// `mine` across the call; else lanes tid, tid + nth, ..., their state read
// from and written back to a.state.
template <bool kRegs, typename F>
__device__ __forceinline__ void ft_each(const FtUpArgs& a, FtLane& mine,
                                        F f) {
  if (kRegs) {
    if (mine.i < a.n) f(mine);
    return;
  }
  const int64_t nth = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < a.n;
       i += nth) {
    const uint32_t st = a.state[i];
    if (!st) continue;  // settled, or never a representative
    FtLane l = ft_lane(a, i, st);
    f(l);
    if (l.st != st) a.state[i] = (uint8_t)l.st;
  }
}

template <bool kRegs>
__global__ void __launch_bounds__(FT_UP_THREADS)
    ft_upsert_kernel(const __grid_constant__ FtUpArgs a) {
  __shared__ unsigned long long s_won, s_left;
  cg::grid_group grid = cg::this_grid();
  if (threadIdx.x == 0) {
    s_won = s_left = 0ull;
    if (blockIdx.x == 0) {
      *a.pend_ctr = 0ull;
      *a.count_out = *a.count_in;
      *a.dropped_out = *a.dropped_in;
    }
  }
  FtLane mine;
  mine.i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (kRegs && mine.i < a.n) mine = ft_lane(a, mine.i, a.state[mine.i]);
  grid.sync();

  uint32_t won = 0;
  unsigned long long seen = 0ull;  // the grid's counter after a round
  for (int r = 0; r < a.max_rounds; ++r) {
    // (a) the slot's keys at the round's start: empty or match
    ft_each<kRegs>(a, mine, [&](FtLane& l) {
      if (!(l.st & FT_ST_PENDING)) return;
      const uint32_t s = ft_slot(a, l, r);
      const int32_t kh = a.keys_hi[s], kl = a.keys_lo[s];
      l.st = FT_ST_PENDING;
      if (kh == -1) {
        a.claim[s] = -1ll;
        l.st |= FT_ST_EMPTY;
      } else if (kh == (int32_t)l.hi && kl == (int32_t)l.lo) {
        l.st |= FT_ST_MATCH;
      }
    });
    grid.sync();
    // (b) the highest ticket claims each empty slot
    ft_each<kRegs>(a, mine, [&](FtLane& l) {
      if (l.st & FT_ST_EMPTY)
        atomicMax(a.claim + ft_slot(a, l, r), (long long)l.i);
    });
    grid.sync();
    // (c) winners write the keys; every writer combines its values
    bool left = false;
    ft_each<kRegs>(a, mine, [&](FtLane& l) {
      if (!(l.st & (FT_ST_EMPTY | FT_ST_MATCH))) {
        left |= (l.st & FT_ST_PENDING) != 0;
        return;
      }
      const uint32_t s = ft_slot(a, l, r);
      bool write = (l.st & FT_ST_MATCH) != 0;
      if (!write && a.claim[s] == (long long)l.i) {
        a.keys_hi[s] = (int32_t)l.hi;
        a.keys_lo[s] = (int32_t)l.lo;
        ++won;
        write = true;
      }
      if (write) {
        for (int v = 0; v < a.n_vals; ++v) {
          if (a.v[v].is64) {
            ft_write_row<int64_t>(a.v[v], s, l.i);
          } else {
            ft_write_row<int32_t>(a.v[v], s, l.i);
          }
        }
      }
      l.st = write ? 0u : FT_ST_PENDING;
      left |= !write;
    });
    // stop when no lane of the grid is pending
    if (__syncthreads_or(left) && threadIdx.x == 0)
      atomicAdd(a.pend_ctr, 1ull);
    grid.sync();
    const unsigned long long now = *(volatile unsigned long long*)a.pend_ctr;
    if (now == seen) break;
    seen = now;
  }

  // count += winners, dropped += lanes still pending
  uint32_t still = 0;
  ft_each<kRegs>(a, mine,
                 [&](FtLane& l) { still += l.st & FT_ST_PENDING; });
  if (won) atomicAdd(&s_won, (unsigned long long)won);
  if (still) atomicAdd(&s_left, (unsigned long long)still);
  __syncthreads();
  if (threadIdx.x == 0) {
    if (s_won) atomicAdd((unsigned long long*)a.count_out, s_won);
    if (s_left) atomicAdd((unsigned long long*)a.dropped_out, s_left);
  }
}

// Blocks of ft_upsert_kernel<kRegs> that the current device holds at
// once (0 when the query fails), cached per device.
template <bool kRegs>
static int ft_coresident_blocks() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (!cached[dev]) {
    int per_sm = 0, sms = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, ft_upsert_kernel<kRegs>, FT_UP_THREADS, 0) !=
            cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return 0;
    cached[dev] = per_sm * sms;
  }
  return cached[dev];
}

template <bool kRegs>
static int ft_launch(FtUpArgs& a, int64_t grid, cudaStream_t s) {
  void* args[] = {(void*)&a};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)ft_upsert_kernel<kRegs>, dim3((unsigned)grid),
      dim3(FT_UP_THREADS), args, 0, s);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// keys_hi, keys_lo: int32 [cap + 1]; khi, klo: int64 [n]; state: bool
// [n], overwritten when n exceeds the grid's threads; claim: int64
// [cap + 2], any content; count_in, dropped_in, count_out, dropped_out:
// int64 []; value array v: tab_v [cap + 1, width], in_v [n, width],
// desc_v = width | is64 << 8 | is_max << 9.
extern "C" int ft_table_upsert(void* keys_hi, void* keys_lo, int64_t cap,
                               const void* khi, const void* klo, void* state,
                               int64_t n, void* claim, const void* count_in,
                               const void* dropped_in, void* count_out,
                               void* dropped_out, int shard_bits,
                               int max_rounds, int n_vals, void* tab0,
                               const void* in0, int desc0, void* tab1,
                               const void* in1, int desc1, void* tab2,
                               const void* in2, int desc2, void* stream) {
  if (cap <= 0 || (cap & (cap - 1)) || cap > (1ll << 31) || n < 0 ||
      shard_bits < 0 || shard_bits > 16 || (cap >> shard_bits) < 1 ||
      max_rounds < 0 || n_vals < 0 || n_vals > FT_UP_MAX_VALS)
    return (int)cudaErrorInvalidValue;
  FtUpArgs a;
  a.keys_hi = (int32_t*)keys_hi;
  a.keys_lo = (int32_t*)keys_lo;
  a.khi = (const int64_t*)khi;
  a.klo = (const int64_t*)klo;
  a.state = (uint8_t*)state;
  a.claim = (long long*)claim;
  a.pend_ctr = (unsigned long long*)claim + cap + 1;
  a.count_in = (const int64_t*)count_in;
  a.dropped_in = (const int64_t*)dropped_in;
  a.count_out = (int64_t*)count_out;
  a.dropped_out = (int64_t*)dropped_out;
  a.n = n;
  const int64_t local_cap = cap >> shard_bits;
  a.local_mask = (uint32_t)(local_cap - 1);
  a.local_bits = 0;
  while ((1ll << a.local_bits) < local_cap) ++a.local_bits;
  a.shard_bits = shard_bits;
  a.max_rounds = max_rounds;
  a.n_vals = n_vals;
  void* tabs[FT_UP_MAX_VALS] = {tab0, tab1, tab2};
  const void* ins[FT_UP_MAX_VALS] = {in0, in1, in2};
  const int descs[FT_UP_MAX_VALS] = {desc0, desc1, desc2};
  for (int v = 0; v < FT_UP_MAX_VALS; ++v) {
    const int w = descs[v] & 0xFF;
    if (v < n_vals && w != 1 && w != 4 && w != 8)
      return (int)cudaErrorInvalidValue;
    a.v[v] = {tabs[v], ins[v], w, (descs[v] >> 8) & 1, (descs[v] >> 9) & 1};
  }
  cudaStream_t s = (cudaStream_t)stream;
  // one lane a thread while the card holds the grid
  int64_t grid = (n + FT_UP_THREADS - 1) / FT_UP_THREADS;
  if (grid < 1) grid = 1;
  const int fit_regs = ft_coresident_blocks<true>();
  if (fit_regs <= 0) return (int)cudaErrorLaunchOutOfResources;
  if (grid <= fit_regs) return ft_launch<true>(a, grid, s);
  const int fit = ft_coresident_blocks<false>();
  if (fit <= 0) return (int)cudaErrorLaunchOutOfResources;
  return ft_launch<false>(a, fit, s);
}
