// A hash-table upsert (core/table.py upsert, kernels/upsert.py) for
// Hopper (sm_90a): every probe round of a batch in one launch, and every
// K-lane chunk of a scan's compacted update lanes in one launch.
//
// Replaces no Pallas kernel: the reference keeps its table in XLA jnp
// (faucet_tpu/core/table.py upsert, a while_loop of scatter rounds over a
// batch it has sorted and combined by key). The port's plain version
// (kernels/upsert.py) sorts and combines in torch (`dedupe`), then runs
// torch rounds of ~31-40 launches each (`probe_rounds_plain`); the scan
// gathers each K-lane chunk's fields and builds the junction rows
// (core/scan.py cov_dist8) before each call, and reads the lane count on
// the host to size its loop. Here none of that is issued: the lanes come
// as they are, unsorted and with duplicate keys, and count and dropped
// are summed on the device.
//
// Why no sort is needed. After the reference's sort and combine, the
// batch's keys are unique and ascending, and the highest ticket (sorted
// lane index) wins an empty slot: the same rule as "the largest sort key
// wins it" (u32x2.sort_key: (hi << 32 | lo) with the sign bit flipped).
// Lanes of one key follow one probe sequence and see the same slot
// states at each round's start, so they settle together, in one slot,
// and add or max into it: integer add and max do not depend on order.
// So claims are made with the sort key, every live lane takes part, and
// each writer combines its own row atomically: rows [:cap], count and
// dropped equal the plain version's, slot arrays included.
//
// Bound: a chunk's lanes (8,192 on the scan's path) touch little: at
// round r each pending lane reads its slot's two key words, empty lanes
// write and max their claim word and read it back, each writer combines
// its value rows and one winner a key writes the key words, a few MB at
// most (chip_smoke.py counts them). Each round is a chain of dependent
// random reads into the table, three grid barriers apart: latency. So
// the grid spreads a chunk's lanes over blocks of FT_UP_THREADS, one
// lane a thread, as many blocks as the card holds at once, and
// synchronizes with grid.sync() (a cooperative launch). Past that many
// lanes a chunk, threads take several in turn.
//
// Lanes. Position q of the batch (direct: q < n, live where mask[q]) or
// of the compacted list (listed: q < *total, the lane idx[q] of the
// scan's flat grids); chunk c holds positions c*K .. c*K + K - 1 and runs
// only after chunk c - 1 has settled, as successive host calls did. A
// lane whose key's high word is EMPTY takes no part (the plain version
// masks it).
//
// A chunk's rounds:
//   (a) each pending lane hashes its key (hash.cuh, bit for bit
//       hash_pair), takes its round-r slot, reads the slot's keys as
//       they stood at the round's start, and notes empty or match; an
//       empty lane stores LLONG_MIN (below every sort key) in claim[slot];
//   (b) after a barrier, empty lanes atomicMax(claim[slot], sort key);
//   (c) after a barrier, an empty lane whose key stands in claim[slot]
//       won the slot: the one whose atomicCAS fills keys_hi counts the
//       new slot and writes keys_lo; every writer (match or winner) adds
//       or maxes its value row into the slot; written lanes settle.
// Matches and winners never share a slot in a round (a slot is empty or
// holds a key), and claim is read only at slots that empty lanes probed
// in that round, so the claim words need no fill. Nothing is written to
// the TRASH row `cap`. After max_rounds, the lanes still pending are
// counted in dropped once per key: per pass, the largest key among the
// pending lanes of each group slot is counted (one atomicCAS among its
// lanes) and leaves, until none is pending.
//
// Values: each lane's row of each value array, gathered from the lane's
// source with the array's strides; or, for a junction table's first two
// arrays (cov8 'add', dist8 'max', int32 [8]), built in registers from
// the lane's slot and distance fields as cov_dist8 builds them.
//
// A lane's key, hashes and state (pending, empty, match) stay in
// registers when each thread holds at most one lane of a chunk; past
// that the state lives in the caller's scratch, one byte a position.
// claim[cap + 1] carries the grid's pending-block counter.
#include <climits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hash.cuh"

namespace cg = cooperative_groups;

#define FT_UP_THREADS 256
#define FT_UP_MAX_VALS 3

#define FT_ST_PENDING 1u
#define FT_ST_EMPTY 2u
#define FT_ST_MATCH 4u

struct FtUpVal {
  void* tab;       // [cap + 1, width] the table's value rows
  const void* in;  // the lanes' rows: element j of source s at s*s0 + j*s1
  int64_t s0, s1;
  int width;       // 1, 4 or 8
  int is64;        // int64 (else int32)
  int is_max;      // max (else add)
};

struct FtUpArgs {
  int32_t* keys_hi;
  int32_t* keys_lo;
  const int64_t* khi;     // keys by source, uint32 words
  const int64_t* klo;
  const uint8_t* mask;    // direct: live positions; listed: null
  const int64_t* idx;     // listed: each position's source; direct: null
  const int64_t* total;   // listed: positions, on the device; direct: null
  int64_t n;              // direct: positions
  int64_t K;              // positions a chunk
  uint8_t* state;         // [K] when a thread holds several positions
  long long* claim;       // [cap + 2]
  unsigned long long* pend_ctr;  // claim + cap + 1
  const int64_t* count_in;
  const int64_t* dropped_in;
  int64_t* count_out;
  int64_t* dropped_out;
  int64_t* lanes_out;     // += positions taken (null: not counted)
  int64_t* chunks_out;    // += chunks run
  const int64_t* slot[4];  // junction rows: ex_slot, en_slot, ex_dist,
  const uint8_t* ok[2];    // en_dist; exit_ok, entry_ok (null: none)
  uint32_t local_mask;  // (cap >> shard_bits) - 1
  int local_bits;       // log2(cap >> shard_bits)
  int shard_bits;
  int max_rounds;
  int n_vals;
  FtUpVal v[FT_UP_MAX_VALS];
};

struct FtLane {
  int64_t p;        // the lane's position in its chunk
  int64_t src;      // its index in the keys and value grids
  long long key;    // its sort key
  uint32_t hi, lo;  // its key
  FtAddr h;         // its hashes
  uint32_t st;      // FT_ST_* bits
};

// the lane at position q of the batch or list (q below its end)
__device__ __forceinline__ FtLane ft_lane(const FtUpArgs& a, int64_t p,
                                          int64_t q, uint32_t st) {
  FtLane l;
  l.p = p;
  l.src = a.idx ? a.idx[q] : q;
  l.hi = (uint32_t)a.khi[l.src];
  l.lo = (uint32_t)a.klo[l.src];
  l.key = (long long)((((unsigned long long)l.hi << 32) | l.lo) ^
                      (1ull << 63));
  l.h = ft_hash(l.hi, l.lo);
  l.st = st;
  return l;
}

// position q's state at its chunk's start: pending when live
__device__ __forceinline__ uint32_t ft_start(const FtUpArgs& a, int64_t q) {
  if (a.mask && !a.mask[q]) return 0u;
  const int64_t src = a.idx ? a.idx[q] : q;
  return (uint32_t)a.khi[src] == 0xFFFFFFFFu ? 0u : FT_ST_PENDING;
}

// kernels/upsert.py probe_idx, in uint32: only the low 32 bits of
// h1 + r * h2 reach the mask
__device__ __forceinline__ uint32_t ft_slot(const FtUpArgs& a,
                                            const FtLane& l, int r) {
  uint32_t s = (l.h.h1 + (uint32_t)r * l.h.h2) & a.local_mask;
  if (a.shard_bits) s |= (l.h.h1 >> (32 - a.shard_bits)) << a.local_bits;
  return s;
}

// *p = *p + c or max(*p, c), atomically. Under max a value only grows, so
// a read that already holds c or more leaves nothing to do.
__device__ __forceinline__ void ft_fold32(int32_t* p, int32_t c,
                                          int is_max) {
  if (is_max) {
    if (c > *p) atomicMax(p, c);
  } else if (c) {
    atomicAdd((unsigned int*)p, (unsigned int)c);  // wraps, as torch's
  }
}

__device__ __forceinline__ void ft_fold64(int64_t* p, int64_t c,
                                          int is_max) {
  if (is_max) {
    if (c > *p) atomicMax((long long*)p, (long long)c);
  } else if (c) {
    atomicAdd((unsigned long long*)p, (unsigned long long)c);
  }
}

// one value array's row of lane src into slot
__device__ __forceinline__ void ft_fold_row(const FtUpVal& v, int64_t slot,
                                            int64_t src) {
  for (int j = 0; j < v.width; ++j) {
    const int64_t e = src * v.s0 + j * v.s1;
    if (v.is64) {
      ft_fold64((int64_t*)v.tab + slot * v.width + j,
                ((const int64_t*)v.in)[e], v.is_max);
    } else {
      ft_fold32((int32_t*)v.tab + slot * v.width + j,
                ((const int32_t*)v.in)[e], v.is_max);
    }
  }
}

// a junction lane's cov8 (add) and dist8 (max) rows, as core/scan.py
// cov_dist8 builds them: slot j counts the exit and entry observed there
// and keeps the larger of their distances (int64, then int32 bits)
__device__ __forceinline__ void ft_fold_junction(const FtUpArgs& a,
                                                 int64_t slot, int64_t src) {
  const int64_t ex = a.slot[0][src], en = a.slot[1][src];
  const int64_t exd = a.slot[2][src], end = a.slot[3][src];
  const bool xo = a.ok[0][src] != 0, eo = a.ok[1][src] != 0;
  int32_t* cov = (int32_t*)a.v[0].tab + slot * 8;
  int32_t* dist = (int32_t*)a.v[1].tab + slot * 8;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const bool x = xo && ex == j, e = eo && en == j;
    const int64_t dx = x ? exd : 0, de = e ? end : 0;
    ft_fold32(cov + j, (int32_t)x + (int32_t)e, 0);
    ft_fold32(dist + j, (int32_t)(dx > de ? dx : de), 1);
  }
}

// f(lane) for each of this thread's pending-or-marked lanes of the chunk
// at `base` (positions below `lim`). kRegs: at most one, held in `mine`;
// else positions tid, tid + nth, ..., their state in a.state.
template <bool kRegs, typename F>
__device__ __forceinline__ void ft_each(const FtUpArgs& a, FtLane& mine,
                                        int64_t base, int64_t lim, F f) {
  if (kRegs) {
    if (mine.st) f(mine);
    return;
  }
  const int64_t nth = (int64_t)gridDim.x * blockDim.x;
  for (int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; p < lim;
       p += nth) {
    const uint32_t st = a.state[p];
    if (!st) continue;  // settled, or never live
    FtLane l = ft_lane(a, p, base + p, st);
    f(l);
    if (l.st != st) a.state[p] = (uint8_t)l.st;
  }
}

// After a grid barrier: whether some block flagged `left` in the step
// before it (each flagging block bumps the counter once).
__device__ __forceinline__ bool ft_grid_any(const FtUpArgs& a, bool left,
                                            unsigned long long& seen,
                                            cg::grid_group& grid) {
  if (__syncthreads_or(left) && threadIdx.x == 0) atomicAdd(a.pend_ctr, 1ull);
  grid.sync();
  const unsigned long long now = *(volatile unsigned long long*)a.pend_ctr;
  const bool any = now != seen;
  seen = now;
  return any;
}

template <bool kRegs>
__global__ void __launch_bounds__(FT_UP_THREADS)
    ft_upsert_kernel(const __grid_constant__ FtUpArgs a) {
  __shared__ unsigned long long s_won, s_drop;
  cg::grid_group grid = cg::this_grid();
  const int64_t total = a.total ? *a.total : a.n;
  const int64_t chunks = total > 0 ? (total + a.K - 1) / a.K : 0;
  if (threadIdx.x == 0) {
    s_won = s_drop = 0ull;
    if (blockIdx.x == 0) {
      *a.pend_ctr = 0ull;
      *a.count_out = *a.count_in;
      *a.dropped_out = *a.dropped_in;
      if (a.lanes_out) {
        *a.lanes_out += total;
        *a.chunks_out += chunks;
      }
    }
  }
  grid.sync();

  const int64_t gtid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t won = 0, drop = 0;
  unsigned long long seen = 0ull;  // the grid's counter after a step
  FtLane mine;
  for (int64_t c = 0; c < chunks; ++c) {
    const int64_t base = c * a.K;
    const int64_t lim = total - base < a.K ? total - base : a.K;
    if (kRegs) {
      mine.st = 0u;
      if (gtid < lim) {
        const uint32_t st = ft_start(a, base + gtid);
        if (st) mine = ft_lane(a, gtid, base + gtid, st);
      }
    } else {
      const int64_t nth = (int64_t)gridDim.x * blockDim.x;
      for (int64_t p = gtid; p < lim; p += nth)
        a.state[p] = (uint8_t)ft_start(a, base + p);
    }

    bool settled = false;
    for (int r = 0; r < a.max_rounds; ++r) {
      // (a) the slot's keys at the round's start: empty or match
      ft_each<kRegs>(a, mine, base, lim, [&](FtLane& l) {
        const uint32_t s = ft_slot(a, l, r);
        const int32_t kh = a.keys_hi[s], kl = a.keys_lo[s];
        l.st = FT_ST_PENDING;
        if (kh == -1) {
          a.claim[s] = LLONG_MIN;
          l.st |= FT_ST_EMPTY;
        } else if (kh == (int32_t)l.hi && kl == (int32_t)l.lo) {
          l.st |= FT_ST_MATCH;
        }
      });
      grid.sync();
      // (b) the largest key claims each empty slot
      ft_each<kRegs>(a, mine, base, lim, [&](FtLane& l) {
        if (l.st & FT_ST_EMPTY) atomicMax(a.claim + ft_slot(a, l, r), l.key);
      });
      grid.sync();
      // (c) one winner writes the keys; every writer combines its values
      bool left = false;
      ft_each<kRegs>(a, mine, base, lim, [&](FtLane& l) {
        const uint32_t s = ft_slot(a, l, r);
        bool write = (l.st & FT_ST_MATCH) != 0;
        if ((l.st & FT_ST_EMPTY) && a.claim[s] == l.key) {
          if (atomicCAS((int*)a.keys_hi + s, -1, (int)l.hi) == -1) {
            a.keys_lo[s] = (int32_t)l.lo;
            ++won;
          }
          write = true;
        }
        if (write) {
          int v = 0;
          if (a.ok[0]) {
            ft_fold_junction(a, s, l.src);
            v = 2;
          }
          for (; v < a.n_vals; ++v) ft_fold_row(a.v[v], s, l.src);
        }
        l.st = write ? 0u : FT_ST_PENDING;
        left |= !write;
      });
      // stop when no lane of the grid is pending
      if (!ft_grid_any(a, left, seen, grid)) {
        settled = true;
        break;
      }
    }
    if (settled) continue;

    // lanes past max_rounds: dropped, once per key. Group slot: round 0's.
    for (;;) {
      ft_each<kRegs>(a, mine, base, lim, [&](FtLane& l) {
        a.claim[ft_slot(a, l, 0)] = LLONG_MIN;
      });
      grid.sync();
      ft_each<kRegs>(a, mine, base, lim, [&](FtLane& l) {
        atomicMax(a.claim + ft_slot(a, l, 0), l.key);
      });
      grid.sync();
      ft_each<kRegs>(a, mine, base, lim, [&](FtLane& l) {
        if (a.claim[ft_slot(a, l, 0)] == l.key) l.st |= FT_ST_EMPTY;
      });
      grid.sync();
      bool left = false;
      ft_each<kRegs>(a, mine, base, lim, [&](FtLane& l) {
        if (l.st & FT_ST_EMPTY) {
          long long* w = a.claim + ft_slot(a, l, 0);
          if (atomicCAS((unsigned long long*)w, (unsigned long long)l.key,
                        (unsigned long long)(l.key ^ 1ll)) ==
              (unsigned long long)l.key)
            ++drop;
          l.st = 0u;
        } else {
          left = true;
        }
      });
      if (!ft_grid_any(a, left, seen, grid)) break;
    }
  }

  if (won) atomicAdd(&s_won, (unsigned long long)won);
  if (drop) atomicAdd(&s_drop, (unsigned long long)drop);
  __syncthreads();
  if (threadIdx.x == 0) {
    if (s_won) atomicAdd((unsigned long long*)a.count_out, s_won);
    if (s_drop) atomicAdd((unsigned long long*)a.dropped_out, s_drop);
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

// Positions a chunk may hold for its lanes to stay in registers (one a
// thread of the largest grid the current card holds at once); past it
// the launch needs `state`. 0 when the query fails.
extern "C" int64_t ft_table_upsert_threads() {
  return (int64_t)ft_coresident_blocks<true>() * FT_UP_THREADS;
}

// keys_hi, keys_lo: int32 [cap + 1]; khi, klo: int64 by source. Direct:
// mask bool [n], idx and total null, K = n; listed: mask null, idx int64
// (>= *total entries), total int64 [] on the device, n ignored, K >= 1.
// state: uint8 [K] when K exceeds ft_table_upsert_threads(), else may be
// null; claim: int64 [cap + 2], any content; count_in, dropped_in,
// count_out, dropped_out: int64 []; lanes_out, chunks_out: int64 [] or
// null. slots: host array of 6 pointers (ex_slot, en_slot, ex_dist,
// en_dist int64; exit_ok, entry_ok bool) or null: then value arrays 0
// and 1 are cov8 and dist8, int32 [cap + 1, 8], built from them. vals:
// host array of n_vals rows (tab, in, s0, s1, width | is64 << 8 |
// is_max << 9).
extern "C" int ft_table_upsert(void* keys_hi, void* keys_lo, int64_t cap,
                               const void* khi, const void* klo,
                               const void* mask, const void* idx,
                               const void* total, int64_t n, int64_t K,
                               void* state, void* claim,
                               const void* count_in, const void* dropped_in,
                               void* count_out, void* dropped_out,
                               void* lanes_out, void* chunks_out,
                               int shard_bits, int max_rounds,
                               const int64_t* slots, int n_vals,
                               const int64_t* vals, void* stream) {
  if (cap <= 0 || (cap & (cap - 1)) || cap > (1ll << 31) || n < 0 ||
      K < 1 || (!total && K < n) || shard_bits < 0 || shard_bits > 16 ||
      (cap >> shard_bits) < 1 || max_rounds < 0 || n_vals < 0 ||
      n_vals > FT_UP_MAX_VALS || (slots && n_vals < 2) ||
      (!idx) != (!total) || (!lanes_out) != (!chunks_out))
    return (int)cudaErrorInvalidValue;
  FtUpArgs a;
  a.keys_hi = (int32_t*)keys_hi;
  a.keys_lo = (int32_t*)keys_lo;
  a.khi = (const int64_t*)khi;
  a.klo = (const int64_t*)klo;
  a.mask = (const uint8_t*)mask;
  a.idx = (const int64_t*)idx;
  a.total = (const int64_t*)total;
  a.n = n;
  a.K = K;
  a.state = (uint8_t*)state;
  a.claim = (long long*)claim;
  a.pend_ctr = (unsigned long long*)claim + cap + 1;
  a.count_in = (const int64_t*)count_in;
  a.dropped_in = (const int64_t*)dropped_in;
  a.count_out = (int64_t*)count_out;
  a.dropped_out = (int64_t*)dropped_out;
  a.lanes_out = (int64_t*)lanes_out;
  a.chunks_out = (int64_t*)chunks_out;
  for (int j = 0; j < 4; ++j)
    a.slot[j] = slots ? (const int64_t*)slots[j] : nullptr;
  for (int j = 0; j < 2; ++j)
    a.ok[j] = slots ? (const uint8_t*)slots[4 + j] : nullptr;
  const int64_t local_cap = cap >> shard_bits;
  a.local_mask = (uint32_t)(local_cap - 1);
  a.local_bits = 0;
  while ((1ll << a.local_bits) < local_cap) ++a.local_bits;
  a.shard_bits = shard_bits;
  a.max_rounds = max_rounds;
  a.n_vals = n_vals;
  for (int v = 0; v < FT_UP_MAX_VALS; ++v) {
    a.v[v] = {nullptr, nullptr, 0, 0, 0, 0, 0};
    if (v >= n_vals) continue;
    const int64_t* r = vals + 5 * v;
    const int desc = (int)r[4], w = desc & 0xFF;
    if (w != 1 && w != 4 && w != 8) return (int)cudaErrorInvalidValue;
    a.v[v] = {(void*)r[0], (const void*)r[1], r[2], r[3], w,
              (desc >> 8) & 1, (desc >> 9) & 1};
  }
  if (slots && (a.v[0].width != 8 || a.v[0].is64 || a.v[0].is_max ||
                a.v[1].width != 8 || a.v[1].is64 || !a.v[1].is_max))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  // one lane a thread while the card holds the grid
  int64_t grid = (K + FT_UP_THREADS - 1) / FT_UP_THREADS;
  const int fit_regs = ft_coresident_blocks<true>();
  if (fit_regs <= 0) return (int)cudaErrorLaunchOutOfResources;
  if (grid <= fit_regs) return ft_launch<true>(a, grid, s);
  if (!state) return (int)cudaErrorInvalidValue;
  const int fit = ft_coresident_blocks<false>();
  if (fit <= 0) return (int)cudaErrorLaunchOutOfResources;
  return ft_launch<false>(a, fit, s);
}
