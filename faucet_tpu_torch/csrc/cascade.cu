// Bloom-cascade insert (A = seen once, B = solid) for Hopper (sm_90a),
// without a sort.
//
// Replaces the Pallas TPU kernel faucet_tpu/kernels/cascade.py
// cascade_insert_fused in all three of its bodies (dense _kernel_v2,
// sparse _kernel_sparse, multi-tile _kernel), with the hashing and block
// addressing around it. Those walk the keys one by one in VMEM. This port
// computes the formulation the reference runs on its CPU backend
// (faucet_tpu/core/bloom.py cascade_insert_nbs, whose plain torch twin is
// kernels/cascade.py cascade_insert_plain): per distinct live key of the
// batch, with in_a / in_b its membership in the PRE-batch filters and
// first its first in-batch lane,
//   not in_a                  -> OR its bits into A
//   in_a or a second lane     -> OR its bits into B
//   new_b[first] = added to B and not in_b
//   solid[lane]  = in_a or in_b or lane != first   (every live lane)
// A lane is live when its mask is set and hi != 0xFFFFFFFF (the
// reference's sort marks masked lanes with that key).
//
// Design: three launches, none of them a sort.
//   1. count: a thread per lane. Each warp gathers its live lanes with a
//      ballot and probes pre-batch A and B for them eight at a time, a
//      quad of four threads per key (bloom_bits.cuh ft_warp_probe;
//      nothing writes a filter in this launch). Then each live lane finds or
//      claims its key's slot in a scratch open-addressing table with a
//      64-bit atomicCAS and folds its lane into the slot's first lane
//      (atomicMin) and last lane (atomicMin of the complement): a key has
//      a second lane exactly when they differ. The lane keeps its slot and
//      its two probe bits in a 4-byte lane word.
//   2. apply: each live lane reads its slot; the key's first lane ORs the
//      bits into A and/or B (atomicOr) and marks its lane word; every lane
//      writes new_b and solid at its own index (no permutation).
//   3. clear: each marked first lane resets its slot, so the table is
//      clean for the next call without a memset of all of it.
// Dead lanes cost a mask byte and no probe, so a mostly masked batch (the
// node-endpoint inserts, ~3% live) costs about its live lanes, with no
// compaction and no host sync. atomicMin and OR commute, so the result
// does not depend on the order the atomics land in: CUDA equals the plain
// version bit for bit.
//
// Table: n_slots, a power of two with n <= 0.6 * n_slots (load factor at
// most 0.6 even if every lane is live and distinct), slots of 16 bytes
// {key u64, first u32, ~last u32}, all ones when empty; linear probing
// from fmix32(h1 ^ h2), so a probe chain stays in one or two 128-byte
// lines. At the dense load shape (573,440 lanes) that is 2**20 slots,
// 16 MB, which with A (16 MB), B (4 MB) and the lane words (2.3 MB) fits
// the 50 MB L2.
//
// Bound: bytes. Per lane 16 bytes of code, a mask byte and two output
// bytes; per distinct key a random 64-byte block of A and of B read, and
// written where bits are added, and a slot touched three times. What
// matters on this card is that the filters and the table stay L2-resident
// and that every lane is in flight at once; shared memory and TMA buy
// nothing for random single-block accesses with no reuse inside a block.
#include <cuda_runtime.h>

#include "bloom_bits.cuh"

// lane word: slot << 2 | in_b << 1 | in_a, FT_FIRST on the key's first
// lane once the apply launch has found it (slots < 2**29), FT_DEAD for a
// dead lane
#define FT_DEAD 0xFFFFFFFFu
#define FT_FIRST 0x80000000u
#define FT_EMPTY 0xFFFFFFFFFFFFFFFFull

struct __align__(16) FtSlot {
  unsigned long long key;
  unsigned int first;  // least lane of the key
  unsigned int nlast;  // complement of the greatest lane of the key
};

struct FtCascade {
  uint32_t* a;
  uint32_t* b;
  uint64_t n_blocks_a, n_blocks_b;
  const int64_t* khi;
  const int64_t* klo;
  const bool* mask;
  int64_t n;
  int local_a, local_b, shard_bits, n_hash_a, n_hash_b;
  FtSlot* table;
  uint32_t slot_mask;
  uint32_t* lanes;
  bool* new_b;
  bool* solid;
};

__global__ void ft_cascade_count_kernel(FtCascade c) {
  // a warp takes 32 consecutive lanes; the loop bound is the same for all
  // its threads, so the warp-wide shuffles below see every thread
  const uint32_t lane = threadIdx.x & 31u;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t base = (int64_t)blockIdx.x * blockDim.x + (threadIdx.x - lane);
       base < c.n; base += stride) {
    const int64_t i = base + lane;
    uint32_t hi = 0u, lo = 0u;
    bool live = false;
    if (i < c.n && c.mask[i]) {
      hi = (uint32_t)c.khi[i];
      live = hi != FT_SENTINEL;
      if (live) lo = (uint32_t)c.klo[i];
    }
    if (i < c.n && !live) c.lanes[i] = FT_DEAD;
    // pre-batch A and B, for the warp's live lanes together
    const FtFilter fa = {c.a, c.n_blocks_a, c.local_a, c.n_hash_a};
    const FtFilter fb = {c.b, c.n_blocks_b, c.local_b, c.n_hash_b};
    const uint32_t probe = ft_warp_probe(live, hi, lo, fa, fb, true,
                                         c.shard_bits);
    if (!live) continue;
    const FtAddr h = ft_hash(hi, lo);
    const unsigned long long key = ((unsigned long long)hi << 32) | lo;
    uint32_t s = ft_fmix32(h.h1 ^ h.h2) & c.slot_mask;
    for (;;) {
      const unsigned long long cur =
          atomicCAS(&c.table[s].key, FT_EMPTY, key);
      if (cur == FT_EMPTY || cur == key) break;
      s = (s + 1) & c.slot_mask;
    }
    // results unused: reductions the thread does not wait for
    atomicMin(&c.table[s].first, (uint32_t)i);
    atomicMin(&c.table[s].nlast, ~(uint32_t)i);
    c.lanes[i] = (s << 2) | probe;
  }
}

__global__ void ft_cascade_apply_kernel(FtCascade c) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < c.n;
       i += stride) {
    const uint32_t w = c.lanes[i];
    if (w == FT_DEAD) {
      c.new_b[i] = false;
      c.solid[i] = false;
      continue;
    }
    // the slot's first lane and complemented last lane, in one load
    const uint2 fl =
        *reinterpret_cast<const uint2*>(&c.table[w >> 2].first);
    const bool pa = w & 1u, pb = w & 2u;
    const bool first = fl.x == (uint32_t)i;
    bool nb = false;
    if (first) {
      const bool add_b = pa || ~fl.y != fl.x;
      const FtAddr h = ft_hash((uint32_t)c.khi[i], (uint32_t)c.klo[i]);
      const uint32_t ba = ft_block(h.h1, c.local_a, c.shard_bits);
      const uint32_t bb = ft_block(h.h1, c.local_b, c.shard_bits);
      if (!pa && ba < c.n_blocks_a)
        ft_block_or(c.a, ba, h.h1r, h.h2, c.n_hash_a);
      if (add_b && bb < c.n_blocks_b)
        ft_block_or(c.b, bb, h.h1r, h.h2, c.n_hash_b);
      nb = add_b && !pb;
      c.lanes[i] = w | FT_FIRST;  // tells the clear launch to reset it
    }
    c.new_b[i] = nb;
    c.solid[i] = pa || pb || !first;
  }
}

__global__ void ft_cascade_clear_kernel(FtCascade c) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < c.n;
       i += stride) {
    const uint32_t w = c.lanes[i];
    if (w != FT_DEAD && (w & FT_FIRST))
      *reinterpret_cast<uint4*>(c.table + ((w & ~FT_FIRST) >> 2)) =
          make_uint4(0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu);
  }
}

extern "C" int ft_cascade_insert(void* a_words, int64_t n_words_a,
                                 void* b_words, int64_t n_words_b,
                                 const void* khi, const void* klo,
                                 const void* mask, int64_t n, int local_a,
                                 int local_b, int shard_bits, int n_hash_a,
                                 int n_hash_b, void* table, int64_t n_slots,
                                 void* lanes, void* new_b, void* solid,
                                 void* stream) {
  if (n <= 0) return 0;
  FtCascade c;
  c.a = (uint32_t*)a_words;
  c.b = (uint32_t*)b_words;
  c.n_blocks_a = (uint64_t)(n_words_a / FT_BLOCK_WORDS);
  c.n_blocks_b = (uint64_t)(n_words_b / FT_BLOCK_WORDS);
  c.khi = (const int64_t*)khi;
  c.klo = (const int64_t*)klo;
  c.mask = (const bool*)mask;
  c.n = n;
  c.local_a = local_a;
  c.local_b = local_b;
  c.shard_bits = shard_bits;
  c.n_hash_a = n_hash_a;
  c.n_hash_b = n_hash_b;
  c.table = (FtSlot*)table;
  c.slot_mask = (uint32_t)(n_slots - 1);
  c.lanes = (uint32_t*)lanes;
  c.new_b = (bool*)new_b;
  c.solid = (bool*)solid;
  const int threads = 256;
  int64_t grid = (n + threads - 1) / threads;
  if (grid > (1 << 20)) grid = 1 << 20;
  cudaStream_t st = (cudaStream_t)stream;
  ft_cascade_count_kernel<<<(unsigned)grid, threads, 0, st>>>(c);
  int err = (int)cudaGetLastError();
  if (err) return err;
  ft_cascade_apply_kernel<<<(unsigned)grid, threads, 0, st>>>(c);
  err = (int)cudaGetLastError();
  if (err) return err;
  ft_cascade_clear_kernel<<<(unsigned)grid, threads, 0, st>>>(c);
  return (int)cudaGetLastError();
}
