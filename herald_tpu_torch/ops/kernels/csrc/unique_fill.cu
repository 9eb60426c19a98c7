// unique_fill for Hopper (sm_90a): JAX's jnp.unique(ids, size=size,
// fill_value=fill, return_inverse=True) for at most 8,192 int32 ids, in one
// launch.
//   uniq [size] int32: the sorted distinct ids, cut to `size` or padded
//                      with `fill`;
//   inv  [n] int64:    each id's rank among the distinct ids (`size` or
//                      more for an id cut off).
// The outputs are fixed by the maths, so they equal bit for bit those of
// the library chain it replaces on the card (ops/kernels/unique.py
// `unique_fill_ref`: sort, flags of each new id, their running count, two
// scatters, about a dozen launches).
//
// Replaces: no Pallas kernel. The JAX package's training steps call
// jnp.unique(size=...) (herald_tpu/train/engine.py:301-302), which XLA
// lowers to a sort and scans. On the H100 the library chain costs a
// launch and a dependent gap a node for 26 KB of keys; this kernel is one
// node.
//
// Bound on the card: latency. The bytes are the ids read once and uniq and
// inv written once (6,656 ids: 26.6 + 26.6 + 53.2 KB, 0.03 us at 3.35
// TB/s); what sets the time is the chain of block-wide steps, so the work
// is cut into parts that run side by side and the chain is kept short.
//
// Design: a cluster of 8 blocks of 1,024 threads; keys are the ids with the
// sign bit flipped, so unsigned order is the ids' signed order.
//   1. Every block reads every id and finds their range by a block-wide
//      min and max. A key's part is its eighth of the range, by a 32-bit
//      fixed-point scale (no division an id), so the keys of part c all
//      lie below those of part c + 1. Block c takes part c.
//   2. Each warp gathers its ids of the part into its own stretch of
//      shared memory (a ballot a round gives each its place, no shared
//      counter), then puts their keys into a hash table (8,192 slots of
//      key and mark, linear probing; a plain read before each 64-bit
//      atomicCAS, so a hot id's later copies take no atomic) and records
//      each id's slot beside its index. The lanes that fill a slot write
//      the key to the warp's stretch of fresh keys, and one scan of the
//      warps' counts packs those into the part's list of distinct keys.
//   3. A bitonic sort of the list, padded to a power of two with
//      0xffffffff: one key a thread up to 1,024 (a wdl step's part holds
//      300 to 1,000 distinct ids), up to 8 beyond, key i in thread i %
//      1,024. Partners 1 to 16 apart swap by shuffles, 32 to 512 apart
//      through shared memory (two buffers over the list's and the fresh
//      keys' bytes, one barrier a step), 1,024 and more apart within
//      the thread; up to 1,024 every step is unrolled. Key i of the sorted
//      list is the part's i-th distinct id: its slot, found again in the
//      table, records i.
//   4. The blocks share their distinct counts through distributed shared
//      memory: the counts of the parts before c are part c's first rank.
//      Block c writes uniq for its keys (where the rank is under `size`),
//      inv for its ids from their slots, and its share of the fill.
// Shared memory: the table (64 KB), the list, the fresh keys, the part's
// keys and its ids with their slots (32 KB each) and scratch, 192.3 KB,
// above the 48 KB a block takes without opting in:
// `herald_unique_fill_prepare` raises the limit, once a device, before the
// first launch there and outside any capture.
//
// Bound by a plain C interface and loaded with ctypes
// (herald_tpu_torch/ops/kernels/build.py, unique.py).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 8;
constexpr int kCapacity = kThreads * kPerThread;      // 8,192 ids
constexpr int kCluster = 8;                 // blocks, one part each
constexpr int kTableBits = 13;
constexpr int kTable = 1 << kTableBits;     // slots, one for every id
constexpr int kStretch = kPerThread * 32;   // the most ids a warp reads
constexpr unsigned kFull = 0xffffffffu;

// shared memory, in bytes from its start
constexpr int kTableAt = 0;                             // u64[kTable]
constexpr int kListAt = kTableAt + kTable * 8;          // u32[kCapacity]
constexpr int kSpareAt = kListAt + kCapacity * 4;       // u32[kCapacity]
constexpr int kPartKeysAt = kSpareAt + kCapacity * 4;   // u32[kCapacity]
constexpr int kPartIdsAt = kPartKeysAt + kCapacity * 4; // u32[kCapacity]
constexpr int kScratchAt = kPartIdsAt + kCapacity * 4;  // u32[2 * 32 + 3]
constexpr int kSmemBytes = kScratchAt + (2 * kWarps + 3) * 4;

static_assert(kTable >= kCapacity, "the table has a slot for every id");
static_assert(kTable * 2 <= kCapacity * 4,
              "the ranks by slot fit in the list's bytes");
static_assert(kSpareAt == kListAt + kCapacity * 4,
              "the sort's two buffers are the list and the spare bytes");
static_assert(kCapacity <= 1 << 16 && kTable <= 1 << 16,
              "an id's index and its slot share one word");

// A key's first slot in the table (Fibonacci hashing).
__device__ __forceinline__ uint32_t hash_slot(uint32_t key) {
  return (key * 2654435761u) >> (32 - kTableBits);
}

// One side of a bitonic compare-exchange: the element at index i keeps the
// smaller of (mine, other) where its run (k) is ascending and it is the
// lower of the pair (j), or neither, and the larger otherwise.
__device__ __forceinline__ uint32_t bitonic_keep(uint32_t mine,
                                                 uint32_t other, int i, int j,
                                                 int k) {
  const bool keep_min = ((i & k) == 0) == ((i & j) == 0);
  return keep_min == (mine < other) ? mine : other;
}

// The bitonic sort of `padded` keys, E of them a thread: key i is v[i /
// kThreads] of thread i % kThreads. Partners up to 16 apart swap by
// shuffles, 32 to 512 apart through `buf` (two buffers of kCapacity keys,
// one barrier a step), 1,024 and more apart within the thread.
template <int E>
__device__ __forceinline__ void bitonic(uint32_t (&v)[kPerThread],
                                        int padded, uint32_t* buf, int t) {
  int cur = 0;
  for (int k = 2; k <= padded; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j >= kThreads) {
#pragma unroll
        for (int b = 1; b < E; b <<= 1) {
          if (b * kThreads != j) continue;
#pragma unroll
          for (int e = 0; e < E; ++e) {
            if ((e ^ b) > e) {
              const int i = e * kThreads + t;
              const uint32_t lo = v[e], hi = v[e ^ b];
              v[e] = bitonic_keep(lo, hi, i, j, k);
              v[e ^ b] = bitonic_keep(hi, lo, i ^ j, j, k);
            }
          }
        }
      } else if (j >= 32) {
        uint32_t* s = buf + cur * kCapacity;
#pragma unroll
        for (int e = 0; e < E; ++e) s[e * kThreads + t] = v[e];
        __syncthreads();
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int i = e * kThreads + t;
          v[e] = bitonic_keep(v[e], s[i ^ j], i, j, k);
        }
        cur ^= 1;   // the next such step writes the other buffer
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          v[e] = bitonic_keep(v[e], __shfl_xor_sync(kFull, v[e], j),
                              e * kThreads + t, j, k);
        }
      }
    }
  }
}

// The same sort for 2^LOG <= kThreads keys, one a thread, every step
// known when it compiles.
template <int LOG>
__device__ __forceinline__ uint32_t bitonic_one(uint32_t x, uint32_t* buf,
                                                int t) {
  int cur = 0;
#pragma unroll
  for (int kk = 1; kk <= LOG; ++kk) {
#pragma unroll
    for (int jj = kk - 1; jj >= 0; --jj) {
      const int k = 1 << kk, j = 1 << jj;
      uint32_t other;
      if (j >= 32) {
        uint32_t* s = buf + cur * kCapacity;
        s[t] = x;
        __syncthreads();
        other = s[t ^ j];
        cur ^= 1;
      } else {
        other = __shfl_xor_sync(kFull, x, j);
      }
      x = bitonic_keep(x, other, t, j, k);
    }
  }
  return x;
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
unique_fill_kernel(const int32_t* __restrict__ ids, int n,
                   int32_t* __restrict__ uniq, int64_t size, int32_t fill,
                   int64_t* __restrict__ inv) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* s_table =
      reinterpret_cast<unsigned long long*>(smem + kTableAt);
  uint32_t* s_list = reinterpret_cast<uint32_t*>(smem + kListAt);
  // after the sort: the rank of each slot's key, over the list
  uint16_t* s_rank = reinterpret_cast<uint16_t*>(smem + kListAt);
  uint32_t* s_spare = reinterpret_cast<uint32_t*>(smem + kSpareAt);
  uint32_t* s_part_keys = reinterpret_cast<uint32_t*>(smem + kPartKeysAt);
  // an id's index in its low 16 bits, its slot in the high 16
  uint32_t* s_part_ids = reinterpret_cast<uint32_t*>(smem + kPartIdsAt);
  int* s_scratch = reinterpret_cast<int*>(smem + kScratchAt);
  uint32_t* s_min = reinterpret_cast<uint32_t*>(s_scratch);   // [kWarps]
  uint32_t* s_max = s_min + kWarps;                           // [kWarps]
  uint32_t* s_range = s_max + kWarps;                         // lo, hi
  int* s_distinct = s_scratch + 2 * kWarps + 2;

  cg::cluster_group cluster = cg::this_cluster();
  const int part = static_cast<int>(cluster.block_rank());
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;

  // 1. every id (id i in round i / kThreads), their range, and an empty
  //    table
  uint32_t key[kPerThread];
  uint32_t lo = kFull, hi = 0;
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const int i = r * kThreads + t;
    key[r] = 0;
    if (i < n) {
      key[r] = static_cast<uint32_t>(ids[i]) ^ 0x80000000u;
      lo = min(lo, key[r]);
      hi = max(hi, key[r]);
    }
  }
  for (int j = t; j < kTable; j += kThreads) s_table[j] = 0;
  lo = __reduce_min_sync(kFull, lo);
  hi = __reduce_max_sync(kFull, hi);
  if (lane == 0) {
    s_min[warp] = lo;
    s_max[warp] = hi;
  }
  __syncthreads();
  if (warp == 0) {
    lo = __reduce_min_sync(kFull, s_min[lane]);
    hi = __reduce_max_sync(kFull, s_max[lane]);
    if (lane == 0) {
      s_range[0] = lo;
      s_range[1] = hi;
    }
  }
  __syncthreads();
  // with n = 0 the range is empty and no id asks for its part
  lo = s_range[0];
  hi = s_range[1];
  const uint32_t span = hi - lo;
  // part = floor((key - lo) * scale / 2^32) < kCluster; a span under
  // kCluster gives each key value a part of its own
  const uint32_t scale =
      span >= kCluster
          ? static_cast<uint32_t>((static_cast<unsigned long long>(kCluster)
                                   << 32) / (span + 1ull))
          : 0u;

  // 2. each warp gathers its ids of this part into its own stretch, in
  //    id order (a ballot a round gives each its place), then puts their
  //    keys into the table, 32 at a time; a key that fills a slot goes on
  //    the warp's stretch of the spare bytes, and one scan of the warps'
  //    counts packs those stretches into the part's list of distinct keys
  const int stretch = warp * kStretch;
  const unsigned lower_lanes = (1u << lane) - 1;
  int part_count = 0;    // this warp's ids of the part
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const int i = r * kThreads + t;
    const uint32_t off = key[r] - lo;
    const bool in_part =
        i < n &&
        static_cast<int>(span < kCluster ? off : __umulhi(off, scale)) == part;
    const unsigned in_lanes = __ballot_sync(kFull, in_part);
    if (in_part) {
      const int at = stretch + part_count + __popc(in_lanes & lower_lanes);
      s_part_keys[at] = key[r];
      s_part_ids[at] = static_cast<uint32_t>(i);
    }
    part_count += __popc(in_lanes);
  }
  __syncwarp();
  int fresh_count = 0;   // keys this warp put in the table
  for (int base = 0; base < part_count; base += 32) {
    const int at = stretch + base + lane;
    bool fresh = false;
    uint32_t k = 0;
    if (base + lane < part_count) {
      k = s_part_keys[at];
      const unsigned long long entry =
          (static_cast<unsigned long long>(k) << 32) | 1ull;
      uint32_t h = hash_slot(k);
      while (true) {
        // a plain read first: copies of a key met after its insertion
        // take no atomic, so a hot id's copies do not queue on one slot
        unsigned long long old =
            *static_cast<volatile unsigned long long*>(&s_table[h]);
        if (old == 0) old = atomicCAS(&s_table[h], 0ull, entry);
        fresh = old == 0;
        if (old == 0 || old == entry) break;
        h = (h + 1) & (kTable - 1);
      }
      s_part_ids[at] |= h << 16;
    }
    const unsigned fresh_lanes = __ballot_sync(kFull, fresh);
    if (fresh) {
      s_spare[stretch + fresh_count + __popc(fresh_lanes & lower_lanes)] = k;
    }
    fresh_count += __popc(fresh_lanes);
  }
  if (lane == 0) s_scratch[warp] = fresh_count;
  __syncthreads();
  if (warp == 0) {
    const int w = s_scratch[lane];
    int wi = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(kFull, wi, o);
      if (lane >= o) wi += x;
    }
    s_scratch[lane] = wi - w;
    if (lane == 31) *s_distinct = wi;
  }
  __syncthreads();
  const int distinct = *s_distinct;
  {
    const int at = s_scratch[warp];
    for (int j = lane; j < fresh_count; j += 32) {
      s_list[at + j] = s_spare[stretch + j];
    }
  }
  __syncthreads();

  // 3. the bitonic sort of the list, padded to a power of two with kFull
  //    (a real kFull, the id 2^31 - 1, is the same value: it sorts last
  //    among the real keys either way); key i is element i / kThreads of
  //    thread i % kThreads
  const int padded = distinct > 1 ? 1 << (32 - __clz(distinct - 1)) : 1;
  uint32_t v[kPerThread];
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) {
    const int i = e * kThreads + t;
    v[e] = i < distinct ? s_list[i] : kFull;
  }
  __syncthreads();   // the list is read before the sort's buffers take it
  uint32_t* const buf = s_list;
  switch (31 - __clz(padded)) {
    case 0: break;
    case 1: v[0] = bitonic_one<1>(v[0], buf, t); break;
    case 2: v[0] = bitonic_one<2>(v[0], buf, t); break;
    case 3: v[0] = bitonic_one<3>(v[0], buf, t); break;
    case 4: v[0] = bitonic_one<4>(v[0], buf, t); break;
    case 5: v[0] = bitonic_one<5>(v[0], buf, t); break;
    case 6: v[0] = bitonic_one<6>(v[0], buf, t); break;
    case 7: v[0] = bitonic_one<7>(v[0], buf, t); break;
    case 8: v[0] = bitonic_one<8>(v[0], buf, t); break;
    case 9: v[0] = bitonic_one<9>(v[0], buf, t); break;
    case 10: v[0] = bitonic_one<10>(v[0], buf, t); break;
    case 11: bitonic<2>(v, padded, buf, t); break;
    case 12: bitonic<4>(v, padded, buf, t); break;
    default: bitonic<8>(v, padded, buf, t); break;
  }
  __syncthreads();   // the buffers are read before the ranks take them
  // key i's slot records rank i
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) {
    const int i = e * kThreads + t;
    if (i < distinct) {
      const unsigned long long entry =
          (static_cast<unsigned long long>(v[e]) << 32) | 1ull;
      uint32_t h = hash_slot(v[e]);
      while (s_table[h] != entry) h = (h + 1) & (kTable - 1);
      s_rank[h] = static_cast<uint16_t>(i);
    }
  }

  // 4. the counts of the parts before this one are its first rank
  cluster.sync();
  const int count =
      lane < kCluster ? *cluster.map_shared_rank(s_distinct, lane) : 0;
  int before = lane < part ? count : 0;
  int all = count;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    before += __shfl_xor_sync(kFull, before, o);
    all += __shfl_xor_sync(kFull, all, o);
  }
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) {
    const int i = e * kThreads + t;
    const int64_t k = static_cast<int64_t>(before) + i;
    if (i < distinct && k < size) {
      uniq[k] = static_cast<int32_t>(v[e] ^ 0x80000000u);
    }
  }
  for (int j = lane; j < part_count; j += 32) {
    const uint32_t id_slot = s_part_ids[stretch + j];
    inv[id_slot & 0xffffu] =
        static_cast<int64_t>(before) + s_rank[id_slot >> 16];
  }
  for (int64_t j = static_cast<int64_t>(all) + part * kThreads + t; j < size;
       j += kCluster * kThreads) {
    uniq[j] = fill;
  }
  cluster.sync();   // no block leaves while another reads its count
}

}  // namespace

// The most ids one launch takes.
extern "C" int herald_unique_fill_capacity() { return kCapacity; }

// Lets the kernel take its shared memory on the current device: once a
// device, before the first launch there, outside any stream capture.
// Returns the CUDA error (0 on success).
extern "C" int herald_unique_fill_prepare() {
  return static_cast<int>(cudaFuncSetAttribute(
      unique_fill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes));
}

// uniq [size] int32 and inv [n] int64 of ids [n] int32, n <= capacity, on
// `stream`. Returns cudaGetLastError() after the launch (0 on success);
// the caller raises on anything else.
extern "C" int herald_unique_fill(const void* ids, void* uniq, void* inv,
                                  int64_t n, int64_t size, int64_t fill,
                                  void* stream) {
  if (n < 0 || n > kCapacity || size < 0 || fill < INT32_MIN ||
      fill > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  unique_fill_kernel<<<kCluster, kThreads, kSmemBytes,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ids), static_cast<int>(n),
      static_cast<int32_t*>(uniq), size, static_cast<int32_t>(fill),
      static_cast<int64_t*>(inv));
  return static_cast<int>(cudaGetLastError());
}
