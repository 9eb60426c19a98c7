// K3 hot_onehot_push for Hopper (sm_90a): out[r] = sum of grads[i] over
// every position i with ids[i] == r, for r in [0, num_rows), in f32.
// Duplicates accumulate; ids outside [0, num_rows) are dropped; a row with
// no position is written as zeros. With a row map, position i's grad row
// is grads[map[i]] instead: a multi-hot step hands K3 the gradient of its
// pooled bags [B * bags, D] and each position's bag row, so the [N, D]
// copy of each position's gradient is never written (the grads read are
// then the pooled rows, B*bags*D*grad_bytes, and the map's N*4 bytes).
//
// Replaces: herald_tpu/ops/pallas/kernels.py `hot_onehot_push` (the
// pallas_call at :274). The Pallas kernel multiplies a bf16 one-hot
// [num_rows, N] by grads [N, D] on the MXU: O(num_rows * N * D) work, so it
// pays only while the segment space is a small hot block. On the H100 the
// function is a segmented reduction and nothing of the matmul carries over.
//
// Bound on the card: bytes. Each grad row is read once and each output row
// written once: N*D*grad_bytes + num_rows*D*4 + N*id_bytes. At DeepFM's
// training shape (N = 26,624, D = 513, num_rows ~ 11,100, f32) that is
// 77.6 MB, 0.023 ms at 3.35 TB/s; at wdl's (N = 6,656, D = 128, ~3,500
// rows) 5.2 MB, 1.6 us, where the launches set the pace.
//
// Design: five kernels after the wrapper's memset of the counters; no
// library sort, no float atomics, no wait on the host. A segment is the
// set of positions of one id.
//   1. count_ids: one thread per position; an integer atomicAdd on
//      counts[id] returns the position's slot in its segment.
//   2. alloc_segments: one thread per row; a block scans its rows' needs
//      and takes their ranges with one atomicAdd on each of two packed
//      cursors. A segment of at most 4 positions (an empty one included)
//      gets a warp unit; a longer one ceil(L/P) block pieces of at most
//      P = 32 positions; one of more than P positions ("long") also gets
//      an index and one partial row per piece.
//   3. place_positions: pos[offset[id] + slot] = position.
//   4. sort_big: segments of more than 512 positions are sorted ascending
//      by a block (bitonic network, in shared memory up to 8,192).
//   5. sum_segments: the first blocks loop over the block pieces; the rest
//      give each warp unit a warp.
//      - A piece finds its positions in ascending order: for a segment of
//        at most 512, each thread ranks positions against the whole
//        segment in shared memory and keeps those of the piece's ranks;
//        beyond that it reads its slice of the sorted segment. Each of the
//        8 warps sums a run of 4 of the piece's rows, and the runs are
//        added in shared memory in warp order. A piece of a short segment
//        writes the output row; a long segment's pieces write partial
//        rows, and the piece that finishes last (a fence and a per-segment
//        ticket) adds the partials, again in runs per warp added in warp
//        order, into the output row.
//      - A warp unit ranks its <= 4 positions by shuffles and sums them in
//        order.
//      Each lane owns a fixed set of columns, and a lane's loads for two
//      or more rows are in flight before their adds (16-byte loads where
//      D % 4 == 0 and the rows are aligned; one column a load otherwise,
//      as at D = 513 whose f32 rows are 4-byte aligned).
//
// Order of additions (the same bits on every launch; none depends on the
// order in which atomics or blocks ran): for each output row and column,
// - a segment of at most 4 positions: 0.0f + its rows in ascending
//   position order;
// - a segment of 5 to 32: its positions ascending, cut into runs of 4;
//   each run summed from 0.0f in order; the runs added to 0.0f in order;
// - a longer one: cut into pieces of 32 ascending positions, each summed
//   as above into a partial; the partials cut into 8 runs of ceil(pieces /
//   8), each summed from 0.0f in piece order; the runs added to 0.0f in
//   order.
// No thread sums more than 4 grad rows, nor more than ceil(N/256) partials.
//
// Bound by a plain C interface and loaded with ctypes
// (herald_tpu_torch/ops/kernels/build.py, segment.py). The wrapper
// allocates the scratch with the sizes of segment.scratch_sizes, which
// the launcher checks against its own layout.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kPiece = 32;          // P: most positions one block piece sums
constexpr int kWarpRows = 4;        // segments up to this size take a warp;
                                    // a piece gives each warp this many rows
constexpr int kRankMax = 512;       // pieces rank segments up to this size
constexpr int kThreads = 256;       // every kernel's block but the sort's
constexpr int kWarps = kThreads / 32;
constexpr int kSortThreads = 512;
constexpr int kSortShared = 8192;   // bigger segments sort in device memory

// Int32 scratch. `cursor`, `counts` and `piece_done` lie in the zeroed
// buffer; the rest is written before it is read.
struct Scratch {
  unsigned long long* cursor;  // [2] (positions, warp units),
                               //     (block pieces, long segments)
  int* counts;                 // [num_rows] positions per id
  int* piece_done;             // [max_long] pieces of a long segment done
  int4* unit;                  // [num_rows] warp unit {first slot,
                               //   positions, output row, 0}
  int4* piece;                 // [max_pieces] {first slot of its segment,
                               //   positions of the segment, piece number,
                               //   long index, or ~output row if short}
  int4* long_seg;              // [max_long] {output row, first piece,
                               //   positions, first slot}
  int* slot;                   // [n] a position's slot, -1 if dropped
  int* pos;                    // [n] positions grouped by segment
  int* seg_off;                // [num_rows] first slot of each segment
};

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
// bf16 held as its 16-bit pattern: the f32 with the same upper half
__device__ __forceinline__ float to_f32(uint16_t b) {
  return __uint_as_float(static_cast<uint32_t>(b) << 16);
}

__device__ __forceinline__ int lo32(unsigned long long x) {
  return static_cast<int>(x & 0xffffffffull);
}
__device__ __forceinline__ int hi32(unsigned long long x) {
  return static_cast<int>(x >> 32);
}

// ---------------------------------------------------------------------
// 1. counts and slots
// ---------------------------------------------------------------------

template <typename IdT>
__global__ void __launch_bounds__(kThreads)
count_ids(const IdT* __restrict__ ids, int64_t n, int64_t num_rows,
          Scratch s) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const int64_t id = static_cast<int64_t>(ids[i]);
  s.slot[i] = (id >= 0 && id < num_rows) ? atomicAdd(s.counts + id, 1) : -1;
}

// ---------------------------------------------------------------------
// 2. ranges of slots, units and pieces
// ---------------------------------------------------------------------

// Two packed pairs of 32-bit channels per row: a = (positions, warp
// units), b = (block pieces, long segments). No channel's total reaches
// 2^32, so the low half never carries into the high one. The block's
// exclusive scan plus the cursor's old value give each row its ranges;
// which block takes which range is left to the atomics and changes no
// result.
__global__ void __launch_bounds__(kThreads)
alloc_segments(int64_t num_rows, Scratch s) {
  __shared__ unsigned long long warp_a[kWarps], warp_b[kWarps];
  __shared__ unsigned long long base_a, base_b;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int len = r < num_rows ? s.counts[r] : 0;
  const int pieces = len > kWarpRows ? (len + kPiece - 1) / kPiece : 0;
  const bool is_long = len > kPiece;
  const unsigned long long a =
      r < num_rows ? (static_cast<unsigned long long>(len) |
                      (len <= kWarpRows ? 1ull << 32 : 0ull))
                   : 0ull;
  const unsigned long long b = static_cast<unsigned long long>(pieces) |
                               (is_long ? 1ull << 32 : 0ull);
  unsigned long long ia = a, ib = b;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned long long ta = __shfl_up_sync(0xffffffffu, ia, o);
    const unsigned long long tb = __shfl_up_sync(0xffffffffu, ib, o);
    if (lane >= o) {
      ia += ta;
      ib += tb;
    }
  }
  if (lane == 31) {
    warp_a[warp] = ia;
    warp_b[warp] = ib;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long ta = 0, tb = 0;
    for (int w = 0; w < kWarps; ++w) {
      const unsigned long long xa = warp_a[w], xb = warp_b[w];
      warp_a[w] = ta;
      warp_b[w] = tb;
      ta += xa;
      tb += xb;
    }
    base_a = atomicAdd(s.cursor, ta);
    base_b = atomicAdd(s.cursor + 1, tb);
  }
  __syncthreads();
  if (r >= num_rows) return;
  const unsigned long long ea = base_a + warp_a[warp] + ia - a;
  const unsigned long long eb = base_b + warp_b[warp] + ib - b;
  const int off = lo32(ea), row = static_cast<int>(r);
  s.seg_off[r] = off;
  if (len <= kWarpRows) {
    s.unit[hi32(ea)] = make_int4(off, len, row, 0);
    return;
  }
  const int first = lo32(eb), lidx = hi32(eb);
  if (is_long) s.long_seg[lidx] = make_int4(row, first, len, off);
  for (int q = 0; q < pieces; ++q) {
    s.piece[first + q] = make_int4(off, len, q, is_long ? lidx : ~row);
  }
}

// ---------------------------------------------------------------------
// 3. positions into their segments
// ---------------------------------------------------------------------

template <typename IdT>
__global__ void __launch_bounds__(kThreads)
place_positions(const IdT* __restrict__ ids, int64_t n, Scratch s) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const int slot = s.slot[i];
  if (slot >= 0) {
    s.pos[s.seg_off[static_cast<int64_t>(ids[i])] + slot] =
        static_cast<int>(i);
  }
}

// ---------------------------------------------------------------------
// 4. segments of more than kRankMax positions sorted ascending
// ---------------------------------------------------------------------

// Bitonic network in which every comparator puts the smaller value at the
// lower index; indices from len to len_p2 act as +infinity and are never
// touched. The whole block calls it.
__device__ void bitonic_sort(int* a, int len, int len_p2) {
  for (int k = 2; k <= len_p2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      const bool flip = j == (k >> 1);
      for (int c = threadIdx.x; c < (len_p2 >> 1); c += blockDim.x) {
        const int o = c & (j - 1);
        const int lo = (c - o) * 2;          // first index of the 2j-block
        const int i = lo + o;
        const int p = flip ? lo + 2 * j - 1 - o : i + j;
        if (p < len) {
          const int x = a[i], y = a[p];
          if (y < x) {
            a[i] = y;
            a[p] = x;
          }
        }
      }
      __syncthreads();
    }
  }
}

__global__ void __launch_bounds__(kSortThreads) sort_big(Scratch s) {
  __shared__ int buf[kSortShared];
  const int n_long = hi32(s.cursor[1]);
  for (int j = blockIdx.x; j < n_long; j += gridDim.x) {
    const int4 ls = s.long_seg[j];
    const int len = ls.z;
    if (len <= kRankMax) continue;
    int* seg = s.pos + ls.w;
    int len_p2 = 1;
    while (len_p2 < len) len_p2 <<= 1;
    if (len_p2 <= kSortShared) {
      for (int c = threadIdx.x; c < len; c += kSortThreads) buf[c] = seg[c];
      __syncthreads();
      bitonic_sort(buf, len, len_p2);
      for (int c = threadIdx.x; c < len; c += kSortThreads) seg[c] = buf[c];
      __syncthreads();
    } else {
      bitonic_sort(seg, len, len_p2);
    }
  }
}

// ---------------------------------------------------------------------
// 5. sums
// ---------------------------------------------------------------------

template <int VEC, bool kL2, typename T>
__device__ __forceinline__ Vec<T, VEC> load_vec(const T* p) {
  if constexpr (kL2) {      // f32 partials written by other blocks
    if constexpr (VEC == 4) {
      const float4 x = __ldcg(reinterpret_cast<const float4*>(p));
      return Vec<T, VEC>{{x.x, x.y, x.z, x.w}};
    } else {
      return Vec<T, VEC>{{__ldcg(p)}};
    }
  } else {
    return *reinterpret_cast<const Vec<T, VEC>*>(p);
  }
}

// acc[q][e] += row_of(i)[c0 + q*32*VEC + e] for i in [0, nrows), in order
// of i; R rows' loads are in flight before their adds.
template <int VEC, int CPT, bool kL2, typename T, typename RowOf>
__device__ __forceinline__ void add_rows(RowOf row_of, int nrows,
                                         int64_t dim, int64_t c0,
                                         float (&acc)[CPT][VEC]) {
  // rows whose loads are in flight together: a warp's run of 4 where a
  // lane takes fewer than 8 columns, 2 up to 17 columns, else 1
  constexpr int kCols = CPT * VEC;
  constexpr int R = kCols >= 32 ? 1 : kCols >= 8 ? 2 : 4;
  for (int i0 = 0; i0 < nrows; i0 += R) {
    Vec<T, VEC> v[R][CPT];
#pragma unroll
    for (int a = 0; a < R; ++a) {
      if (i0 + a < nrows) {
        const T* row = row_of(i0 + a);
#pragma unroll
        for (int q = 0; q < CPT; ++q) {
          const int64_t c = c0 + static_cast<int64_t>(q) * 32 * VEC;
          if (c < dim) v[a][q] = load_vec<VEC, kL2>(row + c);
        }
      }
    }
#pragma unroll
    for (int a = 0; a < R; ++a) {
      if (i0 + a < nrows) {
#pragma unroll
        for (int q = 0; q < CPT; ++q) {
          const int64_t c = c0 + static_cast<int64_t>(q) * 32 * VEC;
          if (c < dim) {
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[q][e] += to_f32(v[a][q].v[e]);
          }
        }
      }
    }
  }
}

template <int VEC, int CPT>
__device__ __forceinline__ void zero(float (&acc)[CPT][VEC]) {
#pragma unroll
  for (int q = 0; q < CPT; ++q)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[q][e] = 0.0f;
}

// One warp: dst = sum of rows (row_of, nrows) for every column, a slab of
// 32 * CPT * VEC columns at a time.
template <int VEC, int CPT, typename T, typename RowOf>
__device__ __forceinline__ void warp_sum(RowOf row_of, int nrows,
                                         int64_t dim, float* dst) {
  const int lane = threadIdx.x & 31;
  for (int64_t c0 = static_cast<int64_t>(lane) * VEC; c0 < dim;
       c0 += 32 * CPT * VEC) {
    float acc[CPT][VEC];
    zero(acc);
    add_rows<VEC, CPT, false, T>(row_of, nrows, dim, c0, acc);
#pragma unroll
    for (int q = 0; q < CPT; ++q) {
      const int64_t c = c0 + static_cast<int64_t>(q) * 32 * VEC;
      if (c < dim) {
        Vec<float, VEC> o;
#pragma unroll
        for (int e = 0; e < VEC; ++e) o.v[e] = acc[q][e];
        *reinterpret_cast<Vec<float, VEC>*>(dst + c) = o;
      }
    }
  }
}

// The whole block: warp w sums rows [w*per_warp, (w+1)*per_warp) of
// (row_of, nrows), and the warps' sums are added in warp order into dst.
template <int VEC, int CPT, bool kL2, typename T, typename RowOf>
__device__ __forceinline__ void block_sum(RowOf row_of, int nrows,
                                          int per_warp, int64_t dim,
                                          float* dst, float* red) {
  constexpr int kSlab = 32 * CPT * VEC;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = warp * per_warp;
  const int mine = max(0, min(per_warp, nrows - r0));
  const int warps = min(kWarps, (nrows + per_warp - 1) / per_warp);
  for (int64_t s0 = 0; s0 < dim; s0 += kSlab) {
    float acc[CPT][VEC];
    zero(acc);
    add_rows<VEC, CPT, kL2, T>([&](int i) { return row_of(r0 + i); }, mine,
                               dim, s0 + lane * VEC, acc);
#pragma unroll
    for (int q = 0; q < CPT; ++q)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        red[warp * kSlab + q * 32 * VEC + lane * VEC + e] = acc[q][e];
    __syncthreads();
    for (int t = threadIdx.x; t < kSlab; t += kThreads) {
      if (s0 + t < dim) {
        float x = 0.0f;
        for (int w = 0; w < warps; ++w) x += red[w * kSlab + t];
        dst[s0 + t] = x;
      }
    }
    __syncthreads();
  }
}

// The grad row of position p: p itself, or map[p] with a row map.
__device__ __forceinline__ int64_t grad_index(const int* __restrict__ rowmap,
                                              int p) {
  return static_cast<int64_t>(rowmap ? __ldg(rowmap + p) : p);
}

// A block piece: ranks [32k, 32k + cnt) of its segment's positions.
template <typename GradT, int VEC, int CPT>
__device__ __forceinline__ void sum_piece(
    int b, const GradT* __restrict__ grads,
    const int* __restrict__ rowmap, float* __restrict__ out,
    float* __restrict__ partials, int64_t dim, const Scratch& s, int* buf,
    int* rows, float* red, int* last) {
  const int4 pc = s.piece[b];   // {first slot, positions, piece, long/~row}
  const int len = pc.y, k = pc.z, tag = pc.w;
  const int cnt = min(kPiece, len - k * kPiece);
  if (len <= kRankMax) {
    for (int e = threadIdx.x; e < len; e += kThreads) buf[e] = s.pos[pc.x + e];
    __syncthreads();
    for (int e = threadIdx.x; e < len; e += kThreads) {
      const int v = buf[e];
      int rank = 0;
      for (int x = 0; x < len; ++x) rank += buf[x] < v;
      const int d = rank - k * kPiece;
      if (d >= 0 && d < cnt) rows[d] = v;
    }
  } else if (static_cast<int>(threadIdx.x) < cnt) {    // sorted by sort_big
    rows[threadIdx.x] = s.pos[pc.x + k * kPiece + threadIdx.x];
  }
  __syncthreads();
  const auto grad_row = [&](int i) {
    return grads + grad_index(rowmap, rows[i]) * dim;
  };
  if (tag < 0) {
    block_sum<VEC, CPT, false, GradT>(grad_row, cnt, kWarpRows, dim,
                                      out + static_cast<int64_t>(~tag) * dim,
                                      red);
    return;
  }
  const int4 ls = s.long_seg[tag];   // {row, first piece, positions, slot}
  block_sum<VEC, CPT, false, GradT>(
      grad_row, cnt, kWarpRows, dim,
      partials + static_cast<int64_t>(ls.y + k) * dim, red);
  // the segment's last piece to finish adds the partials in piece order
  const int pieces = (len + kPiece - 1) / kPiece;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    *last = atomicAdd(s.piece_done + tag, 1) == pieces - 1;
  }
  __syncthreads();
  if (!*last) return;
  __threadfence();
  const float* part = partials + static_cast<int64_t>(ls.y) * dim;
  block_sum<VEC, CPT, true, float>(
      [&](int q) { return part + static_cast<int64_t>(q) * dim; }, pieces,
      (pieces + kWarps - 1) / kWarps, dim,
      out + static_cast<int64_t>(ls.x) * dim, red);
}

// Blocks [0, workers) loop over the block pieces; the others take kWarps
// warp units each.
template <typename GradT, int VEC, int CPT>
__global__ void __launch_bounds__(kThreads)
sum_segments(const GradT* __restrict__ grads, const int* __restrict__ rowmap,
             float* __restrict__ out, float* __restrict__ partials,
             int64_t dim, int workers, Scratch s) {
  __shared__ int buf[kRankMax];
  __shared__ int rows[kWarps][kPiece];
  __shared__ float red[kWarps * 32 * CPT * VEC];
  __shared__ int last;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (static_cast<int>(blockIdx.x) < workers) {
    const int total = lo32(s.cursor[1]);
    for (int b = blockIdx.x; b < total; b += workers) {
      sum_piece<GradT, VEC, CPT>(b, grads, rowmap, out, partials, dim, s,
                                 buf, rows[0], red, &last);
      __syncthreads();
    }
    return;
  }
  const int64_t u =
      static_cast<int64_t>(blockIdx.x - workers) * kWarps + warp;
  if (u >= hi32(s.cursor[0])) return;   // the whole warp
  const int4 d = s.unit[u];             // {first slot, positions, row, 0}
  const int p = lane < d.y ? s.pos[d.x + lane] : INT_MAX;
  int rank = 0;
#pragma unroll
  for (int l = 0; l < kWarpRows; ++l) {
    rank += __shfl_sync(0xffffffffu, p, l) < p;
  }
  int* mine = rows[warp];
  if (lane < d.y) mine[rank] = p;
  __syncwarp();
  warp_sum<VEC, CPT, GradT>(
      [&](int i) { return grads + grad_index(rowmap, mine[i]) * dim; },
      d.y, dim, out + static_cast<int64_t>(d.z) * dim);
}

// Column vectors a lane takes per slab; 17 covers DeepFM's fused width
// 513 in one slab. At most 32 f32 accumulators a lane (wider slabs
// spill registers).
template <typename GradT, int VEC>
void launch_sum(const void* grads, const int* rowmap, void* out,
                void* partials, int64_t dim, int64_t num_rows, int workers,
                const Scratch& s, cudaStream_t stream) {
  const int64_t per_lane = (dim / VEC + 31) / 32;
  const dim3 grid(static_cast<unsigned>(
      workers + (num_rows + kWarps - 1) / kWarps));
  const GradT* g = static_cast<const GradT*>(grads);
  float* o = static_cast<float*>(out);
  float* p = static_cast<float*>(partials);
#define HERALD_SUM(V, C)                                                 \
  sum_segments<GradT, V, C><<<grid, kThreads, 0, stream>>>(              \
      g, rowmap, o, p, dim, workers, s)
  if (per_lane <= 1) {
    HERALD_SUM(VEC, 1);
  } else if (per_lane <= 2) {
    HERALD_SUM(VEC, 2);
  } else if (per_lane <= 4) {
    HERALD_SUM(VEC, 4);
  } else if (VEC == 4 || per_lane <= 8) {
    HERALD_SUM(VEC, 8);
  } else {
    HERALD_SUM(1, 17);
  }
#undef HERALD_SUM
}

template <typename IdT>
void launch_grouping(const void* ids, int64_t n, int64_t num_rows,
                     const Scratch& s, cudaStream_t stream) {
  const IdT* id = static_cast<const IdT*>(ids);
  const unsigned pos_blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  if (n > 0) {
    count_ids<IdT><<<pos_blocks, kThreads, 0, stream>>>(id, n, num_rows, s);
  }
  alloc_segments<<<static_cast<unsigned>((num_rows + kThreads - 1) / kThreads),
                   kThreads, 0, stream>>>(num_rows, s);
  if (n > 0) {
    place_positions<IdT><<<pos_blocks, kThreads, 0, stream>>>(id, n, s);
  }
  if (n > kRankMax) {
    sort_big<<<static_cast<unsigned>(n / (kRankMax + 1)), kSortThreads, 0,
               stream>>>(s);
  }
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount,
                               dev) != cudaSuccess) {
      count = 132;
    }
  }
  return count;
}

}  // namespace

// grad_code: 0 = float32, 1 = bfloat16. `rowmap` is null, or int32 [n]:
// position i sums grads[rowmap[i]] (each in [0, rows of grads)), so grads
// need not have n rows. `zeroed` holds zero_words int32
// set to 0 by the caller, `scratch` plain_words int32, both 16-byte
// aligned; `partials` partial_rows * dim f32: the sizes of
// segment.scratch_sizes(n, num_rows), checked here against this layout.
// Returns cudaGetLastError() after the launches (0 on success); the caller
// raises on anything else.
extern "C" int herald_hot_onehot_push(
    const void* ids, const void* grads, const void* rowmap, void* out,
    void* zeroed, void* scratch, void* partials, int64_t n, int64_t num_rows,
    int64_t dim,
    int64_t zero_words, int64_t plain_words, int64_t partial_rows,
    int grad_code, int ids_int64, void* stream) {
  const int64_t max_pieces = n / (kWarpRows + 1);
  const int64_t max_long = n / (kPiece + 1);
  if (n < 0 || n >= INT_MAX || num_rows <= 0 || num_rows >= INT_MAX ||
      dim <= 0 || (grad_code != 0 && grad_code != 1) ||
      reinterpret_cast<uintptr_t>(zeroed) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0 ||
      zero_words != 4 + num_rows + max_long ||
      plain_words != 4 * (num_rows + max_pieces + max_long) + 2 * n +
                         num_rows ||
      partial_rows != (max_pieces > 1 ? max_pieces : 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int* z = static_cast<int*>(zeroed);
  int* w = static_cast<int*>(scratch);
  Scratch s;
  s.cursor = reinterpret_cast<unsigned long long*>(z);
  s.counts = z + 4;
  s.piece_done = s.counts + num_rows;
  s.unit = reinterpret_cast<int4*>(w);
  s.piece = s.unit + num_rows;
  s.long_seg = s.piece + max_pieces;
  s.slot = reinterpret_cast<int*>(s.long_seg + max_long);
  s.pos = s.slot + n;
  s.seg_off = s.pos + n;

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* map = static_cast<const int*>(rowmap);
  if (ids_int64) {
    launch_grouping<int64_t>(ids, n, num_rows, s, st);
  } else {
    launch_grouping<int32_t>(ids, n, num_rows, s, st);
  }
  // blocks that loop over the block pieces: 4 a multiprocessor at most
  const int64_t want = 4 * static_cast<int64_t>(sm_count());
  const int workers = static_cast<int>(max_pieces < want ? max_pieces : want);

  const int64_t elem = grad_code == 0 ? 4 : 2;
  // 4 columns a load when every grad row and output row starts on a
  // multiple of them: D % 4 == 0 and aligned bases
  const bool vec4 = dim % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(grads) % (4 * elem) == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(partials) % 16 == 0;
  if (grad_code == 0) {
    if (vec4) {
      launch_sum<float, 4>(grads, map, out, partials, dim, num_rows, workers,
                           s, st);
    } else {
      launch_sum<float, 1>(grads, map, out, partials, dim, num_rows, workers,
                           s, st);
    }
  } else {
    if (vec4) {
      launch_sum<uint16_t, 4>(grads, map, out, partials, dim, num_rows,
                              workers, s, st);
    } else {
      launch_sum<uint16_t, 1>(grads, map, out, partials, dim, num_rows,
                              workers, s, st);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
