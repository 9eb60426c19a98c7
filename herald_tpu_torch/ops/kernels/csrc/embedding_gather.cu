// K1 embedding_gather for Hopper (sm_90a): out[i] = table[ids[i]], with a
// zero row for any id outside [0, R), written in the table's dtype or
// widened from bf16 to f32.
//
// Replaces: herald_tpu/ops/pallas/kernels.py `embedding_gather` (the
// pallas_call at :104). The Pallas kernel moves the whole 8-row tile group
// around each id and selects the row with an iota mask, because Mosaic
// tiles device memory in (8, 128) groups. Nothing of that carries over:
// a Hopper load can address any 16 bytes, so each row is copied directly.
//
// Bound on the card: bytes. The gather does no arithmetic. It reads the
// ids and the rows and writes N output rows; a row that several positions
// of a batch read comes from the 50 MB L2 after the first, so the bound
// counts each distinct row once: U*D*table_elem + N*D*out_elem +
// N*id_bytes. Read by position with f32 output, that is 0.89 + 3.41 +
// 0.03 MB at the wdl serving shape (6,656 positions, ~3,490 distinct,
// D = 128, bf16 table), 1.3 us at 3.35 TB/s, and 11.4 + 54.6 + 0.1 MB at
// the dfm shape (26,624 positions, D = 513), 19.7 us.
//
// Design:
//   - a group of L lanes per row, L = 8, 16 or 32: the fewest that cover
//     the output row's 16-byte vectors, up to a warp; 256 threads a block.
//     At D = 128 with bf16 output (16 vectors) two rows share a warp;
//   - each output row is written in three parts: a scalar head up to its
//     first 16-byte boundary (0-3 f32 or 0-7 bf16 elements), aligned
//     16-byte vector stores, and a scalar tail. Stores go to L2 whole and
//     coalesced: a warp's vector stores fill 16 whole sectors;
//   - the source of a vector (8 bytes of bf16 widened to 4 f32, or 16 bytes
//     copied) lies at an address whose residue modulo 16 is the same for
//     every vector of the row. The row dispatches once on it, and a lane
//     loads in the widest aligned pieces (row_access.cuh). At D = 513 a
//     bf16 row (1,026 bytes) starts at any even address, so its pieces are
//     2 to 16 bytes wide; loads that split a sector are served from L1;
//   - a lane issues every load of its row, head and tail included, before
//     its first store (up to 4 vectors, `kUnroll`), so a row costs one
//     round trip to memory, not one per part;
//   - bf16 -> f32 shifts the 16 bits up, which is exact, so the kernel
//     equals `table[ids].to(float32)` (and the zero rows) bit for bit;
//   - ids are int32 or int64; an id < 0 or >= R writes a zero row (the
//     mode="fill" read of the JAX engine), and R need not be a multiple
//     of 8.
//
// The pooled form, gather_pool_rows (no Pallas counterpart: the JAX
// package has no multi-hot model): out[b, k] = the f32 sum of the rows of
// sample b's bag k, positions [offsets[k], offsets[k + 1]) of its P ids,
// in position order, an id outside [0, R) adding a zero row. A multi-hot
// step (DLRM-DCNv2's 214 ids in 26 bags a sample) read by position would
// write [B, P, D] and read it again to pool; this writes [B, bags, D]
// alone. Bound on the card: bytes, each distinct row read once (later
// reads of a row come from L2), the ids once and the pooled rows written
// once: at DLRM-DCNv2's step (B = 8,192, 1,753,088 ids of which about
// 264,000 distinct, D = 128 f32) 0.14 GB of rows, 7 MB of ids and 109 MB
// of output, 0.075 ms at 3.35 TB/s. Design:
//   - K1's group of L lanes per output row, each lane holding its 16-byte
//     vectors of the row in f32 registers across the bag;
//   - the bag's first row is the sum's start, not 0 + row, so a bag of 1
//     writes K1's bits (a -0.0 stays -0.0), and each later row is added
//     in position order: the same bits as the plain version's sum;
//   - a lane issues the loads of kPoolUnroll positions before it adds
//     them, so a long bag (100 ids) keeps several rows in flight;
//   - a width that 4 does not divide, or an unaligned base, takes a
//     scalar loop that adds in the same order.
//
// Bound by a plain C interface and loaded with ctypes
// (herald_tpu_torch/ops/kernels/build.py, gather.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "row_access.cuh"

namespace {

constexpr int kThreads = 256;

constexpr int kUnroll = 4;   // vectors a lane loads before it stores any

// one element in the output dtype (bf16 is held as its 16 bits)
template <typename DstT, typename SrcT>
__device__ __forceinline__ DstT convert(SrcT x) {
  if constexpr (sizeof(SrcT) < sizeof(DstT)) {
    return herald::bf16_to_f32(x);
  } else {
    return x;
  }
}

// the 16 output bytes of one vector from the source words it reads: the
// same 4 words, or 4 bf16 widened to 4 f32 (each 16-bit half moved to the
// upper half of a word)
template <typename SrcT, typename DstT>
__device__ __forceinline__ uint4 to_vector(const uint32_t* w) {
  if constexpr (sizeof(SrcT) < sizeof(DstT)) {
    return make_uint4(w[0] << 16, w[0] & 0xffff0000u, w[1] << 16,
                      w[1] & 0xffff0000u);
  } else {
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
}

template <typename SrcT, typename DstT, int L, typename IdT>
__global__ void __launch_bounds__(kThreads)
gather_rows(const SrcT* __restrict__ table, const IdT* __restrict__ ids,
            DstT* __restrict__ out, int64_t rows, int64_t dim, int64_t n) {
  constexpr int kRowsPerBlock = kThreads / L;
  constexpr int kVec = 16 / sizeof(DstT);    // elements a vector stores
  constexpr int kIn = kVec * sizeof(SrcT);   // source bytes they come from
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock +
                    threadIdx.x / L;
  if (i >= n) return;
  const int lane = threadIdx.x % L;
  const int64_t id = static_cast<int64_t>(ids[i]);
  DstT* dst = out + i * dim;
  if (id < 0 || id >= rows) {
    for (int64_t e = lane; e < dim; e += L) dst[e] = DstT{};
    return;
  }
  const SrcT* src = table + id * dim;
  // head: up to the output row's first 16-byte boundary; then whole
  // vectors; then a tail. Both are shorter than a vector, and L >= kVec,
  // so a lane holds at most one element of each.
  const int64_t to_boundary =
      ((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15) / sizeof(DstT);
  const int64_t head = to_boundary < dim ? to_boundary : dim;
  const int64_t nvec = (dim - head) / kVec;
  const int64_t tail = head + nvec * kVec;
  const bool has_head = lane < head;
  const bool has_tail = lane < dim - tail;
  // every load of the row is issued before any store
  SrcT head_x{}, tail_x{};
  if (has_head) head_x = __ldg(src + lane);
  if (has_tail) tail_x = __ldg(src + tail + lane);
  const char* vsrc = reinterpret_cast<const char*>(src + head);
  uint4* vdst = reinterpret_cast<uint4*>(dst + head);
  const int residue =
      static_cast<int>(reinterpret_cast<uintptr_t>(vsrc) & 15);
  herald::dispatch_residue<sizeof(SrcT)>(residue, [&](auto res) {
    constexpr int R = decltype(res)::value;
    for (int64_t v0 = lane; v0 < nvec; v0 += kUnroll * L) {
      uint32_t w[kUnroll][kIn / 4] = {};
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (v0 + u * L < nvec) {
          herald::load_run<R, kIn>(vsrc + (v0 + u * L) * kIn, w[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (v0 + u * L < nvec) {
          vdst[v0 + u * L] = to_vector<SrcT, DstT>(w[u]);
        }
      }
    }
  });
  if (has_head) dst[lane] = convert<DstT>(head_x);
  if (has_tail) dst[tail + lane] = convert<DstT>(tail_x);
}

template <typename SrcT, typename DstT, int L>
void launch(const void* table, const void* ids, void* out, int64_t rows,
            int64_t dim, int64_t n, int ids_int64, cudaStream_t stream) {
  constexpr int64_t kRowsPerBlock = kThreads / L;
  const dim3 grid(static_cast<unsigned>((n + kRowsPerBlock - 1) /
                                        kRowsPerBlock));
  const SrcT* t = static_cast<const SrcT*>(table);
  DstT* o = static_cast<DstT*>(out);
  if (ids_int64) {
    gather_rows<SrcT, DstT, L, int64_t><<<grid, kThreads, 0, stream>>>(
        t, static_cast<const int64_t*>(ids), o, rows, dim, n);
  } else {
    gather_rows<SrcT, DstT, L, int32_t><<<grid, kThreads, 0, stream>>>(
        t, static_cast<const int32_t*>(ids), o, rows, dim, n);
  }
}

template <typename SrcT, typename DstT>
void dispatch_lanes(const void* table, const void* ids, void* out,
                    int64_t rows, int64_t dim, int64_t n, int ids_int64,
                    cudaStream_t stream) {
  // 16-byte vectors in an output row
  const int64_t vectors =
      (dim * static_cast<int64_t>(sizeof(DstT)) + 15) / 16;
  if (vectors <= 8) {
    launch<SrcT, DstT, 8>(table, ids, out, rows, dim, n, ids_int64, stream);
  } else if (vectors <= 16) {
    launch<SrcT, DstT, 16>(table, ids, out, rows, dim, n, ids_int64, stream);
  } else {
    launch<SrcT, DstT, 32>(table, ids, out, rows, dim, n, ids_int64, stream);
  }
}

constexpr int kPoolUnroll = 4;   // positions a lane loads before it adds

// one source element widened to f32
template <typename SrcT>
__device__ __forceinline__ float to_f32(SrcT x) {
  if constexpr (sizeof(SrcT) == 2) {
    return herald::bf16_to_f32(x);
  } else {
    return x;
  }
}

// 4 source elements from an aligned address (16 bytes of f32, 8 of bf16)
// widened to f32
template <typename SrcT>
__device__ __forceinline__ float4 load4(const SrcT* src) {
  if constexpr (sizeof(SrcT) == 2) {
    const uint2 w = __ldg(reinterpret_cast<const uint2*>(src));
    return make_float4(__uint_as_float(w.x << 16),
                       __uint_as_float(w.x & 0xffff0000u),
                       __uint_as_float(w.y << 16),
                       __uint_as_float(w.y & 0xffff0000u));
  } else {
    return __ldg(reinterpret_cast<const float4*>(src));
  }
}

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// One group of L lanes per output row (sample b, bag k). VEC: the table's
// and the output's rows allow 4-element vectors (dim % 4 == 0, aligned
// bases); else one element a lane at a time.
template <typename SrcT, int L, typename IdT, bool VEC>
__global__ void __launch_bounds__(kThreads)
gather_pool_rows(const SrcT* __restrict__ table, const IdT* __restrict__ ids,
                 const int* __restrict__ offsets, float* __restrict__ out,
                 int64_t rows, int64_t dim, int64_t samples,
                 int64_t positions, int bags) {
  constexpr int kRowsPerBlock = kThreads / L;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock +
                    threadIdx.x / L;
  if (r >= samples * bags) return;
  const int lane = threadIdx.x % L;
  const int64_t b = r / bags;
  const int k = static_cast<int>(r - b * bags);
  const int p0 = __ldg(offsets + k), p1 = __ldg(offsets + k + 1);
  const IdT* bag_ids = ids + b * positions + p0;
  const int n = p1 - p0;
  float* dst = out + r * dim;
  // an id inside the table, or -1
  const auto row_of = [&](int j) -> int64_t {
    const int64_t id = static_cast<int64_t>(__ldg(bag_ids + j));
    return id >= 0 && id < rows ? id : -1;
  };
  if constexpr (VEC) {
    const int64_t nvec = dim / 4;
    for (int64_t v = lane; v < nvec; v += L) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int j0 = 0; j0 < n; j0 += kPoolUnroll) {
        float4 x[kPoolUnroll];
#pragma unroll
        for (int u = 0; u < kPoolUnroll; ++u) {
          x[u] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (j0 + u < n) {
            const int64_t id = row_of(j0 + u);
            if (id >= 0) x[u] = load4(table + id * dim + v * 4);
          }
        }
#pragma unroll
        for (int u = 0; u < kPoolUnroll; ++u) {
          if (j0 + u == 0) {
            acc = x[0];
          } else if (j0 + u < n) {
            add4(acc, x[u]);
          }
        }
      }
      reinterpret_cast<float4*>(dst)[v] = acc;
    }
  } else {
    for (int64_t e = lane; e < dim; e += L) {
      float acc = 0.f;
      for (int j = 0; j < n; ++j) {
        const int64_t id = row_of(j);
        const float x = id >= 0 ? to_f32(__ldg(table + id * dim + e)) : 0.f;
        acc = j == 0 ? x : acc + x;
      }
      dst[e] = acc;
    }
  }
}

template <typename SrcT, int L, bool VEC>
void launch_pool(const void* table, const void* ids, const int* offsets,
                 float* out, int64_t rows, int64_t dim, int64_t samples,
                 int64_t positions, int bags, int ids_int64,
                 cudaStream_t stream) {
  constexpr int64_t kRowsPerBlock = kThreads / L;
  const dim3 grid(static_cast<unsigned>(
      (samples * bags + kRowsPerBlock - 1) / kRowsPerBlock));
  const SrcT* t = static_cast<const SrcT*>(table);
  if (ids_int64) {
    gather_pool_rows<SrcT, L, int64_t, VEC><<<grid, kThreads, 0, stream>>>(
        t, static_cast<const int64_t*>(ids), offsets, out, rows, dim, samples,
        positions, bags);
  } else {
    gather_pool_rows<SrcT, L, int32_t, VEC><<<grid, kThreads, 0, stream>>>(
        t, static_cast<const int32_t*>(ids), offsets, out, rows, dim, samples,
        positions, bags);
  }
}

template <typename SrcT, bool VEC>
void pool_lanes(const void* table, const void* ids, const int* offsets,
                float* out, int64_t rows, int64_t dim, int64_t samples,
                int64_t positions, int bags, int ids_int64,
                cudaStream_t stream) {
  // the fewest lanes that cover the output row's 16-byte vectors, up to a
  // warp
  const int64_t vectors = (dim * 4 + 15) / 16;
  if (vectors <= 8) {
    launch_pool<SrcT, 8, VEC>(table, ids, offsets, out, rows, dim, samples,
                              positions, bags, ids_int64, stream);
  } else if (vectors <= 16) {
    launch_pool<SrcT, 16, VEC>(table, ids, offsets, out, rows, dim, samples,
                               positions, bags, ids_int64, stream);
  } else {
    launch_pool<SrcT, 32, VEC>(table, ids, offsets, out, rows, dim, samples,
                               positions, bags, ids_int64, stream);
  }
}

template <typename SrcT>
void pool_dispatch(const void* table, const void* ids, const int* offsets,
                   float* out, int64_t rows, int64_t dim, int64_t samples,
                   int64_t positions, int bags, int ids_int64,
                   cudaStream_t stream) {
  const bool vec = dim % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(table) % (4 * sizeof(SrcT)) ==
                       0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec) {
    pool_lanes<SrcT, true>(table, ids, offsets, out, rows, dim, samples,
                           positions, bags, ids_int64, stream);
  } else {
    pool_lanes<SrcT, false>(table, ids, offsets, out, rows, dim, samples,
                            positions, bags, ids_int64, stream);
  }
}

}  // namespace

// table_code / out_code: 0 = float32, 1 = bfloat16; the output is the
// table's dtype or, from a bf16 table, float32. Returns cudaGetLastError()
// after the launch (0 on success); the caller raises on anything else.
extern "C" int herald_embedding_gather(const void* table, const void* ids,
                                       void* out, int64_t rows, int64_t dim,
                                       int64_t n, int table_code,
                                       int out_code, int ids_int64,
                                       void* stream) {
  if (n <= 0 || rows < 0 || dim <= 0 || (n + 7) / 8 > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uintptr_t t = reinterpret_cast<uintptr_t>(table);
  const uintptr_t o = reinterpret_cast<uintptr_t>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (table_code == 0 && out_code == 0) {
    if (t % 4 || o % 4) return static_cast<int>(cudaErrorMisalignedAddress);
    dispatch_lanes<float, float>(table, ids, out, rows, dim, n, ids_int64, s);
  } else if (table_code == 1 && out_code == 1) {
    if (t % 2 || o % 2) return static_cast<int>(cudaErrorMisalignedAddress);
    dispatch_lanes<uint16_t, uint16_t>(table, ids, out, rows, dim, n,
                                       ids_int64, s);
  } else if (table_code == 1 && out_code == 0) {
    if (t % 2 || o % 4) return static_cast<int>(cudaErrorMisalignedAddress);
    dispatch_lanes<uint16_t, float>(table, ids, out, rows, dim, n, ids_int64,
                                    s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The pooled form: table [rows, dim] (table_code 0 = float32, 1 =
// bfloat16), ids [samples, positions] (int32, or int64 with ids_int64),
// offsets [bags + 1] int32 on the card (offsets[0] = 0, nondecreasing,
// offsets[bags] = positions), out f32 [samples, bags, dim]. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int herald_gather_pool_rows(const void* table, const void* ids,
                                       const void* offsets, void* out,
                                       int64_t rows, int64_t dim,
                                       int64_t samples, int64_t positions,
                                       int bags, int table_code,
                                       int ids_int64, void* stream) {
  if (samples <= 0 || rows < 0 || dim <= 0 || bags <= 0 || positions < 0 ||
      (samples * bags + 7) / 8 > 0x7fffffffLL ||
      reinterpret_cast<uintptr_t>(out) % 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int* off = static_cast<const int*>(offsets);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (table_code == 0) {
    if (reinterpret_cast<uintptr_t>(table) % 4) {
      return static_cast<int>(cudaErrorMisalignedAddress);
    }
    pool_dispatch<float>(table, ids, off, o, rows, dim, samples, positions,
                         bags, ids_int64, s);
  } else if (table_code == 1) {
    if (reinterpret_cast<uintptr_t>(table) % 2) {
      return static_cast<int>(cudaErrorMisalignedAddress);
    }
    pool_dispatch<uint16_t>(table, ids, off, o, rows, dim, samples, positions,
                            bags, ids_int64, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
