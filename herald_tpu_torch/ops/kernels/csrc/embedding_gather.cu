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
