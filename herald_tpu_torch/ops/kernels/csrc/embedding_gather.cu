// K1 embedding_gather for Hopper (sm_90a): out[i] = table[ids[i]], with a
// zero row for any id outside [0, R).
//
// Replaces: herald_tpu/ops/pallas/kernels.py `embedding_gather` (the
// pallas_call at :104). The Pallas kernel moves the whole 8-row tile group
// around each id and selects the row with an iota mask, because Mosaic
// tiles device memory in (8, 128) groups. Nothing of that carries over:
// a Hopper load can address any 16 bytes, so each row is copied directly.
//
// Bound on the card: bytes. The gather does no arithmetic; it reads N rows
// and N ids and writes N rows, 2*N*D*elem + N*idx_bytes bytes in all. At the
// serving shape (a few thousand unique ids, D = 128, bf16) that is a few MB,
// about a microsecond at 3.35 TB/s, so the launch itself dominates.
//
// Design:
//   - one warp per output row, 8 warps (8 rows) per block, grid ceil(N / 8);
//   - lanes stride over the row in vectors of 16 bytes (8 bf16 or 4 f32)
//     when the row length and both base pointers are multiples of 16 bytes;
//     otherwise in the widest of 8, 4 or 2 bytes that divides them, down to
//     one element (D = 13 f32 copies 4-byte words, D = 13 bf16 2-byte ones);
//   - ids are int32 or int64; an id < 0 or >= R writes a zero row (the
//     mode="fill" read of the JAX engine), and R need not be a multiple of 8;
//   - the copy is bit-exact, so the kernel equals its plain PyTorch version.
//
// Bound by a plain C interface and loaded with ctypes
// (herald_tpu_torch/ops/kernels/build.py, gather.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;

template <typename VecT, typename IdT>
__global__ void __launch_bounds__(kThreads)
gather_rows(const VecT* __restrict__ table, const IdT* __restrict__ ids,
            VecT* __restrict__ out, int64_t rows, int64_t vecs_per_row,
            int64_t n) {
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (i >= n) return;
  const int lane = threadIdx.x & 31;
  const int64_t id = static_cast<int64_t>(ids[i]);
  VecT* dst = out + i * vecs_per_row;
  if (id >= 0 && id < rows) {
    const VecT* src = table + id * vecs_per_row;
    for (int64_t v = lane; v < vecs_per_row; v += 32) dst[v] = __ldg(src + v);
  } else {
    const VecT zero = {};
    for (int64_t v = lane; v < vecs_per_row; v += 32) dst[v] = zero;
  }
}

template <typename VecT>
void launch(const void* table, const void* ids, void* out, int64_t rows,
            int64_t row_bytes, int64_t n, int ids_int64,
            cudaStream_t stream) {
  const int64_t vecs = row_bytes / static_cast<int64_t>(sizeof(VecT));
  const dim3 grid(static_cast<unsigned>((n + kWarpsPerBlock - 1) /
                                        kWarpsPerBlock));
  if (ids_int64) {
    gather_rows<VecT, int64_t><<<grid, kThreads, 0, stream>>>(
        static_cast<const VecT*>(table), static_cast<const int64_t*>(ids),
        static_cast<VecT*>(out), rows, vecs, n);
  } else {
    gather_rows<VecT, int32_t><<<grid, kThreads, 0, stream>>>(
        static_cast<const VecT*>(table), static_cast<const int32_t*>(ids),
        static_cast<VecT*>(out), rows, vecs, n);
  }
}

}  // namespace

// dtype_code: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after
// the launch (0 on success); the caller raises on anything else.
extern "C" int herald_embedding_gather(const void* table, const void* ids,
                                       void* out, int64_t rows, int64_t dim,
                                       int64_t n, int dtype_code,
                                       int ids_int64, void* stream) {
  int64_t elem;
  if (dtype_code == 0) {
    elem = 4;
  } else if (dtype_code == 1) {
    elem = 2;
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0 || rows < 0 || dim <= 0 ||
      (n + kWarpsPerBlock - 1) / kWarpsPerBlock > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t row_bytes = dim * elem;
  const uint64_t align = reinterpret_cast<uintptr_t>(table) |
                         reinterpret_cast<uintptr_t>(out) |
                         static_cast<uint64_t>(row_bytes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (align % 16 == 0) {
    launch<uint4>(table, ids, out, rows, row_bytes, n, ids_int64, s);
  } else if (align % 8 == 0) {
    launch<uint2>(table, ids, out, rows, row_bytes, n, ids_int64, s);
  } else if (align % 4 == 0) {
    launch<unsigned int>(table, ids, out, rows, row_bytes, n, ids_int64, s);
  } else if (align % 2 == 0) {
    launch<unsigned short>(table, ids, out, rows, row_bytes, n, ids_int64, s);
  } else {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  return static_cast<int>(cudaGetLastError());
}
