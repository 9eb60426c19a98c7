// K4 hot_onehot_gather for Hopper (sm_90a): out[i] = hot_table[ids[i]], with
// a zero row for any id outside [0, H), negative ids included.
//
// Replaces: herald_tpu/ops/pallas/kernels.py `hot_onehot_gather` (the
// pallas_call at :234). The Pallas kernel builds a bf16 one-hot [TM, H] of
// each block of ids and multiplies it by the whole hot block on the MXU,
// O(N * H * D) multiply-adds, exact only when the table holds
// bf16-representable values. Hopper reads any 16 bytes directly, so this
// kernel copies each selected row instead: O(N * D) bytes, bit-exact for
// every dtype. On this card the function is therefore the same as K1's
// (embedding_gather.cu); it is its own kernel because it has its own call
// site and shape: the pinned tier's small hot block (H up to a few thousand
// rows, 1 MB at H = 4096, D = 128 bf16, resident in the 50 MB L2) that
// every training step re-reads at the step's unique ids.
//
// Bound on the card: bytes. No arithmetic; it reads N ids, the hot rows
// the in-range ids select, and writes N rows. At the pinned run's shape
// (N = U_cap ~ 4,000 unique ids of which a few hundred are hot, D = 128,
// bf16) that is about 1-2 MB, well under a microsecond at 3.35 TB/s, so
// the launch dominates.
//
// Design:
//   - one warp per output row, 8 warps (8 rows) per block, grid ceil(N / 8);
//   - lanes stride over the row in vectors of 16 bytes (8 bf16 or 4 f32)
//     when the row length and both base pointers are multiples of 16 bytes;
//     otherwise in the widest of 8, 4 or 2 bytes that divides them;
//   - ids are int32 or int64, any value: the bounds check is the pinned
//     mask of the JAX engine (cached.py:463-466), so the caller passes the
//     step's raw unique ids (-1 padding, ids >= H) and gets zero rows there;
//   - a byte copy, so the kernel equals its plain PyTorch version exactly.
//
// Bound by a plain C interface and loaded with ctypes
// (herald_tpu_torch/ops/kernels/build.py, hot_gather.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;

template <typename VecT, typename IdT>
__global__ void __launch_bounds__(kThreads)
hot_gather_rows(const VecT* __restrict__ hot, const IdT* __restrict__ ids,
                VecT* __restrict__ out, int64_t hot_rows,
                int64_t vecs_per_row, int64_t n) {
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (i >= n) return;
  const int lane = threadIdx.x & 31;
  const int64_t id = static_cast<int64_t>(ids[i]);
  VecT* dst = out + i * vecs_per_row;
  if (id >= 0 && id < hot_rows) {
    const VecT* src = hot + id * vecs_per_row;
    for (int64_t v = lane; v < vecs_per_row; v += 32) dst[v] = __ldg(src + v);
  } else {
    const VecT zero = {};
    for (int64_t v = lane; v < vecs_per_row; v += 32) dst[v] = zero;
  }
}

template <typename VecT>
void launch(const void* hot, const void* ids, void* out, int64_t hot_rows,
            int64_t row_bytes, int64_t n, int ids_int64,
            cudaStream_t stream) {
  const int64_t vecs = row_bytes / static_cast<int64_t>(sizeof(VecT));
  const dim3 grid(static_cast<unsigned>((n + kWarpsPerBlock - 1) /
                                        kWarpsPerBlock));
  if (ids_int64) {
    hot_gather_rows<VecT, int64_t><<<grid, kThreads, 0, stream>>>(
        static_cast<const VecT*>(hot), static_cast<const int64_t*>(ids),
        static_cast<VecT*>(out), hot_rows, vecs, n);
  } else {
    hot_gather_rows<VecT, int32_t><<<grid, kThreads, 0, stream>>>(
        static_cast<const VecT*>(hot), static_cast<const int32_t*>(ids),
        static_cast<VecT*>(out), hot_rows, vecs, n);
  }
}

}  // namespace

// dtype_code: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after
// the launch (0 on success); the caller raises on anything else.
extern "C" int herald_hot_onehot_gather(const void* hot, const void* ids,
                                        void* out, int64_t hot_rows,
                                        int64_t dim, int64_t n,
                                        int dtype_code, int ids_int64,
                                        void* stream) {
  int64_t elem;
  if (dtype_code == 0) {
    elem = 4;
  } else if (dtype_code == 1) {
    elem = 2;
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0 || hot_rows < 0 || dim <= 0 ||
      (n + kWarpsPerBlock - 1) / kWarpsPerBlock > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t row_bytes = dim * elem;
  const uint64_t align = reinterpret_cast<uintptr_t>(hot) |
                         reinterpret_cast<uintptr_t>(out) |
                         static_cast<uint64_t>(row_bytes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (align % 16 == 0) {
    launch<uint4>(hot, ids, out, hot_rows, row_bytes, n, ids_int64, s);
  } else if (align % 8 == 0) {
    launch<uint2>(hot, ids, out, hot_rows, row_bytes, n, ids_int64, s);
  } else if (align % 4 == 0) {
    launch<unsigned int>(hot, ids, out, hot_rows, row_bytes, n, ids_int64,
                         s);
  } else if (align % 2 == 0) {
    launch<unsigned short>(hot, ids, out, hot_rows, row_bytes, n, ids_int64,
                           s);
  } else {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  return static_cast<int>(cudaGetLastError());
}
