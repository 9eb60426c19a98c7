// K3 hot_onehot_push for Hopper (sm_90a): out[r] = sum of grads[i] over
// every position i with ids[i] == r, for r in [0, num_rows), in f32.
// Duplicates accumulate; ids outside [0, num_rows) are dropped.
//
// Replaces: herald_tpu/ops/pallas/kernels.py `hot_onehot_push` (the
// pallas_call at :274). The Pallas kernel multiplies a bf16 one-hot
// [num_rows, N] by grads [N, D] on the MXU: O(num_rows * N * D) work, so it
// pays only while the segment space is a small hot block. On the H100 the
// same function at the training shape (N = 6,656 positions, num_rows = the
// ~3,500 unique ids of a batch, D = 128) would be 3 billion multiply-adds
// of tensor-core work for a 5 MB reduction. Nothing of the matmul carries
// over.
//
// Bound on the card: bytes. The kernel reads each grad row once and writes
// each output row once: N*D*grad_bytes + num_rows*D*4 bytes (plus the
// position order), about 5 MB at the training shape, 1.6 us at 3.35 TB/s.
//
// Design (deterministic: the same inputs give the same bits every launch,
// so a resumed run repeats an uninterrupted one on the card):
//   - the wrapper hands in the ids sorted stably with their positions
//     (torch.sort(ids, stable=True)): index bookkeeping, no arithmetic;
//   - one warp per output row r, 8 warps per block, grid ceil(num_rows/8);
//     the warp binary-searches r's segment [lo, hi) in the sorted ids;
//   - the warp sums the segment's grad rows in position order, in f32, no
//     atomics; each lane owns 4 columns (16-byte f32 or 8-byte bf16 loads)
//     when D % 4 == 0 and the grads are aligned, else one column;
//   - an empty segment writes a zero row, so the output needs no memset.
//
// Bound by a plain C interface and loaded with ctypes
// (herald_tpu_torch/ops/kernels/build.py, segment.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
// bf16 held as its 16-bit pattern: the f32 with the same upper half
__device__ __forceinline__ float to_f32(uint16_t b) {
  return __uint_as_float(static_cast<uint32_t>(b) << 16);
}

template <typename IdT>
__device__ __forceinline__ int64_t lower_bound(const IdT* __restrict__ ids,
                                               int64_t n, int64_t key) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (static_cast<int64_t>(ids[mid]) < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

template <typename GradT, int VEC, typename IdT>
__global__ void __launch_bounds__(kThreads)
segment_rows(const IdT* __restrict__ sorted_ids,
             const int64_t* __restrict__ order,
             const GradT* __restrict__ grads, float* __restrict__ out,
             int64_t n, int64_t num_rows, int64_t dim) {
  const int64_t r =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (r >= num_rows) return;
  const int lane = threadIdx.x & 31;
  const int64_t lo = lower_bound(sorted_ids, n, r);
  const int64_t hi = lower_bound(sorted_ids, n, r + 1);
  float* dst = out + r * dim;
  for (int64_t c = static_cast<int64_t>(lane) * VEC; c < dim;
       c += 32 * VEC) {
    float acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.0f;
    for (int64_t j = lo; j < hi; ++j) {
      const Vec<GradT, VEC> g = *reinterpret_cast<const Vec<GradT, VEC>*>(
          grads + order[j] * dim + c);
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] += to_f32(g.v[k]);
    }
    Vec<float, VEC> o;
#pragma unroll
    for (int k = 0; k < VEC; ++k) o.v[k] = acc[k];
    *reinterpret_cast<Vec<float, VEC>*>(dst + c) = o;
  }
}

template <typename GradT, int VEC>
void launch(const void* sorted_ids, const void* order, const void* grads,
            void* out, int64_t n, int64_t num_rows, int64_t dim,
            int ids_int64, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((num_rows + kWarpsPerBlock - 1) /
                                        kWarpsPerBlock));
  const GradT* g = static_cast<const GradT*>(grads);
  const int64_t* o = static_cast<const int64_t*>(order);
  float* dst = static_cast<float*>(out);
  if (ids_int64) {
    segment_rows<GradT, VEC, int64_t><<<grid, kThreads, 0, stream>>>(
        static_cast<const int64_t*>(sorted_ids), o, g, dst, n, num_rows,
        dim);
  } else {
    segment_rows<GradT, VEC, int32_t><<<grid, kThreads, 0, stream>>>(
        static_cast<const int32_t*>(sorted_ids), o, g, dst, n, num_rows,
        dim);
  }
}

}  // namespace

// grad_code: 0 = float32, 1 = bfloat16. `order` holds int64 positions.
// Returns cudaGetLastError() after the launch (0 on success); the caller
// raises on anything else.
extern "C" int herald_hot_onehot_push(const void* sorted_ids,
                                      const void* order, const void* grads,
                                      void* out, int64_t n, int64_t num_rows,
                                      int64_t dim, int grad_code,
                                      int ids_int64, void* stream) {
  if (n < 0 || num_rows <= 0 || dim <= 0 ||
      (num_rows + kWarpsPerBlock - 1) / kWarpsPerBlock > 0x7fffffffLL ||
      (grad_code != 0 && grad_code != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t elem = grad_code == 0 ? 4 : 2;
  // 4 columns a lane when every grad row and the output rows start on a
  // multiple of the vector: D % 4 == 0 and aligned bases
  const bool vec4 =
      dim % 4 == 0 &&
      reinterpret_cast<uintptr_t>(grads) % (4 * elem) == 0 &&
      reinterpret_cast<uintptr_t>(out) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (grad_code == 0) {
    if (vec4) {
      launch<float, 4>(sorted_ids, order, grads, out, n, num_rows, dim,
                       ids_int64, s);
    } else {
      launch<float, 1>(sorted_ids, order, grads, out, n, num_rows, dim,
                       ids_int64, s);
    }
  } else {
    if (vec4) {
      launch<uint16_t, 4>(sorted_ids, order, grads, out, n, num_rows, dim,
                          ids_int64, s);
    } else {
      launch<uint16_t, 1>(sorted_ids, order, grads, out, n, num_rows, dim,
                          ids_int64, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
