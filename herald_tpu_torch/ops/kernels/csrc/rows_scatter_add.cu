// K2 rows_scatter_add for Hopper (sm_90a): table[ids[i]] += grads[i],
// in place, for UNIQUE ids; ids outside [0, R) are skipped.
//
// Replaces: herald_tpu/ops/pallas/kernels.py `rows_scatter_add` (the
// pallas_call at :183). The Pallas kernel walks the ids strictly in order
// and read-modify-writes the whole 8-row tile group around each one,
// because Mosaic tiles device memory in (8, 128) groups and two ids may
// share a group. Hopper addresses any 16 bytes, so each row is updated on
// its own, all rows at once: unique ids never touch the same bytes.
//
// Bound on the card: bytes. Per id it reads the row and the grad row and
// writes the row: N*(2*D*table_bytes + D*grad_bytes) + N*id_bytes bytes,
// about 3.6 MB at the training shape (3,491 unique ids, D = 128, bf16
// table, f32 grads), 1.1 us at 3.35 TB/s.
//
// Design:
//   - one warp per id, 8 warps per block, grid ceil(N / 8); no atomics;
//   - lanes stride over the row 4 elements at a time (8- or 16-byte
//     loads) when D % 4 == 0 and the bases are aligned, else 1 at a time;
//   - rounding as `table[ids] += grads.to(table.dtype)`: the grad is first
//     rounded to the table dtype (round to nearest even), then added in
//     f32 and rounded once. For bf16 that is exactly torch's bf16 + bf16
//     add, so the kernel is bit-exact against its plain version;
//   - an id < 0 or >= R is skipped (the JAX engine's mode="drop" write).
//
// Bound by a plain C interface and loaded with ctypes
// (herald_tpu_torch/ops/kernels/build.py, scatter.py).

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

// f32 -> bf16 bits, round to nearest even (NaN stays NaN), as torch rounds
__device__ __forceinline__ uint16_t to_bf16(float f) {
  const uint32_t u = __float_as_uint(f);
  if ((u & 0x7fffffffu) > 0x7f800000u) return 0x7fc0;
  return static_cast<uint16_t>((u + 0x7fffu + ((u >> 16) & 1u)) >> 16);
}

// table element += grad element, rounded as grads.to(table.dtype) then
// a table-dtype add
__device__ __forceinline__ float add_to(float row, float g) { return row + g; }
__device__ __forceinline__ float add_to(float row, uint16_t g) {
  return row + to_f32(g);
}
__device__ __forceinline__ uint16_t add_to(uint16_t row, float g) {
  return to_bf16(to_f32(row) + to_f32(to_bf16(g)));
}
__device__ __forceinline__ uint16_t add_to(uint16_t row, uint16_t g) {
  return to_bf16(to_f32(row) + to_f32(g));
}

template <typename TableT, typename GradT, int VEC, typename IdT>
__global__ void __launch_bounds__(kThreads)
scatter_rows(TableT* __restrict__ table, const IdT* __restrict__ ids,
             const GradT* __restrict__ grads, int64_t rows, int64_t dim,
             int64_t n) {
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (i >= n) return;
  const int64_t id = static_cast<int64_t>(ids[i]);
  if (id < 0 || id >= rows) return;
  const int lane = threadIdx.x & 31;
  TableT* row = table + id * dim;
  const GradT* g = grads + i * dim;
  for (int64_t c = static_cast<int64_t>(lane) * VEC; c < dim;
       c += 32 * VEC) {
    Vec<TableT, VEC> t = *reinterpret_cast<const Vec<TableT, VEC>*>(row + c);
    const Vec<GradT, VEC> d =
        *reinterpret_cast<const Vec<GradT, VEC>*>(g + c);
#pragma unroll
    for (int k = 0; k < VEC; ++k) t.v[k] = add_to(t.v[k], d.v[k]);
    *reinterpret_cast<Vec<TableT, VEC>*>(row + c) = t;
  }
}

template <typename TableT, typename GradT, int VEC>
void launch(void* table, const void* ids, const void* grads, int64_t rows,
            int64_t dim, int64_t n, int ids_int64, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((n + kWarpsPerBlock - 1) /
                                        kWarpsPerBlock));
  TableT* t = static_cast<TableT*>(table);
  const GradT* g = static_cast<const GradT*>(grads);
  if (ids_int64) {
    scatter_rows<TableT, GradT, VEC, int64_t><<<grid, kThreads, 0, stream>>>(
        t, static_cast<const int64_t*>(ids), g, rows, dim, n);
  } else {
    scatter_rows<TableT, GradT, VEC, int32_t><<<grid, kThreads, 0, stream>>>(
        t, static_cast<const int32_t*>(ids), g, rows, dim, n);
  }
}

template <typename TableT, typename GradT>
void dispatch_vec(void* table, const void* ids, const void* grads,
                  int64_t rows, int64_t dim, int64_t n, int ids_int64,
                  cudaStream_t stream) {
  const bool vec4 =
      dim % 4 == 0 &&
      reinterpret_cast<uintptr_t>(table) % (4 * sizeof(TableT)) == 0 &&
      reinterpret_cast<uintptr_t>(grads) % (4 * sizeof(GradT)) == 0;
  if (vec4) {
    launch<TableT, GradT, 4>(table, ids, grads, rows, dim, n, ids_int64,
                             stream);
  } else {
    launch<TableT, GradT, 1>(table, ids, grads, rows, dim, n, ids_int64,
                             stream);
  }
}

}  // namespace

// table_code / grad_code: 0 = float32, 1 = bfloat16. Returns
// cudaGetLastError() after the launch (0 on success); the caller raises on
// anything else.
extern "C" int herald_rows_scatter_add(void* table, const void* ids,
                                       const void* grads, int64_t rows,
                                       int64_t dim, int64_t n, int table_code,
                                       int grad_code, int ids_int64,
                                       void* stream) {
  if (n <= 0 || rows < 0 || dim <= 0 ||
      (n + kWarpsPerBlock - 1) / kWarpsPerBlock > 0x7fffffffLL ||
      (table_code != 0 && table_code != 1) ||
      (grad_code != 0 && grad_code != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (table_code == 0 && grad_code == 0) {
    dispatch_vec<float, float>(table, ids, grads, rows, dim, n, ids_int64, s);
  } else if (table_code == 0) {
    dispatch_vec<float, uint16_t>(table, ids, grads, rows, dim, n, ids_int64,
                                  s);
  } else if (grad_code == 0) {
    dispatch_vec<uint16_t, float>(table, ids, grads, rows, dim, n, ids_int64,
                                  s);
  } else {
    dispatch_vec<uint16_t, uint16_t>(table, ids, grads, rows, dim, n,
                                     ids_int64, s);
  }
  return static_cast<int>(cudaGetLastError());
}
