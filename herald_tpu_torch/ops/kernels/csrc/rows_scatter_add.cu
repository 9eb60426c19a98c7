// K2 rows_scatter_add for Hopper (sm_90a): table[ids[i]] += grads[i], or
// with a learning rate table[ids[i]] += -lr * grads[i], in place, for
// UNIQUE ids; ids outside [0, R) are skipped.
//
// Replaces: herald_tpu/ops/pallas/kernels.py `rows_scatter_add` (the
// pallas_call at :183). The Pallas kernel walks the ids strictly in order
// and read-modify-writes the whole 8-row tile group around each one,
// because Mosaic tiles device memory in (8, 128) groups and two ids may
// share a group. Hopper addresses any 16 bytes, so each row is updated on
// its own, all rows at once: unique ids never touch the same bytes.
//
// Bound on the card: bytes. Per id it reads the row and the grad row and
// writes the row: N*(2*D*table_bytes + D*grad_bytes) + N*id_bytes bytes
// (and 4 for lr), about 3.6 MB at the wdl training shape (3,491 unique
// ids, D = 128, bf16 table, f32 grads), 1.1 us at 3.35 TB/s, and 45.5 MB
// at the dfm shape (~11,070 ids, D = 513), 13.6 us.
//
// Design:
//   - a group of L lanes per id, L = 8, 16 or 32: the fewest that cover
//     the row's 16-byte vectors, up to a warp; 256 threads a block; no
//     atomics. At D = 128 bf16 (16 vectors) two rows share a warp;
//   - each table row is updated in three parts: a scalar head up to its
//     first 16-byte boundary (0-7 bf16 or 0-3 f32 elements), 16-byte
//     vectors read and written in place, and a scalar tail. The grads of
//     a vector lie at an address whose residue modulo 16 is the same for
//     every vector of the row; the row dispatches once on it, and a lane
//     loads them in the widest aligned pieces (row_access.cuh). At D = 513
//     the bf16 rows (1,026 bytes) start at any even address and the f32
//     grad rows (2,052 bytes) at any multiple of 4, so no row is left to
//     scalar loads;
//   - a lane issues every load of its row, head and tail included, before
//     its first store (up to 2 vectors, `kUnroll`: a 513-wide row has 63
//     or 64 for its 32 lanes), so a row costs one round trip to memory,
//     not one per part. Four vectors a lane need more registers and ran
//     slower at D = 513;
//   - with lr (a 0-d f32 on the card, read by every lane; f32 grads only)
//     the kernel scales each grad by -lr, one f32 multiply rounded to
//     nearest and never fused with the add (__fmul_rn): `-lr * grads` as
//     torch computes it, so the caller needs no launch of its own for it;
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

#include "row_access.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 2;   // vectors a lane loads before it stores any

using herald::bf16_to_f32;
using herald::f32_to_bf16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(uint16_t b) { return bf16_to_f32(b); }

// table element += grad element, rounded as grads.to(table.dtype) then
// a table-dtype add
__device__ __forceinline__ float add_to(float row, float g) { return row + g; }
__device__ __forceinline__ float add_to(float row, uint16_t g) {
  return row + to_f32(g);
}
__device__ __forceinline__ uint16_t add_to(uint16_t row, float g) {
  return f32_to_bf16(to_f32(row) + to_f32(f32_to_bf16(g)));
}
__device__ __forceinline__ uint16_t add_to(uint16_t row, uint16_t g) {
  return f32_to_bf16(to_f32(row) + to_f32(g));
}

template <bool kLr, typename TableT, typename GradT>
__device__ __forceinline__ TableT update(TableT row, GradT g, float neg_lr) {
  if constexpr (kLr) {
    return add_to(row, __fmul_rn(neg_lr, g));
  } else {
    return add_to(row, g);
  }
}

// element K of a vector held in 32-bit words (bf16: its 16 bits)
template <typename T, int K>
__device__ __forceinline__ T get(const uint32_t* w) {
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(w[K]);
  } else {
    return static_cast<uint16_t>(herald::get_half<2 * K>(w));
  }
}

template <typename T, int K>
__device__ __forceinline__ void put(uint32_t* w, T x) {
  if constexpr (sizeof(T) == 4) {
    w[K] = __float_as_uint(x);
  } else {
    herald::set_half<2 * K>(w, x);
  }
}

template <bool kLr, typename TableT, typename GradT, int K = 0>
__device__ __forceinline__ void update_vector(uint32_t* t, const uint32_t* g,
                                              float neg_lr) {
  if constexpr (K < 16 / static_cast<int>(sizeof(TableT))) {
    put<TableT, K>(t, update<kLr>(get<TableT, K>(t), get<GradT, K>(g),
                                  neg_lr));
    update_vector<kLr, TableT, GradT, K + 1>(t, g, neg_lr);
  }
}

template <typename TableT, typename GradT, bool kLr, int L, typename IdT>
__global__ void __launch_bounds__(kThreads)
scatter_rows(TableT* __restrict__ table, const IdT* __restrict__ ids,
             const GradT* __restrict__ grads, const float* __restrict__ lr,
             int64_t rows, int64_t dim, int64_t n) {
  constexpr int kRowsPerBlock = kThreads / L;
  constexpr int kVec = 16 / sizeof(TableT);   // elements in a vector
  constexpr int kGrad = kVec * sizeof(GradT);  // bytes of their grads
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock +
                    threadIdx.x / L;
  if (i >= n) return;
  const int64_t id = static_cast<int64_t>(ids[i]);
  if (id < 0 || id >= rows) return;
  const int lane = threadIdx.x % L;
  const float neg_lr = kLr ? -__ldg(lr) : 0.0f;
  TableT* row = table + id * dim;
  const GradT* g = grads + i * dim;
  // head: up to the table row's first 16-byte boundary; then whole
  // vectors; then a tail. Both are shorter than a vector, and L >= kVec,
  // so a lane holds at most one element of each.
  const int64_t to_boundary =
      ((16 - (reinterpret_cast<uintptr_t>(row) & 15)) & 15) / sizeof(TableT);
  const int64_t head = to_boundary < dim ? to_boundary : dim;
  const int64_t nvec = (dim - head) / kVec;
  const int64_t tail = head + nvec * kVec;
  const bool has_head = lane < head;
  const bool has_tail = lane < dim - tail;
  // every load of the row is issued before any store
  TableT head_t{}, tail_t{};
  GradT head_g{}, tail_g{};
  if (has_head) {
    head_t = row[lane];
    head_g = __ldg(g + lane);
  }
  if (has_tail) {
    tail_t = row[tail + lane];
    tail_g = __ldg(g + tail + lane);
  }
  uint4* vrow = reinterpret_cast<uint4*>(row + head);
  const char* vg = reinterpret_cast<const char*>(g + head);
  const int residue = static_cast<int>(reinterpret_cast<uintptr_t>(vg) & 15);
  herald::dispatch_residue<sizeof(GradT)>(residue, [&](auto res) {
    constexpr int R = decltype(res)::value;
    for (int64_t v0 = lane; v0 < nvec; v0 += kUnroll * L) {
      uint32_t t[kUnroll][4] = {}, d[kUnroll][kGrad / 4] = {};
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t v = v0 + u * L;
        if (v < nvec) {
          const uint4 x = vrow[v];
          t[u][0] = x.x;
          t[u][1] = x.y;
          t[u][2] = x.z;
          t[u][3] = x.w;
          herald::load_run<R, kGrad>(vg + v * kGrad, d[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t v = v0 + u * L;
        if (v < nvec) {
          update_vector<kLr, TableT, GradT>(t[u], d[u], neg_lr);
          vrow[v] = make_uint4(t[u][0], t[u][1], t[u][2], t[u][3]);
        }
      }
    }
  });
  if (has_head) row[lane] = update<kLr>(head_t, head_g, neg_lr);
  if (has_tail) row[tail + lane] = update<kLr>(tail_t, tail_g, neg_lr);
}

template <typename TableT, typename GradT, bool kLr, int L>
void launch(void* table, const void* ids, const void* grads, const float* lr,
            int64_t rows, int64_t dim, int64_t n, int ids_int64,
            cudaStream_t stream) {
  constexpr int64_t kRowsPerBlock = kThreads / L;
  const dim3 grid(static_cast<unsigned>((n + kRowsPerBlock - 1) /
                                        kRowsPerBlock));
  TableT* t = static_cast<TableT*>(table);
  const GradT* g = static_cast<const GradT*>(grads);
  if (ids_int64) {
    scatter_rows<TableT, GradT, kLr, L, int64_t>
        <<<grid, kThreads, 0, stream>>>(t, static_cast<const int64_t*>(ids),
                                        g, lr, rows, dim, n);
  } else {
    scatter_rows<TableT, GradT, kLr, L, int32_t>
        <<<grid, kThreads, 0, stream>>>(t, static_cast<const int32_t*>(ids),
                                        g, lr, rows, dim, n);
  }
}

template <typename TableT, typename GradT, bool kLr>
void dispatch_lanes(void* table, const void* ids, const void* grads,
                    const float* lr, int64_t rows, int64_t dim, int64_t n,
                    int ids_int64, cudaStream_t stream) {
  // 16-byte vectors in a table row
  const int64_t vectors =
      (dim * static_cast<int64_t>(sizeof(TableT)) + 15) / 16;
  if (vectors <= 8) {
    launch<TableT, GradT, kLr, 8>(table, ids, grads, lr, rows, dim, n,
                                  ids_int64, stream);
  } else if (vectors <= 16) {
    launch<TableT, GradT, kLr, 16>(table, ids, grads, lr, rows, dim, n,
                                   ids_int64, stream);
  } else {
    launch<TableT, GradT, kLr, 32>(table, ids, grads, lr, rows, dim, n,
                                   ids_int64, stream);
  }
}

}  // namespace

// table_code / grad_code: 0 = float32, 1 = bfloat16. lr: a device pointer
// to one f32, or null for no scaling; with lr the grads must be f32.
// Returns cudaGetLastError() after the launch (0 on success); the caller
// raises on anything else.
extern "C" int herald_rows_scatter_add(void* table, const void* ids,
                                       const void* grads, const void* lr,
                                       int64_t rows, int64_t dim, int64_t n,
                                       int table_code, int grad_code,
                                       int ids_int64, void* stream) {
  if (n <= 0 || rows < 0 || dim <= 0 || (n + 7) / 8 > 0x7fffffffLL ||
      (table_code != 0 && table_code != 1) ||
      (grad_code != 0 && grad_code != 1) || (lr && grad_code != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uintptr_t t = reinterpret_cast<uintptr_t>(table);
  const uintptr_t g = reinterpret_cast<uintptr_t>(grads);
  if (t % (table_code == 0 ? 4 : 2) || g % (grad_code == 0 ? 4 : 2) ||
      reinterpret_cast<uintptr_t>(lr) % 4) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const float* l = static_cast<const float*>(lr);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lr && table_code == 0) {
    dispatch_lanes<float, float, true>(table, ids, grads, l, rows, dim, n,
                                       ids_int64, s);
  } else if (lr) {
    dispatch_lanes<uint16_t, float, true>(table, ids, grads, l, rows, dim, n,
                                          ids_int64, s);
  } else if (table_code == 0 && grad_code == 0) {
    dispatch_lanes<float, float, false>(table, ids, grads, l, rows, dim, n,
                                        ids_int64, s);
  } else if (table_code == 0) {
    dispatch_lanes<float, uint16_t, false>(table, ids, grads, l, rows, dim,
                                           n, ids_int64, s);
  } else if (grad_code == 0) {
    dispatch_lanes<uint16_t, float, false>(table, ids, grads, l, rows, dim,
                                           n, ids_int64, s);
  } else {
    dispatch_lanes<uint16_t, uint16_t, false>(table, ids, grads, l, rows,
                                              dim, n, ids_int64, s);
  }
  return static_cast<int>(cudaGetLastError());
}
