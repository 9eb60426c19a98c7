// K4 hot_onehot_gather for Hopper (sm_90a), in two modes chosen at compile
// time:
//   gather: out[i] = hot[ids[i]], a zero row for any id outside [0, H),
//           negative ids included (the TPU kernel's function);
//   add:    acc[i, :] += f32(hot[ids[i], :]) for every id inside [0, H);
//           the row of any other id is neither read nor written, so it
//           keeps its bits (-0.0 included). acc is f32 [N, D] with a row
//           stride of its own (its last dim contiguous).
//
// Replaces: herald_tpu/ops/pallas/kernels.py `hot_onehot_gather` (the
// pallas_call at :234). The Pallas kernel builds a bf16 one-hot [TM, H] of
// each block of ids and multiplies it by the whole hot block on the MXU,
// O(N * H * D) multiply-adds, exact only when the table holds
// bf16-representable values. Hopper reads any 16 bytes directly, so this
// kernel copies each selected row instead: O(N * D) bytes, bit-exact for
// every dtype. The add mode is the read of the JAX cached engine's pinned
// tier with what follows it (herald_tpu/train/cached.py:461-467: the fill
// read, the widening and `emb_uniq + hot_rows`, one XLA fusion) in one
// launch that touches only the hot rows.
//
// Bound on the card: bytes. No arithmetic beyond one f32 add an element.
// Gather: the N ids, the hot rows the in-range ids select, N rows written.
// Add: the N ids, and per hot id its hot row read and its acc row read and
// written: N * id_bytes + hits * (D * hot_bytes + 2 * D * 4). At the pinned
// run's shape (N = U_cap ~ 4,100 raw unique ids, about a third of them
// hot, D = 128, a bf16 hot block of 1 MB held in the 50 MB L2) that is
// about 1.7 MB, 0.5 us at 3.35 TB/s: the launch and two dependent round
// trips (the id, then the row) set the time. At FAE's shape (6,656
// positions, an 86 MB hot block in device memory) the hot rows' bytes
// count.
//
// Design:
//   - a group of L lanes per row, L = 8, 16 or 32: the fewest that cover
//     the row's units (16-byte vectors of the hot row, or elements on the
//     narrow path), up to a warp; 256 threads a block. At D = 128 bf16 (16
//     vectors) a half warp covers a row and two rows share a warp;
//   - the group reads its id first. In add mode a cold id ends the group
//     there: no load, no store. In gather mode it stores a zero row;
//   - 16-byte vectors wherever the hot block, the output (or acc and its
//     row stride) and the hot row's length are multiples of 16 bytes: a
//     bf16 vector of 8 elements widens to two f32 vectors of acc. Other
//     widths (13, 513) and alignments take the narrow path, one element a
//     lane at a time, which is right for every width;
//   - a lane issues every load of its row (up to `kUnroll` units, hot and
//     acc) before its first store, so a row costs one round trip;
//   - bf16 -> f32 shifts the 16 bits up, which is exact, and the add is one
//     f32 add rounded to nearest (__fadd_rn): the kernel equals
//     `acc[valid] += hot[ids[valid]].float()` bit for bit, and the gather
//     equals `hot[ids]` with zero rows;
//   - ids are int32 or int64, any value: the bounds check is the pinned
//     mask of the JAX engine (cached.py:463-466), so the caller passes the
//     step's raw unique ids (-1 padding, ids >= H).
//
// Bound by a plain C interface and loaded with ctypes
// (herald_tpu_torch/ops/kernels/build.py, hot_gather.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "row_access.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;   // units a lane loads before it stores any

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(uint16_t b) {
  return herald::bf16_to_f32(b);
}

// acc[0 .. 16 / sizeof(SrcT)) += the elements held in the 16 bytes v, as
// f32 vectors a[0 .. 16 / sizeof(SrcT) / 4)
template <typename SrcT>
__device__ __forceinline__ void add_vector(float4* a, const uint4& v) {
  if constexpr (sizeof(SrcT) == 2) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      a[j].x = __fadd_rn(a[j].x, __uint_as_float(w[2 * j] << 16));
      a[j].y = __fadd_rn(a[j].y, __uint_as_float(w[2 * j] & 0xffff0000u));
      a[j].z = __fadd_rn(a[j].z, __uint_as_float(w[2 * j + 1] << 16));
      a[j].w = __fadd_rn(a[j].w,
                         __uint_as_float(w[2 * j + 1] & 0xffff0000u));
    }
  } else {
    a[0].x = __fadd_rn(a[0].x, __uint_as_float(v.x));
    a[0].y = __fadd_rn(a[0].y, __uint_as_float(v.y));
    a[0].z = __fadd_rn(a[0].z, __uint_as_float(v.z));
    a[0].w = __fadd_rn(a[0].w, __uint_as_float(v.w));
  }
}

// The row of one group: dst is the output row (gather) or the acc row
// (add); src the hot row, or null for a cold id in gather mode.
template <bool kAdd, typename SrcT, int L, bool kVec>
__device__ __forceinline__ void row(const SrcT* __restrict__ src,
                                    void* __restrict__ dst, int64_t dim,
                                    int lane) {
  if constexpr (kVec) {
    // 16-byte vectors of the hot row; in add mode each is kAcc f32
    // vectors of acc
    constexpr int kAcc = kAdd ? 16 / sizeof(SrcT) / 4 : 1;
    const int64_t nvec = dim * static_cast<int64_t>(sizeof(SrcT)) / 16;
    const uint4* s = reinterpret_cast<const uint4*>(src);
    for (int64_t v0 = lane; v0 < nvec; v0 += kUnroll * L) {
      uint4 x[kUnroll];
      float4 a[kUnroll][kAcc];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t v = v0 + u * L;
        if (v < nvec) {
          x[u] = src ? __ldg(s + v) : make_uint4(0, 0, 0, 0);
          if constexpr (kAdd) {
#pragma unroll
            for (int j = 0; j < kAcc; ++j) {
              a[u][j] = static_cast<float4*>(dst)[v * kAcc + j];
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t v = v0 + u * L;
        if (v < nvec) {
          if constexpr (kAdd) {
            add_vector<SrcT>(a[u], x[u]);
#pragma unroll
            for (int j = 0; j < kAcc; ++j) {
              static_cast<float4*>(dst)[v * kAcc + j] = a[u][j];
            }
          } else {
            static_cast<uint4*>(dst)[v] = x[u];
          }
        }
      }
    }
  } else {
    // the narrow path: one element a lane at a time
    for (int64_t e0 = lane; e0 < dim; e0 += kUnroll * L) {
      SrcT x[kUnroll];
      float a[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t e = e0 + u * L;
        if (e < dim) {
          x[u] = src ? __ldg(src + e) : SrcT{};
          if constexpr (kAdd) a[u] = static_cast<float*>(dst)[e];
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t e = e0 + u * L;
        if (e < dim) {
          if constexpr (kAdd) {
            static_cast<float*>(dst)[e] = __fadd_rn(a[u], widen(x[u]));
          } else {
            static_cast<SrcT*>(dst)[e] = x[u];
          }
        }
      }
    }
  }
}

template <typename SrcT, int L, typename IdT, bool kVec>
__global__ void __launch_bounds__(kThreads)
hot_gather_rows(const SrcT* __restrict__ hot, const IdT* __restrict__ ids,
                SrcT* __restrict__ out, int64_t hot_rows, int64_t dim,
                int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * (kThreads / L) +
                    threadIdx.x / L;
  if (i >= n) return;
  const int64_t id = static_cast<int64_t>(ids[i]);
  const SrcT* src = (id >= 0 && id < hot_rows) ? hot + id * dim : nullptr;
  row<false, SrcT, L, kVec>(src, out + i * dim, dim, threadIdx.x % L);
}

template <typename SrcT, int L, typename IdT, bool kVec>
__global__ void __launch_bounds__(kThreads)
hot_add_rows(const SrcT* __restrict__ hot, const IdT* __restrict__ ids,
             float* __restrict__ acc, int64_t hot_rows, int64_t dim,
             int64_t n, int64_t acc_stride) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * (kThreads / L) +
                    threadIdx.x / L;
  if (i >= n) return;
  const int64_t id = static_cast<int64_t>(ids[i]);
  if (id < 0 || id >= hot_rows) return;    // cold: nothing more
  row<true, SrcT, L, kVec>(hot + id * dim, acc + i * acc_stride, dim,
                           threadIdx.x % L);
}

struct Args {
  const void* hot;
  const void* ids;
  void* out;            // gather: [n, dim] contiguous; add: acc
  int64_t hot_rows, dim, n;
  int64_t out_stride;   // elements between rows of out (add mode)
};

template <bool kAdd, typename SrcT, int L, typename IdT, bool kVec>
void start(const Args& a, cudaStream_t s) {
  constexpr int64_t kRows = kThreads / L;
  const dim3 grid(static_cast<unsigned>((a.n + kRows - 1) / kRows));
  const SrcT* hot = static_cast<const SrcT*>(a.hot);
  const IdT* ids = static_cast<const IdT*>(a.ids);
  if constexpr (kAdd) {
    hot_add_rows<SrcT, L, IdT, kVec><<<grid, kThreads, 0, s>>>(
        hot, ids, static_cast<float*>(a.out), a.hot_rows, a.dim, a.n,
        a.out_stride);
  } else {
    hot_gather_rows<SrcT, L, IdT, kVec><<<grid, kThreads, 0, s>>>(
        hot, ids, static_cast<SrcT*>(a.out), a.hot_rows, a.dim, a.n);
  }
}

template <bool kAdd, typename SrcT, typename IdT, bool kVec>
void pick_lanes(const Args& a, cudaStream_t s) {
  const int64_t units =
      kVec ? a.dim * static_cast<int64_t>(sizeof(SrcT)) / 16 : a.dim;
  if (units <= 8) {
    start<kAdd, SrcT, 8, IdT, kVec>(a, s);
  } else if (units <= 16) {
    start<kAdd, SrcT, 16, IdT, kVec>(a, s);
  } else {
    start<kAdd, SrcT, 32, IdT, kVec>(a, s);
  }
}

template <bool kAdd, typename SrcT, typename IdT>
void pick_path(const Args& a, cudaStream_t s) {
  // the vector path needs the hot rows, the output rows and their stride
  // on 16-byte boundaries
  const int64_t out_elem = kAdd ? 4 : static_cast<int64_t>(sizeof(SrcT));
  const uint64_t align =
      reinterpret_cast<uintptr_t>(a.hot) | reinterpret_cast<uintptr_t>(a.out) |
      static_cast<uint64_t>(a.dim * static_cast<int64_t>(sizeof(SrcT))) |
      static_cast<uint64_t>(a.out_stride * out_elem);
  if (align % 16 == 0) {
    pick_lanes<kAdd, SrcT, IdT, true>(a, s);
  } else {
    pick_lanes<kAdd, SrcT, IdT, false>(a, s);
  }
}

// dtype_code: 0 = float32, 1 = bfloat16 (of the hot block). Returns
// cudaGetLastError() after the launch (0 on success).
template <bool kAdd>
int run(const Args& a, int dtype_code, int ids_int64, void* stream) {
  if (a.n <= 0 || a.hot_rows < 0 || a.dim <= 0 ||
      (a.n + 7) / 8 > 0x7fffffffLL || (dtype_code != 0 && dtype_code != 1) ||
      (a.n > 1 && a.out_stride < a.dim)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uintptr_t h = reinterpret_cast<uintptr_t>(a.hot);
  const uintptr_t o = reinterpret_cast<uintptr_t>(a.out);
  const uintptr_t elem = dtype_code == 0 ? 4 : 2;
  if (h % elem || o % (kAdd ? 4 : elem)) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_code == 0 && ids_int64) {
    pick_path<kAdd, float, int64_t>(a, s);
  } else if (dtype_code == 0) {
    pick_path<kAdd, float, int32_t>(a, s);
  } else if (ids_int64) {
    pick_path<kAdd, uint16_t, int64_t>(a, s);
  } else {
    pick_path<kAdd, uint16_t, int32_t>(a, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out [n, dim] contiguous, in the hot block's dtype
extern "C" int herald_hot_onehot_gather(const void* hot, const void* ids,
                                        void* out, int64_t hot_rows,
                                        int64_t dim, int64_t n,
                                        int dtype_code, int ids_int64,
                                        void* stream) {
  return run<false>(Args{hot, ids, out, hot_rows, dim, n, dim}, dtype_code,
                    ids_int64, stream);
}

// acc f32 [n, dim], acc_stride elements between its rows
extern "C" int herald_hot_onehot_gather_add(const void* hot, const void* ids,
                                            void* acc, int64_t hot_rows,
                                            int64_t dim, int64_t n,
                                            int64_t acc_stride,
                                            int dtype_code, int ids_int64,
                                            void* stream) {
  return run<true>(Args{hot, ids, acc, hot_rows, dim, n, acc_stride},
                   dtype_code, ids_int64, stream);
}
