// K5 fm_second_order for Hopper (sm_90a), forward and backward.
//
// Forward:  out[b] = 0.5 * sum_d (s[b, d]^2 - q[b, d]), where
//           s[b, d] = sum_f v[b, f, d] and q[b, d] = sum_f v[b, f, d]^2,
//           in f32 whatever the input dtype (f32 or bf16).
// Backward: grad[b, f, d] = g[b] * (s[b, d] - v[b, f, d]), rounded once to
//           the input dtype.
//
// Replaces: herald_tpu/ops/pallas/kernels.py `fm_second_order` (the
// pallas_call at :309, body `_fm_kernel` at :289-293). The Pallas kernel
// takes a [block_b, F, D] tile per grid step (B a multiple of block_b) and
// has no backward: JAX differentiates DeepFM's inline formula
// (herald_tpu/models/dfm.py:44-45). Here each sample is one block, so B
// needs no multiple, and the backward is a second kernel in this file.
//
// Bound on the card: bytes. The forward reads every element of v once (at
// b1024 / F 26 / D 512 in f32, 54.5 MB: 16 us at 3.35 TB/s) and does 3
// flops per element; the backward reads v and s once and writes the grad
// once (about 111 MB, 33 us).
//
// Design:
//   - v is a strided view: element (b, f, d) sits at v + b*stride_b +
//     f*stride_f + d. DeepFM hands in the 2nd-order columns of the fused
//     [B, F, D+1] activations, whose data pointer (the caller's
//     data_ptr(), storage offset included) is one element past the row
//     start, so rows are only 4-byte (f32) or 2-byte (bf16) aligned: loads
//     are scalar and coalesced (neighbouring threads, neighbouring d);
//   - one block per sample, min(256, D rounded up to 32) threads, grid B;
//     a thread owns the columns d = tid, tid + blockDim, ... and walks
//     f = 0..F-1 in order: the forward keeps s_d and q_d in registers, the
//     backward keeps s_d and g[b] (on the H100 this ran faster than an
//     elementwise backward of one block per (b, f) row);
//   - the forward reduces sum_d (s_d^2 - q_d) with warp shuffles and then
//     across warps in shared memory, in a fixed order, so two launches
//     give the same bits;
//   - the forward writes s (f32 [B, D], 2 MB at b1024 / e512) when asked,
//     and the backward reads it: keeping s costs the forward one 2 MB
//     write it has in registers anyway, and saves the backward a second
//     pass over v to recompute it;
//   - the backward computes g[b] * (s_d - v) in f32 exactly as its plain
//     version does (one subtract, one multiply: nothing to contract into
//     an fma), so given the same s it is bit-exact.
//
// Bound by a plain C interface and loaded with ctypes
// (herald_tpu_torch/ops/kernels/build.py, fm.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
fm_forward(const T* __restrict__ v, int64_t stride_b, int64_t stride_f,
           int64_t num_fields, int64_t dim, float* __restrict__ out,
           float* __restrict__ s_out) {
  __shared__ float warp_sums[kMaxWarps];
  const int64_t b = blockIdx.x;
  const T* row = v + b * stride_b;
  float part = 0.0f;
  for (int64_t d = threadIdx.x; d < dim; d += blockDim.x) {
    float s = 0.0f, q = 0.0f;
    const T* col = row + d;
#pragma unroll 4
    for (int64_t f = 0; f < num_fields; ++f) {
      const float x = to_f32(col[f * stride_f]);
      s += x;
      q = fmaf(x, x, q);
    }
    if (s_out != nullptr) s_out[b * dim + d] = s;
    part += fmaf(s, s, -q);
  }
  // fixed-order block sum: within each warp, then warp 0 over the warps
  for (int off = 16; off > 0; off >>= 1) {
    part += __shfl_down_sync(0xffffffffu, part, off);
  }
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane == 0) warp_sums[warp] = part;
  __syncthreads();
  if (warp == 0) {
    const int warps = blockDim.x >> 5;
    part = lane < warps ? warp_sums[lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1) {
      part += __shfl_down_sync(0xffffffffu, part, off);
    }
    if (lane == 0) out[b] = 0.5f * part;
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
fm_backward(const T* __restrict__ v, int64_t stride_b, int64_t stride_f,
            int64_t num_fields, int64_t dim, const float* __restrict__ g,
            const float* __restrict__ s, T* __restrict__ grad) {
  const int64_t b = blockIdx.x;
  const T* row = v + b * stride_b;
  T* dst = grad + b * num_fields * dim;
  const float gb = g[b];
  for (int64_t d = threadIdx.x; d < dim; d += blockDim.x) {
    const float sd = s[b * dim + d];
#pragma unroll 4
    for (int64_t f = 0; f < num_fields; ++f) {
      const float x = to_f32(row[f * stride_f + d]);
      store(dst + f * dim + d, gb * (sd - x));
    }
  }
}

int threads_for(int64_t dim) {
  const int64_t t = (dim + 31) / 32 * 32;
  return static_cast<int>(t < kMaxThreads ? t : kMaxThreads);
}

bool bad_shape(int64_t batch, int64_t num_fields, int64_t dim,
               int dtype_code) {
  return batch <= 0 || batch > 0x7fffffffLL || num_fields <= 0 || dim <= 0 ||
         (dtype_code != 0 && dtype_code != 1);
}

}  // namespace

// dtype_code: 0 = float32, 1 = bfloat16. Strides are in elements; the last
// dimension is contiguous. `s_out` (f32 [B, D]) may be null. Returns
// cudaGetLastError() after the launch (0 on success); the caller raises on
// anything else.
extern "C" int herald_fm_second_order(const void* v, int64_t stride_b,
                                      int64_t stride_f, int64_t batch,
                                      int64_t num_fields, int64_t dim,
                                      int dtype_code, void* out, void* s_out,
                                      void* stream) {
  if (bad_shape(batch, num_fields, dim, dtype_code)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(batch));
  const int threads = threads_for(dim);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  float* so = static_cast<float*>(s_out);
  if (dtype_code == 0) {
    fm_forward<float><<<grid, threads, 0, st>>>(
        static_cast<const float*>(v), stride_b, stride_f, num_fields, dim, o,
        so);
  } else {
    fm_forward<__nv_bfloat16><<<grid, threads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(v), stride_b, stride_f, num_fields,
        dim, o, so);
  }
  return static_cast<int>(cudaGetLastError());
}

// grad is a contiguous [B, F, D] buffer of the input dtype; g is f32 [B]
// and s f32 [B, D], both contiguous.
extern "C" int herald_fm_second_order_backward(
    const void* v, int64_t stride_b, int64_t stride_f, int64_t batch,
    int64_t num_fields, int64_t dim, int dtype_code, const void* g,
    const void* s, void* grad, void* stream) {
  if (bad_shape(batch, num_fields, dim, dtype_code)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(batch));
  const int threads = threads_for(dim);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* gp = static_cast<const float*>(g);
  const float* sp = static_cast<const float*>(s);
  if (dtype_code == 0) {
    fm_backward<float><<<grid, threads, 0, st>>>(
        static_cast<const float*>(v), stride_b, stride_f, num_fields, dim, gp,
        sp, static_cast<float*>(grad));
  } else {
    fm_backward<__nv_bfloat16><<<grid, threads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(v), stride_b, stride_f, num_fields,
        dim, gp, sp, static_cast<__nv_bfloat16*>(grad));
  }
  return static_cast<int>(cudaGetLastError());
}
