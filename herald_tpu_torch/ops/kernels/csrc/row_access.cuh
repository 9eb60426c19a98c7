// Row runs at any 2-byte alignment, for the row kernels (K1
// embedding_gather.cu, K2 rows_scatter_add.cu).
//
// A row of a bf16 table with an odd width (D = 513: 1,026 bytes) starts at
// any even address, and an f32 row of the same width (2,052 bytes) at any
// multiple of 4. Such a row is read from its first 16-byte boundary on in
// 16-byte vectors; what a lane does with one vector lands on the other
// side (the output row, or the grad row) at an address that is the same
// modulo 16 for every vector of the row. `store_run<R, NB>` and
// `load_run<R, NB>` move such a run of NB bytes (8, 16 or 32) held in
// NB / 4 registers, at an address that is R modulo 16, in the widest
// aligned pieces: 16-byte ones wherever the address allows, else 8, 4 or
// 2. R and NB are template arguments, so every piece is fixed when the
// kernel compiles; a kernel dispatches on R once per row
// (`dispatch_residue`).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace herald {

// Width of the piece at byte O of a run of NB bytes whose first byte lies
// at an address R modulo 16.
template <int R, int O, int NB>
struct Piece {
  static constexpr int A = (R + O) & 15;
  static constexpr int W = (A == 0 && O + 16 <= NB)     ? 16
                           : (A % 8 == 0 && O + 8 <= NB) ? 8
                           : (A % 4 == 0 && O + 4 <= NB) ? 4
                                                         : 2;
};

// the 16 bits at even byte offset B of the words w
template <int B>
__device__ __forceinline__ uint32_t get_half(const uint32_t* w) {
  if constexpr (B % 4 == 0) {
    return w[B / 4] & 0xffffu;
  } else {
    return w[B / 4] >> 16;
  }
}

template <int B>
__device__ __forceinline__ void set_half(uint32_t* w, uint32_t h) {
  if constexpr (B % 4 == 0) {
    w[B / 4] = (w[B / 4] & 0xffff0000u) | h;
  } else {
    w[B / 4] = (w[B / 4] & 0xffffu) | (h << 16);
  }
}

// the 32 bits at even byte offset B of the words w
template <int B>
__device__ __forceinline__ uint32_t get_word(const uint32_t* w) {
  if constexpr (B % 4 == 0) {
    return w[B / 4];
  } else {
    return __funnelshift_r(w[B / 4], w[B / 4 + 1], 16);
  }
}

template <int B>
__device__ __forceinline__ void set_word(uint32_t* w, uint32_t v) {
  if constexpr (B % 4 == 0) {
    w[B / 4] = v;
  } else {
    set_half<B>(w, v & 0xffffu);
    set_half<B + 2>(w, v >> 16);
  }
}

// NB bytes w[0 .. NB/4) to dst, an address R modulo 16
template <int R, int NB, int O = 0>
__device__ __forceinline__ void store_run(char* dst, const uint32_t* w) {
  if constexpr (O < NB) {
    constexpr int W = Piece<R, O, NB>::W;
    if constexpr (W == 16) {
      *reinterpret_cast<uint4*>(dst + O) =
          make_uint4(get_word<O>(w), get_word<O + 4>(w), get_word<O + 8>(w),
                     get_word<O + 12>(w));
    } else if constexpr (W == 8) {
      *reinterpret_cast<uint2*>(dst + O) =
          make_uint2(get_word<O>(w), get_word<O + 4>(w));
    } else if constexpr (W == 4) {
      *reinterpret_cast<uint32_t*>(dst + O) = get_word<O>(w);
    } else {
      *reinterpret_cast<uint16_t*>(dst + O) =
          static_cast<uint16_t>(get_half<O>(w));
    }
    store_run<R, NB, O + W>(dst, w);
  }
}

// NB bytes from src, an address R modulo 16, into w[0 .. NB/4)
template <int R, int NB, int O = 0>
__device__ __forceinline__ void load_run(const char* __restrict__ src,
                                         uint32_t* w) {
  if constexpr (O < NB) {
    constexpr int W = Piece<R, O, NB>::W;
    if constexpr (W == 16) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(src + O));
      set_word<O>(w, v.x);
      set_word<O + 4>(w, v.y);
      set_word<O + 8>(w, v.z);
      set_word<O + 12>(w, v.w);
    } else if constexpr (W == 8) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(src + O));
      set_word<O>(w, v.x);
      set_word<O + 4>(w, v.y);
    } else if constexpr (W == 4) {
      set_word<O>(w, __ldg(reinterpret_cast<const unsigned int*>(src + O)));
    } else {
      set_half<O>(w, __ldg(reinterpret_cast<const unsigned short*>(src + O)));
    }
    load_run<R, NB, O + W>(src, w);
  }
}

// bf16 held as its 16 bits: the f32 with the same upper half (exact)
__device__ __forceinline__ float bf16_to_f32(uint16_t b) {
  return __uint_as_float(static_cast<uint32_t>(b) << 16);
}

// f32 -> bf16 bits, round to nearest even (NaN stays NaN), as torch rounds
__device__ __forceinline__ uint16_t f32_to_bf16(float f) {
  const uint32_t u = __float_as_uint(f);
  if ((u & 0x7fffffffu) > 0x7f800000u) return 0x7fc0;
  return static_cast<uint16_t>((u + 0x7fffu + ((u >> 16) & 1u)) >> 16);
}

template <int V>
struct Residue {
  static constexpr int value = V;
};

// f(Residue<r>{}) for the runtime residue r, an address modulo 16 that is
// a multiple of STEP (2 or 4): one switch per row, so that every vector of
// the row takes the pieces fixed for its residue.
template <int STEP, typename F>
__device__ __forceinline__ void dispatch_residue(int r, F&& f) {
  switch (r) {
    case 0: f(Residue<0>{}); return;
    case 4: f(Residue<4>{}); return;
    case 8: f(Residue<8>{}); return;
    case 12: f(Residue<12>{}); return;
    default: break;
  }
  if constexpr (STEP == 2) {
    switch (r) {
      case 2: f(Residue<2>{}); return;
      case 6: f(Residue<6>{}); return;
      case 10: f(Residue<10>{}); return;
      default: f(Residue<14>{}); return;
    }
  }
}

}  // namespace herald
