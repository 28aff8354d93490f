// Device helpers shared by the Hopper flash-attention kernels
// (flash_attention.cu: K1/K3; flash_backward.cu: K4/K5): the 64-row tile
// geometry, mma.sync m16n8k16 for bf16/fp16 with fp32 accumulators, the
// fragment loads from shared memory, and the zero-padding tile stager.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 64;   // q rows per block (16 per warp)
constexpr int kBlockN = 64;   // kv rows per streamed tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;       // shared-memory row padding, in elements
constexpr float kLog2e = 1.4426950408889634f;

template <typename T>
struct Ops;

template <>
struct Ops<__nv_bfloat16> {
  static __device__ __forceinline__ void mma(float c[4], const uint32_t a[4],
                                             const uint32_t b[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ __nv_bfloat16 cast(float x) {
    return __float2bfloat16(x);
  }
};

template <>
struct Ops<__half> {
  static __device__ __forceinline__ void mma(float c[4], const uint32_t a[4],
                                             const uint32_t b[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ __half cast(float x) {
    return __float2half_rn(x);
  }
};

// Two transposed 8x8 b16 matrices from shared memory: rows k0..k0+15 of a
// row-major [k][n] tile give the m16n8k16 B fragment (k = kv row, n = d).
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t r[2],
                                                  const void* smem) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t lds32(const void* smem) {
  return *reinterpret_cast<const uint32_t*>(smem);
}

// Stage rows [r0, r0 + 64) x cols [0, DP) of a [rows, d] matrix into a
// shared tile with row stride DP + kPad; rows >= `rows` and cols >= d are
// zero, so padded columns add nothing to Q·Kᵀ and padded V rows stay finite.
template <typename T, int DP>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int r0,
                                          int rows, int d, bool vec) {
  constexpr int kChunks = DP / 8;
  constexpr int kStride = DP + kPad;
  const T zero = Ops<T>::cast(0.f);
  for (int i = threadIdx.x; i < kBlockN * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    const int gr = r0 + r;
    T* out = dst + r * kStride + c;
    if (vec && gr < rows && c + 8 <= d) {
      *reinterpret_cast<uint4*>(out) =
          *reinterpret_cast<const uint4*>(src + (size_t)gr * d + c);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        out[e] = (gr < rows && c + e < d) ? src[(size_t)gr * d + c + e] : zero;
      }
    }
  }
}

}  // namespace
