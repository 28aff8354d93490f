// Forward flash attention for Hopper (sm_90a): softmax(q·kᵀ·scale)·v.
//
// Replaces flexdiffuse_tpu/ops/flash_attention.py::_flash_tt_kernel (K1)
// and, because K/V always stream through shared memory here, also its
// VMEM-overflow twin _flash_stream_kernel (K2). Instantiated with kLse it
// is K3, the training forward, which also writes the base-2 log-sum-exp
// rows lse = m + log2(l) in fp32 (replaces
// flexdiffuse_tpu/ops/flash_backward.py::_fwd_lse_kernel, :62); the
// backward kernels K4/K5 (flash_backward.cu) recompute P from them. The
// kLse = false instantiation is K1 unchanged. The TPU kernel's
// transposed [d, s] operands and its ones-row sum fold answer the TPU's
// 128-lane width and its vector unit; neither is carried over.
//
// Takes contiguous [B, H, S, D] bf16 or fp16 tensors, accumulates in fp32,
// allows Sq != Skv, masks the ragged last tiles (any S >= 1) and takes any
// D <= 128, zero-padded in shared memory to a multiple of 16.
//
// Design (simple first): one thread block of 4 warps per (b·h, 64-row q
// tile); each warp owns 16 q rows. A loop walks 64-row K/V tiles staged in
// shared memory. Q·Kᵀ and P·V run on the tensor cores with
// mma.sync.m16n8k16 (16-bit in, fp32 accumulate); the online softmax runs
// in base 2 with scale·log2(e) folded into the scores, and the row max and
// row sum stay in registers. The [Sq, Skv] scores never reach device
// memory: each block reads its Q tile once, streams K/V once and writes O
// once.
//
// What bounds it on this card: at SD's d = 40 (padded to 48) a score costs
// 48 multiply-adds on the tensor cores but an exp2, a max, a sum and a
// rescale on the CUDA cores, and the loads are not overlapped with compute,
// so the kernel is bound by the softmax and by latency, not by the tensor
// cores or device memory. wgmma, TMA, cp.async pipelining and warp
// specialisation are later work.

#include "flash_common.cuh"

namespace {

template <typename T, int DP, bool kLse>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int sq, int skv, int d,
                     float scale_log2, int vec) {
  static_assert(DP % 16 == 0 && DP <= 128, "head dim tile");
  static_assert(kBlockM == kBlockN, "load_tile stages 64-row tiles");
  constexpr int kStride = DP + kPad;
  constexpr int kKSteps = DP / 16;       // k-steps of Q·Kᵀ over d
  constexpr int kDTiles = DP / 8;        // n-tiles of P·V over d
  constexpr int kNTiles = kBlockN / 8;   // n-tiles of Q·Kᵀ over kv
  constexpr int kPSteps = kBlockN / 16;  // k-steps of P·V over kv

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sK = sQ + kBlockM * kStride;
  T* sV = sK + kBlockN * kStride;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;   // fragment row within 8
  const int tq = lane & 3;   // thread within quad
  const size_t bh = blockIdx.y;
  const int q0 = blockIdx.x * kBlockM;

  const T* qb = q + bh * sq * d;
  const T* kb = k + bh * skv * d;
  const T* vb = v + bh * skv * d;
  T* ob = o + bh * sq * d;

  load_tile<T, DP>(sQ, qb, q0, sq, d, vec != 0);
  __syncthreads();

  // A fragments of this warp's 16 q rows, held for the whole kv loop.
  uint32_t qf[kKSteps][4];
  const T* sQw = sQ + warp * 16 * kStride;
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk) {
    const T* p0 = sQw + g * kStride + kk * 16 + tq * 2;
    const T* p1 = p0 + 8 * kStride;
    qf[kk][0] = lds32(p0);
    qf[kk][1] = lds32(p1);
    qf[kk][2] = lds32(p0 + 8);
    qf[kk][3] = lds32(p1 + 8);
  }

  float oacc[kDTiles][4];
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt) {
    oacc[dt][0] = oacc[dt][1] = oacc[dt][2] = oacc[dt][3] = 0.f;
  }
  // Rows g and g + 8 of the warp's 16: running max and (quad-partial) sum.
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  const int n_tiles = (skv + kBlockN - 1) / kBlockN;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockN;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<T, DP>(sK, kb, k0, skv, d, vec != 0);
    load_tile<T, DP>(sV, vb, k0, skv, d, vec != 0);
    __syncthreads();

    // S = Q·Kᵀ for 16 x 64 scores per warp.
    float s[kNTiles][4];
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const T* kr = sK + (nt * 8 + g) * kStride + tq * 2;
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        uint32_t b[2];
        b[0] = lds32(kr + kk * 16);
        b[1] = lds32(kr + kk * 16 + 8);
        Ops<T>::mma(s[nt], qf[kk], b);
      }
    }

    // Base-2 scores, ragged columns masked, row max over the quad.
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + tq * 2 + (e & 1);
        const float x = col < skv ? s[nt][e] * scale_log2 : -INFINITY;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // Column k0 is always valid, so mx is finite; exp2(-inf) = 0 on the
      // first tile.
      alpha[r] = exp2f(m_run[r] - mx[r]);
      m_run[r] = mx[r];
    }

    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[nt][e] - m_run[e >> 1]);
        s[nt][e] = p;
        rs[e >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + rs[r];
#pragma unroll
    for (int dt = 0; dt < kDTiles; ++dt) {
      oacc[dt][0] *= alpha[0];
      oacc[dt][1] *= alpha[0];
      oacc[dt][2] *= alpha[1];
      oacc[dt][3] *= alpha[1];
    }

    // O += P·V: two accumulator n-tiles of S form one A fragment of P.
#pragma unroll
    for (int kt = 0; kt < kPSteps; ++kt) {
      uint32_t a[4];
      a[0] = Ops<T>::pack(s[2 * kt][0], s[2 * kt][1]);
      a[1] = Ops<T>::pack(s[2 * kt][2], s[2 * kt][3]);
      a[2] = Ops<T>::pack(s[2 * kt + 1][0], s[2 * kt + 1][1]);
      a[3] = Ops<T>::pack(s[2 * kt + 1][2], s[2 * kt + 1][3]);
      const T* vr = sV + (kt * 16 + (lane & 15)) * kStride;
#pragma unroll
      for (int dt = 0; dt < kDTiles; ++dt) {
        uint32_t b[2];
        ldmatrix_x2_trans(b, vr + dt * 8);
        Ops<T>::mma(oacc[dt], a, b);
      }
    }
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = 1.f / l;
    if constexpr (kLse) {
      const int row = q0 + warp * 16 + g + 8 * r;
      if (tq == 0 && row < sq) lse[bh * sq + row] = m_run[r] + log2f(l);
    }
  }
  const int row0 = q0 + warp * 16 + g;
  const int row1 = row0 + 8;
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt) {
    const int col = dt * 8 + tq * 2;
    if (row0 < sq) {
      if (col < d) ob[(size_t)row0 * d + col] = Ops<T>::cast(oacc[dt][0] * inv[0]);
      if (col + 1 < d) ob[(size_t)row0 * d + col + 1] = Ops<T>::cast(oacc[dt][1] * inv[0]);
    }
    if (row1 < sq) {
      if (col < d) ob[(size_t)row1 * d + col] = Ops<T>::cast(oacc[dt][2] * inv[1]);
      if (col + 1 < d) ob[(size_t)row1 * d + col + 1] = Ops<T>::cast(oacc[dt][3] * inv[1]);
    }
  }
}

template <typename T, int DP, bool kLse>
int launch_dp(const void* q, const void* k, const void* v, void* o,
              float* lse, int batch_heads, int sq, int skv, int d,
              float scale, int vec, cudaStream_t stream) {
  const int smem = (kBlockM + 2 * kBlockN) * (DP + kPad) * (int)sizeof(T);
  // Above 48 KB (DP = 128) dynamic shared memory needs the opt-in.
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DP, kLse>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + kBlockM - 1) / kBlockM, batch_heads);
  flash_fwd_kernel<T, DP, kLse><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, sq, skv, d,
      scale * kLog2e, vec);
  return (int)cudaGetLastError();
}

template <typename T, bool kLse>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int batch_heads, int sq, int skv, int d, float scale, int vec,
           cudaStream_t stream) {
#define FLASH_CASE(n) \
  case n / 16: \
    return launch_dp<T, n, kLse>(q, k, v, o, lse, batch_heads, sq, skv, d, \
                                 scale, vec, stream);
  switch ((d + 15) / 16) {
    FLASH_CASE(16) FLASH_CASE(32) FLASH_CASE(48) FLASH_CASE(64)
    FLASH_CASE(80) FLASH_CASE(96) FLASH_CASE(112) FLASH_CASE(128)
    default: return (int)cudaErrorInvalidValue;
  }
#undef FLASH_CASE
}

template <bool kLse>
int dispatch(const void* q, const void* k, const void* v, void* o,
             float* lse, int batch_heads, int sq, int skv, int d,
             float scale, int dtype, int vec, void* stream) {
  if (batch_heads < 1 || batch_heads > 65535 || sq < 1 || skv < 1 || d < 1 ||
      d > 128) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<__nv_bfloat16, kLse>(q, k, v, o, lse, batch_heads, sq, skv,
                                       d, scale, vec, s);
  }
  if (dtype == 1) {
    return launch<__half, kLse>(q, k, v, o, lse, batch_heads, sq, skv, d,
                                scale, vec, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry points (bound with ctypes). dtype: 0 = bf16, 1 = fp16.
// vec != 0 promises 16-byte aligned rows (d % 8 == 0, aligned pointers).
// Each launches on `stream` and returns cudaGetLastError() after the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int batch_heads,
                                   int sq, int skv, int d, float scale,
                                   int dtype, int vec, void* stream) {
  return dispatch<false>(q, k, v, o, nullptr, batch_heads, sq, skv, d, scale,
                         dtype, vec, stream);
}

// K3: as flash_attention_fwd, and also writes lse[batch_heads, sq] (fp32,
// base 2: the row max of q·kᵀ·scale·log2(e) plus log2 of the row sum).
extern "C" int flash_attention_fwd_lse(const void* q, const void* k,
                                       const void* v, void* o, float* lse,
                                       int batch_heads, int sq, int skv,
                                       int d, float scale, int dtype, int vec,
                                       void* stream) {
  return dispatch<true>(q, k, v, o, lse, batch_heads, sq, skv, d, scale,
                        dtype, vec, stream);
}
