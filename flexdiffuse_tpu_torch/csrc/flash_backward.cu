// Flash-attention backward for Hopper (sm_90a): the gradients of
// o = softmax(q·kᵀ·scale)·v, from the base-2 lse rows that the training
// forward writes (K3, flash_attention.cu) and D = Σ_d dO∘O (one torch
// reduction outside the kernels, as the JAX package does it in XLA).
//
// K4, flash_bwd_dq_kernel, replaces
// flexdiffuse_tpu/ops/flash_backward.py::_dq_kernel (:146); K5,
// flash_bwd_dkv_kernel, replaces _dkv_kernel (:174). As in the JAX package
// the two are separate kernels, so every output element has one owning
// block: no atomics, and the gradients are deterministic.
//
// Both recompute P = exp2(q·kᵀ·scale·log2(e) − lse) tile by tile, so no
// [Sq, Skv] tensor reaches device memory, and form dS = P∘(dP − D)·scale
// with dP = dO·vᵀ in registers:
// - K4: one block of 4 warps per (b·h, 64-row q tile). Each warp owns 16 q
//   rows and holds their Q and dO fragments; 64-row K/V tiles stream
//   through shared memory; dQ += dS·K accumulates in fp32.
// - K5: one block of 4 warps per (b·h, 64-row kv tile). Each warp owns 16
//   kv rows and holds their K and V fragments; Q/dO tiles stream through
//   shared memory with their lse and D entries; dV += Pᵀ·dO and
//   dK += dSᵀ·Q (unscaled Q: the scale is in dS) accumulate in fp32.
// Products run on mma.sync.m16n8k16 (16-bit in, fp32 accumulate), 16
// columns at a time: two accumulator tiles of S and of dP become, after the
// elementwise step, one A fragment of P or dS, so neither leaves registers.
//
// Takes contiguous [B, H, S, D] bf16 or fp16 tensors with Sq != Skv
// allowed, any S >= 1 (ragged tiles masked: P = 0 outside the valid
// columns, ragged rows are computed but never stored) and D <= 128,
// zero-padded to a multiple of 16 in shared memory, as K1 does.
//
// What bounds it on this card: K4 does three and K5 four products of
// 2·Sq·Skv·D flops per head against a few tens of MB of traffic at SD's
// shapes, so both are compute-bound on paper. At SD's d = 40 (padded to 48)
// every score costs an exp2 and a few fp32 FMAs on the CUDA cores next to
// 3·48 (K4) or 4·48 (K5) multiply-adds on the tensor cores, and the tile
// loads are not overlapped with compute, so the kernels are bound by that
// elementwise work and by latency. wgmma, TMA, cp.async pipelining and warp
// specialisation are later work.

#include "flash_common.cuh"

namespace {

constexpr int kChunks = kBlockN / 16;  // 16-column chunks of a 64-wide tile

// A fragments (m16 x k16, one per k-step over d) of 16 rows of a row-major
// shared tile.
template <typename T, int DP>
__device__ __forceinline__ void load_a_frags(uint32_t f[DP / 16][4],
                                             const T* rows, int lane) {
  constexpr int kStride = DP + kPad;
  const int g = lane >> 2;
  const int tq = lane & 3;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const T* p0 = rows + g * kStride + kk * 16 + tq * 2;
    const T* p1 = p0 + 8 * kStride;
    f[kk][0] = lds32(p0);
    f[kk][1] = lds32(p1);
    f[kk][2] = lds32(p0 + 8);
    f[kk][3] = lds32(p1 + 8);
  }
}

// c[j] = A · Bᵀ for the 8 rows n0 + 8j .. n0 + 8j + 7 of a row-major shared
// tile B (k = d), j = 0, 1: one 16 x 16 chunk of scores.
template <typename T, int DP>
__device__ __forceinline__ void chunk_product(float c[2][4],
                                              const uint32_t a[DP / 16][4],
                                              const T* tile, int n0,
                                              int lane) {
  constexpr int kStride = DP + kPad;
  const int g = lane >> 2;
  const int tq = lane & 3;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
    const T* r = tile + (n0 + 8 * j + g) * kStride + tq * 2;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t b[2];
      b[0] = lds32(r + kk * 16);
      b[1] = lds32(r + kk * 16 + 8);
      Ops<T>::mma(c[j], a[kk], b);
    }
  }
}

// The two accumulator tiles of a 16 x 16 chunk as one A fragment.
template <typename T>
__device__ __forceinline__ void pack_a(uint32_t a[4], const float c[2][4]) {
  a[0] = Ops<T>::pack(c[0][0], c[0][1]);
  a[1] = Ops<T>::pack(c[0][2], c[0][3]);
  a[2] = Ops<T>::pack(c[1][0], c[1][1]);
  a[3] = Ops<T>::pack(c[1][2], c[1][3]);
}

// acc[dt] += A · rows [k0, k0 + 16) of a row-major [k][d] shared tile.
template <typename T, int DP>
__device__ __forceinline__ void accumulate(float acc[DP / 8][4],
                                           const uint32_t a[4],
                                           const T* tile, int k0, int lane) {
  constexpr int kStride = DP + kPad;
  const T* r = tile + (k0 + (lane & 15)) * kStride;
#pragma unroll
  for (int dt = 0; dt < DP / 8; ++dt) {
    uint32_t b[2];
    ldmatrix_x2_trans(b, r + dt * 8);
    Ops<T>::mma(acc[dt], a, b);
  }
}

// Rows row0 and row0 + 8 of a [rows, d] output from fp32 accumulators.
template <typename T, int DP>
__device__ __forceinline__ void store_rows(T* out, const float acc[DP / 8][4],
                                           int row0, int rows, int d,
                                           int lane) {
  const int row1 = row0 + 8;
#pragma unroll
  for (int dt = 0; dt < DP / 8; ++dt) {
    const int col = dt * 8 + (lane & 3) * 2;
    if (row0 < rows) {
      if (col < d) out[(size_t)row0 * d + col] = Ops<T>::cast(acc[dt][0]);
      if (col + 1 < d) out[(size_t)row0 * d + col + 1] = Ops<T>::cast(acc[dt][1]);
    }
    if (row1 < rows) {
      if (col < d) out[(size_t)row1 * d + col] = Ops<T>::cast(acc[dt][2]);
      if (col + 1 < d) out[(size_t)row1 * d + col + 1] = Ops<T>::cast(acc[dt][3]);
    }
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ dvec, T* __restrict__ dq,
                        int sq, int skv, int d, float scale_log2, float scale,
                        int vec) {
  static_assert(DP % 16 == 0 && DP <= 128, "head dim tile");
  static_assert(kBlockM == kBlockN, "load_tile stages 64-row tiles");
  constexpr int kStride = DP + kPad;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sDO = sQ + kBlockM * kStride;
  T* sK = sDO + kBlockM * kStride;
  T* sV = sK + kBlockN * kStride;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const size_t bh = blockIdx.y;
  const int q0 = blockIdx.x * kBlockM;

  load_tile<T, DP>(sQ, q + bh * sq * d, q0, sq, d, vec != 0);
  load_tile<T, DP>(sDO, dout + bh * sq * d, q0, sq, d, vec != 0);
  __syncthreads();

  uint32_t qf[DP / 16][4];
  uint32_t dof[DP / 16][4];
  load_a_frags<T, DP>(qf, sQ + warp * 16 * kStride, lane);
  load_a_frags<T, DP>(dof, sDO + warp * 16 * kStride, lane);

  // Rows g and g + 8 of the warp's 16. A ragged row gets lse = +inf, so
  // its P is 0 and nothing non-finite is formed.
  const int row0 = q0 + warp * 16 + g;
  float lse_r[2];
  float d_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    lse_r[r] = row < sq ? lse[bh * sq + row] : INFINITY;
    d_r[r] = row < sq ? dvec[bh * sq + row] : 0.f;
  }

  float acc[DP / 8][4];
#pragma unroll
  for (int dt = 0; dt < DP / 8; ++dt) {
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  }

  const T* kb = k + bh * skv * d;
  const T* vb = v + bh * skv * d;
  const int n_tiles = (skv + kBlockN - 1) / kBlockN;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockN;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<T, DP>(sK, kb, k0, skv, d, vec != 0);
    load_tile<T, DP>(sV, vb, k0, skv, d, vec != 0);
    __syncthreads();

#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      float s[2][4];
      float dp[2][4];
      chunk_product<T, DP>(s, qf, sK, c * 16, lane);   // S = Q·Kᵀ
      chunk_product<T, DP>(dp, dof, sV, c * 16, lane);  // dP = dO·Vᵀ
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + c * 16 + j * 8 + tq * 2 + (e & 1);
          const int r = e >> 1;
          const float p =
              col < skv ? exp2f(s[j][e] * scale_log2 - lse_r[r]) : 0.f;
          s[j][e] = p * (dp[j][e] - d_r[r]) * scale;   // dS
        }
      }
      uint32_t a[4];
      pack_a<T>(a, s);
      accumulate<T, DP>(acc, a, sK, c * 16, lane);      // dQ += dS·K
    }
  }
  store_rows<T, DP>(dq + bh * sq * d, acc, row0, sq, d, lane);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ dvec, T* __restrict__ dk,
                         T* __restrict__ dv, int sq, int skv, int d,
                         float scale_log2, float scale, int vec) {
  static_assert(DP % 16 == 0 && DP <= 128, "head dim tile");
  static_assert(kBlockM == kBlockN, "load_tile stages 64-row tiles");
  constexpr int kStride = DP + kPad;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);
  T* sV = sK + kBlockN * kStride;
  T* sQ = sV + kBlockN * kStride;
  T* sDO = sQ + kBlockM * kStride;
  float* sLse = reinterpret_cast<float*>(sDO + kBlockM * kStride);
  float* sD = sLse + kBlockM;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const size_t bh = blockIdx.y;
  const int kv0 = blockIdx.x * kBlockN;

  load_tile<T, DP>(sK, k + bh * skv * d, kv0, skv, d, vec != 0);
  load_tile<T, DP>(sV, v + bh * skv * d, kv0, skv, d, vec != 0);
  __syncthreads();

  uint32_t kf[DP / 16][4];
  uint32_t vf[DP / 16][4];
  load_a_frags<T, DP>(kf, sK + warp * 16 * kStride, lane);
  load_a_frags<T, DP>(vf, sV + warp * 16 * kStride, lane);

  float dk_acc[DP / 8][4];
  float dv_acc[DP / 8][4];
#pragma unroll
  for (int dt = 0; dt < DP / 8; ++dt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[dt][e] = dv_acc[dt][e] = 0.f;
  }

  const T* qb = q + bh * sq * d;
  const T* dob = dout + bh * sq * d;
  const float* lseb = lse + bh * sq;
  const float* dvecb = dvec + bh * sq;
  const int n_tiles = (sq + kBlockM - 1) / kBlockM;
  for (int t = 0; t < n_tiles; ++t) {
    const int q0 = t * kBlockM;
    __syncthreads();  // every warp is done with the previous Q/dO tile
    load_tile<T, DP>(sQ, qb, q0, sq, d, vec != 0);
    load_tile<T, DP>(sDO, dob, q0, sq, d, vec != 0);
    // A ragged q column gets lse = +inf, so its P and dS are 0.
    for (int i = threadIdx.x; i < kBlockM; i += kThreads) {
      const bool ok = q0 + i < sq;
      sLse[i] = ok ? lseb[q0 + i] : INFINITY;
      sD[i] = ok ? dvecb[q0 + i] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      float s[2][4];
      float dp[2][4];
      chunk_product<T, DP>(s, kf, sQ, c * 16, lane);    // Sᵀ = K·Qᵀ
      chunk_product<T, DP>(dp, vf, sDO, c * 16, lane);  // dPᵀ = V·dOᵀ
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c * 16 + j * 8 + tq * 2 + (e & 1);
          const float p = exp2f(s[j][e] * scale_log2 - sLse[col]);
          s[j][e] = p;                                    // Pᵀ
          dp[j][e] = p * (dp[j][e] - sD[col]) * scale;    // dSᵀ
        }
      }
      uint32_t a[4];
      pack_a<T>(a, s);
      accumulate<T, DP>(dv_acc, a, sDO, c * 16, lane);  // dV += Pᵀ·dO
      pack_a<T>(a, dp);
      accumulate<T, DP>(dk_acc, a, sQ, c * 16, lane);   // dK += dSᵀ·Q
    }
  }
  const int row0 = kv0 + warp * 16 + g;
  store_rows<T, DP>(dk + bh * skv * d, dk_acc, row0, skv, d, lane);
  store_rows<T, DP>(dv + bh * skv * d, dv_acc, row0, skv, d, lane);
}

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* dvec;
  void* dq;
  void* dk;
  void* dv;
  int batch_heads, sq, skv, d;
  float scale;
  int vec;
};

template <typename T, int DP, bool kDq>
int launch_dp(const BwdArgs& a, cudaStream_t stream) {
  const int tiles = 4 * kBlockM * (DP + kPad) * (int)sizeof(T);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const float scale_log2 = a.scale * kLog2e;
  cudaError_t err;
  if constexpr (kDq) {
    // Above 48 KB (DP >= 96) dynamic shared memory needs the opt-in.
    err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               tiles);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((a.sq + kBlockM - 1) / kBlockM, a.batch_heads);
    flash_bwd_dq_kernel<T, DP><<<grid, kThreads, tiles, stream>>>(
        q, k, v, dout, a.lse, a.dvec, static_cast<T*>(a.dq), a.sq, a.skv,
        a.d, scale_log2, a.scale, a.vec);
  } else {
    const int smem = tiles + 2 * kBlockM * (int)sizeof(float);
    err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((a.skv + kBlockN - 1) / kBlockN, a.batch_heads);
    flash_bwd_dkv_kernel<T, DP><<<grid, kThreads, smem, stream>>>(
        q, k, v, dout, a.lse, a.dvec, static_cast<T*>(a.dk),
        static_cast<T*>(a.dv), a.sq, a.skv, a.d, scale_log2, a.scale, a.vec);
  }
  return (int)cudaGetLastError();
}

template <typename T, bool kDq>
int launch(const BwdArgs& a, cudaStream_t stream) {
#define FLASH_BWD_CASE(n) \
  case n / 16:            \
    return launch_dp<T, n, kDq>(a, stream);
  switch ((a.d + 15) / 16) {
    FLASH_BWD_CASE(16) FLASH_BWD_CASE(32) FLASH_BWD_CASE(48)
    FLASH_BWD_CASE(64) FLASH_BWD_CASE(80) FLASH_BWD_CASE(96)
    FLASH_BWD_CASE(112) FLASH_BWD_CASE(128)
    default: return (int)cudaErrorInvalidValue;
  }
#undef FLASH_BWD_CASE
}

template <bool kDq>
int dispatch(const BwdArgs& a, int dtype, void* stream) {
  if (a.batch_heads < 1 || a.batch_heads > 65535 || a.sq < 1 || a.skv < 1 ||
      a.d < 1 || a.d > 128) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<__nv_bfloat16, kDq>(a, s);
  if (dtype == 1) return launch<__half, kDq>(a, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry points (bound with ctypes). q, dout: [batch_heads, sq, d];
// k, v: [batch_heads, skv, d]; lse, dvec: fp32 [batch_heads, sq]. dtype:
// 0 = bf16, 1 = fp16. vec != 0 promises 16-byte aligned rows (d % 8 == 0,
// aligned pointers). Each launches on `stream` and returns
// cudaGetLastError() after the launch.

// K4: dq [batch_heads, sq, d].
extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const float* lse, const float* dvec,
                                      void* dq, int batch_heads, int sq,
                                      int skv, int d, float scale, int dtype,
                                      int vec, void* stream) {
  const BwdArgs a{q, k, v, dout, lse, dvec, dq, nullptr, nullptr,
                  batch_heads, sq, skv, d, scale, vec};
  return dispatch<true>(a, dtype, stream);
}

// K5: dk, dv [batch_heads, skv, d].
extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const float* lse, const float* dvec,
                                       void* dk, void* dv, int batch_heads,
                                       int sq, int skv, int d, float scale,
                                       int dtype, int vec, void* stream) {
  const BwdArgs a{q, k, v, dout, lse, dvec, nullptr, dk, dv,
                  batch_heads, sq, skv, d, scale, vec};
  return dispatch<false>(a, dtype, stream);
}
