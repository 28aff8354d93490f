// Flash-attention backward for Hopper (sm_90a): the gradients of
// o = softmax(q·kᵀ·scale)·v, from the base-2 lse rows that the training
// forward writes (K3, flash_attention.cu) and D = Σ_d dO∘O (one torch
// reduction outside the kernels, as the JAX package does it in XLA).
//
// K4 replaces flexdiffuse_tpu/ops/flash_backward.py::_dq_kernel (:146); K5
// replaces _dkv_kernel (:174). As in the JAX package the two are separate
// kernels, so every output element has one owning block: no atomics, and
// the gradients are bit-deterministic from run to run. Both recompute
// P = exp2(s·c − lse) tile by tile (c = scale·log2 e in fp32, applied to
// the fp32 score: q is never pre-scaled in its 16-bit type, so K3's
// rounding is the forward's), so no [Sq, Skv] tensor reaches device
// memory, and form dS = P∘(dP − D)·scale with dP = dO·vᵀ in registers.
// The TPU kernels' whole-resident K/V and Q/dO blocks answer VMEM; here the
// streamed operand goes through a ring of shared-memory stages.
//
// What bounds them on this card. Per score each kernel does one exp2 on the
// 16-lane-per-SM MUFU unit: at (4,8,4096,40) 537 M of them take 0.128 ms on
// 132 SMs at 1.98 GHz. K4 does three products of 2·Sq·Skv·DP flops and K5
// four: 0.156 and 0.208 ms on the tensor cores at the padded DP = 48 (0.130
// and 0.174 at d = 40). The bytes take ~0.01 ms. So the tensor cores and
// the exponential unit bound both together, and each consumer's dependent
// chain per tile (score products, exponentials, conversion to 16 bits,
// accumulating products) decides how much of either is used; the design
// keeps two chains per SM and lets one's products run under the other's
// elementwise step. At (4,8,1024,80) the tensor cores bound both.
//
// The Hopper path (flash_bwd_dq_sm90_kernel, flash_bwd_dkv_sm90_kernel),
// for d % 8 == 0 and 16-byte aligned tensors (what TMA takes), K1's
// structure (flash_attention.cu):
// - Warp specialisation: warpgroup 0 is the producer. One thread issues
//   every TMA load through 3-D [B·H, S, D] tensor maps, whose zero fill
//   pads ragged rows and the columns d..DP: the block's own operands once,
//   then the streamed tiles into a ring of kStages stages with full and
//   empty mbarriers. The producer gives its registers to the consumers
//   (setmaxnreg). Two consumer warpgroups each own 64 rows.
// - K4 (dq): one block per (b·h, 128 q rows); each consumer holds its Q and
//   dO tiles, K_j and V_j stream. Per kv tile: S = Q·K_jᵀ and
//   dP = dO·V_jᵀ by wgmma with both operands K-major in shared memory,
//   issued together; dS in registers (lse and D·scale per row, held for
//   the whole block); dQ += dS·K_j by wgmma with A = dS from registers (the
//   fp32 accumulator converted in place: its fragment layout is the
//   register-A layout) and B = K_j MN-major (the transpose bit).
// - K5 (dk, dv): one block per (b·h, 128 kv rows); each consumer holds its
//   K and V tiles, Q_i, dO_i and their lse_i and D_i·scale stream (a second
//   producer warp writes those rows into the stage, +inf / 0 past Sq, so a
//   ragged q column has P = dS = 0). Computed transposed, so that every
//   product keeps A in registers or K-major in shared memory:
//   Sᵀ = K·Q_iᵀ, dPᵀ = V·dO_iᵀ; Pᵀ and dSᵀ in registers with lse_i and D_i
//   per column from shared memory; dV += Pᵀ·dO_i and dK += dSᵀ·Q_i with A
//   from registers and B MN-major. dK and dV stay in fp32 registers: DP / 2
//   each a thread.
// - Overlap. K4: tile j's two score products are issued together with tile
//   j−1's dQ product, so the elementwise step of tile j runs while that is
//   on the tensor cores, and the two consumers take turns to issue
//   (sm90::Turns). K5: tile i's dV and dK products go out in one group with
//   tile i+1's score products, and the elementwise step runs while the
//   other consumer's products are on the tensor cores (K5's own overlap,
//   which holds 144 registers of operands at once, and turns both measured
//   slower: PERF.md). A stage goes back to the producer once its
//   accumulating products are done.
// - Tiles (BwdTiling): the swizzle as K1 chooses it (128-byte for DP <= 64,
//   32-byte above). K4 streams kv tiles of 64 at every width. K5's
//   operands take 1.5 · q tile + DP registers a thread (Sᵀ, dPᵀ, both A
//   fragments, dK, dV) of the 168 that ptxas gives a thread of a
//   384-thread block: K5 streams q tiles of 32 above DP = 48, and of 64 up
//   to it, where ptxas serialises the wgmma for registers (C7512) and the
//   tile of 64 still measured fastest (tiles of 32 or 48, three consumers:
//   PERF.md).
// - Epilogue: each consumer writes its gradient rows into its own Q (K4) or
//   K and V (K5) tiles, free by then, in the swizzled layout; TMA stores
//   them, dropping rows past S and columns past d.
// The wrapper (ops/flash_backward.py::plan_backward) picks the path before
// the launch.
//
// The kept path (flash_bwd_dq_kernel, flash_bwd_dkv_kernel, the first
// port's design) serves what TMA cannot take: d % 8 != 0, a misaligned
// pointer, or fp32 tensors. K4: one block of 4 warps per (b·h, 64-row q tile),
// each warp owning 16 q rows with their Q and dO fragments, 64-row K/V
// tiles staged through shared memory. K5: one block per (b·h, 64-row kv
// tile), each warp owning 16 kv rows with their K and V fragments, Q/dO
// tiles and their lse and D entries staged. Products on mma.sync.m16n8k16,
// 16 columns at a time: two accumulator tiles of S and of dP become, after
// the elementwise step, one A fragment of P or dS. Head dims are zero-padded
// to a multiple of 16 in shared memory; ragged tiles are masked. fp32 q, k,
// v and dO are rounded to bf16 as they are staged, and P and dS to bf16
// before their products, as K1's kept kernel does (flash_attention.cu): the
// operand precision of the TPU's matrix unit on fp32 at default precision.
// lse, D, the scores, the accumulators and the fp32 gradients stay fp32.
//
// Both paths take contiguous [B, H, S, D] bf16 or fp16 tensors (the kept
// path also fp32) with Sq != Skv allowed, any S >= 1 and D <= 128.

#include <type_traits>
#include <utility>

#include "flash_common.cuh"
#include "sm90.cuh"

// The build: ops/flash_backward.py compiles this file BUILD_PARTS times at
// once (-DBUILD_PART=p) and links the objects. Part 0 holds the kept
// kernels, the launcher table and the entry points; the Hopper kernels'
// (dtype, width, kernel) units are spread over the other parts. A compile
// without these macros holds everything.
#ifndef BUILD_PARTS
#define BUILD_PARTS 1
#define BUILD_PART 0
#endif

namespace flash_bwd {

// One K4 or K5 call; the outputs the kernel does not write are null.
struct Args {
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
  int vec;  // the kept path: 16-byte aligned rows
};

using Launcher = int (*)(const Args&, cudaStream_t);

// The Hopper path's launchers, [dtype][DP / 16 - 1][0: K4, 1: K5], filled
// when the library loads.
extern Launcher sm90_launchers[2][8][2];
#if BUILD_PART == 0
Launcher sm90_launchers[2][8][2] = {};
#endif

}  // namespace flash_bwd

#if BUILD_PART == 0
namespace {

using BwdArgs = flash_bwd::Args;


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

// Rows row0 and row0 + 8 of a [rows, d] output of TI from fp32
// accumulators.
template <typename T, int DP, typename TI>
__device__ __forceinline__ void store_rows(TI* out, const float acc[DP / 8][4],
                                           int row0, int rows, int d,
                                           int lane) {
  const int row1 = row0 + 8;
#pragma unroll
  for (int dt = 0; dt < DP / 8; ++dt) {
    const int col = dt * 8 + (lane & 3) * 2;
    if (row0 < rows) {
      if (col < d) out[(size_t)row0 * d + col] = to_out<T, TI>(acc[dt][0]);
      if (col + 1 < d) out[(size_t)row0 * d + col + 1] = to_out<T, TI>(acc[dt][1]);
    }
    if (row1 < rows) {
      if (col < d) out[(size_t)row1 * d + col] = to_out<T, TI>(acc[dt][2]);
      if (col + 1 < d) out[(size_t)row1 * d + col + 1] = to_out<T, TI>(acc[dt][3]);
    }
  }
}

// T: the 16-bit type of the shared tiles and the products; TI: the type of
// q, k, v, dO and the gradients (T, or float).
template <typename T, int DP, typename TI>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const TI* __restrict__ q, const TI* __restrict__ k,
                        const TI* __restrict__ v, const TI* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ dvec, TI* __restrict__ dq,
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

  const TI* kb = k + bh * skv * d;
  const TI* vb = v + bh * skv * d;
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
  store_rows<T, DP, TI>(dq + bh * sq * d, acc, row0, sq, d, lane);
}

template <typename T, int DP, typename TI>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const TI* __restrict__ q, const TI* __restrict__ k,
                         const TI* __restrict__ v, const TI* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ dvec, TI* __restrict__ dk,
                         TI* __restrict__ dv, int sq, int skv, int d,
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

  const TI* qb = q + bh * sq * d;
  const TI* dob = dout + bh * sq * d;
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
  store_rows<T, DP, TI>(dk + bh * skv * d, dk_acc, row0, skv, d, lane);
  store_rows<T, DP, TI>(dv + bh * skv * d, dv_acc, row0, skv, d, lane);
}

template <typename T, int DP, bool kDq, typename TI>
int launch_dp(const BwdArgs& a, cudaStream_t stream) {
  const int tiles = 4 * kBlockM * (DP + kPad) * (int)sizeof(T);
  const TI* q = static_cast<const TI*>(a.q);
  const TI* k = static_cast<const TI*>(a.k);
  const TI* v = static_cast<const TI*>(a.v);
  const TI* dout = static_cast<const TI*>(a.dout);
  const float scale_log2 = a.scale * kLog2e;
  cudaError_t err;
  if constexpr (kDq) {
    // Above 48 KB (DP >= 96) dynamic shared memory needs the opt-in.
    err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, DP, TI>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               tiles);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((a.sq + kBlockM - 1) / kBlockM, a.batch_heads);
    flash_bwd_dq_kernel<T, DP, TI><<<grid, kThreads, tiles, stream>>>(
        q, k, v, dout, a.lse, a.dvec, static_cast<TI*>(a.dq), a.sq, a.skv,
        a.d, scale_log2, a.scale, a.vec);
  } else {
    const int smem = tiles + 2 * kBlockM * (int)sizeof(float);
    err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, DP, TI>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((a.skv + kBlockN - 1) / kBlockN, a.batch_heads);
    flash_bwd_dkv_kernel<T, DP, TI><<<grid, kThreads, smem, stream>>>(
        q, k, v, dout, a.lse, a.dvec, static_cast<TI*>(a.dk),
        static_cast<TI*>(a.dv), a.sq, a.skv, a.d, scale_log2, a.scale, a.vec);
  }
  return (int)cudaGetLastError();
}

template <typename T, bool kDq, typename TI>
int launch(const BwdArgs& a, cudaStream_t stream) {
#define FLASH_BWD_CASE(n) \
  case n / 16:            \
    return launch_dp<T, n, kDq, TI>(a, stream);
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
  if (dtype == 0) return launch<__nv_bfloat16, kDq, __nv_bfloat16>(a, s);
  if (dtype == 1) return launch<__half, kDq, __half>(a, s);
  if (dtype == 2) return launch<__nv_bfloat16, kDq, float>(a, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
#endif  // BUILD_PART == 0

// ---------------------------------------------------------------------------
// The Hopper path.

namespace {

constexpr int kRows = 64;      // rows a consumer warpgroup owns (one wgmma M)
constexpr int kMaxWidths = 8;  // DP = 16, 32, ..., 128
constexpr int kStages = 4;     // streamed tiles in the ring

// The tiles of a head width, chosen here alone (the wrapper knows only the
// path and DP): the swizzle span in bytes; K4's consumer warpgroups and kv
// tile; K5's consumer warpgroups and q tile.
template <int DP>
struct BwdTiling {
  static constexpr int kPitch = DP <= 64 ? 128 : 32;
  static constexpr int kDqConsumers = 2;
  static constexpr int kKvTile = 64;
  static constexpr int kDkvConsumers = 2;
  static constexpr int kQTile = DP <= 48 ? 64 : 32;
};

// K4's shared memory, in bytes from a 1024-aligned base: each consumer's Q
// tile (later its dQ tile), each consumer's dO tile, the K and V stages,
// the barriers.
template <int kPitch, int DP, int BN, int C>
struct DqLayout {
  using G = sm90::Geometry<kPitch, DP>;
  static constexpr int kQ = G::bytes(kRows);
  static constexpr int kDO = C * kQ;
  static constexpr int kKV = G::bytes(BN);
  static constexpr int kK = 2 * C * kQ;
  static constexpr int kV = kK + kStages * kKV;
  static constexpr int kBars = kV + kStages * kKV;
  static constexpr int kBytes = kBars + (2 * kStages + 1) * 8 + 1024;
};

// K5's: each consumer's K and V tiles (later its dK and dV tiles), the Q
// and dO stages, each stage's lse and D·scale rows (fp32), the barriers.
template <int kPitch, int DP, int BM, int C>
struct DkvLayout {
  using G = sm90::Geometry<kPitch, DP>;
  static constexpr int kKt = G::bytes(kRows);
  static constexpr int kV = C * kKt;
  static constexpr int kQt = G::bytes(BM);
  static constexpr int kQ = 2 * C * kKt;
  static constexpr int kDO = kQ + kStages * kQt;
  static constexpr int kLse = kDO + kStages * kQt;
  static constexpr int kD = kLse + kStages * BM * 4;
  static constexpr int kBars = kD + kStages * BM * 4;
  static constexpr int kBytes = kBars + (2 * kStages + 1) * 8 + 1024;
};

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((1024 - (sm90::smem_u32(raw) & 1023)) & 1023);
}

// The accumulator n-blocks 2kt, 2kt + 1 of a 64 x N fp32 tile are the
// register A fragment of k-step kt of the next product.
template <typename T, int N>
__device__ __forceinline__ void to_a(const float (&acc)[N / 2],
                                     uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int kt = 0; kt < N / 16; ++kt) {
    a[kt][0] = Ops<T>::pack(acc[8 * kt], acc[8 * kt + 1]);
    a[kt][1] = Ops<T>::pack(acc[8 * kt + 2], acc[8 * kt + 3]);
    a[kt][2] = Ops<T>::pack(acc[8 * kt + 4], acc[8 * kt + 5]);
    a[kt][3] = Ops<T>::pack(acc[8 * kt + 6], acc[8 * kt + 7]);
  }
}

// A consumer's 64 x DP fp32 accumulator into its tile (rows 16·warp + g and
// + 8 of each warp), in the swizzled layout the output map's TMA store
// reads.
template <typename T, int kPitch, int DP>
__device__ __forceinline__ void stage_out(unsigned char* tile,
                                          const float (&acc)[DP / 2],
                                          int warp, int g, int tq) {
  using G = sm90::Geometry<kPitch, DP>;
#pragma unroll
  for (int i = 0; i < DP / 8; ++i) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int off = G::offset(warp * 16 + g + 8 * r, 8 * i + 2 * tq, kRows);
      *reinterpret_cast<uint32_t*>(tile + off) =
          Ops<T>::pack(acc[4 * i + 2 * r], acc[4 * i + 2 * r + 1]);
    }
  }
}

// Loads the slabs of a rows x DP box at (row0, plane) into a tile.
template <int kPitch, int DP>
__device__ __forceinline__ void load_box(unsigned char* tile,
                                         const CUtensorMap* map,
                                         uint64_t* bar, int rows, int row0,
                                         int plane) {
  using G = sm90::Geometry<kPitch, DP>;
#pragma unroll
  for (int sl = 0; sl < G::kSlabs; ++sl) {
    sm90::tma_load_3d(tile + sl * rows * kPitch, map, bar,
                      sl * G::kSlabCols, row0, plane);
  }
}

template <int kPitch, int DP>
__device__ __forceinline__ void store_box(const CUtensorMap* map,
                                          const unsigned char* tile,
                                          int row0, int plane) {
  using G = sm90::Geometry<kPitch, DP>;
#pragma unroll
  for (int sl = 0; sl < G::kSlabs; ++sl) {
    sm90::tma_store_3d(map, tile + sl * kRows * kPitch, sl * G::kSlabCols,
                       row0, plane);
  }
}

// K4: dq for the 64·C q rows of block (blockIdx.x, b·h).
template <typename T, int DP>
__global__ void __launch_bounds__((BwdTiling<DP>::kDqConsumers + 1) * 128, 1)
    flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_do,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             const __grid_constant__ CUtensorMap tm_dq,
                             const float* __restrict__ lse,
                             const float* __restrict__ dvec, int sq, int skv,
                             float scale_log2, float scale) {
  using Tl = BwdTiling<DP>;
  constexpr int kPitch = Tl::kPitch, BN = Tl::kKvTile, C = Tl::kDqConsumers,
                S = kStages;
  static_assert(DP % 16 == 0 && DP <= 128, "head width");
  using G = sm90::Geometry<kPitch, DP>;
  using L = DqLayout<kPitch, DP, BN, C>;
  using Regs = sm90::Regs<C>;

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* kv_full = q_full + 1;
  uint64_t* kv_empty = kv_full + S;

  const int wg = threadIdx.x / 128;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kRows * C;
  const int n_tiles = (skv + BN - 1) / BN;

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      sm90::mbar_init(&kv_full[s], 1);
      sm90::mbar_init(&kv_empty[s], C);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // Producer: one thread loads Q and dO once, then keeps the ring full.
    sm90::regs_dec<Regs::kProducer>();
    if (threadIdx.x == 0) {
      sm90::prefetch_map(&tm_q);
      sm90::prefetch_map(&tm_do);
      sm90::prefetch_map(&tm_k);
      sm90::prefetch_map(&tm_v);
      sm90::mbar_expect_tx(q_full, 2 * C * L::kQ);
      for (int c = 0; c < C; ++c) {
        load_box<kPitch, DP>(smem + c * L::kQ, &tm_q, q_full, kRows,
                             q0 + c * kRows, bh);
        load_box<kPitch, DP>(smem + L::kDO + c * L::kQ, &tm_do, q_full,
                             kRows, q0 + c * kRows, bh);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % S;
        if (j >= S) sm90::mbar_wait(&kv_empty[s], ((j / S) & 1) ^ 1);
        sm90::mbar_expect_tx(&kv_full[s], 2 * L::kKV);
        load_box<kPitch, DP>(smem + L::kK + s * L::kKV, &tm_k, &kv_full[s],
                             BN, j * BN, bh);
        load_box<kPitch, DP>(smem + L::kV + s * L::kKV, &tm_v, &kv_full[s],
                             BN, j * BN, bh);
      }
    }
  } else {
    // Consumer warpgroup cw: q rows q0 + 64·cw ... + 63.
    sm90::regs_inc<Regs::kConsumer>();
    const int cw = wg - 1;
    const int t = threadIdx.x % 128;
    const int warp = t / 32;
    const int g = (t % 32) / 4;
    const int tq = t % 4;
    unsigned char* s_q = smem + cw * L::kQ;
    const unsigned char* s_do = smem + L::kDO + cw * L::kQ;
    auto k_tile = [&](int j) { return smem + L::kK + (j % S) * L::kKV; };
    auto v_tile = [&](int j) { return smem + L::kV + (j % S) * L::kKV; };

    // Rows g and g + 8 of the warp's 16: lse and D·scale. A row past Sq
    // gets lse = +inf, so its P and dS are 0.
    float lse_r[2], dsc_r[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + cw * kRows + warp * 16 + g + 8 * r;
      const bool ok = row < sq;
      lse_r[r] = ok ? lse[(size_t)bh * sq + row] : INFINITY;
      dsc_r[r] = ok ? dvec[(size_t)bh * sq + row] * scale : 0.f;
    }
    float dq[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dq[i] = 0.f;
    float sc[BN / 2];
    float dp[BN / 2];
    uint32_t dsa[BN / 16][4];

    // S = Q·K_jᵀ and dP = dO·V_jᵀ, one commit group.
    auto issue_scores = [&](int j) {
      sm90::mbar_wait(&kv_full[j % S], (j / S) & 1);
      sm90::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < DP / 16; ++ks) {
        sm90::Wgmma<T, BN>::ss(sc, G::kmajor(s_q + G::kstep(ks, kRows)),
                               G::kmajor(k_tile(j) + G::kstep(ks, BN)),
                               ks > 0);
      }
#pragma unroll
      for (int ks = 0; ks < DP / 16; ++ks) {
        sm90::Wgmma<T, BN>::ss(dp, G::kmajor(s_do + G::kstep(ks, kRows)),
                               G::kmajor(v_tile(j) + G::kstep(ks, BN)),
                               ks > 0);
      }
      sm90::wgmma_commit();
    };
    // dQ += dS_j·K_j.
    auto issue_dq = [&](int j) {
      sm90::fence_regs(dq);
      sm90::wgmma_fence();
#pragma unroll
      for (int kt = 0; kt < BN / 16; ++kt) {
        sm90::WgmmaRs<T, DP>::rs(
            dq, dsa[kt], G::mnmajor(k_tile(j) + kt * 16 * kPitch, BN), 1);
      }
      sm90::wgmma_commit();
    };
    // After dS_j·K_j has completed: K_j/V_j back to the producer.
    auto dq_done = [&](int j) {
      sm90::fence_regs(dq);
      sm90::fence_regs(dsa);
      if (t == 0) sm90::mbar_arrive(&kv_empty[j % S]);
    };
    // dS = exp2(s·c − lse)∘(dP·scale − D·scale), in place in sc. Columns
    // past Skv (only in the ragged last tile) get s = −inf, so P = 0.
    auto grad = [&](int j) {
      sm90::fence_regs(sc);
      sm90::fence_regs(dp);
      if (j * BN + BN > skv) {
#pragma unroll
        for (int i = 0; i < BN / 8; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (j * BN + 8 * i + 2 * tq + (e & 1) >= skv) sc[4 * i + e] = -INFINITY;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = sm90::ex2(
              __fmaf_rn(sc[4 * i + e], scale_log2, -lse_r[e >> 1]));
          sc[4 * i + e] =
              p * __fmaf_rn(dp[4 * i + e], scale, -dsc_r[e >> 1]);
        }
      }
    };

    // The consumers take turns to issue their products (sm90::Turns).
    if (cw == C - 1) sm90::named_arrive<4>(256);
    sm90::mbar_wait(q_full, 0);
    sm90::Turns<C>::wait(cw);
    issue_scores(0);
    sm90::Turns<C>::pass(cw);
    sm90::wgmma_wait<0>();
    grad(0);
    to_a<T, BN>(sc, dsa);
    for (int j = 1; j < n_tiles; ++j) {
      sm90::Turns<C>::wait(cw);
      issue_scores(j);
      issue_dq(j - 1);
      sm90::Turns<C>::pass(cw);
      sm90::wgmma_wait<1>();
      grad(j);
      sm90::wgmma_wait<0>();
      dq_done(j - 1);
      to_a<T, BN>(sc, dsa);
    }
    sm90::Turns<C>::wait(cw);
    issue_dq(n_tiles - 1);
    if (cw != C - 1) sm90::Turns<C>::pass(cw);
    sm90::wgmma_wait<0>();
    dq_done(n_tiles - 1);

    // Every wgmma that read this warpgroup's Q tile has completed.
    stage_out<T, kPitch, DP>(s_q, dq, warp, g, tq);
    sm90::fence_proxy_async();
    sm90::consumer_sync<C>(cw);
    if (t == 0) {
      store_box<kPitch, DP>(&tm_dq, s_q, q0 + cw * kRows, bh);
      sm90::tma_store_commit_and_wait();
    }
  }
}

// K5: dk and dv for the 64·C kv rows of block (blockIdx.x, b·h).
template <typename T, int DP>
__global__ void __launch_bounds__((BwdTiling<DP>::kDkvConsumers + 1) * 128,
                                  1)
    flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_do,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const __grid_constant__ CUtensorMap tm_dk,
                              const __grid_constant__ CUtensorMap tm_dv,
                              const float* __restrict__ lse,
                              const float* __restrict__ dvec, int sq,
                              int skv, float scale_log2, float scale) {
  using Tl = BwdTiling<DP>;
  constexpr int kPitch = Tl::kPitch, BM = Tl::kQTile,
                C = Tl::kDkvConsumers, S = kStages;
  static_assert(DP % 16 == 0 && DP <= 128, "head width");
  using G = sm90::Geometry<kPitch, DP>;
  using L = DkvLayout<kPitch, DP, BM, C>;
  using Regs = sm90::Regs<C>;

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  float* s_lse = reinterpret_cast<float*>(smem + L::kLse);
  float* s_dsc = reinterpret_cast<float*>(smem + L::kD);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* q_full = kv_full + 1;
  uint64_t* q_empty = q_full + S;

  const int wg = threadIdx.x / 128;
  const int bh = blockIdx.y;
  const int kv0 = blockIdx.x * kRows * C;
  const int n_tiles = (sq + BM - 1) / BM;

  if (threadIdx.x == 0) {
    sm90::mbar_init(kv_full, 1);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      // The TMA thread's arrival and one from each lane of the row loader.
      sm90::mbar_init(&q_full[s], 1 + 32);
      sm90::mbar_init(&q_empty[s], C);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    sm90::regs_dec<Regs::kProducer>();
    if (threadIdx.x == 0) {
      // One thread loads K and V once, then Q_i and dO_i into the ring.
      sm90::prefetch_map(&tm_q);
      sm90::prefetch_map(&tm_do);
      sm90::prefetch_map(&tm_k);
      sm90::prefetch_map(&tm_v);
      sm90::mbar_expect_tx(kv_full, 2 * C * L::kKt);
      for (int c = 0; c < C; ++c) {
        load_box<kPitch, DP>(smem + c * L::kKt, &tm_k, kv_full, kRows,
                             kv0 + c * kRows, bh);
        load_box<kPitch, DP>(smem + L::kV + c * L::kKt, &tm_v, kv_full,
                             kRows, kv0 + c * kRows, bh);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % S;
        if (i >= S) sm90::mbar_wait(&q_empty[s], ((i / S) & 1) ^ 1);
        sm90::mbar_expect_tx(&q_full[s], 2 * L::kQt);
        load_box<kPitch, DP>(smem + L::kQ + s * L::kQt, &tm_q, &q_full[s],
                             BM, i * BM, bh);
        load_box<kPitch, DP>(smem + L::kDO + s * L::kQt, &tm_do, &q_full[s],
                             BM, i * BM, bh);
      }
    } else if (threadIdx.x / 32 == 1) {
      // Warp 1 writes each stage's lse and D·scale rows: +inf and 0 past
      // Sq, so a ragged q column has P = 0 and dS = 0.
      const int lane = threadIdx.x % 32;
      const float* lse_b = lse + (size_t)bh * sq;
      const float* d_b = dvec + (size_t)bh * sq;
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % S;
        if (i >= S) sm90::mbar_wait(&q_empty[s], ((i / S) & 1) ^ 1);
        for (int r = lane; r < BM; r += 32) {
          const int row = i * BM + r;
          const bool ok = row < sq;
          s_lse[s * BM + r] = ok ? lse_b[row] : INFINITY;
          s_dsc[s * BM + r] = ok ? d_b[row] * scale : 0.f;
        }
        sm90::mbar_arrive(&q_full[s]);
      }
    }
  } else {
    // Consumer warpgroup cw: kv rows kv0 + 64·cw ... + 63.
    sm90::regs_inc<Regs::kConsumer>();
    const int cw = wg - 1;
    const int t = threadIdx.x % 128;
    const int warp = t / 32;
    const int g = (t % 32) / 4;
    const int tq = t % 4;
    unsigned char* s_k = smem + cw * L::kKt;
    unsigned char* s_v = smem + L::kV + cw * L::kKt;
    auto q_tile = [&](int i) { return smem + L::kQ + (i % S) * L::kQt; };
    auto do_tile = [&](int i) { return smem + L::kDO + (i % S) * L::kQt; };

    float acc_dk[DP / 2];
    float acc_dv[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;
    float st[BM / 2];
    float dpt[BM / 2];
    uint32_t pa[BM / 16][4];
    uint32_t dsa[BM / 16][4];

    // Sᵀ = K·Q_iᵀ and dPᵀ = V·dO_iᵀ, one commit group.
    auto issue_scores = [&](int i) {
      sm90::mbar_wait(&q_full[i % S], (i / S) & 1);
      sm90::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < DP / 16; ++ks) {
        sm90::Wgmma<T, BM>::ss(st, G::kmajor(s_k + G::kstep(ks, kRows)),
                               G::kmajor(q_tile(i) + G::kstep(ks, BM)),
                               ks > 0);
      }
#pragma unroll
      for (int ks = 0; ks < DP / 16; ++ks) {
        sm90::Wgmma<T, BM>::ss(dpt, G::kmajor(s_v + G::kstep(ks, kRows)),
                               G::kmajor(do_tile(i) + G::kstep(ks, BM)),
                               ks > 0);
      }
      sm90::wgmma_commit();
    };
    // dV += Pᵀ·dO_i and dK += dSᵀ·Q_i.
    auto issue_acc = [&](int i) {
      sm90::fence_regs(acc_dk);
      sm90::fence_regs(acc_dv);
      sm90::wgmma_fence();
#pragma unroll
      for (int kt = 0; kt < BM / 16; ++kt) {
        sm90::WgmmaRs<T, DP>::rs(
            acc_dv, pa[kt], G::mnmajor(do_tile(i) + kt * 16 * kPitch, BM), 1);
      }
#pragma unroll
      for (int kt = 0; kt < BM / 16; ++kt) {
        sm90::WgmmaRs<T, DP>::rs(
            acc_dk, dsa[kt], G::mnmajor(q_tile(i) + kt * 16 * kPitch, BM), 1);
      }
      sm90::wgmma_commit();
    };
    // After tile i's accumulating products have completed: its stage back
    // to the producer.
    auto acc_done = [&](int i) {
      sm90::fence_regs(acc_dk);
      sm90::fence_regs(acc_dv);
      sm90::fence_regs(pa);
      sm90::fence_regs(dsa);
      if (t == 0) sm90::mbar_arrive(&q_empty[i % S]);
    };
    // Pᵀ = exp2(sᵀ·c − lse_col) in st, dSᵀ = Pᵀ∘(dPᵀ·scale − D_col·scale)
    // in dpt; a thread's columns are 8n + 2·tq and + 1.
    auto grad = [&](int i) {
      sm90::fence_regs(st);
      sm90::fence_regs(dpt);
      const float* rl = s_lse + (i % S) * BM;
      const float* rd = s_dsc + (i % S) * BM;
#pragma unroll
      for (int n = 0; n < BM / 8; ++n) {
        const float2 l = *reinterpret_cast<const float2*>(rl + 8 * n + 2 * tq);
        const float2 dd = *reinterpret_cast<const float2*>(rd + 8 * n + 2 * tq);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = sm90::ex2(
              __fmaf_rn(st[4 * n + e], scale_log2, (e & 1) ? -l.y : -l.x));
          st[4 * n + e] = p;
          dpt[4 * n + e] =
              p * __fmaf_rn(dpt[4 * n + e], scale, (e & 1) ? -dd.y : -dd.x);
        }
      }
    };

    // Tile i's accumulating products go out with tile i + 1's scores.
    sm90::mbar_wait(kv_full, 0);
    issue_scores(0);
    sm90::wgmma_wait<0>();
    for (int i = 0; i < n_tiles; ++i) {
      grad(i);
      to_a<T, BM>(st, pa);
      to_a<T, BM>(dpt, dsa);
      issue_acc(i);
      if (i + 1 < n_tiles) issue_scores(i + 1);
      sm90::wgmma_wait<0>();
      acc_done(i);
    }

    // Every wgmma that read this warpgroup's K and V tiles has completed.
    stage_out<T, kPitch, DP>(s_k, acc_dk, warp, g, tq);
    stage_out<T, kPitch, DP>(s_v, acc_dv, warp, g, tq);
    sm90::fence_proxy_async();
    sm90::consumer_sync<C>(cw);
    if (t == 0) {
      store_box<kPitch, DP>(&tm_dk, s_k, kv0 + cw * kRows, bh);
      store_box<kPitch, DP>(&tm_dv, s_v, kv0 + cw * kRows, bh);
      sm90::tma_store_commit_and_wait();
    }
  }
}

template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  }
  return err;
}

// K4 (kDq) or K5 on the Hopper path: encodes the tensor maps (q, dO by the
// rows each box takes, k, v likewise, the outputs by 64-row boxes) and
// launches one block per 64·C owned rows (C consumer warpgroups).
template <typename T, int DP, bool kDq>
int launch_sm90(const flash_bwd::Args& a, cudaStream_t stream) {
  using Tl = BwdTiling<DP>;
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int kPitch = Tl::kPitch;
  constexpr int kBox = sm90::Geometry<kPitch, DP>::kSlabCols;
  const int q_rows = kDq ? kRows : Tl::kQTile;
  const int kv_rows = kDq ? Tl::kKvTile : kRows;
  auto encode = [&](CUtensorMap* map, const void* base, int rows, int box) {
    return sm90::encode_slab_map(map, base, kBf16, a.batch_heads, rows, a.d,
                                 box, kBox, kPitch);
  };
  CUtensorMap tm_q, tm_do, tm_k, tm_v, tm_o0, tm_o1;
  bool ok = encode(&tm_q, a.q, a.sq, q_rows) &&
            encode(&tm_do, a.dout, a.sq, q_rows) &&
            encode(&tm_k, a.k, a.skv, kv_rows) &&
            encode(&tm_v, a.v, a.skv, kv_rows);
  ok = ok && (kDq ? encode(&tm_o0, a.dq, a.sq, kRows)
                  : encode(&tm_o0, a.dk, a.skv, kRows) &&
                        encode(&tm_o1, a.dv, a.skv, kRows));
  if (!ok) return (int)cudaErrorInvalidValue;
  constexpr int C = kDq ? Tl::kDqConsumers : Tl::kDkvConsumers;
  const int block = kRows * C;
  const int threads = (C + 1) * 128;
  const float scale_log2 = a.scale * kLog2e;
  if constexpr (kDq) {
    constexpr int smem = DqLayout<kPitch, DP, Tl::kKvTile, C>::kBytes;
    auto kernel = flash_bwd_dq_sm90_kernel<T, DP>;
    const cudaError_t err = set_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((a.sq + block - 1) / block, a.batch_heads);
    kernel<<<grid, threads, smem, stream>>>(tm_q, tm_do, tm_k, tm_v, tm_o0,
                                            a.lse, a.dvec, a.sq, a.skv,
                                            scale_log2, a.scale);
  } else {
    constexpr int smem = DkvLayout<kPitch, DP, Tl::kQTile, C>::kBytes;
    auto kernel = flash_bwd_dkv_sm90_kernel<T, DP>;
    const cudaError_t err = set_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((a.skv + block - 1) / block, a.batch_heads);
    kernel<<<grid, threads, smem, stream>>>(tm_q, tm_do, tm_k, tm_v, tm_o0,
                                            tm_o1, a.lse, a.dvec, a.sq,
                                            a.skv, scale_log2, a.scale);
  }
  return (int)cudaGetLastError();
}

// Unit u = (dtype·8 + width index)·2 + kernel; part 0 holds the kept
// kernels, so with several parts the units go to parts 1 ...
// BUILD_PARTS - 1.
template <int DT, int W, int K>
void enter_unit() {
  constexpr int u = (DT * kMaxWidths + W) * 2 + K;
  constexpr int part = BUILD_PARTS == 1 ? 0 : 1 + u % (BUILD_PARTS - 1);
  if constexpr (part == BUILD_PART) {
    using T = std::conditional_t<DT == 0, __nv_bfloat16, __half>;
    flash_bwd::sm90_launchers[DT][W][K] = &launch_sm90<T, 16 * (W + 1), K == 0>;
  }
}

template <int... W>
bool enter_units(std::integer_sequence<int, W...>) {
  (enter_unit<0, W, 0>(), ...);
  (enter_unit<0, W, 1>(), ...);
  (enter_unit<1, W, 0>(), ...);
  (enter_unit<1, W, 1>(), ...);
  return true;
}

[[maybe_unused]] const bool kEntered =
    enter_units(std::make_integer_sequence<int, kMaxWidths>{});

}  // namespace

#if BUILD_PART == 0
namespace {

template <int K>
int dispatch_sm90(const flash_bwd::Args& a, int dtype, void* stream) {
  if (a.batch_heads < 1 || a.batch_heads > 65535 || a.sq < 1 || a.skv < 1 ||
      a.d < 8 || a.d > 128 || a.d % 8 != 0 || dtype < 0 || dtype > 1) {
    return (int)cudaErrorInvalidValue;
  }
  return flash_bwd::sm90_launchers[dtype][(a.d + 15) / 16 - 1][K](
      a, static_cast<cudaStream_t>(stream));
}

}  // namespace

// Plain C entry points (bound with ctypes). q, dout: [batch_heads, sq, d];
// k, v: [batch_heads, skv, d]; lse, dvec: fp32 [batch_heads, sq]. dtype:
// 0 = bf16, 1 = fp16; the kept path also takes 2 = fp32. Each launches on
// `stream` and returns cudaGetLastError() after the launch.

// K4 on the kept path: dq [batch_heads, sq, d]. vec != 0 promises 16-byte
// aligned rows (d % 8 == 0, aligned pointers).
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

// K5 on the kept path: dk, dv [batch_heads, skv, d].
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

// The Hopper path: as the two above, for d % 8 == 0 (8 <= d <= 128) and
// 16-byte aligned q, k, v, dout and outputs. Returns cudaErrorInvalidValue
// for anything else.
extern "C" int flash_attention_bwd_dq_sm90(const void* q, const void* k,
                                           const void* v, const void* dout,
                                           const float* lse,
                                           const float* dvec, void* dq,
                                           int batch_heads, int sq, int skv,
                                           int d, float scale, int dtype,
                                           void* stream) {
  const flash_bwd::Args a{q, k, v, dout, lse, dvec, dq, nullptr, nullptr,
                          batch_heads, sq, skv, d, scale, 1};
  return dispatch_sm90<0>(a, dtype, stream);
}

extern "C" int flash_attention_bwd_dkv_sm90(const void* q, const void* k,
                                            const void* v, const void* dout,
                                            const float* lse,
                                            const float* dvec, void* dk,
                                            void* dv, int batch_heads,
                                            int sq, int skv, int d,
                                            float scale, int dtype,
                                            void* stream) {
  const flash_bwd::Args a{q, k, v, dout, lse, dvec, nullptr, dk, dv,
                          batch_heads, sq, skv, d, scale, 1};
  return dispatch_sm90<1>(a, dtype, stream);
}
#endif  // BUILD_PART == 0
