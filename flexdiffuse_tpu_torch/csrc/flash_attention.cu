// Forward flash attention for Hopper (sm_90a): softmax(q·kᵀ·scale)·v over
// contiguous [B, H, S, D] bf16/fp16 tensors (fp32 on the kept path), fp32
// accumulators, Sq != Skv allowed, any S >= 1.
//
// Replaces flexdiffuse_tpu/ops/flash_attention.py::_flash_tt_kernel (K1,
// :126) and, because K/V always stream through shared memory here, its
// VMEM-overflow twin _flash_stream_kernel (K2, :44). Instantiated with kLse
// it is K3, the training forward, which also writes the base-2 log-sum-exp
// rows lse = m·scale·log2(e) + log2(l) in fp32 (replaces
// flexdiffuse_tpu/ops/flash_backward.py::_fwd_lse_kernel, :62); the backward
// kernels K4/K5 (flash_backward.cu) recompute P from them in fp32. K1 and K3
// are one template, so K3's o is bit-equal to K1's. The TPU kernel's
// transposed [d, s] operands and its ones-row sum fold answer the TPU's
// 128-lane width and its vector unit; neither is carried over.
//
// What bounds it on this card. At SD's d = 40 a score costs 40 multiply-adds
// on the tensor cores but one exp2 on the 16-lane-per-SM MUFU unit: at
// (2,8,4096,40) 268 M exp2 take ~0.064 ms on 132 SMs at 1.98 GHz, above the
// tensor-core bound (0.043 ms) and the bytes (~0.01 ms). So the design keeps
// the MUFU busy and everything else off it and off the critical path. At
// d = 80 with 1024 tokens the tensor cores bound it (0.0054 ms) and latency
// and grid fill decide.
//
// The Hopper path (flash_fwd_sm90_kernel), for d % 8 == 0 and 16-byte
// aligned tensors (what TMA takes):
// - Warp specialisation: warpgroup 0 is the producer; one thread issues all
//   TMA loads (Q once, then K_j and V_j into a ring of 3 K/V stages, each
//   with a full and an empty mbarrier) and gives its registers to the
//   consumers (setmaxnreg). Each consumer warpgroup owns 64 q rows; a block
//   of three consumers (DP <= 64, kv tile 64) or two (above, kv tile 128)
//   takes 192 or 128 q rows, all reading the same K/V stages (Tiling).
// - Tensor maps are 3-D, [B·H, S, D], so the zero fill of out-of-bounds
//   reads pads both the ragged last rows of each head and the head columns
//   d..DP, and a box never reads the next head's rows. The host encodes
//   them per call (cuTensorMapEncodeTiled fetched through
//   cudaGetDriverEntryPoint; no -lcuda).
// - Head width: DP = d rounded up to 16 (48 at d = 40, 80 at d = 80), the
//   k-steps of S. Neither is a 64- or 128-byte swizzle width, so a tile is
//   stored in slabs of one swizzle span each: 16 columns with the 32-byte
//   swizzle (no column beyond DP), or 64 with the 128-byte one (d = 40:
//   one slab, columns 40..63 zero-filled by TMA, never multiplied). The
//   wgmma descriptors describe exactly the slabs TMA wrote (Geometry); the
//   128-byte swizzle measured faster at d = 40, the 32-byte one at d = 80.
// - S = Q·K_jᵀ: wgmma m64n{kv tile}k16, Q and K both K-major in shared
//   memory. O += P·V_j: wgmma m64n{DP}k16 with A = P in registers (the fp32
//   S accumulator converted in place: its fragment layout is the register-A
//   layout) and B = V_j MN-major (the transpose bit).
// - Pipeline: S_j is issued together with P_{j-1}·V_{j-1}, so the softmax
//   of S_j runs while that product is on the tensor cores, and the
//   consumers take turns to issue their wgmma (ping-pong).
// - Softmax: the row max is taken on the raw scores, as a tree; each score
//   then costs one FFMA s·c − m·c (c = scale·log2 e in fp32, never a q
//   pre-scaled in its 16-bit type, which K4/K5 could not reproduce) and one
//   ex2.approx.ftz. Row max and sum stay in registers, reduced over the
//   quad. The column mask runs only on the ragged last kv tile.
// - What bounds it: clock stamps per phase put a consumer's tile at its own
//   dependent chain (S wait, row max, exp2, P·V issue), not at the shared
//   MUFU unit or tensor cores: taking turns for the exponentials gained
//   nothing, three consumers of kv tile 64 (more chains per SM) and the
//   shorter max tree did.
// - Epilogue: O·(1/l) is written into the consumer's Q tile (free by then)
//   in the swizzled layout and stored by TMA, which drops rows >= Sq and
//   columns >= d; K3 writes lse for rows < Sq.
// The wrapper (ops/flash_attention.py::plan) picks the path before launch.
//
// The kept path (flash_fwd_kernel, the first port's design) serves what
// TMA cannot take: d % 8 != 0 (rows not 16-byte strided), a misaligned
// pointer, or fp32 tensors. One block of 4 warps per (b·h, 64-row q tile),
// K/V tiles staged through registers, mma.sync.m16n8k16, head dim
// zero-padded to a multiple of 16. fp32 q, k, v are rounded to bf16 as they
// are staged, and P to bf16 before P·V: the operand precision at which the
// TPU's matrix unit multiplies fp32 at default precision, which is what the
// reference's Pallas kernel computes there. Scores, softmax, accumulators,
// lse and the fp32 output stay fp32.

#include <type_traits>
#include <utility>

#include "flash_common.cuh"
#include "sm90.cuh"

// The build: ops/flash_attention.build compiles this file BUILD_PARTS times
// at once (-DBUILD_PART=p) and links the objects. Part 0 holds the kept
// kernel, the launcher table and the entry points; the Hopper kernel's
// (dtype, width) units are spread over the other parts. A
// compile without these macros holds everything.
#ifndef BUILD_PARTS
#define BUILD_PARTS 1
#define BUILD_PART 0
#endif

#if BUILD_PART == 0
namespace {

// T: the 16-bit type of the shared tiles and the products; TI: the type of
// q, k, v and o (T, or float).
template <typename T, int DP, bool kLse, typename TI>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const TI* __restrict__ q, const TI* __restrict__ k,
                     const TI* __restrict__ v, TI* __restrict__ o,
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

  const TI* qb = q + bh * sq * d;
  const TI* kb = k + bh * skv * d;
  const TI* vb = v + bh * skv * d;
  TI* ob = o + bh * sq * d;

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
      if (col < d) ob[(size_t)row0 * d + col] = to_out<T, TI>(oacc[dt][0] * inv[0]);
      if (col + 1 < d) ob[(size_t)row0 * d + col + 1] = to_out<T, TI>(oacc[dt][1] * inv[0]);
    }
    if (row1 < sq) {
      if (col < d) ob[(size_t)row1 * d + col] = to_out<T, TI>(oacc[dt][2] * inv[1]);
      if (col + 1 < d) ob[(size_t)row1 * d + col + 1] = to_out<T, TI>(oacc[dt][3] * inv[1]);
    }
  }
}

template <typename T, int DP, bool kLse, typename TI>
int launch_dp(const void* q, const void* k, const void* v, void* o,
              float* lse, int batch_heads, int sq, int skv, int d,
              float scale, int vec, cudaStream_t stream) {
  const int smem = (kBlockM + 2 * kBlockN) * (DP + kPad) * (int)sizeof(T);
  // Above 48 KB (DP = 128) dynamic shared memory needs the opt-in.
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DP, kLse, TI>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + kBlockM - 1) / kBlockM, batch_heads);
  flash_fwd_kernel<T, DP, kLse, TI><<<grid, kThreads, smem, stream>>>(
      static_cast<const TI*>(q), static_cast<const TI*>(k),
      static_cast<const TI*>(v), static_cast<TI*>(o), lse, sq, skv, d,
      scale * kLog2e, vec);
  return (int)cudaGetLastError();
}

template <typename T, bool kLse, typename TI>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int batch_heads, int sq, int skv, int d, float scale, int vec,
           cudaStream_t stream) {
#define FLASH_CASE(n) \
  case n / 16: \
    return launch_dp<T, n, kLse, TI>(q, k, v, o, lse, batch_heads, sq, skv, \
                                     d, scale, vec, stream);
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
    return launch<__nv_bfloat16, kLse, __nv_bfloat16>(
        q, k, v, o, lse, batch_heads, sq, skv, d, scale, vec, s);
  }
  if (dtype == 1) {
    return launch<__half, kLse, __half>(q, k, v, o, lse, batch_heads, sq,
                                        skv, d, scale, vec, s);
  }
  if (dtype == 2) {
    return launch<__nv_bfloat16, kLse, float>(q, k, v, o, lse, batch_heads,
                                              sq, skv, d, scale, vec, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace
#endif  // BUILD_PART == 0

// ---------------------------------------------------------------------------
// The Hopper path.

namespace {

constexpr int kRows = 64;      // q rows per consumer warpgroup (one wgmma M)
constexpr int kMaxWidths = 8;  // DP = 16, 32, ..., 128
constexpr int kStages = 3;     // K/V tiles in the ring

// The tiles of a head width (ops/flash_attention.py::SM90_TILES says the
// same to the wrapper). Up to DP = 64 (SD's d = 40): three consumers, kv
// tile 64 (ptxas allocates 128 registers a thread at 512 threads, whatever
// setmaxnreg gives later: too few for kv tile 128), 128-byte swizzle.
// Above (d = 80): two consumers, kv tile 128, 32-byte swizzle, which wastes
// no column. Each measured fastest at its widths (PERF.md, design steps).
template <int DP>
struct Tiling {
  static constexpr bool kNarrow = DP <= 64;
  static constexpr int kBlockKv = kNarrow ? 64 : 128;
  static constexpr int kConsumers = kNarrow ? 3 : 2;
  static constexpr int kPitch = kNarrow ? 128 : 32;  // swizzle span, bytes
};

using sm90::Geometry;  // the slab layout of a tile (sm90.cuh)
using sm90::Regs;

// Shared memory of one block, in bytes from a 1024-aligned base: each
// consumer's Q tile (later its O tile), the K and V stages, the barriers.
template <int kPitch, int DP, int BN, int C>
struct Layout {
  using G = Geometry<kPitch, DP>;
  static constexpr int kQ = G::bytes(kRows);
  static constexpr int kKV = G::bytes(BN);
  static constexpr int kK = C * kQ;
  static constexpr int kV = kK + kStages * kKV;
  static constexpr int kBars = kV + kStages * kKV;
  static constexpr int kBytes = kBars + (2 * kStages + 1) * 8 + 1024;
};

template <typename T, int kPitch, int DP, int BN>
struct Consumer {
  using G = Geometry<kPitch, DP>;
  float o[DP / 2];
  // Rows g and g + 8 of the warp's 16: running max of the raw scores and
  // the quad-partial row sum.
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  int tq;

  __device__ __forceinline__ Consumer(int t) : tq(t % 4) {
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  }

  // S = Q·K_jᵀ, 64 x BN, DP / 16 k-steps (not committed).
  static __device__ __forceinline__ void issue_s(float (&sc)[BN / 2],
                                                 const unsigned char* s_q,
                                                 const unsigned char* sk) {
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks) {
      sm90::Wgmma<T, BN>::ss(sc, G::kmajor(s_q + G::kstep(ks, kRows)),
                             G::kmajor(sk + G::kstep(ks, BN)), ks > 0);
    }
  }

  // O += P·V_j; the accumulator n-blocks 2kt, 2kt + 1 of S are the A
  // fragment of k-step kt (not committed).
  __device__ __forceinline__ void issue_pv(const uint32_t (&pa)[BN / 16][4],
                                           const unsigned char* sv) {
#pragma unroll
    for (int kt = 0; kt < BN / 16; ++kt) {
      sm90::WgmmaRs<T, DP>::rs(o, pa[kt],
                               G::mnmajor(sv + kt * 16 * kPitch, BN), 1);
    }
  }

  // mx[r][i] = max(mx[r][i], mx[r][i + W]), then W / 2, ... 1: a tree
  // whose levels are unrolled at compile time, so that mx stays in
  // registers (a loop halving its bound left it in local memory).
  template <int W>
  static __device__ __forceinline__ void fold_max(float (&mx)[2][BN / 8]) {
#pragma unroll
    for (int i = 0; i < W; ++i) {
      mx[0][i] = fmaxf(mx[0][i], mx[0][i + W]);
      mx[1][i] = fmaxf(mx[1][i], mx[1][i + W]);
    }
    if constexpr (W > 1) fold_max<W / 2>(mx);
  }

  // The online softmax of one tile in place: masks columns >= skv (only
  // the ragged last tile has any), updates the row max and sum, leaves
  // P = exp2(s·c − m·c) in sc and returns the factor O must be scaled by.
  // The max is taken as a tree and the sum in two halves, to keep the
  // dependent chains short: the softmax is on each consumer's critical path.
  __device__ __forceinline__ void softmax(float (&sc)[BN / 2], int kv0,
                                          int skv, float c,
                                          float (&alpha)[2]) {
    if (kv0 + BN > skv) {
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (kv0 + 8 * i + 2 * tq + (e & 1) >= skv) sc[4 * i + e] = -INFINITY;
        }
      }
    }
    float mx[2][BN / 8];
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      mx[0][i] = fmaxf(sc[4 * i], sc[4 * i + 1]);
      mx[1][i] = fmaxf(sc[4 * i + 2], sc[4 * i + 3]);
    }
    fold_max<BN / 16>(mx);
    float mc[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float m = fmaxf(m_run[r], mx[r][0]);
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      // Column kv0 is always valid, so m is finite; on the first tile
      // m_run is -inf and alpha 0. An unchanged max gives alpha 1 exactly.
      mc[r] = __fmul_rn(m, c);
      alpha[r] = sm90::ex2(__fmul_rn(m_run[r] - m, c));
      m_run[r] = m;
    }
    float rs[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = sm90::ex2(__fmaf_rn(sc[4 * i + e], c, -mc[e >> 1]));
        sc[4 * i + e] = p;
        rs[e >> 1][i & 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[r] = l_run[r] * alpha[r] + (rs[r][0] + rs[r][1]);
    }
  }

  __device__ __forceinline__ void rescale(const float (&alpha)[2]) {
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) {
      o[4 * i] *= alpha[0];
      o[4 * i + 1] *= alpha[0];
      o[4 * i + 2] *= alpha[1];
      o[4 * i + 3] *= alpha[1];
    }
  }

  static __device__ __forceinline__ void to_p(const float (&sc)[BN / 2],
                                              uint32_t (&pa)[BN / 16][4]) {
#pragma unroll
    for (int kt = 0; kt < BN / 16; ++kt) {
      pa[kt][0] = Ops<T>::pack(sc[8 * kt], sc[8 * kt + 1]);
      pa[kt][1] = Ops<T>::pack(sc[8 * kt + 2], sc[8 * kt + 3]);
      pa[kt][2] = Ops<T>::pack(sc[8 * kt + 4], sc[8 * kt + 5]);
      pa[kt][3] = Ops<T>::pack(sc[8 * kt + 6], sc[8 * kt + 7]);
    }
  }
};

using sm90::Turns;  // the consumers' ping-pong (sm90.cuh)

template <typename T, int DP, bool kLse>
__global__ void __launch_bounds__((Tiling<DP>::kConsumers + 1) * 128, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_o,
                          float* __restrict__ lse, int sq, int skv,
                          float scale_log2) {
  using Tl = Tiling<DP>;
  constexpr int kPitch = Tl::kPitch, BN = Tl::kBlockKv, C = Tl::kConsumers,
                S = kStages;
  static_assert(DP % 16 == 0 && DP <= 128, "head width");
  static_assert(BN % 16 == 0 && BN <= 256, "kv tile");
  static_assert(C == 2 || C == 3, "consumers");
  using L = Layout<kPitch, DP, BN, C>;
  using G = Geometry<kPitch, DP>;

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
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
    // Producer: one thread keeps the ring full.
    sm90::regs_dec<Regs<C>::kProducer>();
    if (threadIdx.x == 0) {
      sm90::prefetch_map(&tm_q);
      sm90::prefetch_map(&tm_k);
      sm90::prefetch_map(&tm_v);
      sm90::mbar_expect_tx(q_full, C * L::kQ);
      for (int c = 0; c < C; ++c) {
#pragma unroll
        for (int sl = 0; sl < G::kSlabs; ++sl) {
          sm90::tma_load_3d(smem + c * L::kQ + sl * kRows * kPitch, &tm_q,
                            q_full, sl * G::kSlabCols, q0 + c * kRows, bh);
        }
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % S;
        if (j >= S) sm90::mbar_wait(&kv_empty[s], ((j / S) & 1) ^ 1);
        sm90::mbar_expect_tx(&kv_full[s], 2 * L::kKV);
        unsigned char* sk = smem + L::kK + s * L::kKV;
        unsigned char* sv = smem + L::kV + s * L::kKV;
#pragma unroll
        for (int sl = 0; sl < G::kSlabs; ++sl) {
          sm90::tma_load_3d(sk + sl * BN * kPitch, &tm_k, &kv_full[s],
                            sl * G::kSlabCols, j * BN, bh);
        }
#pragma unroll
        for (int sl = 0; sl < G::kSlabs; ++sl) {
          sm90::tma_load_3d(sv + sl * BN * kPitch, &tm_v, &kv_full[s],
                            sl * G::kSlabCols, j * BN, bh);
        }
      }
    }
  } else {
    // Consumer warpgroup cw: q rows q0 + 64·cw ... + 63.
    sm90::regs_inc<Regs<C>::kConsumer>();
    const int cw = wg - 1;
    const int t = threadIdx.x % 128;
    const int warp = t / 32;
    const int g = (t % 32) / 4;
    unsigned char* s_q = smem + cw * L::kQ;
    auto k_tile = [&](int j) { return smem + L::kK + (j % S) * L::kKV; };
    auto v_tile = [&](int j) { return smem + L::kV + (j % S) * L::kKV; };
    auto wait_tile = [&](int j) {
      sm90::mbar_wait(&kv_full[j % S], (j / S) & 1);
    };
    auto release = [&](int j) {
      if (t == 0) sm90::mbar_arrive(&kv_empty[j % S]);
    };
    Consumer<T, kPitch, DP, BN> st(t);
    float sc[BN / 2];
    uint32_t pa[BN / 16][4];
    float alpha[2];
    auto my_turn = [&] { Turns<C>::wait(cw); };
    auto next_turn = [&](bool last) {
      if (!last || cw != C - 1) Turns<C>::pass(cw);
    };
    auto issue_s = [&](float (&acc)[BN / 2], int j) {
      wait_tile(j);
      sm90::wgmma_fence();
      st.issue_s(acc, s_q, k_tile(j));
      sm90::wgmma_commit();
    };
    auto issue_pv = [&](int j) {
      sm90::fence_regs(st.o);
      sm90::wgmma_fence();
      st.issue_pv(pa, v_tile(j));
      sm90::wgmma_commit();
    };
    // After P_j·V_j has completed: K_j/V_j back to the producer.
    auto pv_done = [&](int j) {
      sm90::fence_regs(st.o);
      sm90::fence_regs(pa);
      release(j);
    };

    if (cw == C - 1) sm90::named_arrive<4>(256);
    sm90::mbar_wait(q_full, 0);
    // S_0, then per tile j >= 1: S_j = Q·K_jᵀ and O += P_{j-1}·V_{j-1}
    // issued together; the softmax of S_j runs while P_{j-1}·V_{j-1} is on
    // the tensor cores; O is rescaled once that product is done.
    my_turn();
    issue_s(sc, 0);
    next_turn(false);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sc);
    st.softmax(sc, 0, skv, scale_log2, alpha);
    st.to_p(sc, pa);
    for (int j = 1; j < n_tiles; ++j) {
      my_turn();
      issue_s(sc, j);
      issue_pv(j - 1);
      next_turn(false);
      sm90::wgmma_wait<1>();
      sm90::fence_regs(sc);
      st.softmax(sc, j * BN, skv, scale_log2, alpha);
      sm90::wgmma_wait<0>();
      pv_done(j - 1);
      st.rescale(alpha);
      st.to_p(sc, pa);
    }
    my_turn();
    issue_pv(n_tiles - 1);
    next_turn(true);
    sm90::wgmma_wait<0>();
    pv_done(n_tiles - 1);

    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = st.l_run[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      inv[r] = 1.f / l;
      if constexpr (kLse) {
        const int row = q0 + cw * kRows + warp * 16 + g + 8 * r;
        if (st.tq == 0 && row < sq) {
          lse[(size_t)bh * sq + row] =
              __fmul_rn(st.m_run[r], scale_log2) + log2f(l);
        }
      }
    }
    // Every wgmma that read this warpgroup's Q tile has completed: O's
    // first DP columns go there, in the layout the O map's TMA store reads.
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int off =
            G::offset(warp * 16 + g + 8 * r, 8 * i + 2 * st.tq, kRows);
        *reinterpret_cast<uint32_t*>(s_q + off) = Ops<T>::pack(
            st.o[4 * i + 2 * r] * inv[r], st.o[4 * i + 2 * r + 1] * inv[r]);
      }
    }
    sm90::fence_proxy_async();
    sm90::consumer_sync<C>(cw);
    if (t == 0) {
#pragma unroll
      for (int sl = 0; sl < G::kSlabs; ++sl) {
        sm90::tma_store_3d(&tm_o, s_q + sl * kRows * kPitch,
                           sl * G::kSlabCols, q0 + cw * kRows, bh);
      }
      sm90::tma_store_commit_and_wait();
    }
  }
}

template <typename T, int DP, bool kLse>
int launch_sm90(const void* q, const void* k, const void* v, void* o,
                float* lse, int batch_heads, int sq, int skv, int d,
                float scale, cudaStream_t stream) {
  using Tl = Tiling<DP>;
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int kBox = Geometry<Tl::kPitch, DP>::kSlabCols;
  const int rows = kRows, bn = Tl::kBlockKv, pitch = Tl::kPitch;
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  if (!sm90::encode_slab_map(&tm_q, q, kBf16, batch_heads, sq, d, rows, kBox,
                             pitch) ||
      !sm90::encode_slab_map(&tm_k, k, kBf16, batch_heads, skv, d, bn, kBox,
                             pitch) ||
      !sm90::encode_slab_map(&tm_v, v, kBf16, batch_heads, skv, d, bn, kBox,
                             pitch) ||
      !sm90::encode_slab_map(&tm_o, o, kBf16, batch_heads, sq, d, rows, kBox,
                             pitch)) {
    return (int)cudaErrorInvalidValue;
  }
  constexpr int smem =
      Layout<Tl::kPitch, DP, Tl::kBlockKv, Tl::kConsumers>::kBytes;
  auto kernel = flash_fwd_sm90_kernel<T, DP, kLse>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               100);
  }
  if (err != cudaSuccess) return (int)err;
  const int block_q = kRows * Tl::kConsumers;
  const dim3 grid((sq + block_q - 1) / block_q, batch_heads);
  kernel<<<grid, (Tl::kConsumers + 1) * 128, smem, stream>>>(
      tm_q, tm_k, tm_v, tm_o, lse, sq, skv, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

using TmaLauncher = int (*)(const void*, const void*, const void*, void*,
                            float*, int, int, int, int, float, cudaStream_t);
namespace flash_sm90 {
// [dtype][DP / 16 - 1][kLse], filled when the library loads.
extern TmaLauncher launchers[2][kMaxWidths][2];
#if BUILD_PART == 0
TmaLauncher launchers[2][kMaxWidths][2] = {};
#endif
}  // namespace flash_sm90

namespace {

// Unit u = dtype·8 + width index; part 0 holds the kept kernel, so with
// several parts the units go to parts 1 ... BUILD_PARTS - 1.
template <int DT, int W>
void enter_unit() {
  constexpr int u = DT * kMaxWidths + W;
  constexpr int part = BUILD_PARTS == 1 ? 0 : 1 + u % (BUILD_PARTS - 1);
  constexpr int dp = 16 * (W + 1);
  if constexpr (part == BUILD_PART) {
    using T = std::conditional_t<DT == 0, __nv_bfloat16, __half>;
    flash_sm90::launchers[DT][W][0] = &launch_sm90<T, dp, false>;
    flash_sm90::launchers[DT][W][1] = &launch_sm90<T, dp, true>;
  }
}

template <int... W>
bool enter_units(std::integer_sequence<int, W...>) {
  (enter_unit<0, W>(), ...);
  (enter_unit<1, W>(), ...);
  return true;
}

[[maybe_unused]] const bool kEntered =
    enter_units(std::make_integer_sequence<int, kMaxWidths>{});

}  // namespace

#if BUILD_PART == 0
namespace {

template <bool kLse>
int dispatch_sm90(const void* q, const void* k, const void* v, void* o,
                  float* lse, int batch_heads, int sq, int skv, int d,
                  float scale, int dtype, void* stream) {
  if (batch_heads < 1 || batch_heads > 65535 || sq < 1 || skv < 1 || d < 8 ||
      d > 128 || d % 8 != 0 || dtype < 0 || dtype > 1) {
    return (int)cudaErrorInvalidValue;
  }
  return flash_sm90::launchers[dtype][(d + 15) / 16 - 1][kLse ? 1 : 0](
      q, k, v, o, lse, batch_heads, sq, skv, d, scale,
      static_cast<cudaStream_t>(stream));
}

}  // namespace

// Plain C entry points (bound with ctypes). dtype: 0 = bf16, 1 = fp16;
// the kept path also takes 2 = fp32 (computed as the kept kernel's note
// says).
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

// The Hopper path: as flash_attention_fwd / flash_attention_fwd_lse, for
// d % 8 == 0 (8 <= d <= 128) and 16-byte aligned q, k, v, o. Returns
// cudaErrorInvalidValue for anything else.
extern "C" int flash_attention_fwd_sm90(const void* q, const void* k,
                                        const void* v, void* o,
                                        int batch_heads, int sq, int skv,
                                        int d, float scale, int dtype,
                                        void* stream) {
  return dispatch_sm90<false>(q, k, v, o, nullptr, batch_heads, sq, skv, d,
                              scale, dtype, stream);
}

extern "C" int flash_attention_fwd_lse_sm90(const void* q, const void* k,
                                            const void* v, void* o,
                                            float* lse, int batch_heads,
                                            int sq, int skv, int d,
                                            float scale, int dtype,
                                            void* stream) {
  return dispatch_sm90<true>(q, k, v, o, lse, batch_heads, sq, skv, d, scale,
                             dtype, stream);
}
#endif  // BUILD_PART == 0
