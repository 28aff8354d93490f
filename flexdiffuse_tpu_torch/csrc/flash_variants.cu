// Attention variants T1–T6 for Hopper (sm_90a): softmax(q·kᵀ·scale)·v
// under six schedules, layouts and rounding points.
//
// Replaces the Pallas kernels of the JAX package's flash-kernel experiment
// tools, each an attempt to make K1 faster:
//   T1 tools/flash_opt.py::make_kernel (:57)       v0, vU (unrolled), vG (G q chains)
//   T2 tools/flash_opt.py::make_kernel_h (:120)    all heads in one instance
//   T3 tools/flash_pipelined.py::_pipelined_kernel (:22)  QKᵀ of tile j+1 before softmax j
//   T4 tools/flash_tt.py::_flash_tt2_kernel (:87)  [B,H,D,S] operands
//   T5 tools/flash_tt3.py::_ttv3_kernel (:41)      [B,H,D,S], exp2, row sum folded into P·V
//   T6 tools/flash_variants.py::make_kernel (:27)  exp / exp2 / exp2 with a bf16-P row sum
// All six compute one function, so they are one template
// (variant_kernel), twelve configurations of it (kConfigs) and six plain C
// entry points at the end of this file.
//
// Numerics shared by all six, unlike K1: q is scaled in its own dtype
// before the product, q̃ = round16(q · round16(c)), with c = scale, or
// scale·log2(e) for the exp2 modes (T5, T6 v1/v2); the scores q̃·kᵀ, the
// running max m, the row sum l and the accumulators are fp32; P is rounded
// to the inputs' dtype for the P·V tensor-core product. The modes differ
// in where else they round:
//   kExp       p = exp(s − m), l = Σ p in fp32          (T1, T2, T3, T4, T6 v0)
//   kExp2      p = exp2(s − m), l = Σ p in fp32         (T6 v1)
//   kExp2P16   p = exp2(s − m), l = Σ round16(p)        (T6 v2, T5 ttv3 and no-fold)
//   kExp2Bf16  p = ex2.bf16(round_bf16(s − m)): exp2 evaluated on bf16
//              arguments, two per instruction (T5 ttv4); l = Σ p
// kFold (T5 ttv3/ttv4) puts ones in V's first zero-padded head column d,
// so column d of the P·V accumulator is Σ round16(p) in fp32, rescaled by
// alpha with the rest: the row sum comes out of the MMA with no quad
// shuffles; the head is padded to round16(d + 1) (d = 40 → 48, 80 → 96).
// kTileRound (T5 no-fold) rounds each 64-column tile's row sum to the
// inputs' dtype before adding it to l, as the TPU kernel rounds the sum of
// its bf16 block (flash_tt3.py:68-69). T4's TPU kernel feeds fp32 P to
// P·V; the tensor cores here take 16-bit P, as K1's do.
//
// Domain (the tools' and more): contiguous bf16 or fp16 tensors, S a
// multiple of 64 (of 64·G for vG), d a multiple of 8 up to 128 (up to 120
// with kFold), 16-byte aligned; anything else returns cudaErrorInvalidValue.
// The TPU block sizes (256–2048 rows) are not carried over: the tile is 64
// K/V rows and 64·G q rows, as K1's (flash_common.cuh).
//
// Design: K1's (flash_attention.cu): one warp per 16 q rows, mma.sync
// m16n8k16 with fp32 accumulators, the online softmax in registers, P·V
// fed from the score accumulators. K/V tiles are staged with cp.async.
// What each variant changes, and its Hopper form:
//   vU  (kLoadAhead)  K/V double-buffered; the next tile's cp.async is
//       issued before this tile's QKᵀ and softmax, so the load overlaps
//       them (the TPU's unrolled loop let its scheduler overlap QK(j+1)
//       with softmax(j)).
//   vG  (G = 2, 4)    G·64 q rows per block on 4·G warps that share each
//       staged K/V tile: G independent softmax chains per K/V load.
//   T2  (kHeadLoop)   one block per (b, q tile) walks all H heads; each
//       head's running state is held in registers while its kv loop runs.
//       (The TPU kernel interleaves the heads per kv block with the state
//       of all H heads in VMEM scratch; H heads of state do not fit in a
//       thread's registers here, so the heads run in turn.) The grid is
//       B × Sq/64 instead of B·H × Sq/64.
//   T3  (kScoreAhead) S(j+1) = q̃·K(j+1)ᵀ is computed into a second set of
//       registers before the softmax and P·V of tile j; K/V tiles are
//       double-buffered.
//   T4, T5 (kBHDS)    [B,H,D,S] in and out: tiles are [d, 64] slabs loaded
//       coalesced along S; the A fragments of q̃ and the B fragments of K
//       come from ldmatrix.trans, V's B fragments are plain 32-bit loads
//       (its [d, s] rows are already k-contiguous), and O is staged through
//       shared memory to be written [d, s] in 16-byte rows.
//   T6 v0 is T1 v0's code: same layout, schedule and rounding points; its
//   entry point launches that instantiation.
//
// What bounds them on this card: as K1, the softmax's CUDA-core work and
// latency at d = 40, not the tensor cores (989 TFLOP/s) or HBM; these are
// the measurements that say which of the TPU-era ideas moves that.

#include <type_traits>
#include <utility>

#include "flash_common.cuh"

namespace {

enum Layout : int { kBHSD = 0, kBHDS = 1 };
enum Softmax : int { kExp = 0, kExp2 = 1, kExp2P16 = 2, kExp2Bf16 = 3 };
enum Prefetch : int { kSync = 0, kLoadAhead = 1, kScoreAhead = 2 };

constexpr int kNTiles = kBlockN / 8;   // n-tiles of QKᵀ over a kv tile
constexpr int kPSteps = kBlockN / 16;  // k-steps of P·V over a kv tile

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices, transposed; lanes 8i..8i+7 address matrix i's rows.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* smem) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// exp2 of two bf16 arguments in one instruction, bf16 results (sm_90).
__device__ __forceinline__ void ex2_bf16x2(float x0, float x1, float& p0,
                                           float& p1) {
  __nv_bfloat162 in = __floats2bfloat162_rn(x0, x1);
  uint32_t out;
  asm("ex2.approx.ftz.bf16x2 %0, %1;\n"
      : "=r"(out)
      : "r"(*reinterpret_cast<uint32_t*>(&in)));
  const __nv_bfloat162 p = *reinterpret_cast<__nv_bfloat162*>(&out);
  p0 = __low2float(p);
  p1 = __high2float(p);
}

__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

// x rounded to T, as a float.
template <typename T>
__device__ __forceinline__ float round16(float x) {
  return to_float(Ops<T>::cast(x));
}

// Shared-memory tile of ROWS sequence positions: [ROWS][DP + kPad] for
// [.., S, D] inputs, [DP][ROWS + kPad] for [.., D, S] inputs.
template <int L, int DP, int ROWS>
struct Tile {
  static constexpr int kStride = L == kBHSD ? DP + kPad : ROWS + kPad;
  static constexpr int kElems = (L == kBHSD ? ROWS : DP) * kStride;
};

// Stage positions [s0, s0 + ROWS) of one head (`src`: its [seq, d] or
// [d, seq] matrix) into `dst` with cp.async; head columns (rows) d..DP-1
// are zero, and column (row) `ones` is one when ones >= 0 (the fold).
// The caller commits the group and waits.
template <typename T, int L, int DP, int ROWS>
__device__ __forceinline__ void stage(T* dst, const T* src, int s0, int seq,
                                      int d, int ones) {
  using Tl = Tile<L, DP, ROWS>;
  const uint32_t one = Ops<T>::pack(1.f, 1.f);
  if constexpr (L == kBHSD) {
    constexpr int kChunks = DP / 8;
    for (int i = threadIdx.x; i < ROWS * kChunks; i += blockDim.x) {
      const int r = i / kChunks, c = (i % kChunks) * 8;
      T* out = dst + r * Tl::kStride + c;
      if (c < d) {
        cp_async16(out, src + (size_t)(s0 + r) * d + c);
      } else {
        // d % 8 == 0, so column `ones` opens its chunk.
        const uint32_t lo = c == ones ? (one & 0xffffu) : 0u;
        *reinterpret_cast<uint4*>(out) = make_uint4(lo, 0u, 0u, 0u);
      }
    }
  } else {
    constexpr int kChunks = ROWS / 8;
    for (int i = threadIdx.x; i < DP * kChunks; i += blockDim.x) {
      const int r = i / kChunks, c = (i % kChunks) * 8;
      T* out = dst + r * Tl::kStride + c;
      if (r < d) {
        cp_async16(out, src + (size_t)r * seq + s0 + c);
      } else {
        const uint32_t w = r == ones ? one : 0u;
        *reinterpret_cast<uint4*>(out) = make_uint4(w, w, w, w);
      }
    }
  }
}

// S = q̃·Kᵀ for this warp's 16 rows against a 64-row K tile.
template <typename T, int L, int DP>
__device__ __forceinline__ void scores(float (&s)[kNTiles][4],
                                       const uint32_t (&qf)[DP / 16][4],
                                       const T* sK, int lane) {
  constexpr int kStride = Tile<L, DP, kBlockN>::kStride;
#pragma unroll
  for (int nt = 0; nt < kNTiles; ++nt) {
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
  }
  if constexpr (L == kBHSD) {
    const int g = lane >> 2, tq = lane & 3;
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
      const T* kr = sK + (nt * 8 + g) * kStride + tq * 2;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        uint32_t b[2] = {lds32(kr + kk * 16), lds32(kr + kk * 16 + 8)};
        Ops<T>::mma(s[nt], qf[kk], b);
      }
    }
  } else {
    // Kᵀ's [d, kv] rows: B fragments of two n-tiles per ldmatrix.x4.trans.
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < kNTiles; nt += 2) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, sK + (kk * 16 + (lane & 15)) * kStride +
                                 (nt + (lane >> 4)) * 8);
        uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
        Ops<T>::mma(s[nt], qf[kk], b0);
        Ops<T>::mma(s[nt + 1], qf[kk], b1);
      }
    }
  }
}

// Online softmax of one score tile, then O += P·V. Rows g and g + 8 of the
// warp's 16: m_run is the running max, l_run the (quad-partial, or with
// kTileRound the full) running row sum.
template <typename T, int L, int DP, int SM, bool kFold, bool kTileRound>
__device__ __forceinline__ void softmax_pv(float (&s)[kNTiles][4],
                                           float (&oacc)[DP / 8][4],
                                           float (&m_run)[2],
                                           float (&l_run)[2], const T* sV,
                                           int lane) {
  constexpr int kStride = Tile<L, DP, kBlockN>::kStride;
  const int g = lane >> 2, tq = lane & 3;
  float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
  for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
  }
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    // S is a multiple of 64: every score is finite; alpha = 0 on tile 0.
    alpha[r] = SM == kExp ? expf(m_run[r] - mx[r]) : exp2f(m_run[r] - mx[r]);
    m_run[r] = mx[r];
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      const float x0 = s[nt][e] - m_run[e >> 1];
      const float x1 = s[nt][e + 1] - m_run[e >> 1];
      float p0, p1;
      if constexpr (SM == kExp) {
        p0 = expf(x0);
        p1 = expf(x1);
      } else if constexpr (SM == kExp2Bf16) {
        ex2_bf16x2(x0, x1, p0, p1);
      } else {
        p0 = exp2f(x0);
        p1 = exp2f(x1);
      }
      if constexpr (SM == kExp2P16 || SM == kExp2Bf16) {
        p0 = round16<T>(p0);
        p1 = round16<T>(p1);
      }
      s[nt][e] = p0;
      s[nt][e + 1] = p1;
      rs[e >> 1] += p0 + p1;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if constexpr (kTileRound) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      rs[r] = round16<T>(rs[r]);
    }
    if constexpr (!kFold) l_run[r] = l_run[r] * alpha[r] + rs[r];
  }
#pragma unroll
  for (int dt = 0; dt < DP / 8; ++dt) {
    oacc[dt][0] *= alpha[0];
    oacc[dt][1] *= alpha[0];
    oacc[dt][2] *= alpha[1];
    oacc[dt][3] *= alpha[1];
  }
#pragma unroll
  for (int kt = 0; kt < kPSteps; ++kt) {
    uint32_t a[4];
    a[0] = Ops<T>::pack(s[2 * kt][0], s[2 * kt][1]);
    a[1] = Ops<T>::pack(s[2 * kt][2], s[2 * kt][3]);
    a[2] = Ops<T>::pack(s[2 * kt + 1][0], s[2 * kt + 1][1]);
    a[3] = Ops<T>::pack(s[2 * kt + 1][2], s[2 * kt + 1][3]);
#pragma unroll
    for (int dt = 0; dt < DP / 8; ++dt) {
      uint32_t b[2];
      if constexpr (L == kBHSD) {
        ldmatrix_x2_trans(b, sV + (kt * 16 + (lane & 15)) * kStride + dt * 8);
      } else {
        const T* vr = sV + (dt * 8 + g) * kStride + kt * 16 + tq * 2;
        b[0] = lds32(vr);
        b[1] = lds32(vr + 8);
      }
      Ops<T>::mma(oacc[dt], a, b);
    }
  }
}

template <typename T, int L, int DP, int SM, bool kFold, bool kTileRound,
          int G, int PF>
__device__ __forceinline__ void attend_head(const T* qb, const T* kb,
                                            const T* vb, T* ob, int sq,
                                            int skv, int d, float qscale,
                                            unsigned char* smem) {
  constexpr int kQRows = kBlockM * G;
  constexpr int kBufs = PF == kSync ? 1 : 2;
  using TQ = Tile<L, DP, kQRows>;
  using TK = Tile<L, DP, kBlockN>;
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + TQ::kElems;               // kBufs K tiles, then kBufs V tiles
  T* sV = sK + kBufs * TK::kElems;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int q0 = blockIdx.x * kQRows;
  const int ones = kFold ? d : -1;

  __syncthreads();  // the previous head (T2) is done with shared memory
  stage<T, L, DP, kQRows>(sQ, qb, q0, sq, d, -1);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  // q̃ = round16(q · round16(c)), in place.
  const float c16 = round16<T>(qscale);
  for (int i = threadIdx.x; i < TQ::kElems; i += blockDim.x) {
    sQ[i] = Ops<T>::cast(to_float(sQ[i]) * c16);
  }
  __syncthreads();

  uint32_t qf[DP / 16][4];
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    if constexpr (L == kBHSD) {
      const T* p0 = sQ + (warp * 16 + g) * TQ::kStride + kk * 16 + tq * 2;
      const T* p1 = p0 + 8 * TQ::kStride;
      qf[kk][0] = lds32(p0);
      qf[kk][1] = lds32(p1);
      qf[kk][2] = lds32(p0 + 8);
      qf[kk][3] = lds32(p1 + 8);
    } else {
      ldmatrix_x4_trans(
          qf[kk], sQ + (kk * 16 + (lane & 7) + ((lane >> 4) & 1) * 8) *
                           TQ::kStride +
                      warp * 16 + ((lane >> 3) & 1) * 8);
    }
  }

  float oacc[DP / 8][4];
#pragma unroll
  for (int dt = 0; dt < DP / 8; ++dt) {
    oacc[dt][0] = oacc[dt][1] = oacc[dt][2] = oacc[dt][3] = 0.f;
  }
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  float s[kNTiles][4];
  const int n_tiles = skv / kBlockN;
  auto stage_kv = [&](int t, int buf) {
    stage<T, L, DP, kBlockN>(sK + buf * TK::kElems, kb, t * kBlockN, skv, d,
                             -1);
    stage<T, L, DP, kBlockN>(sV + buf * TK::kElems, vb, t * kBlockN, skv, d,
                             ones);
  };

  if constexpr (PF == kSync) {
    for (int t = 0; t < n_tiles; ++t) {
      __syncthreads();  // every warp is done with the previous tile
      stage_kv(t, 0);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      scores<T, L, DP>(s, qf, sK, lane);
      softmax_pv<T, L, DP, SM, kFold, kTileRound>(s, oacc, m_run, l_run, sV,
                                                 lane);
    }
  } else if constexpr (PF == kLoadAhead) {
    stage_kv(0, 0);
    cp_async_commit();
    for (int t = 0; t < n_tiles; ++t) {
      const int buf = t & 1;
      // Tile t + 1's copies are in flight while tile t is computed.
      if (t + 1 < n_tiles) stage_kv(t + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();  // all but the newest group: tile t has landed
      __syncthreads();
      scores<T, L, DP>(s, qf, sK + buf * TK::kElems, lane);
      softmax_pv<T, L, DP, SM, kFold, kTileRound>(
          s, oacc, m_run, l_run, sV + buf * TK::kElems, lane);
      __syncthreads();  // buffer `buf` is restaged at iteration t + 1
    }
  } else {
    stage_kv(0, 0);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    scores<T, L, DP>(s, qf, sK, lane);
    for (int t = 0; t < n_tiles; ++t) {
      const int buf = t & 1;
      float s_next[kNTiles][4];
      if (t + 1 < n_tiles) {
        stage_kv(t + 1, buf ^ 1);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        // S(t+1) issued before softmax(S(t)): no dependency between them.
        scores<T, L, DP>(s_next, qf, sK + (buf ^ 1) * TK::kElems, lane);
      }
      softmax_pv<T, L, DP, SM, kFold, kTileRound>(
          s, oacc, m_run, l_run, sV + buf * TK::kElems, lane);
      if (t + 1 < n_tiles) {
#pragma unroll
        for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nt][e] = s_next[nt][e];
        }
      }
      __syncthreads();  // buffer `buf` is restaged at iteration t + 1
    }
  }

  float inv[2];
  if constexpr (kFold) {
    // Column d of the accumulator is the row sum; the quad's thread 0
    // (tq = 0, since d % 8 == 0) holds it.
    float l[2] = {0.f, 0.f};
#pragma unroll
    for (int dt = 0; dt < DP / 8; ++dt) {
      if (dt == (d >> 3)) {
        l[0] = oacc[dt][0];
        l[1] = oacc[dt][2];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      inv[r] = 1.f / __shfl_sync(0xffffffffu, l[r], lane & ~3);
    }
  } else {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_run[r];
      if constexpr (!kTileRound) {
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
      }
      inv[r] = 1.f / l;
    }
  }

  const int r0 = warp * 16 + g;  // row within the q tile; r0 + 8 the other
  if constexpr (L == kBHSD) {
#pragma unroll
    for (int dt = 0; dt < DP / 8; ++dt) {
      const int col = dt * 8 + tq * 2;
      if (col < d) {  // d is even: col + 1 < d too
        *reinterpret_cast<uint32_t*>(ob + (size_t)(q0 + r0) * d + col) =
            Ops<T>::pack(oacc[dt][0] * inv[0], oacc[dt][1] * inv[0]);
        *reinterpret_cast<uint32_t*>(ob + (size_t)(q0 + r0 + 8) * d + col) =
            Ops<T>::pack(oacc[dt][2] * inv[1], oacc[dt][3] * inv[1]);
      }
    }
  } else {
    // Through shared memory (this warp's own q columns of sQ), then [d, s]
    // rows of 16 bytes.
#pragma unroll
    for (int dt = 0; dt < DP / 8; ++dt) {
      const int col = dt * 8 + tq * 2;
      T* o0 = sQ + col * TQ::kStride + r0;
      o0[0] = Ops<T>::cast(oacc[dt][0] * inv[0]);
      o0[TQ::kStride] = Ops<T>::cast(oacc[dt][1] * inv[0]);
      o0[8] = Ops<T>::cast(oacc[dt][2] * inv[1]);
      o0[TQ::kStride + 8] = Ops<T>::cast(oacc[dt][3] * inv[1]);
    }
    __syncthreads();
    constexpr int kChunks = kQRows / 8;
    for (int i = threadIdx.x; i < d * kChunks; i += blockDim.x) {
      const int r = i / kChunks, c = (i % kChunks) * 8;
      *reinterpret_cast<uint4*>(ob + (size_t)r * sq + q0 + c) =
          *reinterpret_cast<const uint4*>(sQ + r * TQ::kStride + c);
    }
  }
}

// Grid: (Sq / (64·G), B·H), or (Sq / 64, B) with kHeadLoop.
template <typename T, int L, int DP, int SM, bool kFold, bool kTileRound,
          int G, int PF, bool kHeadLoop>
__global__ void __launch_bounds__(kThreads* G)
    variant_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, T* __restrict__ o, int heads,
                   int sq, int skv, int d, float qscale) {
  static_assert(DP % 16 == 0 && DP <= 128, "head dim tile");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int h0 = kHeadLoop ? blockIdx.y * heads : blockIdx.y;
  const int nh = kHeadLoop ? heads : 1;
  for (int hh = 0; hh < nh; ++hh) {
    const size_t bh = h0 + hh;
    attend_head<T, L, DP, SM, kFold, kTileRound, G, PF>(
        q + bh * sq * d, k + bh * skv * d, v + bh * skv * d, o + bh * sq * d,
        sq, skv, d, qscale, smem_raw);
  }
}

template <typename T, int L, int DP, int SM, bool kFold, bool kTileRound,
          int G, int PF, bool kHeadLoop>
int launch_dp(const void* q, const void* k, const void* v, void* o,
              int batch, int heads, int sq, int skv, int d, float qscale,
              cudaStream_t stream) {
  constexpr int kBufs = PF == kSync ? 1 : 2;
  const int smem = (Tile<L, DP, kBlockM * G>::kElems +
                    2 * kBufs * Tile<L, DP, kBlockN>::kElems) *
                   (int)sizeof(T);
  auto kernel =
      variant_kernel<T, L, DP, SM, kFold, kTileRound, G, PF, kHeadLoop>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(sq / (kBlockM * G), kHeadLoop ? batch : batch * heads);
  kernel<<<grid, kThreads * G, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), heads, sq, skv, d,
      qscale);
  return (int)cudaGetLastError();
}

// The configurations the entry points launch; T6 v0 is T1 v0.
enum ConfigId : int {
  kT1v0, kT1vU, kT1vG2, kT1vG4, kT2, kT3, kT4, kT5ttv3, kT5ttv4, kT5NoFold,
  kT6v1, kT6v2, kNumConfigs
};
struct Config {
  int layout, softmax;
  bool fold, tile_round;
  int g, prefetch;
  bool head_loop;
};
constexpr Config kConfigs[kNumConfigs] = {
    {kBHSD, kExp, false, false, 1, kSync, false},         // T1 v0, T6 v0
    {kBHSD, kExp, false, false, 1, kLoadAhead, false},    // T1 vU
    {kBHSD, kExp, false, false, 2, kSync, false},         // T1 vG, G = 2
    {kBHSD, kExp, false, false, 4, kSync, false},         // T1 vG, G = 4
    {kBHSD, kExp, false, false, 1, kSync, true},          // T2
    {kBHSD, kExp, false, false, 1, kScoreAhead, false},   // T3
    {kBHDS, kExp, false, false, 1, kSync, false},         // T4
    {kBHDS, kExp2P16, true, false, 1, kSync, false},      // T5 ttv3
    {kBHDS, kExp2Bf16, true, false, 1, kSync, false},     // T5 ttv4
    {kBHDS, kExp2P16, false, true, 1, kSync, false},      // T5 no-fold
    {kBHSD, kExp2, false, false, 1, kSync, false},        // T6 v1
    {kBHSD, kExp2P16, false, false, 1, kSync, false},     // T6 v2
};

// Configuration C in dtype T, at the head width padded to 16 (to d + 1
// with the fold). The caller has checked the domain.
template <int C, typename T>
int launch_config(const void* q, const void* k, const void* v, void* o,
                  int batch, int heads, int sq, int skv, int d, float qscale,
                  cudaStream_t stream) {
  constexpr Config c = kConfigs[C];
#define VARIANT_CASE(n)                                                      \
  case n / 16:                                                               \
    return launch_dp<T, c.layout, n, c.softmax, c.fold, c.tile_round, c.g,   \
                     c.prefetch, c.head_loop>(q, k, v, o, batch, heads, sq,  \
                                              skv, d, qscale, stream);
  switch (((c.fold ? d + 1 : d) + 15) / 16) {
    VARIANT_CASE(16) VARIANT_CASE(32) VARIANT_CASE(48) VARIANT_CASE(64)
    VARIANT_CASE(80) VARIANT_CASE(96) VARIANT_CASE(112) VARIANT_CASE(128)
    default: return (int)cudaErrorInvalidValue;
  }
#undef VARIANT_CASE
}

}  // namespace

// The build. Each (configuration, dtype) pair is one unit of 8 head widths,
// 24 units and 192 kernels in all. ops/flash_attention.build compiles this
// file BUILD_PARTS times at once, with -DBUILD_PART=0..BUILD_PARTS-1, and
// links the objects into one library: part p instantiates the units
// u = 2·C + dtype with u % BUILD_PARTS == p and enters them in `launchers`
// when the library is loaded; part 0 also holds the table and the entry
// points. A compile without these macros holds everything.
#ifndef BUILD_PARTS
#define BUILD_PARTS 1
#define BUILD_PART 0
#endif

using Launcher = int (*)(const void*, const void*, const void*, void*, int,
                         int, int, int, int, float, cudaStream_t);
namespace flash_variants {
extern Launcher launchers[kNumConfigs][2];  // [configuration][dtype]
#if BUILD_PART == 0
Launcher launchers[kNumConfigs][2] = {};
#endif
}  // namespace flash_variants

namespace {

template <int C, int DT>
void enter_unit() {
  if constexpr ((2 * C + DT) % BUILD_PARTS == BUILD_PART) {
    using T = std::conditional_t<DT == 0, __nv_bfloat16, __half>;
    flash_variants::launchers[C][DT] = &launch_config<C, T>;
  }
}

template <int... C>
bool enter_units(std::integer_sequence<int, C...>) {
  (enter_unit<C, 0>(), ...);
  (enter_unit<C, 1>(), ...);
  return true;
}

[[maybe_unused]] const bool kEntered =
    enter_units(std::make_integer_sequence<int, kNumConfigs>{});

}  // namespace

#if BUILD_PART == 0
namespace {

// Checks the domain of configuration `config`, then launches it.
int run(int config, const void* q, const void* k, const void* v, void* o,
        int batch, int heads, int sq, int skv, int d, float scale, int dtype,
        void* stream) {
  const Config& c = kConfigs[config];
  const int rows = c.head_loop ? batch : batch * heads;
  if (dtype < 0 || dtype > 1 || batch < 1 || heads < 1 || rows > 65535 ||
      sq < 1 || skv < 1 || sq % (kBlockM * c.g) != 0 || skv % kBlockN != 0 ||
      d < 8 || d % 8 != 0 || d > (c.fold ? 120 : 128)) {
    return (int)cudaErrorInvalidValue;
  }
  const Launcher launch = flash_variants::launchers[config][dtype];
  if (launch == nullptr) return (int)cudaErrorInvalidDeviceFunction;
  const float qscale = (float)(c.softmax == kExp
                                   ? (double)scale
                                   : (double)scale * 1.4426950408889634);
  return launch(q, k, v, o, batch, heads, sq, skv, d, qscale,
                static_cast<cudaStream_t>(stream));
}

}  // namespace

// Plain C entry points (bound with ctypes), one per TPU kernel. Tensors are
// contiguous [B, H, S, D] (T1, T2, T3, T6) or [B, H, D, S] (T4, T5), 16-byte
// aligned; dtype 0 = bf16, 1 = fp16. Each launches on `stream` and returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a shape
// or option outside the domain).
#define VARIANT_ARGS                                                          \
  const void *q, const void *k, const void *v, void *o, int batch, int heads, \
      int sq, int skv, int d, float scale, int dtype
#define VARIANT_PASS q, k, v, o, batch, heads, sq, skv, d, scale, dtype, stream

// T1: variant 0 = v0, 1 = vU, 2 = vG with G = 2, 3 = vG with G = 4.
extern "C" int flash_opt_attn(VARIANT_ARGS, int variant, void* stream) {
  if (variant < 0 || variant > 3) return (int)cudaErrorInvalidValue;
  return run(kT1v0 + variant, VARIANT_PASS);
}

// T2: all heads of a q tile in one block.
extern "C" int flash_opt_attn_h(VARIANT_ARGS, void* stream) {
  return run(kT2, VARIANT_PASS);
}

// T3: QKᵀ of the next tile before this tile's softmax.
extern "C" int flash_pipelined_attn(VARIANT_ARGS, void* stream) {
  return run(kT3, VARIANT_PASS);
}

// T4: [B, H, D, S] operands, natural exp, fp32 row sum.
extern "C" int flash_tt2_attn(VARIANT_ARGS, void* stream) {
  return run(kT4, VARIANT_PASS);
}

// T5: [B, H, D, S], exp2. bf16_p: exp2 on bf16 arguments; sum_fold: the row
// sum from the P·V product (else summed per tile, rounded to 16 bits).
extern "C" int flash_ttv3_attn(VARIANT_ARGS, int bf16_p, int sum_fold,
                               void* stream) {
  if (sum_fold) return run(bf16_p ? kT5ttv4 : kT5ttv3, VARIANT_PASS);
  if (!bf16_p) return run(kT5NoFold, VARIANT_PASS);
  return (int)cudaErrorInvalidValue;  // the TPU tool has no unfolded bf16_p
}

// T6: variant 0 = exp (T1 v0's instantiation: the same code on Hopper),
// 1 = exp2, 2 = exp2 with the row sum of the 16-bit P.
extern "C" int flash_variants_attn(VARIANT_ARGS, int variant, void* stream) {
  switch (variant) {
    case 0: return run(kT1v0, VARIANT_PASS);
    case 1: return run(kT6v1, VARIANT_PASS);
    case 2: return run(kT6v2, VARIANT_PASS);
    default: return (int)cudaErrorInvalidValue;
  }
}

#undef VARIANT_PASS
#undef VARIANT_ARGS
#endif  // BUILD_PART == 0
