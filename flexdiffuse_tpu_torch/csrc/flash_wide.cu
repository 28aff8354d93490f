// Forward flash attention for wide heads on Hopper (sm_90a):
// softmax(q·kᵀ·scale)·v over contiguous [B, H, S, D] bf16/fp16/fp32
// tensors with 128 < D <= 512, fp32 accumulators, Sq != Skv allowed, any
// S >= 1.
//
// Replaces the JAX package's Pallas kernels at head widths above 128:
// flexdiffuse_tpu/ops/flash_attention.py::_flash_tt_kernel (K1, :126), which
// JAX runs while K/V fit its 8 MiB VMEM budget, and ::_flash_stream_kernel
// (K2, :44), which streams K/V with (m, l, acc) carried in scratch across
// grid steps; the SD VAE's mid-block (one 512-wide head over 4096 tokens at
// 512², 16384 at 1024²) is the call. Here K/V always stream through shared
// memory, so one kernel serves both.
//
// What bounds it on this card. At (1,1,4096,512) the products are 4·S²·D =
// 34.4 GFLOP, 0.035 ms at the bf16 tensor-core peak, against 16 MiB of
// q, k, v and o (0.005 ms at 3.35 TB/s): the tensor cores bound it, so the
// design does each product once and keeps shared-memory traffic per
// product low:
// - The trap: a 64-row q tile with an fp32 accumulator 512 wide is 128 KB,
//   more registers than a warpgroup holds. The choice: the output's D is
//   split across the warps of one block, and so is S's reduction over D.
//   A block of 8 warps owns 32 q rows, as 2 row groups × 4 "quarters" of
//   128 head columns (D is padded to W = 128·nq, nq = ⌈D/128⌉ ≤ 4). Warp
//   (r, c) keeps Q's rows r, columns of quarter c in registers, computes
//   the partial S of its rows over its quarter against each K tile, and
//   owns the output's rows r, columns of quarter c (64 fp32 accumulators a
//   thread). The partial S go through shared memory (fp32) and are summed
//   in a fixed order by warp (r, c) for kv columns 8c..8c+7 of the tile;
//   the row maxima meet there too, so every warp of a row group uses the
//   same running max and P. P (16-bit) is written to shared memory and
//   each warp multiplies its rows of P by its quarter of V. An earlier
//   design (each block one 128-column output chunk, S recomputed per
//   chunk) did 2.5× the products at D = 512 and ran at 3.5 % of the bound
//   at (1,1,4096,512) on an H100 SXM at 700 W.
// - Shared memory: K and V tiles of 32 kv rows × W, double-buffered and
//   filled with cp.async (16-byte rows, zero-filled past Skv) while the
//   block works on the other buffer: 130 KB at D = 512; Q's 32 × W stage
//   (33 KB) is read into registers once and then holds the partial S, the
//   row maxima and P. One block per SM; the grid is ⌈Sq/32⌉ × B·H (128
//   blocks at the VAE's 4096 tokens).
// - mma.sync m16n8k16 (flash_common.cuh); the base-2 online softmax (s ·
//   scale·log2 e, running max and sum in fp32, ragged kv columns masked)
//   and P rounded to the 16-bit type before P·V, as the kept K1 kernel
//   (flash_attention.cu flash_fwd_kernel). Four block barriers per K/V
//   tile order the partial S, the maxima, P and the buffers.
// - D % 8 != 0, a misaligned pointer or fp32 tensors are staged
//   synchronously element by element (fp32 rounded to bf16 as it is
//   staged, the operand precision of the TPU's default-precision fp32
//   product, as the kept kernel does); the output is written from the fp32
//   accumulators in q's dtype.

#include <type_traits>

#include "flash_common.cuh"

namespace {

constexpr int kWideRows = 32;    // q rows per block (2 row groups of 16)
constexpr int kWideKv = 32;      // kv rows per streamed tile
constexpr int kQuarter = 128;    // head columns per warp
constexpr int kWideWarps = 8;    // 2 row groups × 4 quarters
constexpr int kWideThreads = kWideWarps * 32;
constexpr int kSStride = kWideKv + 8;   // fp32 partial-S row stride
constexpr int kPStride = kWideKv + 8;   // 16-bit P row stride

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;   // 0: zero-fill the 16 bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(a),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Stage rows [r0, r0 + nrows) x cols [0, width) of a [rows, d] matrix of TI
// into shared memory of T with row stride `stride`; rows >= `rows` and
// cols >= d are zero. `width` is a multiple of 8. With `async` (T == TI,
// d % 8 == 0, 16-byte aligned rows) by cp.async, to be waited for;
// otherwise synchronously, element by element where a chunk is ragged.
template <typename T, typename TI>
__device__ __forceinline__ void stage(T* dst, int stride, const TI* src,
                                      int r0, int nrows, int rows, int width,
                                      int d, bool async) {
  const int chunks = width / 8;
  const T zero = Ops<T>::cast(0.f);
  for (int i = threadIdx.x; i < nrows * chunks; i += kWideThreads) {
    const int r = i / chunks;
    const int c = (i % chunks) * 8;
    const int gr = r0 + r;
    T* out = dst + r * stride + c;
    if constexpr (std::is_same_v<T, TI>) {
      if (async) {
        const bool in = gr < rows && c < d;
        cp_async16(out, in ? src + (size_t)gr * d + c : src, in);
        continue;
      }
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const bool in = gr < rows && c + e < d;
      if constexpr (std::is_same_v<TI, float>) {
        out[e] = in ? Ops<T>::cast(src[(size_t)gr * d + c + e]) : zero;
      } else {
        out[e] = in ? src[(size_t)gr * d + c + e] : zero;
      }
    }
  }
}

// T: the 16-bit type of the shared tiles and the products; TI: the type of
// q, k, v and o (T, or float). `nq`: head-column quarters, ⌈d/128⌉.
template <typename T, typename TI>
__global__ void __launch_bounds__(kWideThreads, 1)
    flash_fwd_wide_kernel(const TI* __restrict__ q, const TI* __restrict__ k,
                          const TI* __restrict__ v, TI* __restrict__ o,
                          int sq, int skv, int d, int nq, float scale_log2,
                          int vec) {
  constexpr int kKSteps = kQuarter / 16;   // k-steps of a quarter's S
  constexpr int kNTiles = kWideKv / 8;     // n-tiles of S over the kv tile
  constexpr int kPSteps = kWideKv / 16;    // k-steps of P·V over kv
  constexpr int kDTiles = kQuarter / 8;    // n-tiles of P·V over a quarter
  const int width = nq * kQuarter;
  const int stride = width + kPad;
  const int tile_elems = kWideKv * stride;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sK = sQ + kWideRows * stride;      // [2][kWideKv][stride]
  T* sV = sK + 2 * tile_elems;          // [2][kWideKv][stride]
  // After Q is in registers its stage holds the partial S [nq][32]
  // [kSStride] (fp32), the row maxima [4][32] (fp32) and P [32][kPStride].
  float* sS = reinterpret_cast<float*>(smem_raw);
  float* sMax = sS + nq * kWideRows * kSStride;
  T* sP = reinterpret_cast<T*>(sMax + 4 * kWideRows);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;   // fragment row within 8
  const int tq = lane & 3;   // thread within quad
  const int rg = warp & 1;   // row group
  const int quarter = warp >> 1;   // head quarter; kv n-tile in the softmax
  const bool active = quarter < nq;
  const int row0 = rg * 16 + g;    // block rows row0 and row0 + 8
  const size_t bh = blockIdx.y;
  const int q0 = blockIdx.x * kWideRows;
  const bool async = std::is_same_v<T, TI> && vec != 0;

  const TI* qb = q + bh * sq * d;
  const TI* kb = k + bh * skv * d;
  const TI* vb = v + bh * skv * d;
  TI* ob = o + bh * sq * d;

  stage<T, TI>(sQ, stride, qb, q0, kWideRows, sq, width, d, async);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  // A fragments of Q: the warp's 16 rows over its quarter, for the whole
  // kv loop.
  uint32_t qf[kKSteps][4];
  if (active) {
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      const T* p0 = sQ + row0 * stride + quarter * kQuarter + kk * 16 +
                    tq * 2;
      const T* p1 = p0 + 8 * stride;
      qf[kk][0] = lds32(p0);
      qf[kk][1] = lds32(p1);
      qf[kk][2] = lds32(p0 + 8);
      qf[kk][3] = lds32(p1 + 8);
    }
  }

  float oacc[kDTiles][4];
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt) {
    oacc[dt][0] = oacc[dt][1] = oacc[dt][2] = oacc[dt][3] = 0.f;
  }
  // Rows row0 and row0 + 8: running max (the same in every warp of the row
  // group) and this thread's partial sum over its softmax columns.
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  const int n_tiles = (skv + kWideKv - 1) / kWideKv;
  stage<T, TI>(sK, stride, kb, 0, kWideKv, skv, width, d, async);
  stage<T, TI>(sV, stride, vb, 0, kWideKv, skv, width, d, async);
  cp_async_commit();
  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    const T* tK = sK + buf * tile_elems;
    const T* tV = sV + buf * tile_elems;
    cp_async_wait_all();
    // [A] tile t has landed; every warp is done with tile t - 1 (its
    // buffer is free) and with Q's stage (the first time).
    __syncthreads();
    if (t + 1 < n_tiles) {
      const int nb = buf ^ 1;
      stage<T, TI>(sK + nb * tile_elems, stride, kb, (t + 1) * kWideKv,
                   kWideKv, skv, width, d, async);
      stage<T, TI>(sV + nb * tile_elems, stride, vb, (t + 1) * kWideKv,
                   kWideKv, skv, width, d, async);
      cp_async_commit();
    }

    // Partial S = Q[rows, quarter]·K[:, quarter]ᵀ, 16 x 32 per warp.
    if (active) {
      float s[kNTiles][4];
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt) {
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
#pragma unroll
        for (int nt = 0; nt < kNTiles; ++nt) {
          const T* kr = tK + (nt * 8 + g) * stride + quarter * kQuarter +
                        kk * 16 + tq * 2;
          uint32_t b[2];
          b[0] = lds32(kr);
          b[1] = lds32(kr + 8);
          Ops<T>::mma(s[nt], qf[kk], b);
        }
      }
      float* out = sS + quarter * kWideRows * kSStride;
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt) {
        const int col = nt * 8 + tq * 2;
        *reinterpret_cast<float2*>(out + row0 * kSStride + col) =
            make_float2(s[nt][0], s[nt][1]);
        *reinterpret_cast<float2*>(out + (row0 + 8) * kSStride + col) =
            make_float2(s[nt][2], s[nt][3]);
      }
    }
    __syncthreads();   // [B] the partial S are in place

    // Softmax of kv columns 8·quarter .. +7 for the warp's rows: S summed
    // over the quarters in order, base-2, ragged columns masked.
    const int k0 = t * kWideKv;
    const int col = quarter * 8 + tq * 2;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    for (int p = 0; p < nq; ++p) {
      const float* in = sS + p * kWideRows * kSStride;
      const float2 a = *reinterpret_cast<const float2*>(
          in + row0 * kSStride + col);
      const float2 c = *reinterpret_cast<const float2*>(
          in + (row0 + 8) * kSStride + col);
      x[0] += a.x;
      x[1] += a.y;
      x[2] += c.x;
      x[3] += c.y;
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      x[e] = k0 + col + (e & 1) < skv ? x[e] * scale_log2 : -INFINITY;
      mx[e >> 1] = fmaxf(mx[e >> 1], x[e]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    if (tq == 0) {
      sMax[quarter * kWideRows + row0] = mx[0];
      sMax[quarter * kWideRows + row0 + 8] = mx[1];
    }
    __syncthreads();   // [C] the row maxima of the four column slices

    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      float m = m_run[r];
#pragma unroll
      for (int p = 0; p < 4; ++p) m = fmaxf(m, sMax[p * kWideRows + row]);
      // Column k0 is always valid, so m is finite; exp2(-inf) = 0 on the
      // first tile.
      alpha[r] = exp2f(m_run[r] - m);
      m_run[r] = m;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      x[e] = exp2f(x[e] - m_run[e >> 1]);
      rs[e >> 1] += x[e];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + rs[r];
    *reinterpret_cast<uint32_t*>(sP + row0 * kPStride + col) =
        Ops<T>::pack(x[0], x[1]);
    *reinterpret_cast<uint32_t*>(sP + (row0 + 8) * kPStride + col) =
        Ops<T>::pack(x[2], x[3]);
    __syncthreads();   // [D] P is in place

    // O[rows, quarter] = alpha·O + P·V[:, quarter].
#pragma unroll
    for (int dt = 0; dt < kDTiles; ++dt) {
      oacc[dt][0] *= alpha[0];
      oacc[dt][1] *= alpha[0];
      oacc[dt][2] *= alpha[1];
      oacc[dt][3] *= alpha[1];
    }
    if (active) {
#pragma unroll
      for (int kt = 0; kt < kPSteps; ++kt) {
        const T* p0 = sP + row0 * kPStride + kt * 16 + tq * 2;
        const T* p1 = p0 + 8 * kPStride;
        uint32_t a[4];
        a[0] = lds32(p0);
        a[1] = lds32(p1);
        a[2] = lds32(p0 + 8);
        a[3] = lds32(p1 + 8);
        const T* vr = tV + (kt * 16 + (lane & 15)) * stride +
                      quarter * kQuarter;
#pragma unroll
        for (int dt = 0; dt < kDTiles; ++dt) {
          uint32_t b[2];
          ldmatrix_x2_trans(b, vr + dt * 8);
          Ops<T>::mma(oacc[dt], a, b);
        }
      }
    }
  }

  // The row sums: each warp's slice reduced over its quad, then the four
  // slices of the row group added in order.
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (tq == 0) sMax[quarter * kWideRows + row0 + 8 * r] = l;
  }
  __syncthreads();
  if (!active) return;
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = 0.f;
#pragma unroll
    for (int p = 0; p < 4; ++p) l += sMax[p * kWideRows + row0 + 8 * r];
    inv[r] = 1.f / l;
  }
  const int out0 = q0 + row0;
  const int out1 = out0 + 8;
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt) {
    const int c = quarter * kQuarter + dt * 8 + tq * 2;
    if (out0 < sq) {
      if (c < d) ob[(size_t)out0 * d + c] = to_out<T, TI>(oacc[dt][0] * inv[0]);
      if (c + 1 < d) ob[(size_t)out0 * d + c + 1] = to_out<T, TI>(oacc[dt][1] * inv[0]);
    }
    if (out1 < sq) {
      if (c < d) ob[(size_t)out1 * d + c] = to_out<T, TI>(oacc[dt][2] * inv[1]);
      if (c + 1 < d) ob[(size_t)out1 * d + c + 1] = to_out<T, TI>(oacc[dt][3] * inv[1]);
    }
  }
}

template <typename T, typename TI>
int launch_wide(const void* q, const void* k, const void* v, void* o,
                int batch_heads, int sq, int skv, int d, float scale, int vec,
                cudaStream_t stream) {
  const int nq = (d + kQuarter - 1) / kQuarter;
  const int stride = nq * kQuarter + kPad;
  const int smem = (kWideRows + 4 * kWideKv) * stride * (int)sizeof(T);
  // Q's stage takes the partial S, maxima and P at nq = 1, and each more
  // quarter adds more to the stage than to the partial S.
  static_assert(kWideRows * kSStride * 4 + 4 * kWideRows * 4 +
                        kWideRows * kPStride * 2 <=
                    kWideRows * (kQuarter + kPad) * 2 &&
                    kSStride * 4 <= kQuarter * 2,
                "the partial S, maxima and P fit Q's stage");
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wide_kernel<T, TI>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + kWideRows - 1) / kWideRows, batch_heads);
  flash_fwd_wide_kernel<T, TI><<<grid, kWideThreads, smem, stream>>>(
      static_cast<const TI*>(q), static_cast<const TI*>(k),
      static_cast<const TI*>(v), static_cast<TI*>(o), sq, skv, d, nq,
      scale * kLog2e, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 bf16, 1 fp16, 2 fp32 (rounded to bf16 as staged, fp32 out).
// vec: 1 when d % 8 == 0 and every pointer is 16-byte aligned. Returns a
// cudaError_t code; 0 when the launch was accepted.
int flash_attention_fwd_wide(const void* q, const void* k, const void* v,
                             void* o, int batch_heads, int sq, int skv, int d,
                             float scale, int dtype, int vec, void* stream) {
  if (batch_heads < 1 || batch_heads > 65535 || sq < 1 || skv < 1 ||
      d <= 128 || d > 512) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_wide<__nv_bfloat16, __nv_bfloat16>(q, k, v, o, batch_heads,
                                                     sq, skv, d, scale, vec,
                                                     s);
  }
  if (dtype == 1) {
    return launch_wide<__half, __half>(q, k, v, o, batch_heads, sq, skv, d,
                                       scale, vec, s);
  }
  if (dtype == 2) {
    return launch_wide<__nv_bfloat16, float>(q, k, v, o, batch_heads, sq,
                                             skv, d, scale, vec, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
