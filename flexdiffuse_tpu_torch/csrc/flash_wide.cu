// Forward flash attention for wide heads on Hopper (sm_90a):
// softmax(q·kᵀ·scale)·v over contiguous [B, H, S, D] bf16/fp16/fp32
// tensors with D > 128, fp32 accumulators, Sq != Skv allowed, any S >= 1.
//
// Replaces the JAX package's Pallas kernels at head widths above 128:
// flexdiffuse_tpu/ops/flash_attention.py::_flash_tt_kernel (K1, :126), which
// JAX runs while K/V fit its 8 MiB VMEM budget, and ::_flash_stream_kernel
// (K2, :44), which streams K/V with (m, l, acc) carried in scratch across
// grid steps; the SD VAE's mid-block (one 512-wide head over 4096 tokens at
// 512², 16384 at 1024²) is the call. Here K/V always stream through shared
// memory, so one kernel serves both. Two paths, which the wrapper
// (ops/flash_attention.py::plan) picks before the launch, as K1's:
//
// 'wide_sm90' (flash_fwd_wide_sm90_kernel), for bf16/fp16 with
// 128 < D <= 512, D % 8 == 0 and 16-byte aligned tensors (what TMA takes).
// What bounds it on this card: at (1,1,4096,512) the products are 4·S²·D =
// 34.4 GFLOP, 0.035 ms at the bf16 tensor-core peak, against 16 MiB of q,
// k, v and o (0.005 ms at 3.35 TB/s): the tensor cores. The design:
// - Registers. A 64-row x 512-column fp32 accumulator is 256 registers a
//   thread in one warpgroup, over the limit. So the head is split across
//   two consumer warpgroups: each owns columns [c·DP/2, (c+1)·DP/2) of O
//   (DP = D rounded up to 128; 128 registers at DP = 512) for the block's
//   64 q rows, which both share. There is no producer warpgroup: ptxas
//   gives every thread of a 384-thread block 168 registers whatever
//   setmaxnreg asks later, and the consumers spilled; with 256 threads they
//   have 255. One consumer thread issues the TMA loads.
// - S once. Each consumer computes the partial S = Q[:, half]·K_jᵀ[half, :]
//   over its half of D (wgmma m64n32k16, Q and K K-major in shared memory),
//   writes it (fp32) to shared memory and adds the other's in the same
//   order, so both hold the same S bit for bit and run the same online
//   softmax (base 2, m and l in fp32, ragged kv columns masked, P rounded to
//   the 16-bit type). Then O_half += P·V_j[:, half] (wgmma m64n{DP/2}k16, P
//   from registers, V MN-major). S is never recomputed; the softmax's
//   exponentials are done twice, 1/(4·D/2) of the products' work.
// - Shared memory: Q 64 x DP (64 KiB at DP = 512, loaded once), 16 KiB for
//   the two partials, and a ring of 32-row tiles, K_j and V_j each in its
//   own slot, as many pairs as fit (2 at DP = 512, 3 at 384, 5 at 256):
//   214 KB, one block per SM. Tiles are stored as TMA writes them with the
//   128-byte swizzle, in slabs of 64 columns; where D % 64 == 0 one 4-D box
//   brings all of a tile's slabs (else one box per slab, which zero-fills
//   the columns past D). Past the barrier where the two partials of S_j
//   meet, both consumers are done with K_j and with V_{j-2}, so the loader
//   refills those slots there: K a ring ahead, V a ring less two.
// - Pipeline (K1's): S_j is issued together with P_{j-1}·V_{j-1}, so the
//   exchange and the softmax of S_j run while that product is on the tensor
//   cores. O is rescaled only where a row's max moved (alpha = 1 exactly
//   otherwise), as it seldom does after the first tiles.
// - Grid fill. A block owns 64 q rows; at B·H = 1 and 4096 tokens that is 64
//   blocks for 132 SMs. Where the blocks fill at most half the card the kv
//   range is split in two (`split` = 2): a cluster of two blocks on the same
//   q rows, each over half of the kv tiles, whose rank 1 leaves its
//   unnormalised O, m and l in its shared memory for rank 0 to merge
//   (o = Σ o_r·2^((m_r − m)·c) over l likewise, in fp32) before the one
//   store.
// - Epilogue: O·(1/l) is written into the consumer's half of Q's tile (free
//   by then) in the swizzled layout and stored by TMA, which drops rows >= Sq
//   and columns >= D.
// - What holds it back: each 32-row kv tile is a chain of the 16
//   m64n32k16 products of each consumer's partial S (a narrow N, whose
//   issue the warpgroup waits on), the exchange of the partials and the
//   softmax, with only P_{j-1}·V_{j-1} beside it on the tensor cores.
//   Tried and not kept: Q held in registers for S (no gain worth its
//   registers), TMA multicast of K/V across a cluster pair of q tiles
//   (slower: the pair runs in lockstep), and S_{j+1} issued before the
//   softmax of S_j (ptxas serialises the wgmma, C7513, as P's registers are
//   written while S_{j+1} is in flight).
//
// 'wide' (flash_fwd_wide_kernel, the first design, kept) for fp32, D % 8 !=
// 0, misaligned pointers and every D > 512, in any dtype:
// - mma.sync m16n8k16 (flash_common.cuh). A block of 8 warps owns 32 q rows,
//   as 2 row groups x 4 "quarters" of 128 head columns. Warp (r, c) computes
//   the partial S of its rows over its quarter against each K tile and owns
//   the output's rows r, columns of quarter c (64 fp32 accumulators a
//   thread). The partial S go through shared memory (fp32) and are summed
//   in a fixed order; the row maxima meet there too, so every warp of a row
//   group uses the same running max and P. P (16-bit) is written to shared
//   memory and each warp multiplies its rows of P by its quarter of V. Four
//   block barriers per 32-row K/V tile order the partial S, the maxima, P
//   and the buffers.
// - Up to D = 512 Q's quarters stay in registers and K/V tiles of 32 kv rows
//   x 128·⌈D/128⌉ are double-buffered by cp.async (16-byte rows, zero-filled
//   past Skv): 130 KB at D = 512. The grid is ⌈Sq/32⌉ x B·H.
// - Above D = 512 (kChunked): a third grid dimension over 512-column output
//   chunks. Each block owns one chunk of O and, per kv tile, sums S over all
//   of D in 512-column steps (Q's and K's step staged, then each warp's
//   quarter of it), so Q·Kᵀ is computed ⌈D/512⌉ times over: the simplest
//   sound design for widths no model of the repo has. Staging is
//   synchronous.
// - fp32 tensors, D % 8 != 0 or a misaligned pointer are staged element by
//   element (fp32 rounded to bf16 as it is staged, the operand precision of
//   the TPU's default-precision fp32 product, as K1's kept kernel does); the
//   output is written from the fp32 accumulators in q's dtype.

#include <type_traits>
#include <utility>

#include "flash_common.cuh"
#include "sm90.cuh"

// The build: ops/flash_attention.build compiles this file WIDE_PARTS times
// at once (-DBUILD_PART=p) and links the objects. Part 0 holds the kept
// kernel, the launcher table and the entry points; part 1 the Hopper
// kernel's bf16 widths, part 2 its fp16 ones. A compile without these
// macros holds everything.
#ifndef BUILD_PARTS
#define BUILD_PARTS 1
#define BUILD_PART 0
#endif

#if BUILD_PART == 0
namespace {

constexpr int kWideRows = 32;    // q rows per block (2 row groups of 16)
constexpr int kWideKv = 32;      // kv rows per streamed tile
constexpr int kQuarter = 128;    // head columns per warp
constexpr int kChunk = 4 * kQuarter;   // head columns per block
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

// Stage rows [r0, r0 + nrows) x cols [col0, col0 + width) of a [rows, d]
// matrix of TI into shared memory of T with row stride `stride`; rows >=
// `rows` and cols >= d are zero. `width` and `col0` are multiples of 8.
// With `async` (T == TI, d % 8 == 0, 16-byte aligned rows) by cp.async, to
// be waited for; otherwise synchronously, element by element.
template <typename T, typename TI>
__device__ __forceinline__ void stage(T* dst, int stride, const TI* src,
                                      int r0, int nrows, int rows, int col0,
                                      int width, int d, bool async) {
  const int chunks = width / 8;
  const T zero = Ops<T>::cast(0.f);
  for (int i = threadIdx.x; i < nrows * chunks; i += kWideThreads) {
    const int r = i / chunks;
    const int c = (i % chunks) * 8;
    const int gr = r0 + r;
    const int gc = col0 + c;
    T* out = dst + r * stride + c;
    if constexpr (std::is_same_v<T, TI>) {
      if (async) {
        const bool in = gr < rows && gc < d;
        cp_async16(out, in ? src + (size_t)gr * d + gc : src, in);
        continue;
      }
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const bool in = gr < rows && gc + e < d;
      if constexpr (std::is_same_v<TI, float>) {
        out[e] = in ? Ops<T>::cast(src[(size_t)gr * d + gc + e]) : zero;
      } else {
        out[e] = in ? src[(size_t)gr * d + gc + e] : zero;
      }
    }
  }
}

// T: the 16-bit type of the shared tiles and the products; TI: the type of
// q, k, v and o (T, or float). `nq`: head-column quarters of a block, ⌈d/128⌉
// up to d = 512, 4 with kChunked (d > 512: blockIdx.z is the block's
// 512-column chunk of O, and S sums ⌈d/512⌉ chunks).
template <typename T, typename TI, bool kChunked>
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
  // The partial S [nq][32][kSStride] (fp32), the row maxima [4][32] (fp32)
  // and P [32][kPStride]: in Q's stage once Q is in registers, or (kChunked:
  // Q is staged anew for every kv tile, K/V are single-buffered) in K's
  // second buffer.
  float* sS = kChunked ? reinterpret_cast<float*>(sK + tile_elems)
                       : reinterpret_cast<float*>(smem_raw);
  float* sMax = sS + nq * kWideRows * kSStride;
  T* sP = reinterpret_cast<T*>(sMax + 4 * kWideRows);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;   // fragment row within 8
  const int tq = lane & 3;   // thread within quad
  const int rg = warp & 1;   // row group
  const int quarter = warp >> 1;   // head quarter; kv n-tile in the softmax
  const int col0 = kChunked ? blockIdx.z * kChunk : 0;   // O's chunk
  // Whether the warp owns output columns (and, up to d = 512, S's).
  const bool active = kChunked ? col0 + quarter * kQuarter < d : quarter < nq;
  const int row0 = rg * 16 + g;    // block rows row0 and row0 + 8
  const size_t bh = blockIdx.y;
  const int q0 = blockIdx.x * kWideRows;
  const bool async = std::is_same_v<T, TI> && vec != 0;

  const TI* qb = q + bh * sq * d;
  const TI* kb = k + bh * skv * d;
  const TI* vb = v + bh * skv * d;
  TI* ob = o + bh * sq * d;

  // A fragments of Q: the warp's 16 rows over its quarter, for the whole
  // kv loop (up to d = 512).
  uint32_t qf[kKSteps][4];
  auto load_qf = [&] {
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
  };
  // s += Q[rows, quarter]·K[:, quarter]ᵀ from the fragments in qf.
  auto partial_s = [&](float (&s)[kNTiles][4], const T* tK) {
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
  };

  if constexpr (!kChunked) {
    stage<T, TI>(sQ, stride, qb, q0, kWideRows, sq, 0, width, d, async);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    if (active) load_qf();
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
  if constexpr (!kChunked) {
    stage<T, TI>(sK, stride, kb, 0, kWideKv, skv, 0, width, d, async);
    stage<T, TI>(sV, stride, vb, 0, kWideKv, skv, 0, width, d, async);
    cp_async_commit();
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int buf = kChunked ? 0 : t & 1;
    const T* tV = sV + buf * tile_elems;
    float s[kNTiles][4];
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    }
    if constexpr (kChunked) {
      // S over all of d, one 512-column step at a time; V's chunk of the
      // block's output columns with the first step.
      for (int c0 = 0; c0 < d; c0 += kChunk) {
        // Every warp is done with the previous step's Q and K (and, at the
        // first step, with the previous tile's V and partial S).
        __syncthreads();
        stage<T, TI>(sQ, stride, qb, q0, kWideRows, sq, c0, width, d, async);
        stage<T, TI>(sK, stride, kb, t * kWideKv, kWideKv, skv, c0, width, d,
                     async);
        if (c0 == 0) {
          stage<T, TI>(sV, stride, vb, t * kWideKv, kWideKv, skv, col0,
                       width, d, async);
        }
        cp_async_commit();
        cp_async_wait_all();
        __syncthreads();
        if (c0 + quarter * kQuarter < d) {
          load_qf();
          partial_s(s, sK);
        }
      }
    } else {
      cp_async_wait_all();
      // [A] tile t has landed; every warp is done with tile t - 1 (its
      // buffer is free) and with Q's stage (the first time).
      __syncthreads();
      if (t + 1 < n_tiles) {
        const int nb = buf ^ 1;
        stage<T, TI>(sK + nb * tile_elems, stride, kb, (t + 1) * kWideKv,
                     kWideKv, skv, 0, width, d, async);
        stage<T, TI>(sV + nb * tile_elems, stride, vb, (t + 1) * kWideKv,
                     kWideKv, skv, 0, width, d, async);
        cp_async_commit();
      }
      // Partial S = Q[rows, quarter]·K[:, quarter]ᵀ, 16 x 32 per warp.
      if (active) partial_s(s, sK + buf * tile_elems);
    }
    if (kChunked || active) {
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
    const int c = col0 + quarter * kQuarter + dt * 8 + tq * 2;
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
  const bool chunked = d > kChunk;
  const int nq = chunked ? 4 : (d + kQuarter - 1) / kQuarter;
  const int stride = nq * kQuarter + kPad;
  const int smem = (kWideRows + 4 * kWideKv) * stride * (int)sizeof(T);
  // Q's stage takes the partial S, maxima and P at nq = 1, and each more
  // quarter adds more to the stage than to the partial S; K's second
  // buffer (kChunked, nq = 4) holds them as Q's stage does at nq = 4.
  static_assert(kWideRows * kSStride * 4 + 4 * kWideRows * 4 +
                        kWideRows * kPStride * 2 <=
                    kWideRows * (kQuarter + kPad) * 2 &&
                    kSStride * 4 <= kQuarter * 2 && kWideKv == kWideRows,
                "the partial S, maxima and P fit Q's stage (or K's buffer)");
  auto kernel = chunked ? flash_fwd_wide_kernel<T, TI, true>
                        : flash_fwd_wide_kernel<T, TI, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + kWideRows - 1) / kWideRows, batch_heads,
                  chunked ? (d + kChunk - 1) / kChunk : 1);
  kernel<<<grid, kWideThreads, smem, stream>>>(
      static_cast<const TI*>(q), static_cast<const TI*>(k),
      static_cast<const TI*>(v), static_cast<TI*>(o), sq, skv, d, nq,
      scale * kLog2e, vec);
  return (int)cudaGetLastError();
}

}  // namespace
#endif  // BUILD_PART == 0

// ---------------------------------------------------------------------------
// The Hopper path.

namespace {

constexpr int kSmRows = 64;    // q rows per block (one wgmma M)
constexpr int kSmKv = 32;      // kv rows per K or V tile
constexpr int kSmPitch = 128;  // swizzle span, bytes (64 columns a slab)
constexpr int kSmWidths = 3;   // DP = 256, 384, 512
constexpr int kSmThreads = 256;   // two consumer warpgroups
constexpr int kSmemMax = 232448;  // a block's shared memory on sm_90

using sm90::Geometry;

// Shared memory of one block, in bytes from a 1024-aligned base: Q's tile
// (later O's), the partials of S, the ring of kPairs K tiles and kPairs V
// tiles (as many as fit), the barriers. Rank 1 of a split leaves its merge
// state over the partials and the ring.
template <int DP>
struct WideLayout {
  using G = Geometry<kSmPitch, DP>;
  static constexpr int kQ = G::bytes(kSmRows);
  static constexpr int kTile = G::bytes(kSmKv);
  static constexpr int kX = kQ;
  static constexpr int kRing = kX + 2 * kSmRows * kSmKv * 4;
  static constexpr int kSlack = 1024 + 256;   // alignment, barriers
  static constexpr int kPairs = (kSmemMax - kSlack - kRing) / (2 * kTile);
  static constexpr int kBars = kRing + 2 * kPairs * kTile;
  static constexpr int kBytes = kBars + (1 + 2 * kPairs) * 8 + 1024;
  // Per consumer and thread: its O columns and (m, m, l, l), as float4s.
  static constexpr int kMergeF4 = DP / 16 + 1;
  static_assert(kPairs >= 2, "two K/V pairs in the ring");
  static_assert(kX + 2 * kMergeF4 * 128 * 16 <= kBars, "merge state");
  static_assert(kBytes <= kSmemMax, "shared memory");
};

template <typename T, int DP>
__global__ void __launch_bounds__(kSmThreads, 1)
    flash_fwd_wide_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                               const __grid_constant__ CUtensorMap tm_k,
                               const __grid_constant__ CUtensorMap tm_v,
                               const __grid_constant__ CUtensorMap tm_o,
                               int sq, int skv, float scale_log2, int split,
                               int whole) {
  constexpr int DH = DP / 2, BN = kSmKv;
  static_assert(DP % 128 == 0 && DP <= 512, "head width");
  using L = WideLayout<DP>;
  using G = Geometry<kSmPitch, DP>;
  constexpr int H = L::kPairs;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  // full[2·slot] K's, full[2·slot + 1] V's.
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full = q_full + 1;

  // Consumer c: O's columns [c·DH, (c + 1)·DH) for the block's 64 q rows.
  const int c = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  const int warp = t / 32;
  const int g = (t % 32) / 4;
  const int tq = t % 4;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kSmRows;
  // The kv split: cluster rank blockIdx.z takes tiles [t0, t1).
  const int rank = blockIdx.z;
  const int n_tiles = (skv + BN - 1) / BN;
  const int per = (n_tiles + split - 1) / split;
  const int t0 = rank * per;
  const int t1 = min(n_tiles, t0 + per);
  const bool loader = threadIdx.x == 0;

  // Tile j's K (v = 0) or V (v = 1): slot (j − t0) % H of its ring.
  auto tile = [&](int j, int v) {
    return smem + L::kRing + (2 * ((j - t0) % H) + v) * L::kTile;
  };
  auto load = [&](int j, int v) {
    uint64_t* bar = &full[2 * ((j - t0) % H) + v];
    sm90::mbar_expect_tx(bar, L::kTile);
    unsigned char* dst = tile(j, v);
    const CUtensorMap* map = v ? &tm_v : &tm_k;
    if (whole) {   // one box of every slab (d % 64 == 0)
      sm90::tma_load_4d(dst, map, bar, 0, j * BN, 0, bh);
      return;
    }
#pragma unroll
    for (int sl = 0; sl < G::kSlabs; ++sl) {
      sm90::tma_load_3d(dst + sl * BN * kSmPitch, map, bar,
                        sl * G::kSlabCols, j * BN, bh);
    }
  };
  auto wait_tile = [&](int j, int v) {
    sm90::mbar_wait(&full[2 * ((j - t0) % H) + v], ((j - t0) / H) & 1);
  };

  if (loader) {
    sm90::mbar_init(q_full, 1);
#pragma unroll
    for (int b = 0; b < 2 * H; ++b) sm90::mbar_init(&full[b], 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();
  if (loader) {
    sm90::prefetch_map(&tm_q);
    sm90::prefetch_map(&tm_k);
    sm90::prefetch_map(&tm_v);
    sm90::mbar_expect_tx(q_full, L::kQ);
#pragma unroll
    for (int sl = 0; sl < G::kSlabs; ++sl) {
      sm90::tma_load_3d(smem + sl * kSmRows * kSmPitch, &tm_q, q_full,
                        sl * G::kSlabCols, q0, bh);
    }
    for (int j = t0; j < t0 + H && j < t1; ++j) {
      load(j, 0);
      load(j, 1);
    }
  }

  float o[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
  // Rows g and g + 8 of the warp's 16: the running max of the raw scores
  // and the quad-partial row sum; the same in both consumers.
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  float sc[BN / 2];
  uint32_t pa[BN / 16][4];
  float alpha[2];
  float4* xs = reinterpret_cast<float4*>(smem + L::kX);

  // Partial S_j = Q[:, half]·K_j[:, half]ᵀ, 64 x BN (not waited for).
  auto issue_s = [&](int j) {
    wait_tile(j, 0);
    const unsigned char* sk = tile(j, 0);
    sm90::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks) {
      const int kk = c * (DH / 16) + ks;
      sm90::Wgmma<T, BN>::ss(sc, G::kmajor(smem + G::kstep(kk, kSmRows)),
                             G::kmajor(sk + G::kstep(kk, BN)), ks > 0);
    }
    sm90::wgmma_commit();
  };
  // O_half += P_j·V_j[:, half] (not waited for).
  auto issue_pv = [&](int j) {
    wait_tile(j, 1);
    const unsigned char* sv =
        tile(j, 1) + c * (DH / G::kSlabCols) * BN * kSmPitch;
    sm90::fence_regs(o);
    sm90::wgmma_fence();
#pragma unroll
    for (int kt = 0; kt < BN / 16; ++kt) {
      sm90::WgmmaRs<T, DH>::rs(o, pa[kt],
                               G::mnmajor(sv + kt * 16 * kSmPitch, BN), 1);
    }
    sm90::wgmma_commit();
  };
  // S = the two partials, added in one order in both consumers. Consumer c
  // writes its partial to its buffer once the other has read the last one
  // (barrier 2 + c), meets the other (barrier 1), adds the other's, and
  // frees the other's buffer (barrier 3 - c) unless this is its last tile.
  // Past barrier 1 of tile j both consumers are done with K_j (S_j has
  // completed in each) and with V_{j-2} (P_{j-2}·V_{j-2} completed in the
  // last tile), so the loader refills those slots with K_{j+H} and
  // V_{j+H-2}.
  auto exchange = [&](int j) {
    float4* mine = xs + c * (BN / 8) * 128;
    const float4* theirs = xs + (1 - c) * (BN / 8) * 128;
    if (j > t0) {
      if (c == 0) sm90::named_barrier<2>(256);
      else sm90::named_barrier<3>(256);
    }
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      mine[i * 128 + t] =
          make_float4(sc[4 * i], sc[4 * i + 1], sc[4 * i + 2], sc[4 * i + 3]);
    }
    sm90::named_barrier<1>(256);
    if (loader) {
      if (j + H < t1) load(j + H, 0);
      if (j >= t0 + 2 && j + H - 2 < t1) load(j + H - 2, 1);
    }
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const float4 x = theirs[i * 128 + t];
      sc[4 * i] += x.x;
      sc[4 * i + 1] += x.y;
      sc[4 * i + 2] += x.z;
      sc[4 * i + 3] += x.w;
    }
    if (j + 1 < t1) {
      if (c == 0) sm90::named_arrive<3>(256);
      else sm90::named_arrive<2>(256);
    }
  };
  // The online softmax of S_j in place (K1's): masks columns >= skv (only
  // the ragged last tile has any), updates m and l, leaves P =
  // exp2(s·c − m·c) in sc and the factor O must be scaled by in alpha.
  auto softmax = [&](int kv0) {
    if (kv0 + BN > skv) {
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (kv0 + 8 * i + 2 * tq + (e & 1) >= skv) sc[4 * i + e] = -INFINITY;
        }
      }
    }
    static_assert(BN == 32, "the max tree below covers 4 n-blocks");
    const float mx[2] = {fmaxf(fmaxf(sc[0], sc[1]), fmaxf(sc[4], sc[5])),
                         fmaxf(fmaxf(sc[2], sc[3]), fmaxf(sc[6], sc[7]))};
    const float my[2] = {
        fmaxf(fmaxf(sc[8], sc[9]), fmaxf(sc[12], sc[13])),
        fmaxf(fmaxf(sc[10], sc[11]), fmaxf(sc[14], sc[15]))};
    float mc[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float m = fmaxf(m_run[r], fmaxf(mx[r], my[r]));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      // Column kv0 is always valid, so m is finite; on the first tile m_run
      // is -inf and alpha 0. An unchanged max gives alpha 1 exactly.
      mc[r] = __fmul_rn(m, scale_log2);
      alpha[r] = sm90::ex2(__fmul_rn(m_run[r] - m, scale_log2));
      m_run[r] = m;
    }
    float rs[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p =
            sm90::ex2(__fmaf_rn(sc[4 * i + e], scale_log2, -mc[e >> 1]));
        sc[4 * i + e] = p;
        rs[e >> 1][i & 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[r] = l_run[r] * alpha[r] + (rs[r][0] + rs[r][1]);
    }
  };
  // O·alpha, skipped where every row of the warp kept its max (alpha is 1
  // exactly then), as it mostly does after the first tiles.
  auto rescale = [&] {
    if (!__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) return;
#pragma unroll
    for (int i = 0; i < DH / 8; ++i) {
      o[4 * i] *= alpha[0];
      o[4 * i + 1] *= alpha[0];
      o[4 * i + 2] *= alpha[1];
      o[4 * i + 3] *= alpha[1];
    }
  };
  // The accumulator n-blocks 2kt, 2kt + 1 of S are P's A fragment kt.
  auto to_p = [&] {
#pragma unroll
    for (int kt = 0; kt < BN / 16; ++kt) {
      pa[kt][0] = Ops<T>::pack(sc[8 * kt], sc[8 * kt + 1]);
      pa[kt][1] = Ops<T>::pack(sc[8 * kt + 2], sc[8 * kt + 3]);
      pa[kt][2] = Ops<T>::pack(sc[8 * kt + 4], sc[8 * kt + 5]);
      pa[kt][3] = Ops<T>::pack(sc[8 * kt + 6], sc[8 * kt + 7]);
    }
  };

  sm90::mbar_wait(q_full, 0);
  // S_t0, then per tile j: S_j and P_{j-1}·V_{j-1} issued together; the
  // exchange and softmax of S_j run while that product is on the tensor
  // cores; O is rescaled once it is done.
  issue_s(t0);
  sm90::wgmma_wait<0>();
  sm90::fence_regs(sc);
  exchange(t0);
  softmax(t0 * BN);
  to_p();
  for (int j = t0 + 1; j < t1; ++j) {
    issue_s(j);
    issue_pv(j - 1);
    sm90::wgmma_wait<1>();
    sm90::fence_regs(sc);
    exchange(j);
    softmax(j * BN);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(o);
    sm90::fence_regs(pa);
    rescale();
    to_p();
  }
  issue_pv(t1 - 1);
  sm90::wgmma_wait<0>();
  sm90::fence_regs(o);
  sm90::fence_regs(pa);

  float l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = l_run[r];
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if (split > 1) {
    // Rank 1 leaves (o, m, l) where thread t of consumer c in rank 0, which
    // holds the same rows and columns, reads it.
    float4* state =
        reinterpret_cast<float4*>(smem + L::kX) + c * L::kMergeF4 * 128;
    if (rank == 1) {
      __syncthreads();   // both consumers' products are done
#pragma unroll
      for (int i = 0; i < DH / 8; ++i) {
        state[i * 128 + t] =
            make_float4(o[4 * i], o[4 * i + 1], o[4 * i + 2], o[4 * i + 3]);
      }
      state[(DH / 8) * 128 + t] = make_float4(m_run[0], m_run[1], l[0], l[1]);
    }
    sm90::cluster_sync();
    if (rank == 0) {
      const float4 ml = sm90::ld_cluster(
          sm90::map_rank(state + (DH / 8) * 128 + t, 1));
      const float m1[2] = {ml.x, ml.y};
      const float l1[2] = {ml.z, ml.w};
      float a0[2], a1[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m = fmaxf(m_run[r], m1[r]);
        a0[r] = sm90::ex2(__fmul_rn(m_run[r] - m, scale_log2));
        a1[r] = sm90::ex2(__fmul_rn(m1[r] - m, scale_log2));
        l[r] = l[r] * a0[r] + l1[r] * a1[r];
      }
#pragma unroll
      for (int i = 0; i < DH / 8; ++i) {
        const float4 x =
            sm90::ld_cluster(sm90::map_rank(state + i * 128 + t, 1));
        o[4 * i] = o[4 * i] * a0[0] + x.x * a1[0];
        o[4 * i + 1] = o[4 * i + 1] * a0[0] + x.y * a1[0];
        o[4 * i + 2] = o[4 * i + 2] * a0[1] + x.z * a1[1];
        o[4 * i + 3] = o[4 * i + 3] * a0[1] + x.w * a1[1];
      }
    }
    sm90::cluster_sync();   // rank 1's shared memory is read
    if (rank != 0) return;
  }

  const float inv[2] = {1.f / l[0], 1.f / l[1]};
  // Every wgmma that read this consumer's half of Q has completed: O's
  // columns of that half go there, in the layout the O map's TMA store
  // reads.
#pragma unroll
  for (int i = 0; i < DH / 8; ++i) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int off =
          G::offset(warp * 16 + g + 8 * r, c * DH + 8 * i + 2 * tq, kSmRows);
      *reinterpret_cast<uint32_t*>(smem + off) = Ops<T>::pack(
          o[4 * i + 2 * r] * inv[r], o[4 * i + 2 * r + 1] * inv[r]);
    }
  }
  sm90::fence_proxy_async();
  if (c == 0) sm90::named_barrier<4>(128);
  else sm90::named_barrier<5>(128);
  if (t == 0) {
#pragma unroll
    for (int s = 0; s < DH / G::kSlabCols; ++s) {
      const int sl = c * (DH / G::kSlabCols) + s;
      sm90::tma_store_3d(&tm_o, smem + sl * kSmRows * kSmPitch,
                         sl * G::kSlabCols, q0, bh);
    }
    sm90::tma_store_commit_and_wait();
  }
}

template <typename T, int DP>
int launch_wide_sm90(const void* q, const void* k, const void* v, void* o,
                     int batch_heads, int sq, int skv, int d, float scale,
                     int split, cudaStream_t stream) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int kBox = Geometry<kSmPitch, DP>::kSlabCols;
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  // K/V tiles in one box each where d % 64 == 0, else slab by slab (so that
  // the columns past d are zero-filled).
  const int whole = d % 64 == 0;
  const bool kv_maps =
      whole ? sm90::encode_slabs_map(&tm_k, k, kBf16, batch_heads, skv, d,
                                     kSmKv) &&
                  sm90::encode_slabs_map(&tm_v, v, kBf16, batch_heads, skv,
                                         d, kSmKv)
            : sm90::encode_slab_map(&tm_k, k, kBf16, batch_heads, skv, d,
                                    kSmKv, kBox, kSmPitch) &&
                  sm90::encode_slab_map(&tm_v, v, kBf16, batch_heads, skv, d,
                                        kSmKv, kBox, kSmPitch);
  if (!kv_maps ||
      !sm90::encode_slab_map(&tm_q, q, kBf16, batch_heads, sq, d, kSmRows,
                             kBox, kSmPitch) ||
      !sm90::encode_slab_map(&tm_o, o, kBf16, batch_heads, sq, d, kSmRows,
                             kBox, kSmPitch)) {
    return (int)cudaErrorInvalidValue;
  }
  constexpr int smem = WideLayout<DP>::kBytes;
  auto kernel = flash_fwd_wide_sm90_kernel<T, DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               100);
  }
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = split;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((sq + kSmRows - 1) / kSmRows, batch_heads, split);
  cfg.blockDim = dim3(kSmThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, tm_q, tm_k, tm_v, tm_o, sq, skv,
                           scale * kLog2e, split, whole);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

using WideLauncher = int (*)(const void*, const void*, const void*, void*,
                             int, int, int, int, float, int, cudaStream_t);
namespace wide_sm90 {
// [dtype][DP / 128 - 2], filled when the library loads.
extern WideLauncher launchers[2][kSmWidths];
#if BUILD_PART == 0
WideLauncher launchers[2][kSmWidths] = {};
#endif
}  // namespace wide_sm90

namespace {

// bf16 in part 1, fp16 in part 2 (everything in part 0 of a one-part build).
template <int DT, int W>
void enter_wide_unit() {
  constexpr int part = BUILD_PARTS == 1 ? 0 : 1 + DT % (BUILD_PARTS - 1);
  if constexpr (part == BUILD_PART) {
    using T = std::conditional_t<DT == 0, __nv_bfloat16, __half>;
    wide_sm90::launchers[DT][W] = &launch_wide_sm90<T, 128 * (W + 2)>;
  }
}

template <int... W>
bool enter_wide_units(std::integer_sequence<int, W...>) {
  (enter_wide_unit<0, W>(), ...);
  (enter_wide_unit<1, W>(), ...);
  return true;
}

[[maybe_unused]] const bool kWideEntered =
    enter_wide_units(std::make_integer_sequence<int, kSmWidths>{});

}  // namespace

#if BUILD_PART == 0
extern "C" {

// The kept path. dtype: 0 bf16, 1 fp16, 2 fp32 (rounded to bf16 as staged,
// fp32 out). vec: 1 when d % 8 == 0 and every pointer is 16-byte aligned.
// Any d > 128. Returns a cudaError_t code; 0 when the launch was accepted.
int flash_attention_fwd_wide(const void* q, const void* k, const void* v,
                             void* o, int batch_heads, int sq, int skv, int d,
                             float scale, int dtype, int vec, void* stream) {
  if (batch_heads < 1 || batch_heads > 65535 || sq < 1 || skv < 1 ||
      d <= 128 || (d + kChunk - 1) / kChunk > 65535) {
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

// The Hopper path: dtype 0 bf16 or 1 fp16, 128 < d <= 512, d % 8 == 0,
// 16-byte aligned q, k, v, o; `split` 1 or 2 parts of the kv range (2 needs
// at least two 32-row kv tiles). Returns cudaErrorInvalidValue for anything
// else.
int flash_attention_fwd_wide_sm90(const void* q, const void* k,
                                  const void* v, void* o, int batch_heads,
                                  int sq, int skv, int d, float scale,
                                  int dtype, int split, void* stream) {
  if (batch_heads < 1 || batch_heads > 65535 || sq < 1 || skv < 1 ||
      d <= 128 || d > 512 || d % 8 != 0 || dtype < 0 || dtype > 1 ||
      split < 1 || split > 2 || split > (skv + kSmKv - 1) / kSmKv) {
    return (int)cudaErrorInvalidValue;
  }
  return wide_sm90::launchers[dtype][(d + 127) / 128 - 2](
      q, k, v, o, batch_heads, sq, skv, d, scale, split,
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
#endif  // BUILD_PART == 0
