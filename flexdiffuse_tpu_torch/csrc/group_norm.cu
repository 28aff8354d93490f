// Fused GroupNorm (+ affine, optional SiLU) for Hopper (sm_90a): K6.
//
// Replaces flexdiffuse_tpu/ops/group_norm.py::_gn_kernel (:41): per (batch,
// group) fp32 statistics, the per-channel affine folded into y = x·a_c + b_c,
// an optional SiLU, and the output written in its own dtype, so the cast that
// follows every GroupNorm of the UNet and the VAE is fused too.
//
// Layout: a logical NCHW [B, C, H, W] tensor stored channels-last, i.e.
// [B, HW, C] in memory (the TPU kernel's NHWC), y the same. It is the layout
// the port's UNet and VAE activations have on the card, since the models'
// NHWC → NCHW permute at entry propagates through cuDNN's convolutions. The
// TPU kernel's one-hot membership matmuls answer its vector unit and are not
// carried over.
//
// What bounds it: device memory, and at the UNet's sizes latency. The
// function reads x once and writes y once, a few flops per element; a UNet
// call moves 0.3–16 MB, so launch boundaries, a second read of x and
// dependent on-chip steps cost as much as the bytes.
//
// The TPU kernel holds a whole batch row in VMEM. Here the unit held on chip
// is a slab of whole groups; ops/group_norm.py::plan_group_norm chooses it
// and everything else below in Python before the launch, and the entry
// point only checks the plan. Two paths:
// - 'resident', one launch: a thread-block cluster of up to 16 blocks owns
//   one (batch, slab); each block copies its share of the slab's pixels into
//   shared memory once with 16-byte loads, so x is read from device memory
//   exactly once, and y is written once from shared memory. Statistics:
//   each thread sums d = x − K and d² over its own pixels as they arrive (K
//   its first value of the channel: shifted data), the block sums those
//   moments per group (shifted again by a group reference, sums only), each
//   block pushes its (mean, M2) into every rank's shared memory
//   (distributed shared memory), and after one cluster barrier every block
//   combines the ranks in a fixed order, so all blocks hold bit-identical
//   statistics. Every GroupNorm of the SD-1.x UNet at 512² and of the VAE
//   up to 128² takes it; the plan spreads small calls over 64 blocks and
//   keeps tiles within two blocks per SM.
// - 'stream', two launches, for slabs no cluster holds that way (the VAE's
//   256² and 512² activations) and for what 16-byte loads cannot take (C not
//   a multiple of the vector, a misaligned pointer: scalar loads): a stats
//   pass writes per-(block, group) moments (shifted sums per thread, Chan's
//   merge across lanes), and the apply pass's prologue combines its groups'
//   partials in a fixed order, then reads x again and writes y.
// Neither path forms E[x²] − E[x]² of the raw values (the TPU kernel's
// formula), which cancels in fp32 over the VAE's groups of two million
// elements; shifted sums cancel only as far as the shift lies from the
// mean, and each shift is a value or a mean of the group's own data.
// A thread owns one vector of channels (its a_c, b_c stay in registers) and
// walks its lane of pixels. The SiLU of a 16-bit output takes one MUFU
// operation (tanh). No atomics, and every split depends only on the shape,
// so y is bit-identical from run to run.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChannels = 6144;  // the stream apply's statistics: 48 KB
constexpr int kResidentUnroll = 8;  // 16-byte loads in flight per thread
constexpr int kStatsUnroll = 8;   // stream stats: raw loads in flight
constexpr int kApplyUnroll = 8;   // stream apply: raw loads in flight
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;   // resident launches' attribute grants

struct Moments {
  float n, mean, m2;
};

// Chan et al.'s pairwise merge of two sets' (count, mean, M2).
__device__ __forceinline__ Moments merge(Moments a, Moments b) {
  if (b.n == 0.f) return a;
  if (a.n == 0.f) return b;
  const float n = a.n + b.n;
  const float wb = __fdividef(b.n, n);
  const float delta = b.mean - a.mean;
  return Moments{n, a.mean + delta * wb, a.m2 + b.m2 + delta * delta * a.n * wb};
}

// Lane 0 ends with the warp's merged moments (fixed tree order).
__device__ __forceinline__ Moments warp_merge(Moments m) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const Moments o{__shfl_down_sync(kFull, m.n, off),
                    __shfl_down_sync(kFull, m.mean, off),
                    __shfl_down_sync(kFull, m.m2, off)};
    m = merge(m, o);
  }
  return m;
}

__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_float(float v) { return v; }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float v) {
  return __float2half_rn(v);
}
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}

// Elements of T in one 16-byte vector.
template <typename T>
constexpr int kVecOf = 16 / sizeof(T);

template <typename T>
__device__ __forceinline__ void unpack(float (&v)[kVecOf<T>], uint4 raw) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int j = 0; j < kVecOf<T>; ++j) v[j] = to_float(e[j]);
}

// W outputs at p, in one store of W·sizeof(T) bytes (8, 16 or 32; p is
// aligned to it) or one scalar.
template <typename T, int W>
__device__ __forceinline__ void store_w(T* p, const float (&v)[W]) {
  constexpr int bytes = W * (int)sizeof(T);
  if constexpr (W == 1) {
    p[0] = from_float<T>(v[0]);
  } else if constexpr (bytes == 8) {
    uint2 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int j = 0; j < W; ++j) e[j] = from_float<T>(v[j]);
    *reinterpret_cast<uint2*>(p) = raw;
  } else {
    static_assert(bytes == 16 || bytes == 32, "8, 16 or 32 bytes");
    uint4 raw[bytes / 16];
    T* e = reinterpret_cast<T*>(raw);
#pragma unroll
    for (int j = 0; j < W; ++j) e[j] = from_float<T>(v[j]);
#pragma unroll
    for (int k = 0; k < bytes / 16; ++k) {
      reinterpret_cast<uint4*>(p)[k] = raw[k];
    }
  }
}

__device__ __forceinline__ float load_param(const void* p, int dtype, int i) {
  if (dtype == 0) return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  if (dtype == 1) return __half2float(static_cast<const __half*>(p)[i]);
  return static_cast<const float*>(p)[i];
}

__device__ __forceinline__ float tanh_approx(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The affine and SiLU of one element. For a 16-bit output the SiLU is
// h + h·tanh(h), h = t/2: one MUFU operation (tanh.approx, relative error
// about 2^-11, below the output's rounding); for fp32, __expf and a fast
// divide (two; the SiLU of a very negative t divides by +inf: 0).
template <typename Tout>
__device__ __forceinline__ float affine_act(float v, float a, float b,
                                            int silu) {
  const float t = v * a + b;
  if (!silu) return t;
  if constexpr (sizeof(Tout) == 2) {
    const float h = 0.5f * t;
    return fmaf(h, tanh_approx(h), h);
  } else {
    return __fdividef(t, 1.f + __expf(-t));
  }
}

// The cluster barrier in two halves: arrive and wait, every thread of every
// block of the cluster. The first (relaxed) only says the block has
// started, so its shared memory may be written; the second orders the
// writes to other blocks' shared memory before their reads.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// out[g] = the block's (mean, M2) of each of the slab's groups g, from the
// lanes' per-channel moments red[lane][g·cpg + c] (lane l holds
// base + (l < extra) pixels). Sums only, in a fixed order: each moment
// (n, m, M2) enters as n·(m − K) and M2 + n·(m − K)², K the group's first
// moment (lane 0, its first channel), so the block's mean is K + Σ₁/N and
// its M2 is Σ₂ − Σ₁²/N, with K a mean of the group's own data and thus no
// cancellation beyond the spread of its channels' means. tpg threads per
// group (a power of two) each sum a strided share of the group's
// lanes·cpg moments, then a shuffle tree and, above 32 threads per group,
// the warps' sums in warp order. Every thread of the block calls it.
__device__ __forceinline__ void group_moments(const float2* red, int lanes,
                                              int base, int extra, int sc,
                                              int cpg, int slab,
                                              float2* out) {
  __shared__ float2 warp_part[kWarps];
  int tpg = 1;
  while (tpg * 2 * slab <= kThreads) tpg *= 2;
  const int width = min(tpg, 32);
  const int j = threadIdx.x & (tpg - 1);
  const int dl = tpg / cpg, dk = tpg - dl * cpg;
  const float n_blk = (float)(base * lanes + extra) * (float)cpg;
  for (int g0 = 0; g0 < slab; g0 += kThreads / tpg) {
    const int g = g0 + (int)threadIdx.x / tpg;
    const float2* at = red + min(g, slab - 1) * cpg;
    const float k0 = at[0].x;
    float s1 = 0.f, s2 = 0.f;
    if (g < slab) {
      int l = j / cpg, k = j - (j / cpg) * cpg;
      while (l < lanes) {
        const float2 v = at[l * sc + k];
        const float n = (float)(base + (l < extra));
        const float d = v.x - k0;
        s1 += n * d;
        s2 += v.y + n * d * d;
        k += dk;
        l += dl;
        if (k >= cpg) {
          k -= cpg;
          ++l;
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      if (off < width) {
        s1 += __shfl_down_sync(kFull, s1, off, width);
        s2 += __shfl_down_sync(kFull, s2, off, width);
      }
    }
    if (tpg > 32) {
      if ((threadIdx.x & 31) == 0) {
        warp_part[threadIdx.x >> 5] = make_float2(s1, s2);
      }
      __syncthreads();
      if (j == 0) {
        s1 = s2 = 0.f;
        for (int w = 0; w < tpg / 32; ++w) {
          const float2 p = warp_part[(threadIdx.x >> 5) + w];
          s1 += p.x;
          s2 += p.y;
        }
      }
      __syncthreads();
    }
    if (j == 0 && g < slab) {
      out[g] = n_blk > 0.f ? make_float2(k0 + s1 / n_blk, s2 - s1 * s1 / n_blk)
                           : make_float2(0.f, 0.f);
    }
  }
}

// Shared memory of the resident kernel in bytes: the tile [pixels][sc] in
// x's dtype, the lanes' per-channel (mean, M2) [lanes][sc], the block's
// per-group (mean, M2) [slab] and every rank's [cluster][slab]; later the
// group's (mean, rstd) in the block's slots. ops/group_norm.py::
// resident_smem computes the same.
long long resident_smem(int pixels, int sc, int elem, int slab,
                        int cluster) {
  const int units = sc / (16 / elem);
  const int lanes = kThreads / units;
  return (long long)pixels * sc * elem + 8LL * lanes * sc + 8LL * slab +
         8LL * cluster * slab;
}

// One (batch blockIdx.y, slab blockIdx.x / cluster) per cluster; the
// cluster's rank r holds pixels [r·pixels, (r+1)·pixels) of the slab's sc =
// slab·cpg channels. Thread t owns channel vector u = t % units of the slab
// and pixel lane t / units. Each thread takes the moments of its own pixels
// as they arrive (shifted sums), the block sums them per group (shifted
// again, group_moments), pushes the result into every rank's shared
// memory, and after one cluster barrier every block combines the ranks'
// moments in a fixed order: bit-identical statistics in every block.
template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads)
    gn_resident_kernel(const Tin* __restrict__ x,
                       const void* __restrict__ gamma,
                       const void* __restrict__ beta, int w_dtype,
                       Tout* __restrict__ y, int hw, int channels, int cpg,
                       int slab, int pixels, float eps, int silu) {
  constexpr int VE = kVecOf<Tin>;
  extern __shared__ __align__(16) unsigned char smem[];
  cluster_arrive_relaxed();
  cg::cluster_group cluster = cg::this_cluster();
  const int ranks = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int sc = slab * cpg;
  const int units = sc / VE;
  const int lanes = kThreads / units;
  const int u = threadIdx.x % units;
  const int lane = threadIdx.x / units;
  const bool active = lane < lanes;
  const int p0 = rank * pixels;
  const int n_pix = max(0, min(pixels, hw - p0));
  const int c0 = (blockIdx.x / ranks) * sc + u * VE;  // thread's channel
  uint4* tile = reinterpret_cast<uint4*>(smem);       // [pixels][units]
  float2* red = reinterpret_cast<float2*>(smem + (size_t)pixels * sc *
                                                     sizeof(Tin));
  float2* stat = red + lanes * sc;                    // [slab]
  float2* gather = stat + slab;                       // [ranks][slab]
  const size_t row = ((size_t)blockIdx.y * hw + p0) * channels + c0;
  const int base = n_pix / lanes, extra = n_pix - base * lanes;

  // The affine, loaded while x is in flight; each channel's group.
  float ga[VE], be[VE];
  int grp[VE];
#pragma unroll
  for (int j = 0; j < VE; ++j) {
    grp[j] = (u * VE + j) / cpg;
    ga[j] = active ? load_param(gamma, w_dtype, c0 + j) : 0.f;
    be[j] = active ? load_param(beta, w_dtype, c0 + j) : 0.f;
  }

  // x → shared memory, once; as it arrives, each channel's sums of
  // d = x − K and d², K the thread's first value of the channel (shifted
  // data: no cancellation beyond K's distance from the mean).
  float acc[VE], acc2[VE], shift[VE];
#pragma unroll
  for (int j = 0; j < VE; ++j) acc[j] = acc2[j] = shift[j] = 0.f;
  if (active) {
    const Tin* xb = x + row;
    for (int p = lane; p < n_pix; p += lanes * kResidentUnroll) {
      uint4 raw[kResidentUnroll];
#pragma unroll
      for (int k = 0; k < kResidentUnroll; ++k) {
        const int q = p + k * lanes;
        if (q < n_pix) {
          raw[k] = __ldg(reinterpret_cast<const uint4*>(xb + (size_t)q *
                                                                 channels));
        }
      }
#pragma unroll
      for (int k = 0; k < kResidentUnroll; ++k) {
        const int q = p + k * lanes;
        if (q < n_pix) {
          tile[q * units + u] = raw[k];
          float v[VE];
          unpack<Tin>(v, raw[k]);
          if (p == lane && k == 0) {
#pragma unroll
            for (int j = 0; j < VE; ++j) shift[j] = v[j];
          }
#pragma unroll
          for (int j = 0; j < VE; ++j) {
            const float d = v[j] - shift[j];
            acc[j] += d;
            acc2[j] += d * d;
          }
        }
      }
    }
    const int mine = base + (lane < extra);
    const float inv = mine ? 1.f / (float)mine : 0.f;
#pragma unroll
    for (int j = 0; j < VE; ++j) {
      red[lane * sc + u * VE + j] = make_float2(
          shift[j] + acc[j] * inv, acc2[j] - acc[j] * acc[j] * inv);
    }
  }
  __syncthreads();
  group_moments(red, lanes, base, extra, sc, cpg, slab, stat);
  __syncthreads();

  // The block's (mean, M2) of each group → slot [rank][g] of every rank.
  cluster_wait();   // every block has started: its shared memory is live
  for (int i = threadIdx.x; i < slab * ranks; i += kThreads) {
    const int g = i / ranks, dst = i - g * ranks;
    *cluster.map_shared_rank(gather + rank * slab + g, dst) = stat[g];
  }
  cluster_arrive();
  cluster_wait();

  // The ranks' moments combined in a fixed order, a warp per group, its
  // lanes over the ranks: the count-weighted mean, then
  // M2 = Σ M2_r + n_r·(mean_r − mean)².
  const int warp = threadIdx.x >> 5, wl = threadIdx.x & 31;
  for (int g = warp; g < slab; g += kWarps) {
    float n = 0.f;
    float2 p = make_float2(0.f, 0.f);
    for (int r = wl; r < ranks; r += 32) {    // ranks <= 16: one step
      n = (float)max(0, min(pixels, hw - r * pixels)) * cpg;
      p = gather[r * slab + g];
    }
    float total = n, sum = n * p.x;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      total += __shfl_xor_sync(kFull, total, off);
      sum += __shfl_xor_sync(kFull, sum, off);
    }
    const float mean = sum / total;
    const float d = p.x - mean;
    float m2 = p.y + n * d * d;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      m2 += __shfl_xor_sync(kFull, m2, off);
    }
    if (wl == 0) {
      stat[g] = make_float2(mean, 1.f / sqrtf(m2 / total + eps));
    }
  }
  __syncthreads();

  if (active) {
    float a[VE], b[VE];
#pragma unroll
    for (int j = 0; j < VE; ++j) {
      const float2 st = stat[grp[j]];
      a[j] = st.y * ga[j];
      b[j] = be[j] - st.x * a[j];
    }
    Tout* yb = y + row;
#pragma unroll 4
    for (int q = lane; q < n_pix; q += lanes) {
      float v[VE];
      unpack<Tin>(v, tile[q * units + u]);
#pragma unroll
      for (int j = 0; j < VE; ++j) {
        v[j] = affine_act<Tout>(v[j], a[j], b[j], silu);
      }
      store_w<Tout, VE>(yb + (size_t)q * channels, v);
    }
  }
}

// The stream kernels' thread layout: units of W channels (a 16-byte vector
// or one channel); with fewer units than threads, thread t owns unit
// t % units and pixel lane t / units, else each thread takes units t,
// t + kThreads, ... over one lane.
struct Lanes {
  int units, lanes, lane, first, step;
  __device__ Lanes(int channels, int w) {
    units = channels / w;
    const bool wide = units >= kThreads;
    lanes = wide ? 1 : kThreads / units;
    lane = wide ? 0 : threadIdx.x / units;
    first = wide ? threadIdx.x : threadIdx.x % units;
    step = wide ? kThreads : units;
  }
};

// W raw elements of T: one 16-byte vector, or one scalar.
template <typename T, int W>
using Raw = typename std::conditional<W == 1, T, uint4>::type;

// W elements at p. With kStream (the stats pass, which reads x once, in
// order): no L1 allocation, and the L2 fetches the 256-byte block around
// each sector. The apply pass reads without the hint: it takes first the
// chunks the stats pass left in the L2.
template <typename T, int W, bool kStream = false>
__device__ __forceinline__ Raw<T, W> load_raw(const T* p) {
  if constexpr (W == 1) {
    return p[0];
  } else if constexpr (!kStream) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  } else {
    uint4 v;
    asm volatile(
        "ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
        : "l"(p));
    return v;
  }
}

template <typename T, int W>
__device__ __forceinline__ void to_floats(float (&v)[W], Raw<T, W> raw) {
  if constexpr (W == 1) {
    v[0] = to_float(raw);
  } else {
    unpack<T>(v, raw);
  }
}

// Stats: block (blockIdx.x, batch blockIdx.y) covers `pixels` pixels of all
// C channels. Each thread sums d = x − K and d² per channel over its lane
// of pixels, K its first value of the channel (shifted data); the lanes'
// moments per group, merged with Chan's formula in a fixed order, go to
// mean[b][g][block] and m2[b][g][block] (work: the means, then the M2s;
// the counts follow from the shape).
template <typename T, int W>
__global__ void __launch_bounds__(kThreads)
    gn_stream_stats_kernel(const T* __restrict__ x, float* __restrict__ work,
                           int hw, int channels, int groups, int pixels) {
  extern __shared__ float red[];  // [lanes][channels][2]: mean, M2
  const Lanes L(channels, W);
  const int p0 = blockIdx.x * pixels;
  const int n_pix = min(pixels, hw - p0);
  const T* xb = x + ((size_t)blockIdx.y * hw + p0) * channels;
  if (L.lane < L.lanes) {
    for (int u = L.first; u < L.units; u += L.step) {
      float s1[W], s2[W], shift[W];
#pragma unroll
      for (int j = 0; j < W; ++j) s1[j] = s2[j] = shift[j] = 0.f;
      for (int p = L.lane; p < n_pix; p += L.lanes * kStatsUnroll) {
        Raw<T, W> raw[kStatsUnroll];
#pragma unroll
        for (int i = 0; i < kStatsUnroll; ++i) {
          const int q = p + i * L.lanes;
          if (q < n_pix) {
            raw[i] = load_raw<T, W, true>(xb + (size_t)q * channels + u * W);
          }
        }
#pragma unroll
        for (int i = 0; i < kStatsUnroll; ++i) {
          if (p + i * L.lanes < n_pix) {
            float v[W];
            to_floats<T, W>(v, raw[i]);
            if (p == L.lane && i == 0) {
#pragma unroll
              for (int j = 0; j < W; ++j) shift[j] = v[j];
            }
#pragma unroll
            for (int j = 0; j < W; ++j) {
              const float d = v[j] - shift[j];
              s1[j] += d;
              s2[j] += d * d;
            }
          }
        }
      }
      const int n = L.lane < n_pix ? (n_pix - L.lane + L.lanes - 1) / L.lanes
                                   : 0;
      const float inv = n ? 1.f / (float)n : 0.f;
#pragma unroll
      for (int j = 0; j < W; ++j) {
        const int c = u * W + j;
        red[2 * (L.lane * channels + c)] = shift[j] + s1[j] * inv;
        red[2 * (L.lane * channels + c) + 1] = s2[j] - s1[j] * s1[j] * inv;
      }
    }
  }
  __syncthreads();
  const int cpg = channels / groups;
  const int warp = threadIdx.x >> 5, wl = threadIdx.x & 31;
  const size_t plane = (size_t)gridDim.y * groups * gridDim.x;
  for (int g = warp; g < groups; g += kWarps) {
    Moments m{0.f, 0.f, 0.f};
    for (int i = wl; i < L.lanes * cpg; i += 32) {
      const int l = i / cpg;
      const int c = g * cpg + (i - l * cpg);
      const int n = l < n_pix ? (n_pix - l + L.lanes - 1) / L.lanes : 0;
      if (n > 0) {
        m = merge(m, Moments{(float)n, red[2 * (l * channels + c)],
                             red[2 * (l * channels + c) + 1]});
      }
    }
    m = warp_merge(m);
    if (wl == 0) {
      const size_t at = ((size_t)blockIdx.y * groups + g) * gridDim.x +
                        blockIdx.x;
      work[at] = m.mean;
      work[plane + at] = m.m2;
    }
  }
}

// Apply: the prologue combines the batch row's `parts` stats partials of
// every group in a fixed order into (mean, rstd): a team of threads per
// group, each over a strided share, sums n·mean, then M2 + n·(mean_k −
// mean)², each through a shuffle tree. Then y = x·a_c + b_c (+SiLU). Block
// i takes pixel chunk gridDim.x − 1 − i: the chunks the stats pass read
// last, which the L2 may still hold, first.
template <typename Tin, typename Tout, int W>
__global__ void __launch_bounds__(kThreads)
    gn_stream_apply_kernel(const Tin* __restrict__ x,
                           const void* __restrict__ gamma,
                           const void* __restrict__ beta, int w_dtype,
                           const float* __restrict__ work,
                           Tout* __restrict__ y, int hw, int channels,
                           int groups, int pixels, int parts,
                           int stats_pixels, float eps, int silu) {
  extern __shared__ float stat[];  // [groups][2]: mean, rstd
  const int cpg = channels / groups;
  int team = kThreads / groups;    // a power of two, at most 32
  team = team >= 32 ? 32 : team >= 16 ? 16 : team >= 8 ? 8 : team >= 4 ? 4
       : team >= 2 ? 2 : 1;
  const int teams = kThreads / team;
  const int j = threadIdx.x % team;
  const size_t plane = (size_t)gridDim.y * groups * parts;

  // The first batch of the thread's x, in flight during the prologue.
  const Lanes L(channels, W);
  const int chunk = gridDim.x - 1 - blockIdx.x;
  const int p0 = chunk * pixels;
  const int n_pix = min(pixels, hw - p0);
  const size_t row = ((size_t)blockIdx.y * hw + p0) * channels;
  Raw<Tin, W> raw[kApplyUnroll];
  if (L.lane < L.lanes) {
#pragma unroll
    for (int i = 0; i < kApplyUnroll; ++i) {
      const int q = L.lane + i * L.lanes;
      if (q < n_pix) {
        raw[i] = load_raw<Tin, W>(x + row + (size_t)q * channels +
                                  L.first * W);
      }
    }
  }

  for (int g0 = 0; g0 < groups; g0 += teams) {
    const int g = min(g0 + (int)threadIdx.x / team, groups - 1);
    const float* mp = work + ((size_t)blockIdx.y * groups + g) * parts;
    float total = 0.f, sum = 0.f;
#pragma unroll 4
    for (int k = j; k < parts; k += team) {
      const float n = (float)min(stats_pixels, hw - k * stats_pixels) * cpg;
      total += n;
      sum += n * mp[k];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      if (off < team) {
        total += __shfl_xor_sync(kFull, total, off, team);
        sum += __shfl_xor_sync(kFull, sum, off, team);
      }
    }
    const float mean = sum / total;
    float m2 = 0.f;
#pragma unroll 4
    for (int k = j; k < parts; k += team) {
      const float n = (float)min(stats_pixels, hw - k * stats_pixels) * cpg;
      const float d = mp[k] - mean;
      m2 += mp[plane + k] + n * d * d;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      if (off < team) m2 += __shfl_xor_sync(kFull, m2, off, team);
    }
    if (g0 + (int)threadIdx.x / team < groups && j == 0) {
      stat[2 * g] = mean;
      stat[2 * g + 1] = 1.f / sqrtf(m2 / total + eps);
    }
  }
  __syncthreads();

  if (L.lane >= L.lanes) return;
  bool loaded = true;   // the first batch is in raw
  for (int u = L.first; u < L.units; u += L.step) {
    float a[W], b[W];
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const int c = u * W + i;
      const int g = c / cpg;
      a[i] = stat[2 * g + 1] * load_param(gamma, w_dtype, c);
      b[i] = load_param(beta, w_dtype, c) - stat[2 * g] * a[i];
    }
    const Tin* xb = x + row + u * W;
    Tout* yb = y + row + u * W;
    for (int p = L.lane; p < n_pix; p += L.lanes * kApplyUnroll) {
      if (!loaded) {
#pragma unroll
        for (int i = 0; i < kApplyUnroll; ++i) {
          const int q = p + i * L.lanes;
          if (q < n_pix) raw[i] = load_raw<Tin, W>(xb + (size_t)q * channels);
        }
      }
      loaded = false;
#pragma unroll
      for (int i = 0; i < kApplyUnroll; ++i) {
        const int q = p + i * L.lanes;
        if (q < n_pix) {
          float v[W];
          to_floats<Tin, W>(v, raw[i]);
#pragma unroll
          for (int c = 0; c < W; ++c) {
            v[c] = affine_act<Tout>(v[c], a[c], b[c], silu);
          }
          store_w<Tout, W>(yb + (size_t)q * channels, v);
        }
      }
    }
  }
}

struct Args {
  const void* x;
  const void* gamma;
  const void* beta;
  void* y;
  float* work;
  int batch, channels, groups, hw, w_dtype, silu;
  float eps;
  int path, vec, slab, cluster, pixels, smem, grid_x, stats_pixels;
};

// The error of a call that failed, with the runtime's last-error state
// cleared, so that the next launch does not report it again.
int fail(cudaError_t err) {
  cudaGetLastError();
  return (int)err;
}

template <typename Tin, typename Tout>
int launch_resident(const Args& a, cudaStream_t stream) {
  auto kernel = gn_resident_kernel<Tin, Tout>;
  // Per instantiation and device (attributes are per device): the largest
  // shared memory granted so far (only ever raised, so a later, smaller
  // launch still fits) and whether clusters above 8 blocks are allowed. A
  // device past kMaxDevices is granted on every launch.
  static int smem_granted[kMaxDevices];
  static bool wide_clusters[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return fail(err);
  const bool known = dev < kMaxDevices;
  if (a.smem > 48 * 1024 && (!known || a.smem > smem_granted[dev])) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
    if (err != cudaSuccess) return fail(err);
    if (known) smem_granted[dev] = a.smem;
  }
  if (a.cluster > 8 && (!known || !wide_clusters[dev])) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return fail(err);
    if (known) wide_clusters[dev] = true;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.grid_x, a.batch);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = a.smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const Tin*>(a.x),
                           a.gamma, a.beta, a.w_dtype, static_cast<Tout*>(a.y),
                           a.hw, a.channels, a.channels / a.groups, a.slab,
                           a.pixels, a.eps, a.silu);
  if (err != cudaSuccess) return fail(err);
  err = cudaGetLastError();
  return err == cudaSuccess ? 0 : fail(err);
}

template <typename Tin, typename Tout, int W>
int launch_stream(const Args& a, cudaStream_t stream) {
  const int parts = (a.hw + a.stats_pixels - 1) / a.stats_pixels;
  const int units = a.channels / W;
  const int lanes = units >= kThreads ? 1 : kThreads / units;
  gn_stream_stats_kernel<Tin, W>
      <<<dim3(parts, a.batch), kThreads,
         (size_t)lanes * a.channels * 2 * sizeof(float), stream>>>(
          static_cast<const Tin*>(a.x), a.work, a.hw, a.channels, a.groups,
          a.stats_pixels);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return fail(err);
  gn_stream_apply_kernel<Tin, Tout, W>
      <<<dim3(a.grid_x, a.batch), kThreads,
         (size_t)a.groups * 2 * sizeof(float), stream>>>(
          static_cast<const Tin*>(a.x), a.gamma, a.beta, a.w_dtype, a.work,
          static_cast<Tout*>(a.y), a.hw, a.channels, a.groups, a.pixels,
          parts, a.stats_pixels, a.eps, a.silu);
  err = cudaGetLastError();
  return err == cudaSuccess ? 0 : fail(err);
}

template <typename Tin, typename Tout>
int launch_path(const Args& a, cudaStream_t stream) {
  if (a.path == 0) return launch_resident<Tin, Tout>(a, stream);
  return a.vec ? launch_stream<Tin, Tout, kVecOf<Tin>>(a, stream)
               : launch_stream<Tin, Tout, 1>(a, stream);
}

template <typename Tin>
int launch_out(int out_dtype, const Args& a, cudaStream_t stream) {
  switch (out_dtype) {
    case 0: return launch_path<Tin, __nv_bfloat16>(a, stream);
    case 1: return launch_path<Tin, __half>(a, stream);
    case 2: return launch_path<Tin, float>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The plan is consistent with the shape: it covers every (batch, group)
// and pixel, its vectors are whole, its shared memory is what the kernel
// lays out. Resource limits (cluster size, shared memory) are left to the
// CUDA runtime, which refuses the launch.
bool plan_ok(const Args& a, int elem) {
  if (a.batch < 1 || a.channels < 1 || a.groups < 1 || a.hw < 1 ||
      a.channels % a.groups || a.batch > 65535 ||
      a.channels > kMaxChannels || a.w_dtype < 0 || a.w_dtype > 2 ||
      a.pixels < 1 || a.grid_x < 1) {
    return false;
  }
  const int ve = 16 / elem;
  const int cpg = a.channels / a.groups;
  if (a.vec && a.channels % ve) return false;
  if (a.path == 0) {
    const int sc = a.slab * cpg;
    return a.vec && a.slab >= 1 && a.groups % a.slab == 0 && sc % ve == 0 &&
           sc / ve <= kThreads && a.cluster >= 1 &&
           (long long)a.pixels * a.cluster >= a.hw &&
           (long long)a.grid_x == (long long)a.cluster * (a.groups / a.slab) &&
           a.stats_pixels == 0 &&
           (long long)a.smem ==
               resident_smem(a.pixels, sc, elem, a.slab, a.cluster);
  }
  return a.path == 1 && a.cluster == 1 && a.slab == a.groups &&
         a.smem == 0 && a.work != nullptr && a.stats_pixels >= 1 &&
         a.grid_x == (a.hw + a.pixels - 1) / a.pixels;
}

int elem_size(int dtype) { return dtype == 2 ? 4 : 2; }

}  // namespace

// Plain C entry points (bound with ctypes). Dtype codes: 0 = bf16, 1 =
// fp16, 2 = fp32. x and y channels-last [B, HW, C]; gamma, beta: [C].

// The shape and the plan of a call, as ops/group_norm.py::launch packs
// them (one struct per plan, built once).
struct Shape {
  int batch, channels, groups, hw;
  int path, vec, slab, cluster, pixels, smem, grid_x, stats_pixels;
};

// Launches K6 on `stream` as the plan says (ops/group_norm.py::Plan): path
// 0 'resident' (one cluster launch; work unused, stats_pixels 0) or 1
// 'stream' (two launches: stats blocks of stats_pixels pixels, apply blocks
// of `pixels`; work: 2·batch·groups·⌈hw/stats_pixels⌉ floats). vec != 0
// promises 16-byte aligned x and y. Returns cudaErrorInvalidValue for a
// plan that does not fit the shape, else the launches' error (0:
// launched).
extern "C" int group_norm_fwd(const void* x, const void* gamma,
                              const void* beta, void* y, float* work,
                              const Shape* p, float eps, int silu,
                              int in_dtype, int out_dtype, int w_dtype,
                              void* stream) {
  if (in_dtype < 0 || in_dtype > 2) return (int)cudaErrorInvalidValue;
  const Args a{x, gamma, beta, y, work, p->batch, p->channels, p->groups,
               p->hw, w_dtype, silu, eps, p->path, p->vec, p->slab,
               p->cluster, p->pixels, p->smem, p->grid_x, p->stats_pixels};
  if (!plan_ok(a, elem_size(in_dtype))) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (in_dtype) {
    case 0: return launch_out<__nv_bfloat16>(out_dtype, a, s);
    case 1: return launch_out<__half>(out_dtype, a, s);
    default: return launch_out<float>(out_dtype, a, s);
  }
}
