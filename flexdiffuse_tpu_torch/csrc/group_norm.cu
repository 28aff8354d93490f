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
// Design (simple first, deterministic): the TPU kernel holds a whole batch
// row in VMEM; here each pass is cut into blocks that run in any order, in
// three launches.
// - gn_nhwc_stats_vec_kernel (C % 8 == 0; else the scalar
//   gn_nhwc_stats_kernel): one block per (pixel chunk, batch); each thread
//   walks an 8-channel octet down its lane of the chunk's pixels (coalesced
//   across the warp) keeping Welford moments, and the block writes
//   per-channel moments [B, S, C, 3].
// - gn_nhwc_finalize_kernel: one block per (batch, group) merges the
//   S·(C/G) partials with Chan's formula in a fixed tree order into mean and
//   rstd.
// - gn_nhwc_apply_kernel: one block per kChunk elements of a batch row holds
//   a_c, b_c of all C channels in shared memory and writes y.
// No atomics, and every split depends only on the shape, so the output is
// bit-identical from run to run. The moments never form E[x²] − E[x]² (the
// TPU kernel's formula), which cancels in fp32 over the VAE decode's groups
// of two million elements.
//
// What bounds it on this card: device memory. The function reads x once and
// writes y once, a few flops per element; the passes read x twice (the
// second read is served by the 50 MB L2 for the UNet's activations, not for
// the VAE's largest). 16-byte vector loads and stores are used when the row
// is a multiple of 8 elements and both pointers are 16-byte aligned (the
// stats pass: when C % 8 == 0 too); any other shape takes the scalar path.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 8;        // elements per thread per step
constexpr int kChunk = 4096;   // elements per block of the apply pass
constexpr int kStatsElems = 16384;  // channels-last stats: ~elements/block
// Channels-last apply keeps (a_c, b_c) of all C channels in 48 KB of shared
// memory.
constexpr int kMaxNhwcChannels = 6144;
constexpr unsigned kFull = 0xffffffffu;

struct Moments {
  float n, mean, m2;
};

// Chan et al.'s pairwise merge of two sets' (count, mean, M2).
__device__ __forceinline__ Moments merge(Moments a, Moments b) {
  if (b.n == 0.f) return a;
  if (a.n == 0.f) return b;
  const float n = a.n + b.n;
  const float wb = b.n / n;
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

// Thread 0 ends with the block's merged moments (fixed order).
__device__ __forceinline__ Moments block_merge(Moments m) {
  __shared__ Moments warp_acc[kWarps];
  m = warp_merge(m);
  if ((threadIdx.x & 31) == 0) warp_acc[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    m = warp_acc[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) m = merge(m, warp_acc[w]);
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

// Loads n <= kVec elements at p; with vec, a full vector in 16-byte loads.
template <typename T>
__device__ __forceinline__ void load_vec(float v[kVec], const T* p, int n,
                                         bool vec) {
  if (vec && n == kVec) {
    if constexpr (sizeof(T) == 2) {
      const uint4 raw = *reinterpret_cast<const uint4*>(p);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < kVec; ++j) v[j] = to_float(e[j]);
    } else {
      const float4 a = reinterpret_cast<const float4*>(p)[0];
      const float4 b = reinterpret_cast<const float4*>(p)[1];
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < kVec; ++j) v[j] = j < n ? to_float(p[j]) : 0.f;
}

template <typename T>
__device__ __forceinline__ void store_vec(T* p, const float v[kVec], int n,
                                          bool vec) {
  if (vec && n == kVec) {
    if constexpr (sizeof(T) == 2) {
      uint4 raw;
      T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int j = 0; j < kVec; ++j) e[j] = from_float<T>(v[j]);
      *reinterpret_cast<uint4*>(p) = raw;
    } else {
      reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
      reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    if (j < n) p[j] = from_float<T>(v[j]);
  }
}

__device__ __forceinline__ float load_param(const void* p, int dtype, int i) {
  if (dtype == 0) return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  if (dtype == 1) return __half2float(static_cast<const __half*>(p)[i]);
  return static_cast<const float*>(p)[i];
}

// Pixels per channels-last stats block: about kStatsElems elements.
inline int nhwc_pixels(int channels, int hw) {
  int pix = kStatsElems / channels;
  if (pix < 1) pix = 1;
  return pix < hw ? pix : hw;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    gn_nhwc_stats_kernel(const T* __restrict__ x, float* __restrict__ part,
                         int hw, int channels, int pix) {
  const int p0 = blockIdx.x * pix;
  const int p1 = min(p0 + pix, hw);
  const T* xb = x + (size_t)blockIdx.y * hw * channels;
  float* pb = part + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) *
                         channels * 3;
  for (int c = threadIdx.x; c < channels; c += kThreads) {
    float mean = 0.f, m2 = 0.f;
#pragma unroll 4
    for (int p = p0; p < p1; ++p) {
      const float v = to_float(xb[(size_t)p * channels + c]);
      const float d = v - mean;
      mean += d / (float)(p - p0 + 1);
      m2 += d * (v - mean);
    }
    pb[3 * c] = (float)(p1 - p0);
    pb[3 * c + 1] = mean;
    pb[3 * c + 2] = m2;
  }
}

// The same moments when C % 8 == 0: each thread owns one 8-channel octet
// (one 16-byte load per pixel when x is aligned) and one of `lanes` pixel
// lanes; the lanes' moments meet in shared memory and are merged in lane
// order. With more octets than threads, each thread takes several octets
// and there is one lane.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    gn_nhwc_stats_vec_kernel(const T* __restrict__ x, float* __restrict__ part,
                             int hw, int channels, int pix, int vec) {
  extern __shared__ float red[];  // [lanes][channels][2]: mean, M2
  const int n_oct = channels / kVec;
  const int lanes = n_oct >= kThreads ? 1 : kThreads / n_oct;
  const int p0 = blockIdx.x * pix;
  const int p1 = min(p0 + pix, hw);
  const T* xb = x + (size_t)blockIdx.y * hw * channels;
  float* pb = part + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) *
                         channels * 3;
  const int lane = lanes == 1 ? 0 : threadIdx.x / n_oct;
  const int first = lanes == 1 ? threadIdx.x : threadIdx.x % n_oct;
  const int step = lanes == 1 ? kThreads : n_oct;
  if (lane < lanes) {
    for (int o = first; o < n_oct; o += step) {
      float mean[kVec], m2[kVec];
#pragma unroll
      for (int j = 0; j < kVec; ++j) mean[j] = m2[j] = 0.f;
      int k = 0;
      for (int p = p0 + lane; p < p1; p += lanes) {
        float v[kVec];
        load_vec(v, xb + (size_t)p * channels + o * kVec, kVec, vec);
        const float inv = 1.f / (float)(++k);
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const float d = v[j] - mean[j];
          mean[j] += d * inv;
          m2[j] += d * (v[j] - mean[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const int c = o * kVec + j;
        if (lanes == 1) {
          pb[3 * c] = (float)k;
          pb[3 * c + 1] = mean[j];
          pb[3 * c + 2] = m2[j];
        } else {
          red[2 * (lane * channels + c)] = mean[j];
          red[2 * (lane * channels + c) + 1] = m2[j];
        }
      }
    }
  }
  if (lanes == 1) return;
  __syncthreads();
  for (int c = threadIdx.x; c < channels; c += kThreads) {
    Moments m{0.f, 0.f, 0.f};
    for (int l = 0; l < lanes; ++l) {
      const int n = (p1 - p0 - l + lanes - 1) / lanes;   // lane l's pixels
      if (n > 0) {
        m = merge(m, Moments{(float)n, red[2 * (l * channels + c)],
                             red[2 * (l * channels + c) + 1]});
      }
    }
    pb[3 * c] = m.n;
    pb[3 * c + 1] = m.mean;
    pb[3 * c + 2] = m.m2;
  }
}

__global__ void __launch_bounds__(kThreads)
    gn_nhwc_finalize_kernel(const float* __restrict__ part,
                            float* __restrict__ stat, int parts, int channels,
                            int groups, int cpg, float eps) {
  const int b = blockIdx.x / groups;
  const int g = blockIdx.x % groups;
  Moments m{0.f, 0.f, 0.f};
  for (int i = threadIdx.x; i < parts * cpg; i += kThreads) {
    const int s = i / cpg;
    const float* p = part + (((size_t)b * parts + s) * channels + g * cpg +
                             (i - s * cpg)) * 3;
    m = merge(m, Moments{p[0], p[1], p[2]});
  }
  m = block_merge(m);
  if (threadIdx.x == 0) {
    stat[2 * blockIdx.x] = m.mean;
    stat[2 * blockIdx.x + 1] = 1.f / sqrtf(m.m2 / m.n + eps);
  }
}

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads)
    gn_nhwc_apply_kernel(const Tin* __restrict__ x,
                         const void* __restrict__ gamma,
                         const void* __restrict__ beta, int w_dtype,
                         const float* __restrict__ stat, Tout* __restrict__ y,
                         int groups, int cpg, int channels, long long row_len,
                         int silu, int vec) {
  extern __shared__ float ab[];   // (a_c, b_c) pairs of all C channels
  const int b = blockIdx.y;
  for (int c = threadIdx.x; c < channels; c += kThreads) {
    const float* st = stat + 2 * (b * groups + c / cpg);
    const float a = st[1] * load_param(gamma, w_dtype, c);
    ab[2 * c] = a;
    ab[2 * c + 1] = load_param(beta, w_dtype, c) - st[0] * a;
  }
  __syncthreads();

  const long long start = (long long)blockIdx.x * kChunk;
  const long long end = min(start + kChunk, row_len);
  const Tin* xb = x + (size_t)b * row_len;
  Tout* yb = y + (size_t)b * row_len;
  for (long long e = start + (long long)threadIdx.x * kVec; e < end;
       e += (long long)kThreads * kVec) {
    const int n = (int)min((long long)kVec, end - e);
    float v[kVec];
    load_vec(v, xb + e, n, vec);
    int c = (int)(e % channels);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      if (j < n) {
        float t = v[j] * ab[2 * c] + ab[2 * c + 1];
        if (silu) t = t / (1.f + expf(-t));
        v[j] = t;
        if (++c == channels) c = 0;
      }
    }
    store_vec(yb + e, v, n, vec);
  }
}

struct Args {
  const void* x;
  const void* gamma;
  const void* beta;
  void* y;
  float* work;
  int batch, channels, groups, hw, w_dtype, silu, vec;
  float eps;
};

// Pixels per stats block, and the number of such blocks.
inline int nhwc_parts(int channels, int hw, int* pix) {
  *pix = nhwc_pixels(channels, hw);
  return (hw + *pix - 1) / *pix;
}

// Floats of fp32 workspace the passes need: the per-channel moments
// [B, S, C, 3] and then (mean, rstd) [B·G, 2].
long long workspace_floats(int batch, int channels, int groups, int hw) {
  int pix;
  const long long parts = nhwc_parts(channels, hw, &pix);
  return (long long)batch * parts * channels * 3 +
         (long long)batch * groups * 2;
}

template <typename Tin, typename Tout>
int launch_nhwc(const Args& a, cudaStream_t stream) {
  const int cpg = a.channels / a.groups;
  int pix;
  const int parts = nhwc_parts(a.channels, a.hw, &pix);
  float* stat = a.work + (size_t)a.batch * parts * a.channels * 3;
  const dim3 stats_grid(parts, a.batch);
  if (a.channels % kVec == 0) {
    const int n_oct = a.channels / kVec;
    const int lanes = n_oct >= kThreads ? 1 : kThreads / n_oct;
    const size_t smem = lanes == 1 ? 0 : lanes * a.channels * 2 * sizeof(float);
    gn_nhwc_stats_vec_kernel<Tin><<<stats_grid, kThreads, smem, stream>>>(
        static_cast<const Tin*>(a.x), a.work, a.hw, a.channels, pix, a.vec);
  } else {
    gn_nhwc_stats_kernel<Tin><<<stats_grid, kThreads, 0, stream>>>(
        static_cast<const Tin*>(a.x), a.work, a.hw, a.channels, pix);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gn_nhwc_finalize_kernel<<<a.batch * a.groups, kThreads, 0, stream>>>(
      a.work, stat, parts, a.channels, a.groups, cpg, a.eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long row_len = (long long)a.hw * a.channels;
  const dim3 grid((unsigned)((row_len + kChunk - 1) / kChunk), a.batch);
  gn_nhwc_apply_kernel<Tin, Tout><<<grid, kThreads,
                                    a.channels * 2 * sizeof(float), stream>>>(
      static_cast<const Tin*>(a.x), a.gamma, a.beta, a.w_dtype, stat,
      static_cast<Tout*>(a.y), a.groups, cpg, a.channels, row_len, a.silu,
      a.vec);
  return (int)cudaGetLastError();
}

template <typename Tin>
int launch_out(int out_dtype, const Args& a, cudaStream_t stream) {
  switch (out_dtype) {
    case 0: return launch_nhwc<Tin, __nv_bfloat16>(a, stream);
    case 1: return launch_nhwc<Tin, __half>(a, stream);
    case 2: return launch_nhwc<Tin, float>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

bool valid(int batch, int channels, int groups, int hw) {
  return batch >= 1 && channels >= 1 && groups >= 1 && hw >= 1 &&
         channels % groups == 0 && batch <= 65535 &&
         channels <= kMaxNhwcChannels;
}

}  // namespace

// Plain C entry points (bound with ctypes). Dtype codes: 0 = bf16, 1 =
// fp16, 2 = fp32. x and y channels-last [B, HW, C]; gamma, beta: [C].

// The fp32 workspace group_norm_fwd needs, in floats; -1 for a shape it
// does not take.
extern "C" long long group_norm_workspace(int batch, int channels,
                                          int groups, int hw) {
  if (!valid(batch, channels, groups, hw)) return -1;
  return workspace_floats(batch, channels, groups, hw);
}

// work: group_norm_workspace(...) floats. vec != 0 promises 16-byte aligned
// x and y and a row of HW·C elements that is a multiple of 8. Launches the
// passes on `stream` and returns cudaGetLastError() after them.
extern "C" int group_norm_fwd(const void* x, const void* gamma,
                              const void* beta, void* y, float* work,
                              int batch, int channels, int groups, int hw,
                              float eps, int silu, int in_dtype,
                              int out_dtype, int w_dtype, int vec,
                              void* stream) {
  if (!valid(batch, channels, groups, hw) || w_dtype < 0 || w_dtype > 2) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{x, gamma, beta, y, work, batch, channels, groups, hw,
               w_dtype, silu, vec, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (in_dtype) {
    case 0: return launch_out<__nv_bfloat16>(out_dtype, a, s);
    case 1: return launch_out<__half>(out_dtype, a, s);
    case 2: return launch_out<float>(out_dtype, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
