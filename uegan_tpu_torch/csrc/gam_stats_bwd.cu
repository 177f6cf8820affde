// Backward of the GAM statistics (kernel A, gam_stats.cu): dx from dmean and
// dstd, NHWC.
//
// JAX differentiates uegan_tpu/ops/norms.py:feature_mean_std with its own
// autodiff; the TPU package has no kernel for it (its train step runs the
// statistics in plain jnp).  The port's train forward runs kernel A, so
// its gradient is this kernel.  Per element, with the f32 mean and the f32
// var before the clamp that kernel A wrote in the same forward:
//   std = sqrt(max(var, 0) + eps)
//   f   = 1 where var > 0, 1/2 where var == 0, 0 where var < 0
//         (jnp.maximum's gradient: a tie splits it evenly)
//   dx  = dmean / hw + dstd * f * (x - mean) / (std * max(hw - 1, 1))
// in f32, dx written in x's dtype.  dmean and dstd come in x's dtype.
//
// What bounds it on the card: bytes.  It reads x once and writes dx once;
// the four (n, c) vectors are read again by every pixel, from L1 and L2.
// One thread per word of V channels of one pixel (16 bytes where C and the
// pointers allow it); the grid strides over the (N, H*W, C / V) words, so
// neighbouring threads touch neighbouring words.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    gam_stats_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dmean,
                         const T* __restrict__ dstd, const float* __restrict__ mean32,
                         const float* __restrict__ var32, T* __restrict__ dx, int64_t hw, int c,
                         int64_t words, float eps) {
  const int cw = c / V;  // words a pixel
  const float fhw = (float)hw;
  const float den = (float)(hw > 1 ? hw - 1 : 1);
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < words;
       i += (int64_t)gridDim.x * kThreads) {
    const int64_t pix = i / cw;  // over n * hw
    const int ch = (int)(i - pix * cw) * V;
    const int64_t at = (pix / hw) * c + ch;  // (n, ch) in the (n, c) vectors
    const Pack<T, V> xv = *reinterpret_cast<const Pack<T, V>*>(x + pix * c + ch);
    const Pack<T, V> dm = *reinterpret_cast<const Pack<T, V>*>(dmean + at);
    const Pack<T, V> ds = *reinterpret_cast<const Pack<T, V>*>(dstd + at);
    Pack<T, V> out;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float m = mean32[at + k], var = var32[at + k];
      const float s = sqrtf(fmaxf(var, 0.f) + eps);
      const float f = var > 0.f ? 1.f : (var == 0.f ? 0.5f : 0.f);
      const float a = to_f32(dm.v[k]) / fhw;
      const float b = to_f32(ds.v[k]) * f / (s * den);
      out.v[k] = from_f32<T>(a + b * (to_f32(xv.v[k]) - m));
    }
    *reinterpret_cast<Pack<T, V>*>(dx + pix * c + ch) = out;
  }
}

template <typename T, int V>
int launch(const void* x, const void* dmean, const void* dstd, const void* mean32,
           const void* var32, void* dx, int64_t n, int64_t hw, int64_t c, float eps,
           cudaStream_t stream) {
  const int64_t words = n * hw * (c / V);
  int sms = 132;
  int dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // enough blocks for 8 an SM, each thread then striding over the rest
  const int64_t need = (words + kThreads - 1) / kThreads;
  const int64_t most = (int64_t)sms * 8;
  const unsigned blocks = (unsigned)(need < most ? need : most);
  gam_stats_bwd_kernel<T, V><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dmean), static_cast<const T*>(dstd),
      static_cast<const float*>(mean32), static_cast<const float*>(var32), static_cast<T*>(dx),
      hw, (int)c, words, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  x, dx: (n, hw, c); dmean, dstd: (n, c)
// in x's dtype; mean32, var32: (n, c) float32 from uegan_gam_stats.  vec:
// channels a thread takes as one word (1, 2, 4, or 8 for bfloat16; C % vec
// == 0 and x, dx, dmean, dstd aligned to vec * itemsize, mean32 and var32 to
// 4 bytes).  Returns the cudaError_t of the launch (0 on success).
extern "C" int uegan_gam_stats_bwd(const void* x, const void* dmean, const void* dstd,
                                   const void* mean32, const void* var32, void* dx, int dtype,
                                   int64_t n, int64_t hw, int64_t c, int vec, float eps,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define UEGAN_GAM_BWD(T, V) launch<T, V>(x, dmean, dstd, mean32, var32, dx, n, hw, c, eps, s)
  if (dtype == 0) {
    switch (vec) {
      case 1: return UEGAN_GAM_BWD(float, 1);
      case 2: return UEGAN_GAM_BWD(float, 2);
      case 4: return UEGAN_GAM_BWD(float, 4);
    }
  } else if (dtype == 1) {
    switch (vec) {
      case 1: return UEGAN_GAM_BWD(__nv_bfloat16, 1);
      case 2: return UEGAN_GAM_BWD(__nv_bfloat16, 2);
      case 4: return UEGAN_GAM_BWD(__nv_bfloat16, 4);
      case 8: return UEGAN_GAM_BWD(__nv_bfloat16, 8);
    }
  }
#undef UEGAN_GAM_BWD
  return (int)cudaErrorInvalidValue;
}
