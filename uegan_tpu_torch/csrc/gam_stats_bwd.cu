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
//   a   = dmean / hw
//   b   = dstd * f / (std * max(hw - 1, 1))
//   dx  = a + b * (x - mean)
// in f32, dx written in x's dtype.  dmean and dstd come in x's dtype.
//
// What bounds it on the card: bytes.  It reads x once and writes dx once
// (the train step's five calls at batch 20: 325 MB, 97 us at 3.35 TB/s).
// a, b and the mean belong to an (image, channel), so the kernel takes
// kernel A's partition (ops/gam_stats.py:split_plan): grid (splits, channel
// tiles, n), block (s, t, n) covers pixels [s * chunk, (s + 1) * chunk) of
// image n over a tile of `gt` groups of V channels, and each thread keeps
// one group for its whole loop.  So a thread works out its V channels' a,
// b and mean once, from one word of dmean and of dstd and V floats of the
// mean and var, in the same f32 operations in the same order as a
// per-element formula would, and its loop is one subtract and one
// multiply-add an element.  The loop makes kUnroll loads of one word each
// (16 bytes where C and the four x-dtype pointers allow it, else 8, 4 or 2)
// before any arithmetic, as A does, and writes dx with streaming stores
// (st.global.cs); offsets inside an image are 32-bit (the wrapper refuses
// maps of 2^31 elements or more).  The grid is at most one wave of
// kBlocksPerSM blocks an SM.  On the card this kernel was slower with A's
// prefetch.global.L2 of the next step's words, with plain stores, and with
// 12 or 16 loads a step (PERF.md).

#include "fixed_sum.cuh"

namespace {

constexpr int kUnroll = 8;       // pixels a thread loads before it works on them
constexpr int kBlocksPerSM = 2;  // as kernel A: the plan's grid is one wave of 2 an SM

// grid (splits, channel tiles, n); a tile is gt groups of V channels, and
// its threads run rows = kThreads / gt pixels side by side
template <typename T, int V>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    gam_stats_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dmean,
                         const T* __restrict__ dstd, const float* __restrict__ mean32,
                         const float* __restrict__ var32, T* __restrict__ dx, int hw, int c,
                         int gt, int chunk, float eps) {
  using P = Pack<T, V>;
  const int split = blockIdx.x, tile = blockIdx.y, n = blockIdx.z;
  const int rows = kThreads / gt;
  const int g = threadIdx.x % gt, r = threadIdx.x / gt;
  const int ch = (tile * gt + g) * V;
  if (r >= rows || ch >= c) return;  // no barrier below

  // the thread's channels' coefficients, once
  const int at = n * c + ch;  // (n, ch) in the (n, c) vectors
  const P dm = *reinterpret_cast<const P*>(dmean + at);
  const P ds = *reinterpret_cast<const P*>(dstd + at);
  const float fhw = (float)hw;
  const float den = (float)(hw > 1 ? hw - 1 : 1);
  float a[V], b[V], m[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const float var = var32[at + k];
    m[k] = mean32[at + k];
    const float s = sqrtf(fmaxf(var, 0.f) + eps);
    const float f = var > 0.f ? 1.f : (var == 0.f ? 0.5f : 0.f);
    a[k] = to_f32(dm.v[k]) / fhw;
    b[k] = to_f32(ds.v[k]) * f / (s * den);
  }

  const int p0 = split * chunk;
  const int p1 = min(p0 + chunk, hw);
  const int64_t base = (int64_t)n * hw * c + ch;
  const T* xs = x + base;
  T* out = dx + base;
  for (int p = p0 + r; p < p1; p += rows * kUnroll) {
    P v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int q = p + u * rows;
      if (q < p1) v[u] = load_once(reinterpret_cast<const P*>(xs + q * c));
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int q = p + u * rows;
      if (q < p1) {
        P o;
#pragma unroll
        for (int k = 0; k < V; ++k) o.v[k] = from_f32<T>(a[k] + b[k] * (to_f32(v[u].v[k]) - m[k]));
        store_once(reinterpret_cast<P*>(out + q * c), o);
      }
    }
  }
}

template <typename T, int V>
int launch(const void* x, const void* dmean, const void* dstd, const void* mean32,
           const void* var32, void* dx, int64_t n, int64_t hw, int64_t c, int64_t gt,
           int64_t splits, int64_t chunk, float eps, cudaStream_t stream) {
  if (gt < 1 || gt > kThreads || n > 65535 || n * hw * c >= ((int64_t)1 << 31))
    return (int)cudaErrorInvalidValue;
  const int64_t tiles = (c / V + gt - 1) / gt;
  const dim3 grid((unsigned)splits, (unsigned)tiles, (unsigned)n);
  gam_stats_bwd_kernel<T, V><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dmean), static_cast<const T*>(dstd),
      static_cast<const float*>(mean32), static_cast<const float*>(var32), static_cast<T*>(dx),
      (int)hw, (int)c, (int)gt, (int)chunk, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  x, dx: (n, hw, c); dmean, dstd: (n, c)
// in x's dtype; mean32, var32: (n, c) float32 from uegan_gam_stats.  vec,
// groups, splits, chunk: kernel A's plan (ops/gam_stats.py:split_plan) with
// vec checked against x, dx, dmean and dstd (C % vec == 0, each aligned to
// vec * itemsize); mean32 and var32 aligned to 4 bytes.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int uegan_gam_stats_bwd(const void* x, const void* dmean, const void* dstd,
                                   const void* mean32, const void* var32, void* dx, int dtype,
                                   int64_t n, int64_t hw, int64_t c, int vec, int64_t groups,
                                   int64_t splits, int64_t chunk, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define UEGAN_GAM_BWD(T, V) \
  launch<T, V>(x, dmean, dstd, mean32, var32, dx, n, hw, c, groups, splits, chunk, eps, s)
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
