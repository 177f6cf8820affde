// x2 bilinear upsample with align_corners=True, NHWC.
//
// Replaces uegan_tpu/ops/pallas/resize2x.py:upsample2x_ac_pallas.  For
// out = 2 * in with align_corners=True, output row 2o mixes input rows o-1
// and o, and output row 2o+1 mixes rows o and o+1, with weights linear in o:
//   out[2o]   = g * x[o-1] + (1 - g) * x[o],      g = o / (2H - 1)
//   out[2o+1] = (1 - f) * x[o] + f * x[o+1],      f = (H - 1 - o) / (2H - 1)
// and the same along W (rows first, then columns, as the TPU kernel does).
// The math is f32; the output is written in x's dtype.  The edge taps
// (x[-1] for o = 0, x[H] for o = H-1) carry exactly zero weight; they are
// clamped into range, because an out-of-range read is a fault and 0 * NaN is
// NaN.  H = 1 or W = 1 gives weights 0 and a copy of the single row.
//
// What bounds it on the card: bytes.  It reads x once and writes 4x as many
// bytes; the 2x2 taps that neighbouring threads share come from L1/L2.  No
// interpolation matrices are built.  Grid: (row chunks, output row, n).  The
// row's taps and weights are computed once per block; threads run along the
// contiguous (ox, c) axis with c fastest, V channels per thread (16-byte
// loads and stores where C and the pointers allow it), so a warp's loads
// and stores coalesce.

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

// Taps (a, b) and their weights (wa, wb) for output index k of a 2x axis of
// input size n.
__device__ __forceinline__ void taps(int k, int n, int& a, int& b, float& wa, float& wb) {
  const int o = k >> 1;
  const float den = (float)(2 * n - 1);
  if ((k & 1) == 0) {
    a = o > 0 ? o - 1 : 0;
    b = o;
    wa = (float)o / den;
    wb = 1.f - wa;
  } else {
    a = o;
    b = o + 1 < n ? o + 1 : n - 1;
    wb = (float)(n - 1 - o) / den;
    wa = 1.f - wb;
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    upsample2x_ac(const T* __restrict__ x, T* __restrict__ out, int h, int w, int c) {
  const int cv = c / V;  // packs per pixel
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= 2 * w * cv) return;
  const int oy = blockIdx.y;
  const int n = blockIdx.z;
  const int ox = i / cv;
  const int ch = (i - ox * cv) * V;

  int ya, yb, xa, xb;
  float wya, wyb, wxa, wxb;
  taps(oy, h, ya, yb, wya, wyb);
  taps(ox, w, xa, xb, wxa, wxb);

  using P = Pack<T, V>;
  const T* img = x + (int64_t)n * h * w * c;
  const P ra_a = *reinterpret_cast<const P*>(img + ((int64_t)ya * w + xa) * c + ch);
  const P rb_a = *reinterpret_cast<const P*>(img + ((int64_t)yb * w + xa) * c + ch);
  const P ra_b = *reinterpret_cast<const P*>(img + ((int64_t)ya * w + xb) * c + ch);
  const P rb_b = *reinterpret_cast<const P*>(img + ((int64_t)yb * w + xb) * c + ch);
  P res;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float ta = to_f32(ra_a.v[j]) * wya + to_f32(rb_a.v[j]) * wyb;  // column xa
    const float tb = to_f32(ra_b.v[j]) * wya + to_f32(rb_b.v[j]) * wyb;  // column xb
    res.v[j] = from_f32<T>(ta * wxa + tb * wxb);
  }
  *reinterpret_cast<P*>(out + (((int64_t)n * 2 * h + oy) * 2 * w + ox) * c + ch) = res;
}

template <typename T, int V>
int launch(const void* x, void* out, int64_t n, int64_t h, int64_t w, int64_t c,
           cudaStream_t stream) {
  const int64_t row_packs = 2 * w * (c / V);
  const dim3 grid((unsigned)((row_packs + kThreads - 1) / kThreads), (unsigned)(2 * h),
                  (unsigned)n);
  upsample2x_ac<T, V><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(x),
                                                      static_cast<T*>(out), (int)h, (int)w,
                                                      (int)c);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  vec: channels per thread, 1 or the
// 16-byte width (4 for float32, 8 for bfloat16); the caller checks that C and
// both pointers allow it.  Returns the cudaError_t of the launch.
extern "C" int uegan_upsample2x(const void* x, void* out, int dtype, int64_t n, int64_t h,
                                int64_t w, int64_t c, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec == 1) return launch<float, 1>(x, out, n, h, w, c, s);
  if (dtype == 0 && vec == 4) return launch<float, 4>(x, out, n, h, w, c, s);
  if (dtype == 1 && vec == 1) return launch<__nv_bfloat16, 1>(x, out, n, h, w, c, s);
  if (dtype == 1 && vec == 8) return launch<__nv_bfloat16, 8>(x, out, n, h, w, c, s);
  return (int)cudaErrorInvalidValue;
}
