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
//
// The backward (upsample2x_bwd_kernel, B') is the adjoint of that map, written
// as a gather so that no two threads add to one element and nothing is
// atomic: input row i is a tap of output rows 2i-1, 2i, 2i+1 and 2i+2 only
// (2o uses o-1 and o, 2o+1 uses o and o+1), so
//   dx[i, j] = sum over r, s of w_r(i) * w_s(j) * dy[r, s]
// over those at most 4 rows and 4 columns, where w_r(i) is the weight the
// forward gives tap i in output row r (the sum of both taps' weights where a
// clamp makes them the same row; zero-weight taps are skipped, so rows and
// columns outside the map are never read).  The sums
// are f32, rows of four column taps first; dx is written in dy's dtype.  The
// same grid and word layout as the forward, over input rows.

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

// The output indices 2i-1 .. 2i+2 of a 2x axis of input size n, the only
// ones that can tap input index i, each with the weight it gives i (zero
// where it lies outside the axis or does not tap i).
__device__ __forceinline__ void adjoint_taps(int i, int n, int (&k)[4], float (&wk)[4]) {
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int o = 2 * i + s - 1;
    k[s] = o < 0 ? 0 : (o < 2 * n ? o : 2 * n - 1);
    wk[s] = 0.f;
    if (o >= 0 && o < 2 * n) {
      int a, b;
      float wa, wb;
      taps(o, n, a, b, wa, wb);
      wk[s] = (a == i ? wa : 0.f) + (b == i ? wb : 0.f);
    }
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    upsample2x_bwd_kernel(const T* __restrict__ dy, T* __restrict__ dx, int h, int w, int c) {
  const int cv = c / V;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= w * cv) return;
  const int iy = blockIdx.y;
  const int n = blockIdx.z;
  const int ix = i / cv;
  const int ch = (i - ix * cv) * V;

  int rk[4], ck[4];
  float rw[4], cw[4];
  adjoint_taps(iy, h, rk, rw);
  adjoint_taps(ix, w, ck, cw);

  using P = Pack<T, V>;
  const T* img = dy + (int64_t)n * 4 * h * w * c;
  float acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0.f;
  // fixed trip counts, so that the tap arrays stay in registers
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    if (rw[r] == 0.f) continue;
    float t[V];
#pragma unroll
    for (int j = 0; j < V; ++j) t[j] = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (cw[q] == 0.f) continue;
      const P v = *reinterpret_cast<const P*>(img + ((int64_t)rk[r] * 2 * w + ck[q]) * c + ch);
#pragma unroll
      for (int j = 0; j < V; ++j) t[j] += cw[q] * to_f32(v.v[j]);
    }
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] += rw[r] * t[j];
  }
  P res;
#pragma unroll
  for (int j = 0; j < V; ++j) res.v[j] = from_f32<T>(acc[j]);
  *reinterpret_cast<P*>(dx + (((int64_t)n * h + iy) * w + ix) * c + ch) = res;
}

template <typename T, int V>
int launch_bwd(const void* dy, void* dx, int64_t n, int64_t h, int64_t w, int64_t c,
               cudaStream_t stream) {
  const int64_t row_packs = w * (c / V);
  const dim3 grid((unsigned)((row_packs + kThreads - 1) / kThreads), (unsigned)h, (unsigned)n);
  upsample2x_bwd_kernel<T, V><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(dy),
                                                          static_cast<T*>(dx), (int)h, (int)w,
                                                          (int)c);
  return (int)cudaGetLastError();
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

// The backward: dy (n, 2h, 2w, c) -> dx (n, h, w, c), both in dtype; vec as
// for uegan_upsample2x, checked against dy's and dx's pointers.
extern "C" int uegan_upsample2x_bwd(const void* dy, void* dx, int dtype, int64_t n, int64_t h,
                                    int64_t w, int64_t c, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec == 1) return launch_bwd<float, 1>(dy, dx, n, h, w, c, s);
  if (dtype == 0 && vec == 4) return launch_bwd<float, 4>(dy, dx, n, h, w, c, s);
  if (dtype == 1 && vec == 1) return launch_bwd<__nv_bfloat16, 1>(dy, dx, n, h, w, c, s);
  if (dtype == 1 && vec == 8) return launch_bwd<__nv_bfloat16, 8>(dy, dx, n, h, w, c, s);
  return (int)cudaErrorInvalidValue;
}
