// The packed path's two space-to-depth boundary passes, NHWC.
//
// Replaces uegan_tpu/ops/pallas/s2d_fuse.py:s2d_convert (kernel C) and
// :residual_tail_d2s (kernel D).  Packed channel k = pi*2C + pj*C + c holds
// original pixel (2i + pi, 2j + pj), channel c.
//
//   C: out[n, i, j, k] = x[n, 2i + pi, 2j + pj, c], converted to the output
//      dtype (f32 -> bf16 rounds to nearest even, as torch's .to() does on
//      the card).
//   D: out[n, 2i + pi, 2j + pj, c] = clip(f32(res[n, i, j, k]) +
//      f32(xp[n, i, j, k]), -1, 1), rounded to the inputs' dtype.  The clip
//      is two compares, so a NaN sum stays NaN, as torch.clamp and jnp.clip
//      keep it; fminf/fmaxf would turn it into -1.
//
// What bounds them on the card: bytes.  Each reads its inputs once and
// writes its output once, with one add and two compares an element at most.
// The TPU kernels view the full-res tensor as (N, H/2, 2, W*C) so that the
// row interleave is an index on a size-2 dim of a VMEM block; here each
// thread computes its own source offsets instead.  The grid is 1-d over the
// flat output.  Each thread takes kPer elements kThreads apart: every store
// coalesces across the warp, and the thread's kPer loads are issued before
// any store, so they are in flight together.  With one element a thread,
// each thread had one 2- or 4-byte load in flight, too few bytes to cover
// the memory latency, and C ran at about 1 TB/s.  Each read sits in a
// contiguous run of 2C elements (one pj pair) shared with its neighbours.
// No 16-byte packs: at C = 3 a packed pixel is 12 elements and a run of 2C
// elements is 6, so neither lines up with 16 bytes.  Offsets are 32-bit:
// the wrappers refuse tensors of 2^31 elements or more.  Each element's
// two index divisions take a multiply-high and a shift (FastDiv): the card
// has no integer divide instruction, so a 32-bit division by a runtime
// value compiles to some 20 instructions, and at two per element their
// issue time comes near the memory time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 4;  // elements a thread

// n / d for 0 <= n < 2^31 by a multiply-high and a shift (Granlund and
// Montgomery's round-up method, as PyTorch's IntDivider): m and s are set
// on the host.
struct FastDiv {
  unsigned d, m, s;
  explicit FastDiv(unsigned divisor) : d(divisor), s(0) {
    while (s < 32 && (1ull << s) < divisor) ++s;
    m = (unsigned)(((1ull << 32) * ((1ull << s) - divisor)) / divisor + 1);
  }
  __device__ __forceinline__ unsigned div(unsigned n) const { return (__umulhi(n, m) + n) >> s; }
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
  return __float2bfloat16_rn(v);
}

template <typename TI, typename TO>
__device__ __forceinline__ TO convert(TI v) {
  if constexpr (std::is_same<TI, TO>::value) {
    return v;  // a copy keeps every bit, NaN payloads included
  } else {
    return from_f32<TO>(to_f32(v));
  }
}

// out (N, H/2, W/2, 4C); flat output index o = row * row_len + k, where
// row = n * H/2 + hq reads source rows 2 * row and 2 * row + 1
template <typename TI, typename TO>
__global__ void __launch_bounds__(kThreads)
    s2d_convert_kernel(const TI* __restrict__ x, TO* __restrict__ out, unsigned total,
                       unsigned w, unsigned c, FastDiv by_row, FastDiv by_pixel) {
  const unsigned c2 = 2 * c;
  const unsigned base = blockIdx.x * (kThreads * kPer) + threadIdx.x;
  TO v[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const unsigned o = base + i * kThreads;
    if (o < total) {
      const unsigned row = by_row.div(o);  // row_len = (W/2) * 4C
      const unsigned k = o - row * by_row.d;
      const unsigned wq = by_pixel.div(k);  // 4C
      const unsigned r = k - wq * 2 * c2;  // pi*2C + pj*C + c
      const unsigned pi = r >= c2 ? 1 : 0;
      // pj*C + c is contiguous in the source row
      v[i] = convert<TI, TO>(x[(2 * row + pi) * (w * c) + wq * c2 + (r - pi * c2)]);
    }
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const unsigned o = base + i * kThreads;
    if (o < total) out[o] = v[i];
  }
}

// out (N, 2Hp, 2Wp, C); flat output index o = orow * row_len + j, where
// orow = n * 2Hp + oy reads packed row orow / 2 at phase pi = orow & 1
template <typename T>
__global__ void __launch_bounds__(kThreads)
    residual_tail_d2s_kernel(const T* __restrict__ res, const T* __restrict__ xp,
                             T* __restrict__ out, unsigned total, unsigned wp, unsigned c,
                             FastDiv by_row, FastDiv by_pair) {
  const unsigned c2 = 2 * c;
  const unsigned base = blockIdx.x * (kThreads * kPer) + threadIdx.x;
  float t[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const unsigned o = base + i * kThreads;
    if (o < total) {
      const unsigned orow = by_row.div(o);  // row_len = Wp * 2C
      const unsigned j = o - orow * by_row.d;
      const unsigned wq = by_pair.div(j);  // 2C
      const unsigned src = ((orow >> 1) * wp + wq) * (2 * c2) + (orow & 1) * c2 + (j - wq * c2);
      t[i] = to_f32(res[src]) + to_f32(xp[src]);
    }
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const unsigned o = base + i * kThreads;
    if (o < total) {
      const float u = t[i] < -1.f ? -1.f : (t[i] > 1.f ? 1.f : t[i]);
      out[o] = from_f32<T>(u);
    }
  }
}

inline unsigned blocks_for(int64_t total) {
  return (unsigned)((total + kThreads * kPer - 1) / (kThreads * kPer));
}

template <typename TI, typename TO>
int launch_s2d(const void* x, void* out, int64_t n, int64_t h, int64_t w, int64_t c,
               cudaStream_t stream) {
  const int64_t total = n * h * w * c;
  if (total == 0) return 0;
  s2d_convert_kernel<TI, TO><<<blocks_for(total), kThreads, 0, stream>>>(
      static_cast<const TI*>(x), static_cast<TO*>(out), (unsigned)total, (unsigned)w,
      (unsigned)c, FastDiv((unsigned)(w / 2 * 4 * c)), FastDiv((unsigned)(4 * c)));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_tail(const void* res, const void* xp, void* out, int64_t n, int64_t hp, int64_t wp,
                int64_t c, cudaStream_t stream) {
  const int64_t total = n * hp * wp * 4 * c;
  if (total == 0) return 0;
  residual_tail_d2s_kernel<T><<<blocks_for(total), kThreads, 0, stream>>>(
      static_cast<const T*>(res), static_cast<const T*>(xp), static_cast<T*>(out),
      (unsigned)total, (unsigned)wp, (unsigned)c, FastDiv((unsigned)(wp * 2 * c)),
      FastDiv((unsigned)(2 * c)));
  return (int)cudaGetLastError();
}

}  // namespace

// in_dtype, out_dtype: 0 = float32, 1 = bfloat16.  H and W are even and
// N*H*W*C < 2^31 (the caller checks).  Returns the cudaError_t of the launch.
extern "C" int uegan_s2d_convert(const void* x, void* out, int in_dtype, int out_dtype,
                                 int64_t n, int64_t h, int64_t w, int64_t c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (in_dtype == 0 && out_dtype == 0) return launch_s2d<float, float>(x, out, n, h, w, c, s);
  if (in_dtype == 0 && out_dtype == 1) return launch_s2d<float, bf16>(x, out, n, h, w, c, s);
  if (in_dtype == 1 && out_dtype == 0) return launch_s2d<bf16, float>(x, out, n, h, w, c, s);
  if (in_dtype == 1 && out_dtype == 1) return launch_s2d<bf16, bf16>(x, out, n, h, w, c, s);
  return (int)cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = bfloat16, for res, xp and out alike; c is the
// original channel count (the packed tensors hold 4c).
extern "C" int uegan_residual_tail_d2s(const void* res, const void* xp, void* out, int dtype,
                                       int64_t n, int64_t hp, int64_t wp, int64_t c,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_tail<float>(res, xp, out, n, hp, wp, c, s);
  if (dtype == 1) return launch_tail<__nv_bfloat16>(res, xp, out, n, hp, wp, c, s);
  return (int)cudaErrorInvalidValue;
}
