// Reflect pad of a convolution's input, NHWC, from one or two channel parts.
//
// Replaces no TPU kernel.  The JAX package pads with jnp.pad(mode="reflect")
// (uegan_tpu/ops/padding.py:reflect_pad_2d) and leaves it to XLA, which fuses
// the pad into the convolution's input.  cuDNN takes no reflect pad, so on
// the card the padded map is a pass of its own, written before each
// reflect-padded conv (ops/conv.py:conv2d_reflect).  The decoder's convs read
// the channel concat of two maps (the upsampled stage and the GAM of the
// skip); the pad takes both parts and writes the concat padded, so the
// concat is never written on its own.
//
// Forward: out (N, H + 2p, W + 2p, C1 + C2) from a (N, H, W, C1) and b
// (N, H, W, C2), every map contiguous NHWC (NCHW tensors in channels_last
// memory).  Output pixel (r, c) copies source pixel (reflect(r - p, H),
// reflect(c - p, W)), channels 0 .. C1 - 1 from a and the rest from b.
// reflect() is numpy's mode="reflect" for any p: period 2(n - 1), the border
// not repeated, and n = 1 maps every index to 0.  The kernel copies bits, so
// it is bit-equal to F.pad(mode="reflect") of the concat in any dtype.
//
// Backward: dx, split into the same parts, from dy of the padded shape.  It
// is a gather, so no two threads write one element and nothing is atomic or
// zeroed first: dx[y, x] sums the dy positions whose source is (y, x).  The
// positions of one axis whose source is y are its taps: the centre y + p
// first, then the others in ascending order (for p < n and y not within p
// of the border, the centre alone).  The sum runs over the column taps, and
// within each over the row taps, so for the usual 2 x 2 it adds centre, row
// mirror, column mirror, corner, in f32, and rounds once to dy's dtype.
// ops/reflect_pad.py:plain_backward sums in the same order.
//
// What bounds it on the card: bytes.  The forward reads each source element
// once and writes each output element once (the six padded inputs of the
// 512 px B=16 packed forward: 704 MB read, 715 MB written, 0.42 ms at
// 3.35 TB/s); the backward reads dy once (plus the edge rows and columns a
// second time) and writes dx once.  Design: a block takes output rows (dx
// rows in the backward) in turn, grid-stride, and works out each row's
// source row (its row taps) once.  Its threads run along the row's W x C
// words, neighbouring threads on neighbouring addresses, in 16-byte words
// where C1, C2 and every pointer allow it (8, 4 or 2 bytes otherwise, in the
// same kernel: D's 3-channel bf16 input takes 2-byte words).  A thread
// carries its (column, word) position from one step to the next by adding
// the block's stride, with no division in the loop, and reflects the column
// only where it falls outside the map; interior columns are a straight copy.
// The forward loads kUnroll words before it stores them, so that each
// thread keeps that many loads in flight.  The backward sums word by word
// (an interior dx word has the centre alone); on the card an unrolled copy
// of the interior with the border's sums in a loop of their own ran no
// faster at the train step's shapes, whose small maps are bound by their
// border and launch tails (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int64_t kMaxGrid = 1 << 20;  // blocks; more rows are walked grid-stride

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

// numpy's reflect: the source index of padded index i + p, for i in
// [-p, n - 1 + p] and any p.
__device__ __forceinline__ int reflect(int i, int n) {
  if (i >= 0 && i < n) return i;
  if (n == 1) return 0;
  const int period = 2 * (n - 1);
  int m = i % period;
  if (m < 0) m += period;
  return m > n - 1 ? period - m : m;
}

// ceil(a / b) for b > 0 and a of either sign
__device__ __forceinline__ int ceil_div(int a, int b) {
  return a >= 0 ? (a + b - 1) / b : -(-a / b);
}

// Calls f(padded index) for each tap of source index y on an axis of n with
// pad p: the centre first, then the others in ascending order.  The others
// are the i = +-y (mod 2(n - 1)) in [-p, n - 1 + p]: walking up from the
// lowest, an i = y (mod 2(n - 1)) is followed 2(n - 1 - y) later by a
// mirror and a mirror 2y later by an i = y; where a step is 0 (y = n - 1, or
// y = 0, where the two kinds meet) the next is a period on.
template <typename F>
__device__ __forceinline__ void for_each_tap(int y, int n, int p, F f) {
  f(y + p);
  if (p < n && y > p && y < n - 1 - p) return;  // no other tap
  if (n == 1) {
    for (int i = -p; i <= p; ++i)
      if (i != 0) f(i + p);
    return;
  }
  const int period = 2 * (n - 1);
  int i = min(y + period * ceil_div(-p - y, period), -y + period * ceil_div(y - p, period));
  while (i <= n - 1 + p) {
    if (i != y) f(i + p);
    i += (i - y) % period == 0 ? (y == n - 1 ? period : 2 * (n - 1 - y)) : 2 * y;
  }
}

// W: one word of the copy (16, 8, 4 or 2 bytes).  aw, bw: the parts' words a
// pixel (bw = 0 for one part); rows = N * (H + 2p) output rows.
template <typename W>
__global__ void __launch_bounds__(kThreads)
    reflection_pad_nhwc_kernel(const W* __restrict__ a, const W* __restrict__ b,
                               W* __restrict__ out, int h, int w, int p, int aw, int bw,
                               int64_t rows) {
  const int hp = h + 2 * p, wp = w + 2 * p;
  const int cw = aw + bw;
  const int row_words = wp * cw;
  // one step of kThreads words moves a thread dq pixels and dr words on
  const int dq = kThreads / cw, dr = kThreads - dq * cw;
  const int ox0 = threadIdx.x / cw, k0 = threadIdx.x - ox0 * cw;
  for (int64_t row = blockIdx.x; row < rows; row += gridDim.x) {
    const int64_t img = row / hp;
    const int sy = reflect((int)(row - img * hp) - p, h);
    const W* arow = a + (img * h + sy) * (int64_t)w * aw;
    const W* brow = b + (img * h + sy) * (int64_t)w * bw;
    W* orow = out + row * (int64_t)row_words;
    int ox = ox0, k = k0;
    for (int j0 = threadIdx.x; j0 < row_words; j0 += kUnroll * kThreads) {
      W v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (j0 + u * kThreads < row_words) {
          const int sx = reflect(ox - p, w);
          v[u] = k < aw ? arow[sx * aw + k] : brow[sx * bw + (k - aw)];
        }
        k += dr;
        ox += dq;
        if (k >= cw) {
          k -= cw;
          ++ox;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (j0 + u * kThreads < row_words) orow[j0 + u * kThreads] = v[u];
    }
  }
}

// V elements a word; aw, bw: the parts' words a pixel; rows = N * H dx rows.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    reflection_pad_nhwc_bwd_kernel(const T* __restrict__ dy, T* __restrict__ da,
                                   T* __restrict__ db, int h, int w, int p, int aw, int bw,
                                   int64_t rows) {
  using P = Pack<T, V>;
  const int hp = h + 2 * p, wp = w + 2 * p;
  const int cw = aw + bw;
  const int row_words = w * cw;
  const int dq = kThreads / cw, dr = kThreads - dq * cw;
  const int x0 = threadIdx.x / cw, k0 = threadIdx.x - x0 * cw;
  const P* dyp = reinterpret_cast<const P*>(dy);
  for (int64_t row = blockIdx.x; row < rows; row += gridDim.x) {
    const int64_t img = row / h;
    const int y = (int)(row - img * h);
    const P* dyi = dyp + img * hp * (int64_t)wp * cw;
    P* arow = reinterpret_cast<P*>(da) + row * (int64_t)w * aw;
    P* brow = reinterpret_cast<P*>(db) + row * (int64_t)w * bw;
    int x = x0, k = k0;
    for (int j = threadIdx.x; j < row_words; j += kThreads) {
      float acc[V];
      bool first = true;
      for_each_tap(x, w, p, [&](int qc) {
        for_each_tap(y, h, p, [&](int qr) {
          const P t = dyi[((int64_t)qr * wp + qc) * cw + k];
#pragma unroll
          for (int e = 0; e < V; ++e) acc[e] = first ? to_f32(t.v[e]) : acc[e] + to_f32(t.v[e]);
          first = false;
        });
      });
      P o;
#pragma unroll
      for (int e = 0; e < V; ++e) o.v[e] = from_f32<T>(acc[e]);
      if (k < aw)
        arow[x * aw + k] = o;
      else
        brow[x * bw + (k - aw)] = o;
      k += dr;
      x += dq;
      if (k >= cw) {
        k -= cw;
        ++x;
      }
    }
  }
}

template <typename W>
int launch_pad(const void* a, const void* b, void* out, int64_t n, int64_t h, int64_t w,
               int64_t p, int64_t a_bytes, int64_t b_bytes, cudaStream_t s) {
  const int64_t rows = n * (h + 2 * p);
  const int grid = (int)(rows < kMaxGrid ? rows : kMaxGrid);
  reflection_pad_nhwc_kernel<W><<<grid, kThreads, 0, s>>>(
      static_cast<const W*>(a), static_cast<const W*>(b), static_cast<W*>(out), (int)h, (int)w,
      (int)p, (int)(a_bytes / sizeof(W)), (int)(b_bytes / sizeof(W)), rows);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int launch_pad_bwd(const void* dy, void* da, void* db, int64_t n, int64_t h, int64_t w,
                   int64_t p, int64_t c1, int64_t c2, cudaStream_t s) {
  const int64_t rows = n * h;
  const int grid = (int)(rows < kMaxGrid ? rows : kMaxGrid);
  reflection_pad_nhwc_bwd_kernel<T, V><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(dy), static_cast<T*>(da), static_cast<T*>(db), (int)h, (int)w,
      (int)p, (int)(c1 / V), (int)(c2 / V), rows);
  return (int)cudaGetLastError();
}

}  // namespace

// a, b: the parts (b may be null, with b_bytes 0); a_bytes, b_bytes: their
// bytes a pixel; word: the bytes a thread moves at once (16, 8, 4 or 2),
// which divides a_bytes, b_bytes and every pointer's address.
extern "C" int uegan_reflect_pad(const void* a, const void* b, void* out, int64_t n, int64_t h,
                                 int64_t w, int64_t p, int64_t a_bytes, int64_t b_bytes, int word,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b == nullptr) b = a;
  switch (word) {
    case 16: return launch_pad<uint4>(a, b, out, n, h, w, p, a_bytes, b_bytes, s);
    case 8: return launch_pad<uint2>(a, b, out, n, h, w, p, a_bytes, b_bytes, s);
    case 4: return launch_pad<uint32_t>(a, b, out, n, h, w, p, a_bytes, b_bytes, s);
    case 2: return launch_pad<uint16_t>(a, b, out, n, h, w, p, a_bytes, b_bytes, s);
  }
  return (int)cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = bfloat16, for dy, da and db alike; c1, c2: the
// parts' channels (db may be null, with c2 0); vec: channels a word.
extern "C" int uegan_reflect_pad_bwd(const void* dy, void* da, void* db, int dtype, int64_t n,
                                     int64_t h, int64_t w, int64_t p, int64_t c1, int64_t c2,
                                     int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (db == nullptr) db = da;
  using bf16 = __nv_bfloat16;
#define UEGAN_PAD_BWD(T, V) launch_pad_bwd<T, V>(dy, da, db, n, h, w, p, c1, c2, s)
  if (dtype == 0) {
    switch (vec) {
      case 1: return UEGAN_PAD_BWD(float, 1);
      case 2: return UEGAN_PAD_BWD(float, 2);
      case 4: return UEGAN_PAD_BWD(float, 4);
    }
  } else if (dtype == 1) {
    switch (vec) {
      case 1: return UEGAN_PAD_BWD(bf16, 1);
      case 2: return UEGAN_PAD_BWD(bf16, 2);
      case 4: return UEGAN_PAD_BWD(bf16, 4);
      case 8: return UEGAN_PAD_BWD(bf16, 8);
    }
  }
#undef UEGAN_PAD_BWD
  return (int)cudaErrorInvalidValue;
}
