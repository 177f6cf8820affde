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
// writes its output once, with one add and two compares an element at most
// (C at (8, 512, 512, 3) f32 -> bf16: 25.2 MB in, 12.6 MB out, 11.3 us at
// 3.35 TB/s).
//
// C works on row pairs.  Output row i of image n is a fixed permutation of
// source rows 2i and 2i + 1: for each pixel pair wq, the 2C elements of row
// 2i at columns 2wq, 2wq + 1, then the same 2C elements of row 2i + 1.  Both
// source rows and the output row are contiguous, so a block takes `pairs`
// pixel pairs of one row pair (the whole row at the main shape, 6,144 bytes
// a source row and 6,144 an output row) and
//   1. copies the two source runs into shared memory as words of `in_word`
//      bytes, all of a thread's loads issued before its stores;
//   2. interleaves them in shared memory, one thread a run of 2C elements,
//      converting to the output dtype as it goes (a copy where the dtypes
//      are equal, so NaN payloads survive);
//   3. writes the output run back as words of `out_word` bytes.
// Row and column come from the block index and a thread's place in the run:
// no index division per element.  The caller picks the words: 16 bytes
// where every run and both pointers line up with 16 (the main shape), else
// the widest that does, down to one element (the ragged shapes and a
// misaligned input take that path in the same kernel).  Gathering single
// elements instead would move 64 bytes a warp transaction, and 2C-element
// runs (6 at C = 3) never line up with 16 bytes on their own.
//
// D keeps the flat grid: each thread takes kPer elements kThreads apart of
// the flat output, its loads issued before any store, and each element's two
// index divisions take a multiply-high and a shift (FastDiv: the card has
// no integer divide instruction).  Offsets are 32-bit: the wrappers refuse
// tensors of 2^31 elements or more.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 4;  // D: elements a thread; C: words a thread loads before storing

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

// words [0, n) of a to d[0, n) and of b to d[n, 2n), kPer loads a thread in
// flight before its stores
template <typename W>
__device__ __forceinline__ void copy_two(const void* a, const void* b, void* d, int n) {
  const W* wa = static_cast<const W*>(a);
  const W* wb = static_cast<const W*>(b);
  W* wd = static_cast<W*>(d);
  for (int base = 0; base < 2 * n; base += kThreads * kPer) {
    W v[kPer];
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int i = base + p * kThreads + threadIdx.x;
      if (i < 2 * n) v[p] = i < n ? wa[i] : wb[i - n];
    }
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int i = base + p * kThreads + threadIdx.x;
      if (i < 2 * n) wd[i] = v[p];
    }
  }
}

template <typename W>
__device__ __forceinline__ void copy_one(const void* s, void* d, int n) {
  const W* ws = static_cast<const W*>(s);
  W* wd = static_cast<W*>(d);
  for (int base = 0; base < n; base += kThreads * kPer) {
    W v[kPer];
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int i = base + p * kThreads + threadIdx.x;
      if (i < n) v[p] = ws[i];
    }
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int i = base + p * kThreads + threadIdx.x;
      if (i < n) wd[i] = v[p];
    }
  }
}

// grid (N * H/2 row pairs, ceil((W/2) / pairs) column blocks); dynamic
// shared memory: the two source runs (in_span bytes, a multiple of 16), then
// the output run
template <typename TI, typename TO>
__global__ void __launch_bounds__(kThreads)
    s2d_convert_kernel(const TI* __restrict__ x, TO* __restrict__ out, int64_t wc, int c2,
                       int pairs, int wq_total, int in_word, int out_word, int in_span) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int64_t rp = blockIdx.x;
  const int wq0 = blockIdx.y * pairs;
  const int k = min(pairs, wq_total - wq0);
  const int run = k * c2;  // elements the block takes of each source row
  TI* sin = reinterpret_cast<TI*>(smem);
  TO* sout = reinterpret_cast<TO*>(smem + in_span);
  const TI* a = x + rp * 2 * wc + (int64_t)wq0 * c2;  // row 2 rp; row 2 rp + 1 is wc on
  TO* dst = out + rp * 2 * wc + (int64_t)wq0 * 2 * c2;
  const int in_bytes = run * (int)sizeof(TI);
  switch (in_word) {
    case 16: copy_two<uint4>(a, a + wc, sin, in_bytes / 16); break;
    case 8: copy_two<uint2>(a, a + wc, sin, in_bytes / 8); break;
    case 4: copy_two<unsigned>(a, a + wc, sin, in_bytes / 4); break;
    default: copy_two<unsigned short>(a, a + wc, sin, in_bytes / 2); break;
  }
  __syncthreads();
  // output run j = 2 wq + pi is source row pi's run wq
  for (int j = threadIdx.x; j < 2 * k; j += kThreads) {
    const TI* s = sin + (j & 1) * run + (j >> 1) * c2;
    TO* d = sout + j * c2;
    for (int t = 0; t < c2; ++t) d[t] = convert<TI, TO>(s[t]);
  }
  __syncthreads();
  const int out_bytes = 2 * run * (int)sizeof(TO);
  switch (out_word) {
    case 16: copy_one<uint4>(sout, dst, out_bytes / 16); break;
    case 8: copy_one<uint2>(sout, dst, out_bytes / 8); break;
    case 4: copy_one<unsigned>(sout, dst, out_bytes / 4); break;
    default: copy_one<unsigned short>(sout, dst, out_bytes / 2); break;
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
               int64_t pairs, int in_word, int out_word, int64_t in_span, int64_t smem,
               cudaStream_t stream) {
  const int64_t wq_total = w / 2;
  const dim3 grid((unsigned)(n * h / 2), (unsigned)((wq_total + pairs - 1) / pairs));
  auto kernel = s2d_convert_kernel<TI, TO>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, kThreads, (size_t)smem, stream>>>(
      static_cast<const TI*>(x), static_cast<TO*>(out), w * c, (int)(2 * c), (int)pairs,
      (int)wq_total, in_word, out_word, (int)in_span);
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

// in_dtype, out_dtype: 0 = float32, 1 = bfloat16.  H and W are even, and the
// plan comes from the caller (ops/s2d_fuse.py:s2d_plan): `pairs` pixel pairs
// a block; in_word, out_word in bytes (2, 4, 8 or 16, at least the element
// size), dividing every run the block reads or writes and its address;
// in_span the two source runs' bytes rounded up to 16; smem the block's
// dynamic shared memory.  Returns the cudaError_t of the launch.
extern "C" int uegan_s2d_convert(const void* x, void* out, int in_dtype, int out_dtype,
                                 int64_t n, int64_t h, int64_t w, int64_t c, int64_t pairs,
                                 int in_word, int out_word, int64_t in_span, int64_t smem,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
#define UEGAN_S2D(TI, TO) \
  launch_s2d<TI, TO>(x, out, n, h, w, c, pairs, in_word, out_word, in_span, smem, s)
  if (in_dtype == 0 && out_dtype == 0) return UEGAN_S2D(float, float);
  if (in_dtype == 0 && out_dtype == 1) return UEGAN_S2D(float, bf16);
  if (in_dtype == 1 && out_dtype == 0) return UEGAN_S2D(bf16, float);
  if (in_dtype == 1 && out_dtype == 1) return UEGAN_S2D(bf16, bf16);
#undef UEGAN_S2D
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
