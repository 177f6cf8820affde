// The body that kernels E (packed_conv_int8.cu) and F (packed_conv.cu)
// share: a stride-1 SxS convolution of an NHWC map as an implicit GEMM,
// with the epilogue applied to each sum before the single store.
//
//   out[n, l, w, o] = epi(sum_{si, sj, c} x[n, l + si - s0, w + sj - s0, c]
//                                          * k[o, si, sj, c])
//
// with zero padding on both axes (rows and columns outside the map read 0).
// The TPU kernels zero-pad the rows and wrap the columns, so their output
// columns [0, s0) and [W - s1, W) are unspecified and the callers overwrite
// them; here those columns hold the zero-padded conv, and every column
// equals the plain PyTorch versions.
//
// GEMM view: M = N*L*W output pixels, N = Cout, K = S*S*Cin.  A K index is
// a "word": 4 int8 channels packed in one 32-bit register for E (summed by
// __dp4a), one channel converted to f32 for F (summed by fmaf).  The
// kernel's weights come from the wrapper as (Cout, S, S, Cw) words, Cw the
// channels of one tap in words (for int8 Cin is zero-padded to a multiple
// of 4), so each tap starts on a word.
//
// A block computes a 64-pixel x 64-channel tile; its 256 threads each hold
// 4 x 4 sums.  Each step stages 8 words of K for the tile's pixels and
// channels in shared memory, then every thread reads 4 pixels' and 4
// channels' words as one 16-byte load each and does 16 multiply-adds per
// word.  Each staging thread loads one word of two pixels and of two
// channels; 8 neighbouring threads read 8 neighbouring words of one pixel.
// The thread's place in K (tap row, tap column, word) is carried from step
// to step, so no index division runs inside the loop.  F sums each step's 8
// products apart and adds that to the running sum: the rounding error of a
// K = 2304 sum then grows with K / 8 additions to a large sum, not with K.
//
// What bounds the kernels on the card: E at its 1x1 main-path site moves
// far more bytes than it does operations (bytes); at the 3x3 sites and for
// F the multiply-adds bound it.  This first form does them on the CUDA
// cores (__dp4a, fmaf), not the tensor cores, so it runs well under the
// card's int8 and bf16 rates; a tensor-core (wgmma) form is later work.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace packed_conv {

constexpr int kBM = 64;        // output pixels a block
constexpr int kBN = 64;        // output channels a block
constexpr int kBK = 8;         // words of K a step
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 sums each
constexpr int kPadA = 4;       // shared row padding: staging stores hit 32 banks

struct Geometry {
  int n, l, w;   // input (and output) map
  int cin;       // channels of x
  int cout;      // output channels
  int S, s0;     // window and lead pad
  int cw;        // words of one tap
  int kw;        // S * S * cw
  int m;         // n * l * w
};

// Element traits: how a word of K is loaded and summed.
template <typename T>
struct Elem;

template <>
struct Elem<int8_t> {
  using Word = int;
  using Acc = int;
  static constexpr int kPer = 4;
  static constexpr bool kStepSums = false;  // int32 sums are exact
  // 4 channels starting at c (c a multiple of 4) of one pixel's row; the
  // channels at or past cin read 0.  vec: cin % 4 == 0 and the row aligned.
  __device__ __forceinline__ static Word load(const int8_t* row, int c, int cin, bool vec) {
    if (vec) return *reinterpret_cast<const int*>(row + c);
    unsigned v = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (c + i < cin) v |= (unsigned)(uint8_t)row[c + i] << (8 * i);
    return (int)v;
  }
  __device__ __forceinline__ static Acc mac(Acc acc, Word a, Word b) { return __dp4a(a, b, acc); }
  __device__ __forceinline__ static float to_f32(Acc a) { return __int2float_rn(a); }
};

template <>
struct Elem<float> {
  using Word = float;
  using Acc = float;
  static constexpr int kPer = 1;
  static constexpr bool kStepSums = true;
  __device__ __forceinline__ static Word load(const float* row, int c, int, bool) { return row[c]; }
  __device__ __forceinline__ static Acc mac(Acc acc, Word a, Word b) { return fmaf(a, b, acc); }
  __device__ __forceinline__ static float to_f32(Acc a) { return a; }
};

template <>
struct Elem<__nv_bfloat16> {
  using Word = float;  // converted on load: a bf16 product is exact in f32
  using Acc = float;
  static constexpr int kPer = 1;
  static constexpr bool kStepSums = true;
  __device__ __forceinline__ static Word load(const __nv_bfloat16* row, int c, int, bool) {
    return __bfloat162float(row[c]);
  }
  __device__ __forceinline__ static Acc mac(Acc acc, Word a, Word b) { return fmaf(a, b, acc); }
  __device__ __forceinline__ static float to_f32(Acc a) { return a; }
};

// Four words of shared memory (16-byte aligned) in one 16-byte load.
__device__ __forceinline__ void load4(const int* p, int (&o)[4]) {
  const int4 v = *reinterpret_cast<const int4*>(p);
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}
__device__ __forceinline__ void load4(const float* p, float (&o)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}

// Move (si, sj, word) on by `step` words of K.
__device__ __forceinline__ void advance(int& si, int& sj, int& cw, int step, const Geometry& g) {
  cw += step;
  while (cw >= g.cw) {
    cw -= g.cw;
    if (++sj == g.S) {
      sj = 0;
      ++si;
    }
  }
}

// Epi: a functor called as epi(m, o, sum_as_f32) once for every output
// pixel m < g.m and channel o < g.cout.
template <typename T, typename Epi>
__global__ void __launch_bounds__(kThreads)
    conv_kernel(const T* __restrict__ x, const typename Elem<T>::Word* __restrict__ wts,
                Geometry g, bool vec, Epi epi) {
  using E = Elem<T>;
  using Word = typename E::Word;
  using Acc = typename E::Acc;
  __shared__ __align__(16) Word As[kBK][kBM + kPadA];
  __shared__ __align__(16) Word Bs[kBK][kBN + kPadA];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;  // sums: pixels ty*4.., channels tx*4..
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int lw = tid % kBK, lr = tid / kBK;  // staging: word lw of rows lr, lr + 32

  // the two staged pixels' coordinates
  int pn[2], pl[2], pw[2];
  bool pok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + lr + 32 * h;
    pok[h] = m < g.m;
    const int mm = pok[h] ? m : 0;
    pw[h] = mm % g.w;
    const int t = mm / g.w;
    pl[h] = t % g.l;
    pn[h] = t / g.l;
  }
  int si = 0, sj = 0, cw = 0;
  advance(si, sj, cw, lw, g);

  Acc acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = Acc(0);

  for (int k0 = 0; k0 < g.kw; k0 += kBK) {
    const bool kok = k0 + lw < g.kw;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      Word a = Word(0);
      const int li = pl[h] + si - g.s0, wi = pw[h] + sj - g.s0;
      if (kok && pok[h] && li >= 0 && li < g.l && wi >= 0 && wi < g.w) {
        const T* row = x + ((size_t)(pn[h] * g.l + li) * g.w + wi) * g.cin;
        a = E::load(row, cw * E::kPer, g.cin, vec);
      }
      As[lw][lr + 32 * h] = a;
      const int o = n0 + lr + 32 * h;
      Word b = Word(0);
      if (kok && o < g.cout) b = wts[(size_t)o * g.kw + k0 + lw];
      Bs[lw][lr + 32 * h] = b;
    }
    __syncthreads();
    Acc part[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[i][j] = E::kStepSums ? Acc(0) : acc[i][j];
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      Word a[4], b[4];
      load4(&As[kk][ty * 4], a);
      load4(&Bs[kk][tx * 4], b);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[i][j] = E::mac(part[i][j], a[i], b[j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = E::kStepSums ? acc[i][j] + part[i][j] : part[i][j];
    __syncthreads();
    advance(si, sj, cw, kBK, g);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= g.m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = n0 + tx * 4 + j;
      if (o < g.cout) epi(m, o, E::to_f32(acc[i][j]));
    }
  }
}

inline Geometry geometry(int64_t n, int64_t l, int64_t w, int64_t cin, int64_t cout, int S, int s0,
                         int per) {
  Geometry g;
  g.n = (int)n;
  g.l = (int)l;
  g.w = (int)w;
  g.cin = (int)cin;
  g.cout = (int)cout;
  g.S = S;
  g.s0 = s0;
  g.cw = (int)((cin + per - 1) / per);
  g.kw = S * S * g.cw;
  g.m = (int)(n * l * w);
  return g;
}

template <typename T, typename Epi>
int launch(const T* x, const typename Elem<T>::Word* wts, const Geometry& g, bool vec, Epi epi,
           cudaStream_t stream) {
  if (g.m == 0 || g.cout == 0) return 0;
  const dim3 grid((unsigned)((g.m + kBM - 1) / kBM), (unsigned)((g.cout + kBN - 1) / kBN));
  conv_kernel<T, Epi><<<grid, kThreads, 0, stream>>>(x, wts, g, vec, epi);
  return (int)cudaGetLastError();
}

}  // namespace packed_conv
