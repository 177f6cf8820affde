// Kernel F: stride-1 packed conv + bias + activation, bf16 or f32, NHWC.
//
// Replaces uegan_tpu/ops/pallas/packed_conv.py:packed_conv_pallas (called
// at :155), the float sibling of kernel E: the same conv with zero padding,
// summed in f32, then
//
//   out = act(sum + bias[o])   act: none / leaky (y >= 0 ? y : 0.2 y) / tanh
//
// rounded once to the input's dtype.
//
// bf16 runs on the tensor-core body it shares with E (packed_conv_body.cuh:
// TMA-fed wgmma m64n128k16, f32 sums): at the dec4 shape the multiply-adds
// bound it, and the design note in the header says how the body feeds them.
//
// f32 stays on the CUDA cores: TF32 tensor cores keep 10 mantissa bits and
// would miss F's f32 tolerance.  A block computes a 64-pixel x 64-channel
// tile; its 256 threads each hold 4 x 4 sums.  Each step stages 8 channels
// of K for the tile's pixels and channels in shared memory (padded rows:
// conflict-free stores), then every thread reads 4 pixels and 4 channels as
// one 16-byte load each and does 16 fmaf a channel.  The thread's place in
// K (tap row, tap column, channel) is carried from step to step, so no index
// division runs inside the loop.  Each step's 8 products are summed apart
// and added to the running sum: the rounding error of a K = 2304 sum then
// grows with K / 8 additions to a large sum, not with K.  No path runs F.

#include "packed_conv_body.cuh"

namespace {

__device__ __forceinline__ float activate(float v, int act) {
  if (act == 1) return v >= 0.f ? v : __fmul_rn(v, 0.2f);
  if (act == 2) return tanhf(v);
  return v;
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core body's epilogue
// ---------------------------------------------------------------------------
template <int kAct>  // 0 none, 1 leaky 0.2, 2 tanh
struct FloatEpilogue {
  static constexpr bool kMul = false;
  static constexpr int kOutBytes = 2;
  const __nv_bfloat16* mul;  // unused: F has no factor
  void* out;
  const float* bias;

  using Param = float;
  __device__ __forceinline__ Param param(int o) const { return __ldg(bias + o); }
  __device__ __forceinline__ float operator()(float acc, float b, float) const {
    return activate(__fadd_rn(acc, b), kAct);
  }
  __device__ __forceinline__ void store2(uint8_t* dst, float v0, float v1) const {
    *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
  }
};

template <int kAct>
int run_bf16(const void* x, const void* wts, const void* bias, void* out, int64_t n, int64_t l,
             int64_t w, int64_t cin, int64_t cout, int S, int s0, cudaStream_t st) {
  const FloatEpilogue<kAct> epi{nullptr, out, static_cast<const float*>(bias)};
  return tc_conv::launch<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(x),
                                        static_cast<const __nv_bfloat16*>(wts), n, l, w, cin, cout,
                                        S, s0, epi, false, st);
}

// ---------------------------------------------------------------------------
// f32: the CUDA-core body
// ---------------------------------------------------------------------------
constexpr int kBM = 64, kBN = 64, kBK = 8, kThreads = 256, kPad = 4;

struct Geometry {
  int l, w, cin, cout, S, s0, kw, m;
};

__device__ __forceinline__ void advance(int& si, int& sj, int& c, int step, const Geometry& g) {
  c += step;
  while (c >= g.cin) {
    c -= g.cin;
    if (++sj == g.S) {
      sj = 0;
      ++si;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    conv_f32(const float* __restrict__ x, const float* __restrict__ wts,
             const float* __restrict__ bias, float* __restrict__ out, Geometry g, int act) {
  __shared__ __align__(16) float As[kBK][kBM + kPad];
  __shared__ __align__(16) float Bs[kBK][kBN + kPad];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;  // sums: pixels ty*4.., channels tx*4..
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int lk = tid % kBK, lr = tid / kBK;  // staging: channel lk of rows lr, lr + 32

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
  int si = 0, sj = 0, c = 0;
  advance(si, sj, c, lk, g);

  float acc[4][4] = {};
  for (int k0 = 0; k0 < g.kw; k0 += kBK) {
    const bool kok = k0 + lk < g.kw;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float a = 0.f;
      const int li = pl[h] + si - g.s0, wi = pw[h] + sj - g.s0;
      if (kok && pok[h] && li >= 0 && li < g.l && wi >= 0 && wi < g.w)
        a = x[((size_t)(pn[h] * g.l + li) * g.w + wi) * g.cin + c];
      As[lk][lr + 32 * h] = a;
      const int o = n0 + lr + 32 * h;
      Bs[lk][lr + 32 * h] = (kok && o < g.cout) ? wts[(size_t)o * g.kw + k0 + lk] : 0.f;
    }
    __syncthreads();
    float part[4][4] = {};
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[i][j] = fmaf(av[i], bv[j], part[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += part[i][j];
    __syncthreads();
    advance(si, sj, c, kBK, g);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= g.m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = n0 + tx * 4 + j;
      if (o < g.cout) out[(size_t)m * g.cout + o] = activate(__fadd_rn(acc[i][j], bias[o]), act);
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, for x, wts and out.  x (n, l, w, cin);
// wts (cout, S, S, cin); bias (cout,) f32; out (n, l, w, cout).  For bf16,
// cin * 2 is a multiple of 16 and x and wts are 16-byte aligned (the
// wrapper zero-pads the channels).  Element counts < 2^31 (the caller
// checks).  Returns the cudaError_t of the launch, or one of
// tc_conv::kErrNoEncoder / kErrEncode.
extern "C" int uegan_packed_conv(const void* x, const void* wts, const void* bias, void* out,
                                 int dtype, int64_t n, int64_t l, int64_t w, int64_t cin,
                                 int64_t cout, int S, int s0, int act, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (act < 0 || act > 2 || dtype < 0 || dtype > 1) return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    if (act == 0) return run_bf16<0>(x, wts, bias, out, n, l, w, cin, cout, S, s0, st);
    if (act == 1) return run_bf16<1>(x, wts, bias, out, n, l, w, cin, cout, S, s0, st);
    return run_bf16<2>(x, wts, bias, out, n, l, w, cin, cout, S, s0, st);
  }
  const Geometry g{(int)l, (int)w, (int)cin, (int)cout, S, s0, (int)(S * S * cin),
                   (int)(n * l * w)};
  if (g.m == 0 || g.cout == 0) return 0;
  const dim3 grid((unsigned)((g.m + kBM - 1) / kBM), (unsigned)((g.cout + kBN - 1) / kBN));
  conv_f32<<<grid, kThreads, 0, st>>>(static_cast<const float*>(x), static_cast<const float*>(wts),
                                      static_cast<const float*>(bias), static_cast<float*>(out), g,
                                      act);
  return (int)cudaGetLastError();
}
