// Kernel E: int8 packed conv with the int8 path's fused epilogue, NHWC.
//
// Replaces uegan_tpu/ops/pallas/packed_conv_int8.py:packed_conv_int8_pallas
// (:167; its 1x1 body _kernel_1x1, called at :236, and its SxS body
// _kernel, called at :249).  Same arithmetic:
//
//   acc = sum s8 x * s8 k                  (int32, exact)
//   y   = f32(acc) * w_scale[o] + bias[o]  (rounded multiply, rounded add)
//   y   = act(y)                           (none / leaky: y >= 0 ? y : 0.2 y / tanh)
//   y   = y * f32(mul)                     (optional bf16 factor, same shape as out)
//   out = bf16(y), or with requant s8(clip(rint(y * inv_scale), -127, 127))
//
// inv_scale is 1 / out_scale computed in f32 by the caller, as the TPU
// kernel computes it; rint rounds half to even, as jnp.round and torch.round
// do.  The multiply and the add are __fmul_rn and __fadd_rn so that nvcc
// does not contract them into one fma, which would round differently from
// the plain PyTorch version (two rounded ops).
//
// The sum is the tensor-core body (packed_conv_body.cuh): TMA-fed wgmma
// m64n128k32 s8 -> s32.  The int32 sums of the tensor cores are exact, so the
// output does not depend on the order of summation.  The TPU kernel keeps
// the int32 accumulator in VMEM so that it never reaches HBM; here it stays
// in registers, and the epilogue runs on it before the one store.  At the
// main path's 1x1 site (ga1) E is a byte stream: 67 MB of int8 in, 134 MB
// of bf16 out; the body's persistent blocks overlap one tile's epilogue
// and 16-byte stores with the next tile's TMA loads.  At the 3x3 sites the
// tensor cores' multiply-adds bound it.

#include "packed_conv_body.cuh"

namespace {

template <int kAct, bool kMulT, bool kRequant>  // kAct: 0 none, 1 leaky 0.2, 2 tanh
struct Int8Epilogue {
  static constexpr bool kMul = kMulT;
  static constexpr int kOutBytes = kRequant ? 1 : 2;
  const __nv_bfloat16* mul;  // (n, l, w, cout) when kMul
  void* out;                 // bf16, or int8 with requant
  const float* ws;
  const float* bias;
  float inv_scale;

  struct Param {
    float ws, bias;
  };
  __device__ __forceinline__ Param param(int o) const { return {__ldg(ws + o), __ldg(bias + o)}; }

  __device__ __forceinline__ float operator()(int acc, const Param& p, float mulv) const {
    float v = __fadd_rn(__fmul_rn(__int2float_rn(acc), p.ws), p.bias);
    if (kAct == 1) v = v >= 0.f ? v : __fmul_rn(v, 0.2f);
    if (kAct == 2) v = tanhf(v);
    return kMul ? __fmul_rn(v, mulv) : v;
  }

  __device__ __forceinline__ static int requant(float v, float inv) {
    v = rintf(__fmul_rn(v, inv));
    return (int)(v < -127.f ? -127.f : (v > 127.f ? 127.f : v));
  }

  __device__ __forceinline__ void store2(uint8_t* dst, float v0, float v1) const {
    if (kRequant) {
      *reinterpret_cast<uint16_t*>(dst) =
          (uint16_t)((requant(v0, inv_scale) & 0xff) | (requant(v1, inv_scale) & 0xff) << 8);
    } else {
      *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
    }
  }
};

struct Args {
  const int8_t *x, *wts;
  const float *ws, *bias;
  const __nv_bfloat16* mul;
  void* out;
  int64_t n, l, w, cin, cout;
  int S, s0;
  float inv_scale;
  bool vec_mul;
  cudaStream_t stream;
};

template <int kAct, bool kMul, bool kRequant>
int run(const Args& a) {
  const Int8Epilogue<kAct, kMul, kRequant> epi{a.mul, a.out, a.ws, a.bias, a.inv_scale};
  return tc_conv::launch<int8_t>(a.x, a.wts, a.n, a.l, a.w, a.cin, a.cout, a.S, a.s0, epi,
                                 a.vec_mul, a.stream);
}

template <int kAct>
int run_act(const Args& a, bool mul, bool requant) {
  if (mul) return requant ? run<kAct, true, true>(a) : run<kAct, true, false>(a);
  return requant ? run<kAct, false, true>(a) : run<kAct, false, false>(a);
}

}  // namespace

// x (n, l, w, cin) int8 NHWC and wts (cout, S, S, cin) int8, cin a multiple
// of 16 and both 16-byte aligned (the wrapper zero-pads the channels);
// w_scale, bias (cout,) f32; mul null or (n, l, w, cout) bf16; out (n, l, w,
// cout) bf16, or int8 when requant.  vec_mul: cout % 8 == 0 and mul 16-byte
// aligned.  Element counts < 2^31 (the caller checks).  Returns the
// cudaError_t of the launch, or tc_conv::kErrNoEncoder / kErrEncode.
extern "C" int uegan_packed_conv_int8(const void* x, const void* wts, const void* w_scale,
                                      const void* bias, const void* mul, void* out, int64_t n,
                                      int64_t l, int64_t w, int64_t cin, int64_t cout, int S,
                                      int s0, int act, int requant, float inv_scale, int vec_mul,
                                      void* stream) {
  const Args a{static_cast<const int8_t*>(x), static_cast<const int8_t*>(wts),
               static_cast<const float*>(w_scale), static_cast<const float*>(bias),
               static_cast<const __nv_bfloat16*>(mul), out, n, l, w, cin, cout, S, s0,
               inv_scale, vec_mul != 0, static_cast<cudaStream_t>(stream)};
  const bool has_mul = mul != nullptr, rq = requant != 0;
  if (act == 0) return run_act<0>(a, has_mul, rq);
  if (act == 1) return run_act<1>(a, has_mul, rq);
  if (act == 2) return run_act<2>(a, has_mul, rq);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory a block of the tensor-core body takes (E's and F's).
extern "C" int uegan_tc_conv_smem_bytes() { return tc_conv::kSmemBytes; }
