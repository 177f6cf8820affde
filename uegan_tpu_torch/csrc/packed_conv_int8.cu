// Kernel E: int8 packed conv with the int8 path's fused epilogue, NHWC.
//
// Replaces uegan_tpu/ops/pallas/packed_conv_int8.py:packed_conv_int8_pallas
// (its 1x1 body _kernel_1x1 and its SxS body _kernel).  Same arithmetic:
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
// The sum is the shared implicit-GEMM body (packed_conv_body.cuh) with
// __dp4a: 4 int8 products a instruction.  The TPU kernel keeps the int32
// accumulator in VMEM so that it never reaches HBM; here it stays in
// registers, and the epilogue runs on it before the one store.

#include "packed_conv_body.cuh"

namespace {

struct Int8Epilogue {
  const float* ws;
  const float* bias;
  const __nv_bfloat16* mul;  // null: no factor
  void* out;                 // bf16, or int8 with requant
  int cout;
  int act;                   // 0 none, 1 leaky 0.2, 2 tanh
  int requant;
  float inv_scale;

  __device__ __forceinline__ void operator()(int m, int o, float acc) const {
    float v = __fadd_rn(__fmul_rn(acc, ws[o]), bias[o]);
    if (act == 1) {
      v = v >= 0.f ? v : __fmul_rn(v, 0.2f);
    } else if (act == 2) {
      v = tanhf(v);
    }
    const size_t idx = (size_t)m * cout + o;
    if (mul != nullptr) v = __fmul_rn(v, __bfloat162float(mul[idx]));
    if (requant) {
      v = rintf(__fmul_rn(v, inv_scale));
      v = v < -127.f ? -127.f : (v > 127.f ? 127.f : v);
      static_cast<int8_t*>(out)[idx] = (int8_t)(int)v;
    } else {
      static_cast<__nv_bfloat16*>(out)[idx] = __float2bfloat16_rn(v);
    }
  }
};

}  // namespace

// x (n, l, w, cin) int8 NHWC; wts (cout, S, S, cw*4) int8 with the channels
// past cin zero (read as int32 words); w_scale, bias (cout,) f32; mul null or
// (n, l, w, cout) bf16; out (n, l, w, cout) bf16, or int8 when requant.
// vec: cin % 4 == 0 and x 4-byte aligned.  Element counts < 2^31 (the caller
// checks).  Returns the cudaError_t of the launch.
extern "C" int uegan_packed_conv_int8(const void* x, const void* wts, const void* w_scale,
                                      const void* bias, const void* mul, void* out, int64_t n,
                                      int64_t l, int64_t w, int64_t cin, int64_t cout, int S,
                                      int s0, int act, int requant, float inv_scale, int vec,
                                      void* stream) {
  using namespace packed_conv;
  const Geometry g = geometry(n, l, w, cin, cout, S, s0, Elem<int8_t>::kPer);
  Int8Epilogue epi{static_cast<const float*>(w_scale), static_cast<const float*>(bias),
                   static_cast<const __nv_bfloat16*>(mul), out, (int)cout, act, requant,
                   inv_scale};
  return launch<int8_t>(static_cast<const int8_t*>(x), static_cast<const int*>(wts), g, vec != 0,
                        epi, static_cast<cudaStream_t>(stream));
}
