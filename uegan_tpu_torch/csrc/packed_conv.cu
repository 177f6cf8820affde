// Kernel F: stride-1 packed conv + bias + activation, f32 or bf16, NHWC.
//
// Replaces uegan_tpu/ops/pallas/packed_conv.py:packed_conv_pallas, the
// float sibling of kernel E: the same conv with zero padding, summed in f32
// (a bf16 product is exact in f32), then
//
//   out = act(sum + bias[o])   act: none / leaky (y >= 0 ? y : 0.2 y) / tanh
//
// rounded once to the input's dtype.  The sum is the shared implicit-GEMM
// body (packed_conv_body.cuh) with fmaf on the CUDA cores.

#include "packed_conv_body.cuh"

namespace {

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T>
struct FloatEpilogue {
  const float* bias;
  T* out;
  int cout;
  int act;  // 0 none, 1 leaky 0.2, 2 tanh

  __device__ __forceinline__ void operator()(int m, int o, float acc) const {
    float v = __fadd_rn(acc, bias[o]);
    if (act == 1) {
      v = v >= 0.f ? v : __fmul_rn(v, 0.2f);
    } else if (act == 2) {
      v = tanhf(v);
    }
    store(out + (size_t)m * cout + o, v);
  }
};

template <typename T>
int run(const void* x, const void* wts, const void* bias, void* out, int64_t n, int64_t l,
        int64_t w, int64_t cin, int64_t cout, int S, int s0, int act, cudaStream_t stream) {
  using namespace packed_conv;
  const Geometry g = geometry(n, l, w, cin, cout, S, s0, Elem<T>::kPer);
  FloatEpilogue<T> epi{static_cast<const float*>(bias), static_cast<T*>(out), (int)cout, act};
  return launch<T>(static_cast<const T*>(x), static_cast<const float*>(wts), g, false, epi,
                   stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, for x and out.  x (n, l, w, cin); wts
// (cout, S, S, cin) f32; bias (cout,) f32; out (n, l, w, cout).  Element
// counts < 2^31 (the caller checks).  Returns the cudaError_t of the launch.
extern "C" int uegan_packed_conv(const void* x, const void* wts, const void* bias, void* out,
                                 int dtype, int64_t n, int64_t l, int64_t w, int64_t cin,
                                 int64_t cout, int S, int s0, int act, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return run<float>(x, wts, bias, out, n, l, w, cin, cout, S, s0, act, s);
  if (dtype == 1) return run<__nv_bfloat16>(x, wts, bias, out, n, l, w, cin, cout, S, s0, act, s);
  return (int)cudaErrorInvalidValue;
}
