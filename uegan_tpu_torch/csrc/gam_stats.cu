// GAM statistics: per-(n, c) mean and unbiased std over H*W of an NHWC map.
//
// Replaces uegan_tpu/ops/pallas/gam_stats.py:gam_mean_std_pallas.  Same
// arithmetic: f32 sums of x and x*x in one read of x, then
//   mean = S1 / hw
//   var  = (S2 - hw * mean^2) / max(hw - 1, 1)
//   std  = sqrt(max(var, 0) + eps)
// with mean and std written in x's dtype.
//
// What bounds it on the card: bytes.  Each element of x is read once and
// takes two flops, so the kernel can go no faster than reading x from device
// memory.  The TPU kernel walks H tiles in order and carries its sums in
// VMEM from one grid step to the next; blocks on the card run in no order,
// so this is two passes instead:
//   pass 1: grid (C tiles, HW splits, N).  Threads run along C, which is
//           contiguous in NHWC, so a warp reads 32 neighbouring channels of
//           one pixel.  Each block writes f32 partial sums of its split to an
//           (N, S, 2, C) scratch.  The split count is chosen by the caller so
//           that enough blocks are in flight to fill the card.
//   pass 2: one thread per (n, c) adds the S partials in a fixed order.
// No atomics, so a run gives the same bits every time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileC = 32;  // channels per pass-1 block (threadIdx.x)
constexpr int kRows = 8;    // pixels read side by side per block (threadIdx.y)
constexpr int kFinishThreads = 128;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kTileC * kRows)
    partial_sums(const T* __restrict__ x, float* __restrict__ part, int64_t hw, int c,
                 int64_t chunk) {
  const int ch = blockIdx.x * kTileC + threadIdx.x;
  const int split = blockIdx.y;
  const int n = blockIdx.z;
  const int64_t p0 = (int64_t)split * chunk;
  const int64_t p1 = p0 + chunk < hw ? p0 + chunk : hw;
  float s1 = 0.f, s2 = 0.f;
  if (ch < c) {
    const T* base = x + (int64_t)n * hw * c + ch;
    for (int64_t p = p0 + threadIdx.y; p < p1; p += kRows) {
      const float v = load_f32(base + p * c);
      s1 += v;
      s2 += v * v;
    }
  }
  __shared__ float sh1[kRows][kTileC];
  __shared__ float sh2[kRows][kTileC];
  sh1[threadIdx.y][threadIdx.x] = s1;
  sh2[threadIdx.y][threadIdx.x] = s2;
  __syncthreads();
  if (threadIdx.y == 0 && ch < c) {
    for (int r = 1; r < kRows; ++r) {
      s1 += sh1[r][threadIdx.x];
      s2 += sh2[r][threadIdx.x];
    }
    float* out = part + ((int64_t)n * gridDim.y + split) * 2 * c;
    out[ch] = s1;
    out[c + ch] = s2;
  }
}

template <typename T>
__global__ void finish(const float* __restrict__ part, T* __restrict__ mean,
                       T* __restrict__ std, int64_t hw, int c, int splits, float eps) {
  const int ch = blockIdx.x * kFinishThreads + threadIdx.x;
  const int n = blockIdx.y;
  if (ch >= c) return;
  const float* p = part + (int64_t)n * splits * 2 * c + ch;
  float s1 = 0.f, s2 = 0.f;
  for (int s = 0; s < splits; ++s) {
    s1 += p[(int64_t)s * 2 * c];
    s2 += p[(int64_t)s * 2 * c + c];
  }
  const float fhw = (float)hw;
  const float m = s1 / fhw;
  // rounded multiplies, no fma contraction: s2 - hw*m^2 cancels, and an fma
  // would turn a zero variance (hw = 1, or a constant map) into +-1 ulp of s2
  const float hmm = __fmul_rn(__fmul_rn(fhw, m), m);
  const float var = (s2 - hmm) / (float)(hw > 1 ? hw - 1 : 1);
  store_f32(mean + (int64_t)n * c + ch, m);
  store_f32(std + (int64_t)n * c + ch, sqrtf(fmaxf(var, 0.f) + eps));
}

template <typename T>
int launch(const void* x, void* part, void* mean, void* std, int64_t n, int64_t hw,
           int64_t c, int64_t splits, int64_t chunk, float eps, cudaStream_t stream) {
  const dim3 grid1((unsigned)((c + kTileC - 1) / kTileC), (unsigned)splits, (unsigned)n);
  partial_sums<T><<<grid1, dim3(kTileC, kRows), 0, stream>>>(
      static_cast<const T*>(x), static_cast<float*>(part), hw, (int)c, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid2((unsigned)((c + kFinishThreads - 1) / kFinishThreads), (unsigned)n);
  finish<T><<<grid2, kFinishThreads, 0, stream>>>(static_cast<const float*>(part),
                                                  static_cast<T*>(mean), static_cast<T*>(std),
                                                  hw, (int)c, (int)splits, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  part: (n, splits, 2, c) float32 scratch.
// Returns the cudaError_t of the launches (0 on success).
extern "C" int uegan_gam_stats(const void* x, void* part, void* mean, void* std, int dtype,
                               int64_t n, int64_t hw, int64_t c, int64_t splits,
                               int64_t chunk, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, part, mean, std, n, hw, c, splits, chunk, eps, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, part, mean, std, n, hw, c, splits, chunk, eps, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* uegan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
