// GAM statistics: per-(n, c) mean and unbiased std over H*W of an NHWC map.
//
// Replaces uegan_tpu/ops/pallas/gam_stats.py:gam_mean_std_pallas.  Same
// arithmetic: f32 sums of x and x*x in one read of x, then
//   mean = S1 / hw
//   var  = (S2 - hw * mean^2) / max(hw - 1, 1)
//   std  = sqrt(max(var, 0) + eps)
// with mean and std written in x's dtype.  For a training forward the
// caller also passes mean32 and var32, and the combine writes the f32 mean
// and the f32 var before the clamp there: the backward kernel
// (gam_stats_bwd.cu) needs the values from before the cast to x's dtype, as
// JAX's vjp of uegan_tpu/ops/norms.py:feature_mean_std uses them, and the
// var from before the clamp, whose sign picks the clamp's gradient.
//
// What bounds it on the card: bytes.  Each element of x is read once and
// takes two flops, so the kernel can go no faster than reading x from device
// memory (the five canonical GAM sites at B = 8 read 260 MB, 78 us at
// 3.35 TB/s).  The TPU kernel walks H tiles in order and carries its sums in
// VMEM from one grid step to the next; blocks on the card run in no order,
// so the design is one launch of gridDim (splits, channel tiles, N):
//
// - Block (s, t, n) sums pixels [s * chunk, (s + 1) * chunk) of image n over
//   its tile of at most 8 groups of channels (64 bf16 or 32 f32 at every GAM
//   site), so that each tile's combine below adds few partials and the tiles
//   of one image combine on several SMs at once.  The caller sizes the grid
//   to at most one wave of kBlocksPerSM blocks an SM: blocks all do the same
//   work, and a block past the wave would run alone in a second one.
// - Each thread owns a fixed group of V channels and reads them as one word
//   of V * itemsize bytes, 16 at every GAM site (8 bf16 or 4 f32 channels);
//   where C * itemsize or x's address does not line up with 16 bytes (C = 3,
//   5, 12), the caller picks a narrower V and the same kernel reads 8-, 4-
//   or 2-byte words.  The tile's threads run `rows` pixels side by side and
//   step kUnroll pixels at a time, issuing kUnroll loads before adding any:
//   with 8 loads of 16 bytes a thread and 2 blocks an SM, 64 KB are in
//   flight on each SM, and each step first asks L2 to prefetch the next
//   step's words, so the next 64 KB are on their way too (4 loads and 4
//   blocks an SM, or 12 and 16 loads, were slower on the card; PERF.md).
//   Sums are f32 in registers.
// - The block adds its threads' sums in shared memory in a fixed order and
//   writes them to an (N, splits, 2, C) f32 scratch (fixed_sum.cuh).
// - The last block of (n, t) to finish, told by an integer ticket (one
//   acquire-release add per block), adds the splits' partials in split
//   order, writes mean and std, and resets the ticket to 0, so the counters
//   live across calls (allocated once per device) and a CUDA graph can
//   replay the launch.  No float atomics: a run gives the same bits every
//   time.  A thread block cluster could combine through distributed shared
//   memory instead, but caps an image at 8 blocks (16 non-portable), which
//   leaves most of the card idle at batch 1.

#include "fixed_sum.cuh"

namespace {

constexpr int kUnroll = 8;       // pixels a thread loads before it adds them
constexpr int kBlocksPerSM = 2;  // the grid is one wave of 2 blocks an SM (128 registers)

// grid (splits, channel tiles, n); a tile is gt groups of V channels, and
// its threads run rows = kThreads / gt pixels side by side
template <typename T, int V>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    gam_stats_kernel(const T* __restrict__ x, float* __restrict__ part,
                     unsigned* __restrict__ ticket, T* __restrict__ mean, T* __restrict__ std,
                     float* __restrict__ mean32, float* __restrict__ var32, int64_t hw, int c,
                     int gt, int64_t chunk, float eps) {
  __shared__ float sh[2][kThreads * V];
  const int split = blockIdx.x, tile = blockIdx.y, n = blockIdx.z;
  const int rows = kThreads / gt;
  const int g = threadIdx.x % gt, r = threadIdx.x / gt;
  const int c0 = tile * gt * V;          // the tile's first channel
  const int width = gt * V;              // a row of sh: the tile's channels
  const int cb = min(width, c - c0);     // of which exist
  const int ch = c0 + g * V;
  float s1[V], s2[V];
#pragma unroll
  for (int k = 0; k < V; ++k) s1[k] = s2[k] = 0.f;
  if (r < rows && ch < c) {
    const int64_t p0 = (int64_t)split * chunk;
    const int64_t p1 = p0 + chunk < hw ? p0 + chunk : hw;
    const T* base = x + (int64_t)n * hw * c + ch;
    for (int64_t p = p0 + r; p < p1; p += (int64_t)rows * kUnroll) {
      // the next step's words to L2 first: they are on their way while this
      // step's loads wait, at no cost in registers
#pragma unroll
      for (int u = kUnroll; u < 2 * kUnroll; ++u) {
        const int64_t q = p + (int64_t)u * rows;
        if (q < p1) asm volatile("prefetch.global.L2 [%0];" ::"l"(base + q * c));
      }
      Pack<T, V> v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t q = p + (int64_t)u * rows;
        if (q < p1) v[u] = load_once(reinterpret_cast<const Pack<T, V>*>(base + q * c));
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (p + (int64_t)u * rows < p1) {
#pragma unroll
          for (int k = 0; k < V; ++k) {
            const float f = to_f32(v[u].v[k]);
            s1[k] += f;
            s2[k] += f * f;
          }
        }
      }
    }
  }
  const float fhw = (float)hw;
  combine_splits<V>(sh, s1, s2, part, ticket, c, n, split, tile, rows, c0, width, cb,
                    [&](int j, float a, float b) {
    const float m = a / fhw;
    // rounded multiplies, no fma contraction: s2 - hw*m^2 cancels, and
    // an fma would turn a zero variance (hw = 1, or a constant map) into
    // +-1 ulp of s2
    const float hmm = __fmul_rn(__fmul_rn(fhw, m), m);
    const float var = (b - hmm) / (float)(hw > 1 ? hw - 1 : 1);
    const int64_t at = (int64_t)n * c + c0 + j;
    mean[at] = from_f32<T>(m);
    std[at] = from_f32<T>(sqrtf(fmaxf(var, 0.f) + eps));
    if (mean32 != nullptr) {
      mean32[at] = m;
      var32[at] = var;
    }
  });
}

template <typename T, int V>
int launch(const void* x, void* part, void* ticket, void* mean, void* std, void* mean32,
           void* var32, int64_t n, int64_t hw, int64_t c, int64_t gt, int64_t splits,
           int64_t chunk, float eps, cudaStream_t stream) {
  const int64_t tiles = (c + gt * V - 1) / (gt * V);
  const dim3 grid((unsigned)splits, (unsigned)tiles, (unsigned)n);
  gam_stats_kernel<T, V><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<float*>(part), static_cast<unsigned*>(ticket),
      static_cast<T*>(mean), static_cast<T*>(std), static_cast<float*>(mean32),
      static_cast<float*>(var32), hw, (int)c, (int)gt, chunk, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_vec(int vec, const void* x, void* part, void* ticket, void* mean, void* std,
               void* mean32, void* var32, int64_t n, int64_t hw, int64_t c, int64_t gt,
               int64_t splits, int64_t chunk, float eps, cudaStream_t s) {
#define UEGAN_GAM_LAUNCH(V) \
  launch<T, V>(x, part, ticket, mean, std, mean32, var32, n, hw, c, gt, splits, chunk, eps, s)
  switch (vec) {
    case 1: return UEGAN_GAM_LAUNCH(1);
    case 2: return UEGAN_GAM_LAUNCH(2);
    case 4: return UEGAN_GAM_LAUNCH(4);
    case 8:
      if constexpr (sizeof(T) == 2) return UEGAN_GAM_LAUNCH(8);
      break;
  }
#undef UEGAN_GAM_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  vec: channels a thread reads as one word
// (1, 2, 4, or 8 for bfloat16; C % vec == 0 and x aligned to vec * itemsize);
// gt: channel groups of vec a block covers (1 to 256); splits, chunk: each
// image's pixels cut into `splits` runs of `chunk`.  part: (n, splits, 2, c)
// float32 scratch; ticket: n * ceil(c / (gt * vec)) zeroed unsigned counters,
// left zeroed.  mean32, var32: null, or (n, c) float32 outputs for the
// backward.  Returns the cudaError_t of the launch (0 on success).
extern "C" int uegan_gam_stats(const void* x, void* part, void* ticket, void* mean, void* std,
                               void* mean32, void* var32, int dtype, int64_t n, int64_t hw,
                               int64_t c, int vec, int64_t gt, int64_t splits, int64_t chunk,
                               float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (gt < 1 || gt > kThreads || (mean32 == nullptr) != (var32 == nullptr))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_vec<float>(vec, x, part, ticket, mean, std, mean32, var32, n, hw, c, gt,
                             splits, chunk, eps, s);
  if (dtype == 1)
    return launch_vec<__nv_bfloat16>(vec, x, part, ticket, mean, std, mean32, var32, n, hw, c,
                                     gt, splits, chunk, eps, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* uegan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
