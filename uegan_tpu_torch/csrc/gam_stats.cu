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
//   writes them to an (N, splits, 2, C) f32 scratch.
// - The last block of (n, t) to finish, told by an integer ticket (one
//   acquire-release add per block), adds the splits' partials in split
//   order, writes mean and std, and resets the ticket to 0, so the counters
//   live across calls (allocated once per device) and a CUDA graph can
//   replay the launch.  No float atomics: a run gives the same bits every
//   time.  A thread block cluster could combine through distributed shared
//   memory instead, but caps an image at 8 blocks (16 non-portable), which
//   leaves most of the card idle at batch 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;       // pixels a thread loads before it adds them
constexpr int kBlocksPerSM = 2;  // the grid is one wave of 2 blocks an SM (128 registers)

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

// One word of x.  A 16-byte word is read past L1 (each is read once) with an
// L2 prefetch of the 256-byte sector around it, which the thread's
// neighbours read next.
template <typename P>
__device__ __forceinline__ P load_once(const P* p) {
  if constexpr (sizeof(P) == 16) {
    int4 r;
    asm volatile("ld.global.nc.L1::no_allocate.L2::256B.v4.s32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
                 : "l"(p));
    return *reinterpret_cast<P*>(&r);
  } else {
    return *p;
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Column sums of a [rows][cols] matrix of (s1, s2) pairs, in a fixed order,
// with all the block's threads: lane l of `lanes` adds rows l, l + lanes, ...
// in order and leaves its sum in row l of sh (rows l >= lanes are read only
// by their own lane); then column j's sum is lanes 0, 1, ... in order, handed
// to emit(j, s1, s2) by one thread.  get(r, j) reads the matrix.
template <int kMaxFloats, typename Get, typename Emit>
__device__ __forceinline__ void column_sums(float (&sh)[2][kMaxFloats], int rows, int cols,
                                            Get get, Emit emit) {
  const int lanes = max(1, min(rows, kThreads / cols));
  for (int idx = threadIdx.x; idx < lanes * cols; idx += kThreads) {
    const int j = idx % cols, l = idx / cols;
    float a = 0.f, b = 0.f;
#pragma unroll 8
    for (int r = l; r < rows; r += lanes) {
      const float2 v = get(r, j);
      a += v.x;
      b += v.y;
    }
    sh[0][l * cols + j] = a;
    sh[1][l * cols + j] = b;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < cols; j += kThreads) {
    float a = 0.f, b = 0.f;
    for (int l = 0; l < lanes; ++l) {
      a += sh[0][l * cols + j];
      b += sh[1][l * cols + j];
    }
    emit(j, a, b);
  }
}

// grid (splits, channel tiles, n); a tile is gt groups of V channels, and
// its threads run rows = kThreads / gt pixels side by side
template <typename T, int V>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    gam_stats_kernel(const T* __restrict__ x, float* __restrict__ part,
                     unsigned* __restrict__ ticket, T* __restrict__ mean, T* __restrict__ std,
                     int64_t hw, int c, int gt, int64_t chunk, float eps) {
  __shared__ float sh[2][kThreads * V];
  __shared__ bool is_last;
  const int split = blockIdx.x, splits = gridDim.x, tile = blockIdx.y, n = blockIdx.z;
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
  // thread (r, g) holds row r, columns g*V .. g*V + V - 1 of a [rows][width]
  // matrix; it is read from a copy, since column_sums writes sh in place
  float* mine1 = &sh[0][threadIdx.x * V];
  float* mine2 = &sh[1][threadIdx.x * V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    mine1[k] = s1[k];
    mine2[k] = s2[k];
  }
  __syncthreads();
  float* out = part + ((int64_t)n * splits + split) * 2 * c + c0;
  column_sums(
      sh, rows, width,
      [&](int rr, int j) { return make_float2(sh[0][rr * width + j], sh[1][rr * width + j]); },
      [&](int j, float a, float b) {
        if (j < cb) {
          out[j] = a;
          out[c + j] = b;
        }
      });
  // take a ticket: thread 0's add releases the block's partials (the
  // barrier orders every thread's writes before it) and acquires the other
  // blocks' (the barrier after it orders every thread's reads); the last
  // block of (n, tile) combines every split's partials
  __syncthreads();
  unsigned* tk = ticket + (int64_t)n * gridDim.y + tile;
  if (threadIdx.x == 0) {
    unsigned before;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
                 : "=r"(before)
                 : "l"(tk)
                 : "memory");
    is_last = before == (unsigned)(splits - 1);
  }
  __syncthreads();
  if (!is_last) return;
  const float* all = part + (int64_t)n * splits * 2 * c + c0;
  const float fhw = (float)hw;
  column_sums(
      sh, splits, cb,
      [&](int s, int j) {
        const float* p = all + (int64_t)s * 2 * c + j;
        return make_float2(__ldcg(p), __ldcg(p + c));
      },
      [&](int j, float a, float b) {
        const float m = a / fhw;
        // rounded multiplies, no fma contraction: s2 - hw*m^2 cancels, and
        // an fma would turn a zero variance (hw = 1, or a constant map) into
        // +-1 ulp of s2
        const float hmm = __fmul_rn(__fmul_rn(fhw, m), m);
        const float var = (b - hmm) / (float)(hw > 1 ? hw - 1 : 1);
        store_f32(mean + (int64_t)n * c + c0 + j, m);
        store_f32(std + (int64_t)n * c + c0 + j, sqrtf(fmaxf(var, 0.f) + eps));
      });
  if (threadIdx.x == 0) *tk = 0u;
}

template <typename T, int V>
int launch(const void* x, void* part, void* ticket, void* mean, void* std, int64_t n,
           int64_t hw, int64_t c, int64_t gt, int64_t splits, int64_t chunk, float eps,
           cudaStream_t stream) {
  const int64_t tiles = (c + gt * V - 1) / (gt * V);
  const dim3 grid((unsigned)splits, (unsigned)tiles, (unsigned)n);
  gam_stats_kernel<T, V><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<float*>(part), static_cast<unsigned*>(ticket),
      static_cast<T*>(mean), static_cast<T*>(std), hw, (int)c, (int)gt, chunk, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_vec(int vec, const void* x, void* part, void* ticket, void* mean, void* std,
               int64_t n, int64_t hw, int64_t c, int64_t gt, int64_t splits, int64_t chunk,
               float eps, cudaStream_t s) {
  switch (vec) {
    case 1: return launch<T, 1>(x, part, ticket, mean, std, n, hw, c, gt, splits, chunk, eps, s);
    case 2: return launch<T, 2>(x, part, ticket, mean, std, n, hw, c, gt, splits, chunk, eps, s);
    case 4: return launch<T, 4>(x, part, ticket, mean, std, n, hw, c, gt, splits, chunk, eps, s);
    case 8:
      if constexpr (sizeof(T) == 2)
        return launch<T, 8>(x, part, ticket, mean, std, n, hw, c, gt, splits, chunk, eps, s);
      break;
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  vec: channels a thread reads as one word
// (1, 2, 4, or 8 for bfloat16; C % vec == 0 and x aligned to vec * itemsize);
// gt: channel groups of vec a block covers (1 to 256); splits, chunk: each
// image's pixels cut into `splits` runs of `chunk`.  part: (n, splits, 2, c)
// float32 scratch; ticket: n * ceil(c / (gt * vec)) zeroed unsigned counters,
// left zeroed.  Returns the cudaError_t of the launch (0 on success).
extern "C" int uegan_gam_stats(const void* x, void* part, void* ticket, void* mean, void* std,
                               int dtype, int64_t n, int64_t hw, int64_t c, int vec,
                               int64_t gt, int64_t splits, int64_t chunk, float eps,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (gt < 1 || gt > kThreads) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_vec<float>(vec, x, part, ticket, mean, std, n, hw, c, gt, splits, chunk, eps,
                             s);
  if (dtype == 1)
    return launch_vec<__nv_bfloat16>(vec, x, part, ticket, mean, std, n, hw, c, gt, splits,
                                     chunk, eps, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* uegan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
