// x2 bilinear upsample with align_corners=True, NHWC.
//
// Replaces uegan_tpu/ops/pallas/resize2x.py:upsample2x_ac_pallas.  For
// out = 2 * in with align_corners=True, output row 2o mixes input rows o-1
// and o, and output row 2o+1 mixes rows o and o+1, with weights linear in o:
//   out[2o]   = g * x[o-1] + (1 - g) * x[o],      g = o / (2H - 1)
//   out[2o+1] = (1 - f) * x[o] + f * x[o+1],      f = (H - 1 - o) / (2H - 1)
// and the same along W (rows first, then columns, as the TPU kernel does).
// The math is f32; the output is written in x's dtype.  The edge taps
// (x[-1] for o = 0, x[H] for o = H-1) carry exactly zero weight; they are
// clamped into range, because an out-of-range read is a fault and 0 * NaN is
// NaN.  H = 1 or W = 1 gives weights 0 and a copy of the single row.
//
// What bounds it on the card: bytes.  It reads x once and writes 4x as many
// bytes; the 2x2 taps that neighbouring threads share come from L1/L2.  No
// interpolation matrices are built.  Grid: (row chunks, output row, n).  The
// row's taps and weights are computed once per block; threads run along the
// contiguous (ox, c) axis with c fastest, V channels per thread (16-byte
// loads and stores where C and the pointers allow it), so a warp's loads
// and stores coalesce.
//
// The backward (upsample2x_bwd_kernel, B') is the adjoint of that map, written
// as a gather so that no two threads add to one element and nothing is
// atomic: input row i is a tap of output rows 2i-1, 2i, 2i+1 and 2i+2 only
// (2o uses o-1 and o, 2o+1 uses o and o+1), so
//   dx[i, j] = sum over r of w_r(i) * h[r, j],
//   h[r, j]  = sum over q of w_q(j) * dy[r, q]
// over those at most 4 rows r and 4 columns q, where w_r(i) is the weight the
// forward gives tap i in output row r (the sum of both taps' weights where a
// clamp makes them the same row; zero-weight taps are skipped, so rows and
// columns outside the map are never read).  The sums are f32, in that order
// (each row's horizontal sum over q in order, then the rows in order); dx is
// written in dy's dtype.
//
// What bounds it on the card: bytes.  It reads dy once and writes a quarter
// as many bytes (the train step's four calls at batch 20: 315 MB in, 79 MB
// out, 117 us at 3.35 TB/s).  Each dy element is a tap of 2 input columns
// and each h row of 2 input rows, so a thread per dx word that gathers its
// 16 taps from global memory moves dy over the L2-to-SM path about 4 times
// and works out each h twice.  Instead a block takes a tile of `rows` input
// rows x `cols` input columns x `groups` words of V channels (16 bytes where
// C and the pointers allow it; 8, 4 or 2 bytes otherwise, in the same
// kernel) and streams the tile's dy rows 2 i0 - 1 .. 2 (i0 + rows), columns
// 2 j0 - 1 .. 2 (j0 + cols), through a ring of kStages rows in shared
// memory: each row is copied with cp.async (16-, 8- or 4-byte words; 2-byte
// words by plain loads), kStages - 1 = 5 rows ahead of the one being summed.
// Thread (j, g) works out h[r, j] for its column and word from the staged
// row and adds it to the two input rows that r feeds, lo = (r - 1) >> 1
// and lo + 1; rows come in order, so each input row's terms arrive in the
// same order as in the gather, row lo is complete once r = 2 lo + 2 (or the
// last dy row) is added, and it is stored then.  So dy crosses from HBM
// once, plus a halo of 2 rows a tile and 2 columns a strip (from L2: tiles
// of one strip run side by side), each h is worked out once and kept in
// registers, and no thread waits on a load it just made.  The caller sizes the
// tiles so that the grid is one wave of kBwdBlocksPerSM blocks an SM
// (ops/resize2x.py:backward_plan); where the map has more tiles than that,
// each block walks over several and the ring runs on across them.  On the
// card a ring of 6 rows at 6 blocks an SM beat 4 at 8, 8 at 4 or 5, 10 at
// 4, 256-thread blocks with 32-column tiles and 128-channel tiles; L2 size
// hints on the copies and streaming stores of dx changed nothing (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

// Taps (a, b) and their weights (wa, wb) for output index k of a 2x axis of
// input size n.
__device__ __forceinline__ void taps(int k, int n, int& a, int& b, float& wa, float& wb) {
  const int o = k >> 1;
  const float den = (float)(2 * n - 1);
  if ((k & 1) == 0) {
    a = o > 0 ? o - 1 : 0;
    b = o;
    wa = (float)o / den;
    wb = 1.f - wa;
  } else {
    a = o;
    b = o + 1 < n ? o + 1 : n - 1;
    wb = (float)(n - 1 - o) / den;
    wa = 1.f - wb;
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    upsample2x_ac(const T* __restrict__ x, T* __restrict__ out, int h, int w, int c) {
  const int cv = c / V;  // packs per pixel
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= 2 * w * cv) return;
  const int oy = blockIdx.y;
  const int n = blockIdx.z;
  const int ox = i / cv;
  const int ch = (i - ox * cv) * V;

  int ya, yb, xa, xb;
  float wya, wyb, wxa, wxb;
  taps(oy, h, ya, yb, wya, wyb);
  taps(ox, w, xa, xb, wxa, wxb);

  using P = Pack<T, V>;
  const T* img = x + (int64_t)n * h * w * c;
  const P ra_a = *reinterpret_cast<const P*>(img + ((int64_t)ya * w + xa) * c + ch);
  const P rb_a = *reinterpret_cast<const P*>(img + ((int64_t)yb * w + xa) * c + ch);
  const P ra_b = *reinterpret_cast<const P*>(img + ((int64_t)ya * w + xb) * c + ch);
  const P rb_b = *reinterpret_cast<const P*>(img + ((int64_t)yb * w + xb) * c + ch);
  P res;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float ta = to_f32(ra_a.v[j]) * wya + to_f32(rb_a.v[j]) * wyb;  // column xa
    const float tb = to_f32(ra_b.v[j]) * wya + to_f32(rb_b.v[j]) * wyb;  // column xb
    res.v[j] = from_f32<T>(ta * wxa + tb * wxb);
  }
  *reinterpret_cast<P*>(out + (((int64_t)n * 2 * h + oy) * 2 * w + ox) * c + ch) = res;
}

// The weight that output index 2i + s - 1 (s = 0 .. 3) of a 2x axis of input
// size n gives input index i: zero where it lies outside the axis.
__device__ __forceinline__ float adjoint_weight(int i, int s, int n) {
  const int o = 2 * i + s - 1;
  if (o < 0 || o >= 2 * n) return 0.f;
  int a, b;
  float wa, wb;
  taps(o, n, a, b, wa, wb);
  return (a == i ? wa : 0.f) + (b == i ? wb : 0.f);
}

constexpr int kBwdThreads = 128;     // threads a block of B'
constexpr int kBwdBlocksPerSM = 6;   // the grid: one wave of 6 blocks an SM
constexpr int kStages = 6;           // dy rows in a block's ring
constexpr int kMaxGroups = 8;        // words across C a tile covers at most
constexpr int kMaxRows = 64;         // input rows a tile covers at most
// one staged dy row: 2 cols + 2 columns of `groups` words of at most 16
// bytes, with cols * groups <= kBwdThreads
constexpr int kStageBytes = (2 * kBwdThreads + 2 * kMaxGroups) * 16;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// One word of dy into shared memory: cp.async for 4, 8 and 16 bytes (16
// past L1), a plain load and store for 2.
template <typename P>
__device__ __forceinline__ void stage_word(P* dst, const P* src) {
  if constexpr (sizeof(P) == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)), "l"(src)
                 : "memory");
  } else if constexpr (sizeof(P) >= 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(smem_u32(dst)), "l"(src),
                 "n"((int)sizeof(P))
                 : "memory");
  } else {
    *dst = *src;
  }
}

// A tile of B': image, first word of its channel tile, first input column,
// input rows [i0, i1).  Tile t counts channel tiles fastest, then chunks of
// rows, strips of columns and images, so that the tiles that run side by
// side read whole pixels together and share their halo rows in L2.
struct BwdTile {
  int img, word0, j0, i0, i1;
};

__device__ __forceinline__ BwdTile bwd_tile(int t, int h, int groups, int cols, int rows,
                                            int ctiles, int strips, int chunks) {
  BwdTile p;
  p.word0 = (t % ctiles) * groups;
  t /= ctiles;
  const int chunk = t % chunks;
  t /= chunks;
  const int strip = t % strips;
  p.img = t / strips;
  p.j0 = strip * cols;
  p.i0 = chunk * rows;
  p.i1 = min(p.i0 + rows, h);
  return p;
}

// grid: one wave of blocks, block b takes tiles b, b + gridDim.x, ...; a
// tile is `steps` = 2 rows + 2 steps, one dy row each (rows outside the map
// are steps with no copy and no sum).  Thread (j, g) = (tid / groups, tid %
// groups) copies staged columns 2j and 2j + 1 of word g (thread j = 0 also
// the last two) and sums input column j0 + j, word word0 + g.
template <typename T, int V>
__global__ void __launch_bounds__(kBwdThreads, kBwdBlocksPerSM)
    upsample2x_bwd_kernel(const T* __restrict__ dy, T* __restrict__ dx, int h, int w, int c,
                          int groups, int rows, int ctiles, int strips, int chunks, int tiles) {
  using P = Pack<T, V>;
  __shared__ __align__(16) unsigned char ring[kStages][kStageBytes];
  // the tile's row weights by step: [0] that of row lo, [1] that of row lo + 1
  __shared__ float rw[2][2 * kMaxRows + 2];
  const int cols = kBwdThreads / groups;
  const int j = threadIdx.x / groups, g = threadIdx.x - j * groups;
  const bool lane = j < cols;  // threads past cols * groups only keep the barriers
  const int words = c / V;
  const int steps = 2 * rows + 2;
  const int stride = gridDim.x;
  const int total = (tiles - (int)blockIdx.x + stride - 1) / stride * steps;

  // the copies of one step, kStages - 1 steps ahead of the sums; one commit
  // group a step, empty or not
  int ik = 0, il = 0;
  BwdTile it = bwd_tile(blockIdx.x, h, groups, cols, rows, ctiles, strips, chunks);
  auto fetch = [&](int s) {
    if (s < total) {
      const int r = 2 * it.i0 - 1 + il;
      const int word = it.word0 + g;
      if (lane && r >= 0 && r <= min(2 * it.i1, 2 * h - 1) && word < words) {
        const P* row = reinterpret_cast<const P*>(dy + ((int64_t)it.img * 2 * h + r) * 2 * w * c) +
                       word;
        P* st = reinterpret_cast<P*>(ring[s % kStages]) + g;
        for (int sc = 2 * j; sc < 2 * cols + 2; sc += 2 * cols) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 2 * it.j0 - 1 + sc + e;
            if (col >= 0 && col < 2 * w)
              stage_word(st + (sc + e) * groups, row + (int64_t)col * words);
          }
        }
      }
      if (++il == steps) {
        il = 0;
        const int t = blockIdx.x + ++ik * stride;
        if (t < tiles) it = bwd_tile(t, h, groups, cols, rows, ctiles, strips, chunks);
      }
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };

#pragma unroll 1
  for (int s = 0; s < kStages - 1; ++s) fetch(s);

  BwdTile tc = bwd_tile(blockIdx.x, h, groups, cols, rows, ctiles, strips, chunks);
  int ck = 0, cl = 0;
  float cw[4];  // the weights of column j0 + j's taps 2 (j0 + j) - 1 + q
  float acc_lo[V], acc_hi[V];  // the sums of input rows lo and lo + 1
  bool act = false;
#pragma unroll 1
  for (int s = 0; s < total; ++s) {
    if (cl == 0) {  // a new tile: its column taps, its row weights, fresh sums
      if (s > 0) tc = bwd_tile(blockIdx.x + ++ck * stride, h, groups, cols, rows, ctiles, strips,
                               chunks);
      act = lane && tc.j0 + j < w && tc.word0 + g < words;
#pragma unroll
      for (int q = 0; q < 4; ++q) cw[q] = adjoint_weight(tc.j0 + j, q, w);
      for (int l = threadIdx.x; l < steps; l += kBwdThreads) {
        rw[0][l] = adjoint_weight(tc.i0 - 1 + (l >> 1), 2 + (l & 1), h);
        rw[1][l] = adjoint_weight(tc.i0 + (l >> 1), l & 1, h);
      }
#pragma unroll
      for (int k = 0; k < V; ++k) acc_lo[k] = acc_hi[k] = 0.f;
    } else if ((cl & 1) == 0) {  // lo moves down one row: lo + 1's sums become lo's
#pragma unroll
      for (int k = 0; k < V; ++k) {
        acc_lo[k] = acc_hi[k];
        acc_hi[k] = 0.f;
      }
    }
    fetch(s + kStages - 1);
    asm volatile("cp.async.wait_group %0;" ::"n"(kStages - 1) : "memory");
    __syncthreads();
    const int r = 2 * tc.i0 - 1 + cl;  // the staged dy row
    const int lo = tc.i0 - 1 + (cl >> 1);
    if (act && r >= 0 && r <= min(2 * tc.i1, 2 * h - 1)) {
      const P* st = reinterpret_cast<const P*>(ring[s % kStages]) + g;
      float t[V];
#pragma unroll
      for (int k = 0; k < V; ++k) t[k] = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (cw[q] == 0.f) continue;
        const P v = st[(2 * j + q) * groups];
#pragma unroll
        for (int k = 0; k < V; ++k) t[k] += cw[q] * to_f32(v.v[k]);
      }
      if (lo >= tc.i0) {
        const float wl = rw[0][cl];
#pragma unroll
        for (int k = 0; k < V; ++k) acc_lo[k] += wl * t[k];
        if ((cl & 1) || r == 2 * h - 1) {  // row lo has all its terms
          P res;
#pragma unroll
          for (int k = 0; k < V; ++k) res.v[k] = from_f32<T>(acc_lo[k]);
          *reinterpret_cast<P*>(dx + (((int64_t)tc.img * h + lo) * w + tc.j0 + j) * c +
                                (tc.word0 + g) * V) = res;
        }
      }
      if (lo + 1 < tc.i1) {
        const float wh = rw[1][cl];
#pragma unroll
        for (int k = 0; k < V; ++k) acc_hi[k] += wh * t[k];
      }
    }
    __syncthreads();  // the slot and the weights are free for the next copies
    if (++cl == steps) cl = 0;
  }
}

template <typename T, int V>
int launch_bwd(const void* dy, void* dx, int64_t n, int64_t h, int64_t w, int64_t c, int groups,
               int rows, int64_t grid, cudaStream_t stream) {
  const int64_t words = c / V;
  const int64_t cols = kBwdThreads / groups;
  const int64_t ctiles = (words + groups - 1) / groups;
  const int64_t strips = (w + cols - 1) / cols;
  const int64_t chunks = (h + rows - 1) / rows;
  const int64_t tiles = n * ctiles * strips * chunks;
  if (tiles >= (int64_t)1 << 31 || grid < 1 || grid > tiles)
    return (int)cudaErrorInvalidValue;
  upsample2x_bwd_kernel<T, V><<<(unsigned)grid, kBwdThreads, 0, stream>>>(
      static_cast<const T*>(dy), static_cast<T*>(dx), (int)h, (int)w, (int)c, groups, rows,
      (int)ctiles, (int)strips, (int)chunks, (int)tiles);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int launch(const void* x, void* out, int64_t n, int64_t h, int64_t w, int64_t c,
           cudaStream_t stream) {
  const int64_t row_packs = 2 * w * (c / V);
  const dim3 grid((unsigned)((row_packs + kThreads - 1) / kThreads), (unsigned)(2 * h),
                  (unsigned)n);
  upsample2x_ac<T, V><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(x),
                                                      static_cast<T*>(out), (int)h, (int)w,
                                                      (int)c);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  vec: channels per thread, 1 or the
// 16-byte width (4 for float32, 8 for bfloat16); the caller checks that C and
// both pointers allow it.  Returns the cudaError_t of the launch.
extern "C" int uegan_upsample2x(const void* x, void* out, int dtype, int64_t n, int64_t h,
                                int64_t w, int64_t c, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec == 1) return launch<float, 1>(x, out, n, h, w, c, s);
  if (dtype == 0 && vec == 4) return launch<float, 4>(x, out, n, h, w, c, s);
  if (dtype == 1 && vec == 1) return launch<__nv_bfloat16, 1>(x, out, n, h, w, c, s);
  if (dtype == 1 && vec == 8) return launch<__nv_bfloat16, 8>(x, out, n, h, w, c, s);
  return (int)cudaErrorInvalidValue;
}

// The backward: dy (n, 2h, 2w, c) -> dx (n, h, w, c), both in dtype.  vec:
// channels a word, 1, 2, 4 (or 8 for bfloat16), dividing C with both
// pointers aligned to the word; groups: words a tile spans across C (1 ..
// 8); rows: input rows a tile spans (1 .. 64); grid: blocks, at most the
// tiles (ops/resize2x.py:backward_plan).
extern "C" int uegan_upsample2x_bwd(const void* dy, void* dx, int dtype, int64_t n, int64_t h,
                                    int64_t w, int64_t c, int vec, int groups, int rows,
                                    int64_t grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (groups < 1 || groups > kMaxGroups || rows < 1 || rows > kMaxRows)
    return (int)cudaErrorInvalidValue;
#define UEGAN_UP_BWD(T, V) launch_bwd<T, V>(dy, dx, n, h, w, c, groups, rows, grid, s)
  if (dtype == 0) {
    switch (vec) {
      case 1: return UEGAN_UP_BWD(float, 1);
      case 2: return UEGAN_UP_BWD(float, 2);
      case 4: return UEGAN_UP_BWD(float, 4);
    }
  } else if (dtype == 1) {
    switch (vec) {
      case 1: return UEGAN_UP_BWD(__nv_bfloat16, 1);
      case 2: return UEGAN_UP_BWD(__nv_bfloat16, 2);
      case 4: return UEGAN_UP_BWD(__nv_bfloat16, 4);
      case 8: return UEGAN_UP_BWD(__nv_bfloat16, 8);
    }
  }
#undef UEGAN_UP_BWD
  return (int)cudaErrorInvalidValue;
}
