// Train-mode BatchNorm / InstanceNorm of a conv's output with the block's
// activation folded in, forward and backward, on NHWC maps.
//
// JAX's uegan_tpu/models/blocks.py:NormLayer (train=True) followed by the
// block's LeakyReLU, which XLA fuses on the TPU; the port's G and D blocks
// run conv -> norm -> act as one call of this pair, and so do NIMA's 53
// train-mode BatchNorms (flax's, uegan_tpu/models/nima.py) with their ReLU6,
// ReLU or no activation.  A map is read as G
// groups of `rows` pixels of C channels: instance norm takes one group an
// image (G = N, rows = H*W), batch norm one group for the batch (G = 1,
// rows = N*H*W), so one kernel serves both.  Per (group, channel), in f32:
//   forward:  mean, var = the mean and the biased variance over the group
//             z = (x - mean) * rsqrt(var + eps) * gamma + beta
//             y = z >= 0 ? min(z, cap) : slope * z  (slope 1, cap inf: no activation;
//                                                    slope 0, cap 6: ReLU6)
//             running_mean = (1 - m) running_mean + m * mean_G(mean)
//             running_var  = (1 - m) running_var + m * mean_G(var) * unbias
//                            (unbias cnt / max(cnt - 1, 1), or 1 for flax's rule)
//   backward: dz = 0 where z > cap, dy where 0 < z <= cap, slope * dy where
//             z < 0; at z == 0 dy, or slope * dy under `strict` (F.relu's
//             rule; torch.clamp's and jnp.where(z >= 0)'s pass dy there)
//             (z recomputed from x)
//             xh = (x - mean) * rstd
//             dx = gamma * rstd * (dz - sum(dz) / cnt - xh * sum(dz * xh) / cnt)
//             dgamma = sum over every row of dz * xh, dbeta of dz
// with cnt = rows, the sums over the group; y and dx are written in x's
// dtype.  The running statistics and the gradients of gamma and beta are
// float32 vectors of C.
//
// What bounds it on the card: bytes.  The forward must read x and write y,
// the backward read dy and x and write dx (a train step at the cell's
// shapes: about 2.05 GB, 0.61 ms at 3.35 TB/s).  Statistics need the whole
// group before any output, and blocks run in no order, so each direction
// is two launches from one C call on the caller's stream:
//
// - stats (norm_act_nhwc_stats_kernel, _bwd_stats_kernel): grid (splits,
//   channel tiles, G), gam_stats.cu's partition (ops/gam_stats.py:
//   split_plan).  Block (s, t, g) sums rows [s * chunk, (s + 1) * chunk) of
//   group g over a tile of at most 8 words of V channels (16 bytes a word
//   where C and the pointers allow); its threads add their sums in shared
//   memory in a fixed order and write them to a float32 scratch, and the
//   last block of (g, t), told by an integer ticket, adds the splits'
//   partials in split order (fixed_sum.cuh, as in gam_stats.cu).  No float
//   atomics, so a run gives the same bits every time, and the tickets are
//   left at zero for the next call.
//   The forward sums x - K and (x - K)^2, K the mean of the group's first 8
//   rows: shifted sums keep the variance's cancellation to the spread of the
//   data, not its mean, in one read of x, and a mean of 8 rows lies nearer
//   the group's mean than one row does (with the first row alone, an
//   outlying first pixel cost a float32 y up to 1.4e-5 at hw = 1024).  The backward sums dz and dz * xh.
// - apply (norm_act_nhwc_apply_kernel, _bwd_apply_kernel): the same grid;
//   each thread keeps one word of channels for its whole loop, so it works
//   out their mean, rstd, gamma and beta (and the backward's two sums) once
//   and its loop is a few multiply-adds an element.  The blocks (0, t, 0)
//   also fold the G groups' statistics into the running statistics (forward)
//   or the G groups' sums into dgamma and dbeta (backward), in group order.
//
// The apply launches read x a second time; at most of the step's shapes the
// stats launch has just left much of it in the 50 MB L2.  The forward's apply
// walks each run back to front: the stats blocks, one wave, each walk their
// run front to back, so when they end the L2 holds the tail of every run,
// and the apply reads those words first.
//
// The GAM's non-affine instance norm at inference (ops/gam_norm.py) is this
// forward with gamma 1, beta 0, slope 1 and no running statistics: per
// image, (x - mean) * rsqrt(var + eps), y in x's dtype.  Its caller cuts
// each image into the runs a batch of 16 gets, whatever the batch, so that
// an image's sums, and its output, do not depend on the batch it came in.

#include <cmath>

#include "fixed_sum.cuh"

namespace {

constexpr int kUnroll = 8;       // words a thread loads before it adds them (one input)
constexpr int kUnrollBwd = 4;    // the same for the backward's two inputs
constexpr int kBlocksPerSM = 2;  // the plan's grid is one wave of 2 blocks an SM
constexpr int kShiftRows = 8;    // rows whose mean shifts the forward's sums

// The activation at z, and its derivative at z times g: see the header.
// Clamp false (cap inf, strict 0: the LeakyReLU and no activation) takes the
// one-compare forms; the kernels are built for both, so the norm layers'
// and the GAM norm's calls run no instruction of the clamp.
template <bool Clamp>
__device__ __forceinline__ float act(float z, float slope, float cap) {
  if constexpr (Clamp) {
    return z >= 0.f ? fminf(z, cap) : slope * z;
  } else {
    return z >= 0.f ? z : slope * z;
  }
}

template <bool Clamp>
__device__ __forceinline__ float act_grad(float z, float g, float slope, float cap, int strict) {
  if constexpr (Clamp) {
    if (z > cap) return 0.f;
    return (z > 0.f || (z == 0.f && !strict)) ? g : slope * g;
  } else {
    return z >= 0.f ? g : slope * g;
  }
}

// A block's place in the partition: grid (splits, tiles, groups), a tile
// of gt words of V channels, kThreads / gt rows side by side.
struct Place {
  int split, tile, grp, lanes, g, r, c0, width, cb, ch;
  bool active;
  int64_t p0, p1;
  __device__ Place(int64_t rows, int c, int gt, int64_t chunk, int V) {
    split = blockIdx.x;
    tile = blockIdx.y;
    grp = blockIdx.z;
    lanes = kThreads / gt;
    g = threadIdx.x % gt;
    r = threadIdx.x / gt;
    c0 = tile * gt * V;
    width = gt * V;
    cb = min(width, c - c0);
    ch = c0 + g * V;
    active = r < lanes && ch < c;
    p0 = (int64_t)split * chunk;
    p1 = p0 + chunk < rows ? p0 + chunk : rows;
  }
};

// The shifts K of the V channels of a group's word at p (its first row): the
// mean of the group's first kShiftRows rows, or of all of them where it has
// fewer.  Every block of the group (V words) and the combine (V = 1) compute
// it alike, to the bit.
template <typename T, int V>
__device__ __forceinline__ void shift_of(const T* p, int c, int64_t rows, float (&K)[V]) {
  const int n = rows < kShiftRows ? (int)rows : kShiftRows;
#pragma unroll
  for (int k = 0; k < V; ++k) K[k] = 0.f;
  for (int q = 0; q < n; ++q) {
    const Pack<T, V> w = *reinterpret_cast<const Pack<T, V>*>(p + (int64_t)q * c);
#pragma unroll
    for (int k = 0; k < V; ++k) K[k] += to_f32(w.v[k]);
  }
#pragma unroll
  for (int k = 0; k < V; ++k) K[k] /= (float)n;
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    norm_act_nhwc_stats_kernel(const T* __restrict__ x, float* __restrict__ part,
                               unsigned* __restrict__ ticket, float* __restrict__ mean,
                               float* __restrict__ var, int64_t rows, int c, int gt,
                               int64_t chunk) {
  __shared__ float sh[2][kThreads * V];
  const Place pl(rows, c, gt, chunk, V);
  const T* base = x + (int64_t)pl.grp * rows * c;
  float s1[V], s2[V];
#pragma unroll
  for (int k = 0; k < V; ++k) s1[k] = s2[k] = 0.f;
  if (pl.active) {
    float K[V];
    shift_of<T, V>(base + pl.ch, c, rows, K);
    const int64_t step = (int64_t)pl.lanes;
    for (int64_t p = pl.p0 + pl.r; p < pl.p1; p += step * kUnroll) {
      Pack<T, V> v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t q = p + u * step;
        if (q < pl.p1) v[u] = load_once(reinterpret_cast<const Pack<T, V>*>(base + q * c + pl.ch));
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (p + u * step < pl.p1) {
#pragma unroll
          for (int k = 0; k < V; ++k) {
            const float d = to_f32(v[u].v[k]) - K[k];
            s1[k] += d;
            s2[k] = fmaf(d, d, s2[k]);
          }
        }
      }
    }
  }
  const float cnt = (float)rows;
  combine_splits<V>(sh, s1, s2, part, ticket, c, pl.grp, pl.split, pl.tile, pl.lanes,
                    pl.c0, pl.width, pl.cb, [&](int j, float a, float b) {
    const float md = a / cnt;
    const float v = fmaxf(b / cnt - md * md, 0.f);
    const int64_t at = (int64_t)pl.grp * c + pl.c0 + j;
    float k0[1];
    shift_of<T, 1>(base + pl.c0 + j, c, rows, k0);
    mean[at] = k0[0] + md;
    var[at] = v;
  });
}

template <typename T, int V, bool Clamp>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    norm_act_nhwc_apply_kernel(const T* __restrict__ x, T* __restrict__ y,
                               const float* __restrict__ mean, const float* __restrict__ var,
                               const float* __restrict__ gamma, const float* __restrict__ beta,
                               float* __restrict__ run_mean, float* __restrict__ run_var,
                               int64_t rows, int c, int gt, int64_t chunk, int groups, float eps,
                               float slope, float momentum, float unbias, float cap) {
  const Place pl(rows, c, gt, chunk, V);
  if (run_mean != nullptr && blockIdx.x == 0 && blockIdx.z == 0) {
    for (int j = threadIdx.x; j < pl.cb; j += kThreads) {
      const int ch = pl.c0 + j;
      float a = 0.f, b = 0.f;
      for (int q = 0; q < groups; ++q) {
        a += mean[(int64_t)q * c + ch];
        b += var[(int64_t)q * c + ch];
      }
      run_mean[ch] = (1.f - momentum) * run_mean[ch] + momentum * (a / (float)groups);
      run_var[ch] = (1.f - momentum) * run_var[ch] + momentum * ((b / (float)groups) * unbias);
    }
  }
  if (!pl.active || pl.p0 + pl.r >= pl.p1) return;
  float m[V], rs[V], ga[V], be[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int64_t at = (int64_t)pl.grp * c + pl.ch + k;
    m[k] = mean[at];
    rs[k] = __frsqrt_rn(var[at] + eps);
    ga[k] = gamma[pl.ch + k];
    be[k] = beta[pl.ch + k];
  }
  const int64_t off = (int64_t)pl.grp * rows * c + pl.ch;
  const T* xb = x + off;
  T* yb = y + off;
  const int64_t step = (int64_t)pl.lanes;
  const int64_t stride = step * kUnroll;
  // back to front: from the last step the stats loop made in this run to its
  // first, so the first words read are the ones the stats launch read last
  for (int64_t p = pl.p0 + pl.r + (pl.p1 - 1 - pl.p0 - pl.r) / stride * stride; p >= pl.p0;
       p -= stride) {
    Pack<T, V> v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t q = p + u * step;
      if (q < pl.p1) v[u] = load_once(reinterpret_cast<const Pack<T, V>*>(xb + q * c));
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t q = p + u * step;
      if (q < pl.p1) {
        Pack<T, V> o;
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float xh = (to_f32(v[u].v[k]) - m[k]) * rs[k];
          const float z = fmaf(xh, ga[k], be[k]);
          o.v[k] = from_f32<T>(act<Clamp>(z, slope, cap));
        }
        store_once(reinterpret_cast<Pack<T, V>*>(yb + q * c), o);
      }
    }
  }
}

template <typename T, int V, bool Clamp>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    norm_act_nhwc_bwd_stats_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                                   const float* __restrict__ mean,
                                   const float* __restrict__ var,
                                   const float* __restrict__ gamma,
                                   const float* __restrict__ beta, float* __restrict__ part,
                                   unsigned* __restrict__ ticket, float* __restrict__ sdz,
                                   float* __restrict__ sdzx, int64_t rows, int c, int gt,
                                   int64_t chunk, float eps, float slope, float cap,
                                   int strict) {
  __shared__ float sh[2][kThreads * V];
  const Place pl(rows, c, gt, chunk, V);
  float s1[V], s2[V];
#pragma unroll
  for (int k = 0; k < V; ++k) s1[k] = s2[k] = 0.f;
  if (pl.active) {
    float m[V], rs[V], ga[V], be[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int64_t at = (int64_t)pl.grp * c + pl.ch + k;
      m[k] = mean[at];
      rs[k] = __frsqrt_rn(var[at] + eps);
      ga[k] = gamma[pl.ch + k];
      be[k] = beta[pl.ch + k];
    }
    const int64_t off = (int64_t)pl.grp * rows * c + pl.ch;
    const T* xb = x + off;
    const T* db = dy + off;
    const int64_t step = (int64_t)pl.lanes;
    for (int64_t p = pl.p0 + pl.r; p < pl.p1; p += step * kUnrollBwd) {
      Pack<T, V> xv[kUnrollBwd], dv[kUnrollBwd];
#pragma unroll
      for (int u = 0; u < kUnrollBwd; ++u) {
        const int64_t q = p + u * step;
        if (q < pl.p1) {
          xv[u] = load_once(reinterpret_cast<const Pack<T, V>*>(xb + q * c));
          dv[u] = load_once(reinterpret_cast<const Pack<T, V>*>(db + q * c));
        }
      }
#pragma unroll
      for (int u = 0; u < kUnrollBwd; ++u) {
        if (p + u * step < pl.p1) {
#pragma unroll
          for (int k = 0; k < V; ++k) {
            const float xh = (to_f32(xv[u].v[k]) - m[k]) * rs[k];
            const float z = fmaf(xh, ga[k], be[k]);
            const float g = to_f32(dv[u].v[k]);
            const float dz = act_grad<Clamp>(z, g, slope, cap, strict);
            s1[k] += dz;
            s2[k] = fmaf(dz, xh, s2[k]);
          }
        }
      }
    }
  }
  combine_splits<V>(sh, s1, s2, part, ticket, c, pl.grp, pl.split, pl.tile, pl.lanes,
                    pl.c0, pl.width, pl.cb, [&](int j, float a, float b) {
    const int64_t at = (int64_t)pl.grp * c + pl.c0 + j;
    sdz[at] = a;
    sdzx[at] = b;
  });
}

template <typename T, int V, bool Clamp>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    norm_act_nhwc_bwd_apply_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                                   T* __restrict__ dx, const float* __restrict__ mean,
                                   const float* __restrict__ var,
                                   const float* __restrict__ gamma,
                                   const float* __restrict__ beta,
                                   const float* __restrict__ sdz,
                                   const float* __restrict__ sdzx, float* __restrict__ dgamma,
                                   float* __restrict__ dbeta, int64_t rows, int c, int gt,
                                   int64_t chunk, int groups, float eps, float slope,
                                   float cap, int strict) {
  const Place pl(rows, c, gt, chunk, V);
  if (blockIdx.x == 0 && blockIdx.z == 0) {
    for (int j = threadIdx.x; j < pl.cb; j += kThreads) {
      const int ch = pl.c0 + j;
      float a = 0.f, b = 0.f;
      for (int q = 0; q < groups; ++q) {
        a += sdzx[(int64_t)q * c + ch];
        b += sdz[(int64_t)q * c + ch];
      }
      dgamma[ch] = a;
      dbeta[ch] = b;
    }
  }
  if (!pl.active) return;
  const float cnt = (float)rows;
  float m[V], rs[V], ga[V], be[V], kk[V], m1[V], m2[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int64_t at = (int64_t)pl.grp * c + pl.ch + k;
    m[k] = mean[at];
    rs[k] = __frsqrt_rn(var[at] + eps);
    ga[k] = gamma[pl.ch + k];
    be[k] = beta[pl.ch + k];
    kk[k] = ga[k] * rs[k];
    m1[k] = sdz[at] / cnt;
    m2[k] = sdzx[at] / cnt;
  }
  const int64_t off = (int64_t)pl.grp * rows * c + pl.ch;
  const T* xb = x + off;
  const T* db = dy + off;
  T* ob = dx + off;
  const int64_t step = (int64_t)pl.lanes;
  for (int64_t p = pl.p0 + pl.r; p < pl.p1; p += step * kUnrollBwd) {
    Pack<T, V> xv[kUnrollBwd], dv[kUnrollBwd];
#pragma unroll
    for (int u = 0; u < kUnrollBwd; ++u) {
      const int64_t q = p + u * step;
      if (q < pl.p1) {
        xv[u] = load_once(reinterpret_cast<const Pack<T, V>*>(xb + q * c));
        dv[u] = load_once(reinterpret_cast<const Pack<T, V>*>(db + q * c));
      }
    }
#pragma unroll
    for (int u = 0; u < kUnrollBwd; ++u) {
      const int64_t q = p + u * step;
      if (q < pl.p1) {
        Pack<T, V> o;
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float xh = (to_f32(xv[u].v[k]) - m[k]) * rs[k];
          const float z = fmaf(xh, ga[k], be[k]);
          const float g = to_f32(dv[u].v[k]);
          const float dz = act_grad<Clamp>(z, g, slope, cap, strict);
          o.v[k] = from_f32<T>(kk[k] * (dz - m1[k] - xh * m2[k]));
        }
        store_once(reinterpret_cast<Pack<T, V>*>(ob + q * c), o);
      }
    }
  }
}

struct Args {
  int64_t groups, rows, c, gt, splits, chunk;
};

template <typename T, int V, bool Clamp>
int launch_fwd(const Args& a, const void* x, void* y, void* part, void* ticket, void* mean,
               void* var, const void* gamma, const void* beta, void* run_mean, void* run_var,
               float eps, float slope, float momentum, float unbias, float cap,
               cudaStream_t s) {
  const int64_t tiles = (a.c + a.gt * V - 1) / (a.gt * V);
  const dim3 grid((unsigned)a.splits, (unsigned)tiles, (unsigned)a.groups);
  norm_act_nhwc_stats_kernel<T, V><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<float*>(part), static_cast<unsigned*>(ticket),
      static_cast<float*>(mean), static_cast<float*>(var), a.rows, (int)a.c, (int)a.gt,
      a.chunk);
  norm_act_nhwc_apply_kernel<T, V, Clamp><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(y), static_cast<const float*>(mean),
      static_cast<const float*>(var), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<float*>(run_mean),
      static_cast<float*>(run_var), a.rows, (int)a.c, (int)a.gt, a.chunk, (int)a.groups, eps,
      slope, momentum, unbias, cap);
  return (int)cudaGetLastError();
}

template <typename T, int V, bool Clamp>
int launch_bwd(const Args& a, const void* dy, const void* x, void* dx, void* part, void* ticket,
               const void* mean, const void* var, const void* gamma, const void* beta,
               void* sdz, void* sdzx, void* dgamma, void* dbeta, float eps, float slope,
               float cap, int strict, cudaStream_t s) {
  const int64_t tiles = (a.c + a.gt * V - 1) / (a.gt * V);
  const dim3 grid((unsigned)a.splits, (unsigned)tiles, (unsigned)a.groups);
  norm_act_nhwc_bwd_stats_kernel<T, V, Clamp><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(dy), static_cast<const T*>(x), static_cast<const float*>(mean),
      static_cast<const float*>(var), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<float*>(part), static_cast<unsigned*>(ticket),
      static_cast<float*>(sdz), static_cast<float*>(sdzx), a.rows, (int)a.c, (int)a.gt,
      a.chunk, eps, slope, cap, strict);
  norm_act_nhwc_bwd_apply_kernel<T, V, Clamp><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(dy), static_cast<const T*>(x), static_cast<T*>(dx),
      static_cast<const float*>(mean), static_cast<const float*>(var),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<const float*>(sdz), static_cast<const float*>(sdzx),
      static_cast<float*>(dgamma), static_cast<float*>(dbeta), a.rows, (int)a.c, (int)a.gt,
      a.chunk, (int)a.groups, eps, slope, cap, strict);
  return (int)cudaGetLastError();
}

// vec -> the kernels' V; 8 only for bfloat16 (16 bytes)
#define UEGAN_NORM_DISPATCH(T, vec, CALL) \
  switch (vec) {                          \
    case 1: return CALL(T, 1);            \
    case 2: return CALL(T, 2);            \
    case 4: return CALL(T, 4);            \
    case 8:                               \
      if constexpr (sizeof(T) == 2) return CALL(T, 8); \
      break;                              \
  }

template <typename T>
int fwd_vec(int vec, const Args& a, const void* x, void* y, void* part, void* ticket,
            void* mean, void* var, const void* gamma, const void* beta, void* run_mean,
            void* run_var, float eps, float slope, float momentum, float unbias, float cap,
            cudaStream_t s) {
#define UEGAN_NORM_FWD(TT, V)                                                                  \
  (std::isinf(cap) ? launch_fwd<TT, V, false>(a, x, y, part, ticket, mean, var, gamma, beta,         \
                                         run_mean, run_var, eps, slope, momentum, unbias, cap, s) \
              : launch_fwd<TT, V, true>(a, x, y, part, ticket, mean, var, gamma, beta,          \
                                        run_mean, run_var, eps, slope, momentum, unbias, cap, s))
  UEGAN_NORM_DISPATCH(T, vec, UEGAN_NORM_FWD)
#undef UEGAN_NORM_FWD
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int bwd_vec(int vec, const Args& a, const void* dy, const void* x, void* dx, void* part,
            void* ticket, const void* mean, const void* var, const void* gamma,
            const void* beta, void* sdz, void* sdzx, void* dgamma, void* dbeta, float eps,
            float slope, float cap, int strict, cudaStream_t s) {
#define UEGAN_NORM_BWD(TT, V)                                                                  \
  (std::isinf(cap) && !strict                                                                       \
       ? launch_bwd<TT, V, false>(a, dy, x, dx, part, ticket, mean, var, gamma, beta, sdz,     \
                                  sdzx, dgamma, dbeta, eps, slope, cap, strict, s)             \
       : launch_bwd<TT, V, true>(a, dy, x, dx, part, ticket, mean, var, gamma, beta, sdz,      \
                                 sdzx, dgamma, dbeta, eps, slope, cap, strict, s))
  UEGAN_NORM_DISPATCH(T, vec, UEGAN_NORM_BWD)
#undef UEGAN_NORM_BWD
  return (int)cudaErrorInvalidValue;
}

bool bad_args(const Args& a) {
  return a.gt < 1 || a.gt > kThreads || a.groups < 1 || a.groups > 65535 || a.rows < 1 ||
         a.splits < 1 || a.chunk < 1;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  x, y: (groups * rows, c) contiguous,
// rows of c channels; vec: channels a thread reads as one word (c % vec == 0,
// every map pointer aligned to vec * itemsize); gt: words a block covers;
// splits, chunk: each group's rows cut into `splits` runs of `chunk`.  part:
// (groups, splits, 2, c) float32 scratch; ticket: groups * ceil(c / (gt *
// vec)) zeroed unsigned counters, left zeroed.  mean, var: (groups, c)
// float32 outputs (the biased variance); gamma, beta: c float32.  run_mean,
// run_var: c float32, updated in place with `momentum` (var times `unbias`,
// cnt / max(cnt - 1, 1), or 1), or both null.  slope: the LeakyReLU's (1
// for none); cap: the upper clamp (ReLU6's 6; inf for none).  Returns the
// cudaError_t of the launches (0 on success).
extern "C" int uegan_norm_act(const void* x, void* y, void* part, void* ticket, void* mean,
                              void* var, const void* gamma, const void* beta, void* run_mean,
                              void* run_var, int dtype, int64_t groups, int64_t rows, int64_t c,
                              int vec, int64_t gt, int64_t splits, int64_t chunk, float eps,
                              float slope, float momentum, float unbias, float cap,
                              void* stream) {
  const Args a{groups, rows, c, gt, splits, chunk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_args(a) || (run_mean == nullptr) != (run_var == nullptr))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return fwd_vec<float>(vec, a, x, y, part, ticket, mean, var, gamma, beta, run_mean, run_var,
                          eps, slope, momentum, unbias, cap, s);
  if (dtype == 1)
    return fwd_vec<__nv_bfloat16>(vec, a, x, y, part, ticket, mean, var, gamma, beta, run_mean,
                                  run_var, eps, slope, momentum, unbias, cap, s);
  return (int)cudaErrorInvalidValue;
}

// The backward: dy, x, dx as x above; mean, var the forward's; sdz, sdzx:
// (groups, c) float32 scratch (each group's sums of dz and dz * xh); dgamma,
// dbeta: c float32 outputs; slope, cap as the forward's; strict: 1 for
// F.relu's derivative at z == 0 (slope * dy), 0 for dy there.
extern "C" int uegan_norm_act_bwd(const void* dy, const void* x, void* dx, void* part,
                                  void* ticket, const void* mean, const void* var,
                                  const void* gamma, const void* beta, void* sdz, void* sdzx,
                                  void* dgamma, void* dbeta, int dtype, int64_t groups,
                                  int64_t rows, int64_t c, int vec, int64_t gt, int64_t splits,
                                  int64_t chunk, float eps, float slope, float cap, int strict,
                                  void* stream) {
  const Args a{groups, rows, c, gt, splits, chunk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_args(a)) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return bwd_vec<float>(vec, a, dy, x, dx, part, ticket, mean, var, gamma, beta, sdz, sdzx,
                          dgamma, dbeta, eps, slope, cap, strict, s);
  if (dtype == 1)
    return bwd_vec<__nv_bfloat16>(vec, a, dy, x, dx, part, ticket, mean, var, gamma, beta, sdz,
                                  sdzx, dgamma, dbeta, eps, slope, cap, strict, s);
  return (int)cudaErrorInvalidValue;
}
