// What the channels-last reduction kernels share (gam_stats.cu, its backward
// gam_stats_bwd.cu, norm_act.cu): one word of V channels a thread, read and
// written once, and a fixed-order sum of per-block partials across the
// blocks of a grid, with no float atomics.
//
// The sum: a grid of (splits, channel tiles, groups) blocks, block (s, t, g)
// holding its threads' f32 sums of two quantities for its rows of group g
// over tile t's channels.  combine_splits adds the threads' sums in shared
// memory in a fixed order and writes them to a (groups, splits, 2, c) f32
// scratch; the last block of (g, t) to finish, told by an integer ticket
// (one acquire-release add a block), adds the splits' partials in split
// order and resets the ticket to 0, so the counters live across calls (one
// set a stream) and a CUDA graph can replay the launch.  A run gives the
// same bits every time.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

// One word, read once: a 16-byte word past L1 with an L2 prefetch of the
// 256-byte sector around it, which the thread's neighbours read next.
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

// One word of an output, written once and not read again by the kernel: a
// 16-byte word with the streaming (evict-first) hint.
template <typename P>
__device__ __forceinline__ void store_once(P* p, const P& v) {
  if constexpr (sizeof(P) == 16) {
    const int4 r = *reinterpret_cast<const int4*>(&v);
    asm volatile("st.global.cs.v4.s32 [%0], {%1, %2, %3, %4};" ::"l"(p), "r"(r.x), "r"(r.y),
                 "r"(r.z), "r"(r.w)
                 : "memory");
  } else {
    *p = v;
  }
}

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

// Block (split, tile, grp) of a grid (splits, tiles, groups): thread (r, g)
// holds sums s1, s2 of row r of `lanes`, channels c0 + g * V .. + V - 1 of
// the tile's `width` (of which the first cb exist).  The block's column sums
// go to part[grp][split][0..1][c0 ..]; the last block of (grp, tile) then
// adds every split's partials in split order and hands each channel's two
// sums to emit(j, s1, s2), j from 0 to cb; the other blocks return.
template <int V, typename Emit>
__device__ __forceinline__ void combine_splits(float (&sh)[2][kThreads * V], const float (&s1)[V],
                                               const float (&s2)[V], float* part,
                                               unsigned* ticket, int c, int grp, int split,
                                               int tile, int lanes, int c0, int width, int cb,
                                               Emit emit) {
  __shared__ bool is_last;
  const int splits = gridDim.x;
  // a row of sh per thread; read from a copy, since column_sums writes sh
  // in place
  float* mine1 = &sh[0][threadIdx.x * V];
  float* mine2 = &sh[1][threadIdx.x * V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    mine1[k] = s1[k];
    mine2[k] = s2[k];
  }
  __syncthreads();
  float* out = part + ((int64_t)grp * splits + split) * 2 * c + c0;
  column_sums(
      sh, lanes, width,
      [&](int rr, int j) { return make_float2(sh[0][rr * width + j], sh[1][rr * width + j]); },
      [&](int j, float a, float b) {
        if (j < cb) {
          out[j] = a;
          out[c + j] = b;
        }
      });
  // take a ticket: thread 0's add releases the block's partials (the
  // barrier orders every thread's writes before it) and acquires the other
  // blocks' (the barrier after it orders every thread's reads)
  __syncthreads();
  unsigned* tk = ticket + (int64_t)grp * gridDim.y + tile;
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
  const float* all = part + (int64_t)grp * splits * 2 * c + c0;
  column_sums(
      sh, splits, cb,
      [&](int s, int j) {
        const float* p = all + (int64_t)s * 2 * c + j;
        return make_float2(__ldcg(p), __ldcg(p + c));
      },
      emit);
  if (threadIdx.x == 0) *tk = 0u;
}

}  // namespace
