// The tensor-core body that kernel E (packed_conv_int8.cu) and kernel F in
// bf16 (packed_conv.cu) share: a stride-1 SxS convolution of an NHWC map as
// an implicit GEMM on Hopper's TMA and wgmma, with the caller's epilogue
// applied to the register sums before the single store.
//
//   out[n, l, w, o] = epi(sum_{si, sj, c} x[n, l + si - s0, w + sj - s0, c]
//                                          * k[o, si, sj, c])
//
// with zero padding on both axes (rows and columns outside the map read 0).
// The TPU kernels zero-pad the rows and wrap the columns, so their output
// columns [0, s0) and [W - s1, W) are unspecified and the callers overwrite
// them; here those columns hold the zero-padded conv, and every column
// equals the plain PyTorch versions.
//
// GEMM view.  M is the output pixels, N is Cout, K is one tap (si, sj) x a
// 128-byte chunk of channels (64 bf16 or 128 int8).  An M tile is a box of
// tr rows x tw columns of one image, tw * tr = 128 (tw = 128 at W >= 128).
// In NHWC the channels of a pixel are contiguous, so the A tile of tap
// (si, sj) is the input box shifted by (si - s0, sj - s0): one TMA tiled
// load of the 4-d map (C, W, L, N).  Its coordinates may fall outside the
// map, and TMA fills those elements with zeros: that is the zero padding,
// with no masking code.  The weights come from the wrapper K-major, (Cout,
// S*S, Cpad), and the B tile of one K step is one TMA load of 128 output
// channels x the same 128-byte chunk.  Both land in 128-byte-swizzled
// shared memory, the layout wgmma reads.  Where the whole K is one step and
// Cout one N tile (E at its 1x1 main-path site: 16 KB of weights), every
// tile has the same B: the producer loads it once, into stage 0's B slot,
// and it stays resident there, so the L2 sends the SMs activations only.
//
// A block is persistent (one per SM, 200 KB of shared memory) and walks the
// tiles with a stride of the grid.  Warps 0-7 are two consumer warpgroups,
// each taking 64 rows of the M tile with wgmma m64n128k16 (bf16 -> f32) or
// m64n128k32 (s8 -> s32, exact).  Warp 8 is the producer: one thread keeps
// a ring of kStages stages (A 16 KB + B 16 KB each) filled by TMA, with a
// full and an empty mbarrier a stage, running ahead across tile edges so
// that one tile's epilogue overlaps the next tile's loads.  A consumer
// keeps one wgmma group in flight and frees a stage when the group that
// read it has retired.
//
// Epilogue.  The caller's functor turns each register sum into the output
// element in the same rounded operations as the plain version.  Its
// activation and options are template constants, so the epilogue is
// straight-line code (with runtime switches the compiler predicated the
// tanh and requant paths into every element).  Each tile's per-channel
// parameters go to shared memory, one channel a thread; then every value is
// computed from loads alone, then every value is stored, so that no load
// waits behind a store.  The tile is staged in shared memory (rows padded by
// 16 bytes: conflict-free) and written with 16-byte coalesced streaming
// stores.  An optional bf16 factor `mul` of the output's shape is fetched by
// cp.async into shared memory as a tile, issued before the tile's main loop.
// Rows of Cout * element bytes that are not a multiple of 16 (ragged shapes
// only) take an element-wise copy.
//
// The wrapper guarantees what TMA needs: Cpad * element bytes a multiple of
// 16 (it zero-pads the channels of x and k otherwise) and 16-byte-aligned
// bases.  Cout > 128 takes several N tiles (n fastest, so the two tiles of
// one M tile find A in L2); a ragged N tile reads zero weights past Cout and
// is masked at the store.
//
// What bounds the kernels on the card: E at its 1x1 main-path site is a
// byte stream (67 MB in, 134 MB out), and the epilogue's work per byte
// decides how close it comes; E at the 3x3 sites and F are bound by the
// tensor cores' multiply-adds, and at this tile shape by the rate at which
// TMA brings the A and B tiles from L2 (32 KB a K step for 2 M
// multiply-adds), which the main loop waits on.
// F in float32 does not use this body: TF32 tensor cores would miss F's f32
// tolerance, so it stays on the CUDA cores (packed_conv.cu).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc_conv {

constexpr int kBM = 128;                 // output pixels a tile
constexpr int kBN = 128;                 // output channels a tile
constexpr int kRowBytes = 128;           // K bytes a stage: one swizzle row
constexpr int kTileBytes = kBM * kRowBytes;  // A tile; B (kBN rows) the same
constexpr int kStages = 4;
constexpr int kPitch = kBN * 2 + 16;     // bytes a staged epilogue row
constexpr int kEpiBytes = 64 * kPitch;   // one warpgroup's staged rows
constexpr int kThreads = 288;            // 2 consumer warpgroups + 1 producer warp
constexpr int kSmemBytes =
    2 * kStages * kTileBytes + 4 * kEpiBytes + 2 * kBN * 8 + 2 * kStages * 8 + 1024;

struct Geometry {
  int n, l, w;        // input (and output) map
  int cout;
  int S, s0;
  int chunks;         // 128-byte channel chunks of one tap
  int per_chunk;      // channels a chunk
  int tw, twl, tr;    // M box: tw = 1 << twl columns x tr rows
  int tiles_w, tiles_l, tiles_n, tiles;
};

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// barrier over one consumer warpgroup (ids 1, 2; 0 is __syncthreads)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;" ::"r"(wg + 1) : "memory");
}

// wgmma operand descriptor of a K-major tile in 128-byte-swizzled shared
// memory: 8-row groups 1024 bytes apart, stage buffers 1024-aligned.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

#define TC_OPS8(c, a, i) \
  c(a[i]), c(a[i + 1]), c(a[i + 2]), c(a[i + 3]), c(a[i + 4]), c(a[i + 5]), c(a[i + 6]), c(a[i + 7])
#define TC_OPS64(c, a)                                                                         \
  TC_OPS8(c, a, 0), TC_OPS8(c, a, 8), TC_OPS8(c, a, 16), TC_OPS8(c, a, 24), TC_OPS8(c, a, 32), \
      TC_OPS8(c, a, 40), TC_OPS8(c, a, 48), TC_OPS8(c, a, 56)
#define TC_REGS64                                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "  \
  "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "  \
  "%56, %57, %58, %59, %60, %61, %62, %63}"

// One 32-byte K slice of a 64 x 128 product: d (+)= A * B^T.
__device__ __forceinline__ void mma(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " TC_REGS64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : TC_OPS64("+f", d)
      : "l"(da), "l"(db), "r"(accumulate));
}
__device__ __forceinline__ void mma(int (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " TC_REGS64 ", %64, %65, p;\n}\n"
      : TC_OPS64("+r", d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// Keep the compiler from touching the sums before the wgmma that writes
// them has retired.
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_regs(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

template <typename T>
struct Elem;
template <>
struct Elem<int8_t> {
  using Acc = int;
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_UINT8;  // bits copied
};
template <>
struct Elem<__nv_bfloat16> {
  using Acc = float;
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};

struct Tile {
  int img, l0, w0, n0;
};

__device__ __forceinline__ Tile tile_of(int t, const Geometry& g) {
  Tile o;
  o.n0 = (t % g.tiles_n) * kBN;
  t /= g.tiles_n;
  o.w0 = (t % g.tiles_w) * g.tw;
  t /= g.tiles_w;
  o.l0 = (t % g.tiles_l) * g.tr;
  o.img = t / g.tiles_l;
  return o;
}

// Row `row` (0..63) of warpgroup wg's half of the tile: its pixel index,
// or false where the box runs past the map.
__device__ __forceinline__ bool pixel_of(int wg, int row, const Tile& tl, const Geometry& g,
                                         size_t& pix) {
  const int m = wg * 64 + row;
  const int l = tl.l0 + (m >> g.twl), w = tl.w0 + (m & (g.tw - 1));
  pix = ((size_t)tl.img * g.l + l) * g.w + w;
  return l < g.l && w < g.w;
}

// Epi: a functor with fields `mul` (bf16 of the output's shape, read when
// the constant kMul is true) and `out`, the constant kOutBytes (bytes an
// output element), and the activation and every option as template
// constants, so that the epilogue is straight-line code; `param(o)` loads output
// channel o's parameters (a `Param`), `epi(sum, param, mul_value)` returns
// the f32 value and `store2(dst, v0, v1)` writes the output elements of two
// neighbouring channels.
template <typename T, typename Epi>
__global__ void __launch_bounds__(kThreads, 1)
    conv_kernel(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_k,
                Geometry g, Epi epi, int vec_out, int vec_mul) {
  using Acc = typename Elem<T>::Acc;
  using Param = typename Epi::Param;
  static_assert(sizeof(Param) <= 8, "a channel's epilogue parameters take 8 bytes at most");
  extern __shared__ uint8_t smem_raw[];
  // offsets from smem_raw keep the compiler's view of these as shared memory
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* a_st = smem;
  uint8_t* b_st = a_st + kStages * kTileBytes;
  uint8_t* epi_out = b_st + kStages * kTileBytes;
  uint8_t* epi_mul = epi_out + 2 * kEpiBytes;
  uint8_t* epi_prm = epi_mul + 2 * kEpiBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(epi_prm + 2 * kBN * 8);
  uint64_t* empty = full + kStages;

  const int warp = threadIdx.x / 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival a consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int taps = g.S * g.S;
  const int nk = taps * g.chunks;
  const bool b_resident = nk == 1 && g.tiles_n == 1;

  if (warp == 8) {
    // producer: one thread keeps the ring full
    if (threadIdx.x % 32 == 0) {
      int stage = 0;
      uint32_t phase = 0;
      bool b_loaded = false;
      for (int t = blockIdx.x; t < g.tiles; t += gridDim.x) {
        const Tile tl = tile_of(t, g);
        for (int tap = 0; tap < taps; ++tap) {
          const int si = tap / g.S, sj = tap - si * g.S;
          for (int kc = 0; kc < g.chunks; ++kc) {
            mbar_wait(&empty[stage], phase ^ 1);
            // a resident B arrives with the block's first stage, which every
            // consumer waits on before its first read of B
            const bool load_b = !(b_resident && b_loaded);
            mbar_expect_tx(&full[stage], load_b ? 2 * kTileBytes : kTileBytes);
            tma_load_4d(a_st + stage * kTileBytes, &map_x, &full[stage], kc * g.per_chunk,
                        tl.w0 + sj - g.s0, tl.l0 + si - g.s0, tl.img);
            if (load_b)
              tma_load_3d(b_st + stage * kTileBytes, &map_k, &full[stage], kc * g.per_chunk, tap,
                          tl.n0);
            b_loaded = true;
            if (++stage == kStages) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      }
    }
    return;
  }

  // consumers
  const int wg = warp / 4, tid = threadIdx.x % 128, lane = tid % 32, wq = tid / 32;
  uint8_t* obuf = epi_out + wg * kEpiBytes;
  uint8_t* mbuf = epi_mul + wg * kEpiBytes;
  Param* pbuf = reinterpret_cast<Param*>(epi_prm) + wg * kBN;
  uint8_t* const out = static_cast<uint8_t*>(epi.out);
  constexpr int osize = Epi::kOutBytes;
  // 16-byte copies between the staged rows and global memory: thread tid
  // moves chunk tid % 16 of rows tid / 16 + 8 i
  const int cch = tid % 16, crow = tid / 16;
  int stage = 0;
  uint32_t phase = 0;
  Acc acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = Acc(0);

  for (int t = blockIdx.x; t < g.tiles; t += gridDim.x) {
    const Tile tl = tile_of(t, g);
    const int ncols = min(kBN, g.cout - tl.n0);
    // the factor's tile, fetched while the main loop runs
    if (Epi::kMul) {
      const uint8_t* mul = reinterpret_cast<const uint8_t*>(epi.mul);
      if (vec_mul) {
        if (cch < ncols / 8) {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int row = crow + 8 * i;
            size_t pix;
            if (pixel_of(wg, row, tl, g, pix))
              cp_async16(mbuf + row * kPitch + cch * 16,
                         mul + (pix * g.cout + tl.n0) * 2 + cch * 16);
          }
        }
      } else {
        for (int i = tid; i < 64 * ncols; i += 128) {
          const int row = i / ncols, col = i - row * ncols;
          size_t pix;
          if (pixel_of(wg, row, tl, g, pix))
            *reinterpret_cast<__nv_bfloat16*>(mbuf + row * kPitch + col * 2) =
                epi.mul[pix * g.cout + tl.n0 + col];
        }
      }
    }

    int prev = -1;
    for (int ks = 0; ks < nk; ++ks) {
      mbar_wait(&full[stage], phase);
      const uint32_t a = smem_u32(a_st + stage * kTileBytes + wg * 64 * kRowBytes);
      const uint32_t b = smem_u32(b_st + (b_resident ? 0 : stage * kTileBytes));
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < kRowBytes / 32; ++k)
        mma(acc, desc(a + 32 * k), desc(b + 32 * k), ks > 0 || k > 0);
      wgmma_commit();
      wgmma_wait<1>();
      if (prev >= 0 && tid == 0) mbar_arrive(&empty[prev]);
      prev = stage;
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (tid == 0) mbar_arrive(&empty[prev]);

    // the epilogue: one channel's parameters a thread into shared memory;
    // then every value from loads alone, then the stores alone, so that no
    // load waits behind a store
    pbuf[tid] = epi.param(tl.n0 + (tid < ncols ? tid : 0));
    cp_async_wait_all();
    wg_sync(wg);  // parameters and factor in; the last tile's copy has read obuf
    float val[64];
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int col = j * 8 + (lane % 4) * 2;
      const Param p0 = pbuf[col], p1 = pbuf[col + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wq * 16 + lane / 4 + h * 8;
        float2 m = make_float2(1.f, 1.f);
        if (Epi::kMul)
          m = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(mbuf + row * kPitch + col * 2));
        val[4 * j + 2 * h] = epi(acc[4 * j + 2 * h], p0, m.x);
        val[4 * j + 2 * h + 1] = epi(acc[4 * j + 2 * h + 1], p1, m.y);
      }
    }
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int col = j * 8 + (lane % 4) * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wq * 16 + lane / 4 + h * 8;
        epi.store2(obuf + row * kPitch + col * osize, val[4 * j + 2 * h], val[4 * j + 2 * h + 1]);
      }
    }
    wg_sync(wg);
    if (vec_out) {
      if (cch < ncols * osize / 16) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int row = crow + 8 * i;
          size_t pix;
          if (pixel_of(wg, row, tl, g, pix))  // a streaming global store: no alias of obuf
            __stcs(reinterpret_cast<int4*>(out + (pix * g.cout + tl.n0) * osize + cch * 16),
                   *reinterpret_cast<const int4*>(obuf + row * kPitch + cch * 16));
        }
      }
    } else {
      for (int i = tid; i < 64 * ncols; i += 128) {
        const int row = i / ncols, col = i - row * ncols;
        size_t pix;
        if (pixel_of(wg, row, tl, g, pix)) {
          uint8_t* dst = out + (pix * g.cout + tl.n0 + col) * osize;
          const uint8_t* src = obuf + row * kPitch + col * osize;
          for (int byte = 0; byte < osize; ++byte) dst[byte] = src[byte];
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's entry-point lookup, so that
// the library links without -lcuda.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Error codes past the runtime's: no encoder, or a tensor map it refused.
constexpr int kErrNoEncoder = 10001;
constexpr int kErrEncode = 10002;

// x (n, l, w, cpad) and wts (cout, S, S, cpad) of T, cpad * sizeof(T) a
// multiple of 16, both 16-byte aligned.  vec_mul: the factor's rows (cout
// bf16) are 16-byte multiples and its base 16-byte aligned.  Returns a
// cudaError_t, or kErrNoEncoder / kErrEncode.
template <typename T, typename Epi>
int launch(const T* x, const T* wts, int64_t n, int64_t l, int64_t w, int64_t cpad, int64_t cout,
           int S, int s0, Epi epi, bool vec_mul, cudaStream_t stream) {
  if (n * l * w == 0 || cout == 0) return 0;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kErrNoEncoder;
  const int es = (int)sizeof(T);
  Geometry g;
  g.n = (int)n;
  g.l = (int)l;
  g.w = (int)w;
  g.cout = (int)cout;
  g.S = S;
  g.s0 = s0;
  g.per_chunk = kRowBytes / es;
  g.chunks = (int)((cpad + g.per_chunk - 1) / g.per_chunk);
  g.twl = 0;
  while ((1 << g.twl) < w && g.twl < 7) ++g.twl;  // tw: W rounded up to a power of 2, <= 128
  g.tw = 1 << g.twl;
  g.tr = kBM / g.tw;
  g.tiles_w = (int)((w + g.tw - 1) / g.tw);
  g.tiles_l = (int)((l + g.tr - 1) / g.tr);
  g.tiles_n = (int)((cout + kBN - 1) / kBN);
  const int64_t tiles = n * g.tiles_l * g.tiles_w * g.tiles_n;
  if (tiles >= (int64_t)1 << 31) return (int)cudaErrorInvalidValue;
  g.tiles = (int)tiles;

  CUtensorMap map_x, map_k;
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  {
    const cuuint64_t dims[4] = {(cuuint64_t)cpad, (cuuint64_t)w, (cuuint64_t)l, (cuuint64_t)n};
    const cuuint64_t strides[3] = {(cuuint64_t)(cpad * es), (cuuint64_t)(w * cpad * es),
                                   (cuuint64_t)(l * w * cpad * es)};
    const cuuint32_t box[4] = {(cuuint32_t)g.per_chunk, (cuuint32_t)g.tw, (cuuint32_t)g.tr, 1};
    if (encode(&map_x, Elem<T>::kMap, 4, const_cast<T*>(x), dims, strides, box, ones,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return kErrEncode;
  }
  {
    const cuuint64_t dims[3] = {(cuuint64_t)cpad, (cuuint64_t)(S * S), (cuuint64_t)cout};
    const cuuint64_t strides[2] = {(cuuint64_t)(cpad * es), (cuuint64_t)(S * S * cpad * es)};
    const cuuint32_t box[3] = {(cuuint32_t)g.per_chunk, 1, (cuuint32_t)kBN};
    if (encode(&map_k, Elem<T>::kMap, 3, const_cast<T*>(wts), dims, strides, box, ones,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return kErrEncode;
  }

  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  static bool attr_set[64] = {};  // the attribute is the device's
  if (dev >= 64 || !attr_set[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(conv_kernel<T, Epi>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) attr_set[dev] = true;
  }
  const int vec_out = (cout * Epi::kOutBytes) % 16 == 0;
  const int grid = (int)(tiles < sms ? tiles : sms);
  conv_kernel<T, Epi><<<grid, kThreads, kSmemBytes, stream>>>(map_x, map_k, g, epi, vec_out,
                                                              vec_mul ? 1 : 0);
  return (int)cudaGetLastError();
}

}  // namespace tc_conv
