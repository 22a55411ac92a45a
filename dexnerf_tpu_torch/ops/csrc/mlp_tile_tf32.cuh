// The float32 FlexibleNeRF forward tile on Hopper's tensor cores, in split
// TF32 ("3xTF32"), for the fused render's float32 route (fused_render.cu)
// and kernel 4's f32 pass (fused_train_loss.cu: the forward, and the
// cotangent chain on the same products and epilogue pieces).
//
// Each f32 operand x is split into hi = tf32(x) and lo = tf32(x - hi)
// (round to nearest, ties away, as cvt.rna.tf32.f32), and each product is
// taken as lo.hi + hi.lo + hi.hi on wgmma m64nNk8 .tf32 with f32
// accumulators; lo.lo (~2^-22 of the product) is dropped. That keeps ~21
// bits of each operand where f32 FMA keeps 24, so the route computes the f32
// contract within its tolerances.
//
// Layouts:
// * B (the weights, ops/fused_render.py::pack_flex_weights_tf32): per layer
//   and K-chunk of 32, a [N][32] hi chunk, then its lo chunk, each one ring
//   stage, K-major in wgmma's 128 B swizzle (16 B groups of row r at group
//   g ^ (r % 8)), in consumption order.
// * K is permuted within each block of 8: position p holds feature
//   tf32_feature(p), so that a layer's f32 accumulator, whose thread holds
//   features 2q and 2q + 1 of each 8-column block (q = lane % 4), is already
//   in the register layout of wgmma's tf32 A fragment (positions q and
//   q + 4): the hi half of an activation is the next layer's A operand
//   without moving between threads.
// * A: hi from registers; lo from a consumer's "area" in shared memory
//   ([64 rows][32] K-major chunks, the same swizzle), written by the
//   epilogue that makes the activation. Layer1 and the skip layer read the
//   xyz encoding's hi and lo from the area too: the encoding is computed
//   again at the skip layer (elementwise f32 PE costs ~2% of the tile's
//   products), so one area serves both.
#pragma once

#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kCons = 2;                     // consumer warpgroups, each a worker
constexpr int kThreads = 128 * (kCons + 1);  // + the weight stream's warpgroup
constexpr int kTile = 64;                    // rows of a tile (wgmma's M)
constexpr int kKc = 32;                      // K of a chunk: one 128 B swizzle row of f32
constexpr int kChunk = kTile * 128;          // bytes of a [64][32] f32 A chunk
constexpr int kMinStages = 2;                // a consumer holds one chunk (hi + lo)
constexpr int kMaxStages = 16;
constexpr int kMaxDx = 128;                  // xyz encoding width
constexpr int kSmemMax = 232448;

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

// Floats of the aux buffer before the viewdir rows (biases and heads, each
// padded to 4 floats at most): what the epilogues read, kept in shared
// memory.
__host__ __device__ inline int aux_head_max(int H, int nt) {
  return (nt + 3) * H + 4 * (H / 2) + 8 + 4 * (nt + 7);
}

// Bytes of a consumer's area: the lo half of an H-wide activation, or the
// hi and lo halves of the kx-chunk encoding.
__host__ __device__ inline int area_bytes(int H, int kx) {
  const int n = H / kKc > 2 * kx ? H / kKc : 2 * kx;
  return n * kChunk;
}

// ---- the split
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;  // the bits wgmma reads; the rest zero
}
// hi = tf32(x), lo = tf32(x - hi) (x - hi is exact in f32)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_bits(x);
  lo = tf32_bits(__fsub_rn(x, __uint_as_float(hi)));
}

// K position of feature f (within its block of 8: 2i -> i, 2i + 1 -> i + 4)
__device__ __forceinline__ int tf32_pos(int f) {
  return (f & ~7) + ((f & 7) >> 1) + ((f & 1) << 2);
}
// Byte offset of (row, K position) in an area tile: [pos / 32] chunks of
// [64 rows][128 B], 16 B groups swizzled by row % 8.
__device__ __forceinline__ uint32_t area_off(int row, int pos) {
  return (pos >> 5) * kChunk + row * 128 + ((((pos & 31) >> 2) ^ (row & 7)) << 4) +
         (pos & 3) * 4;
}
__device__ __forceinline__ void store_split(uint32_t hi_t, uint32_t lo_t, int row, int f,
                                            float v) {
  uint32_t h, l;
  split_tf32(v, h, l);
  const uint32_t o = area_off(row, tf32_pos(f));
  sts32(hi_t + o, h);
  sts32(lo_t + o, l);
}

// Coordinate d of row i's point pt into the encoding tiles (hi, lo), by one
// of the row's two threads (half = 0, 1): pt itself (half 0, when included),
// then sin and cos of the frequencies half, half + 2, ... (band(f)). The
// argument is rounded as written and sincosf is the accurate one (the top
// frequency multiplies any error by up to 2^9); only the encoding is split.
template <class Band>
__device__ __forceinline__ void encode_coord_tf32(uint32_t hi_t, uint32_t lo_t, int i, int d,
                                                  float pt, int half, int fx, int inc_x,
                                                  Band band) {
  const int cx = inc_x ? 3 : 0;
  if (inc_x && half == 0) store_split(hi_t, lo_t, i, d, pt);
  for (int f = half; f < fx; f += 2) {
    float sn, cs;
    sincosf(__fmul_rn(pt, band(f)), &sn, &cs);
    store_split(hi_t, lo_t, i, cx + 6 * f + d, sn);
    store_split(hi_t, lo_t, i, cx + 6 * f + 3 + d, cs);
  }
}

// A sink that takes nothing (hidden_epilogue_tf32's default).
struct NoSink {
  template <class... T>
  __device__ __forceinline__ void operator()(T...) const {}
};

// ---- wgmma m64nNk8 .tf32, f32 accumulators, both operands K-major
#define TF_ACC8(i)                                                                            \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define TF_ACC16(i) TF_ACC8(i), TF_ACC8(i + 8)
#define TF_R0 "%0, %1, %2, %3, %4, %5, %6, %7"
#define TF_R8 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define TF_R16 ", %16, %17, %18, %19, %20, %21, %22, %23"
#define TF_R24 ", %24, %25, %26, %27, %28, %29, %30, %31"
#define TF_R32 ", %32, %33, %34, %35, %36, %37, %38, %39"
#define TF_R40 ", %40, %41, %42, %43, %44, %45, %46, %47"
#define TF_R48 ", %48, %49, %50, %51, %52, %53, %54, %55"
#define TF_R56 ", %56, %57, %58, %59, %60, %61, %62, %63"
// A and B from shared memory. Operands: the accumulators, da, db, scale-d.
#define TF_MMA(N, REGS, DA, DB, SC, ...)                                                    \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #SC ", 0;\n"                           \
               "wgmma.mma_async.sync.aligned.m64n" #N "k8.f32.tf32.tf32 {" REGS "}, %" #DA \
               ", %" #DB ", p, 1, 1;\n}\n"                                                  \
               : __VA_ARGS__                                                              \
               : "l"(da), "l"(db), "r"(scale_d))
// A from registers. Operands: the accumulators, a0..a3, db, scale-d.
#define TF_MMA_RS(N, REGS, A0, A1, A2, A3, DB, SC, ...)                                     \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #SC ", 0;\n"                           \
               "wgmma.mma_async.sync.aligned.m64n" #N "k8.f32.tf32.tf32 {" REGS "}, {%" #A0 \
               ", %" #A1 ", %" #A2 ", %" #A3 "}, %" #DB ", p, 1, 1;\n}\n"                   \
               : __VA_ARGS__                                                              \
               : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(scale_d))

// d[64 x N] (+)= A B for one k8 step, A ([64][8]) and B ([N][8]) in shared
// memory; scale_d 0 starts the sum.
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], uint64_t da, uint64_t db,
                                           int scale_d) {
  static_assert(N == 16 || N == 32 || N == 48 || N == 64 || N == 96 || N == 128,
                "the kernel's wgmma widths");
  if constexpr (N == 16) {
    TF_MMA(16, TF_R0, 8, 9, 10, TF_ACC8(0));
  } else if constexpr (N == 32) {
    TF_MMA(32, TF_R0 TF_R8, 16, 17, 18, TF_ACC16(0));
  } else if constexpr (N == 48) {
    TF_MMA(48, TF_R0 TF_R8 TF_R16, 24, 25, 26, TF_ACC16(0), TF_ACC8(16));
  } else if constexpr (N == 64) {
    TF_MMA(64, TF_R0 TF_R8 TF_R16 TF_R24, 32, 33, 34, TF_ACC16(0), TF_ACC16(16));
  } else if constexpr (N == 96) {
    TF_MMA(96, TF_R0 TF_R8 TF_R16 TF_R24 TF_R32 TF_R40, 48, 49, 50, TF_ACC16(0), TF_ACC16(16),
           TF_ACC16(32));
  } else {
    TF_MMA(128, TF_R0 TF_R8 TF_R16 TF_R24 TF_R32 TF_R40 TF_R48 TF_R56, 64, 65, 66, TF_ACC16(0),
           TF_ACC16(16), TF_ACC16(32), TF_ACC16(48));
  }
}

// The same with A from registers: the thread's part of the [64][8] A block,
// rows 16 w + g (a0, a2) and 16 w + g + 8 (a1, a3) of warp w, K positions q
// (a0, a1) and q + 4 (a2, a3), g = lane / 4, q = lane % 4.
template <int N>
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[N / 2], uint32_t a0, uint32_t a1,
                                              uint32_t a2, uint32_t a3, uint64_t db,
                                              int scale_d) {
  static_assert(N == 16 || N == 32 || N == 48 || N == 64 || N == 96 || N == 128,
                "the kernel's wgmma widths");
  if constexpr (N == 16) {
    TF_MMA_RS(16, TF_R0, 8, 9, 10, 11, 12, 13, TF_ACC8(0));
  } else if constexpr (N == 32) {
    TF_MMA_RS(32, TF_R0 TF_R8, 16, 17, 18, 19, 20, 21, TF_ACC16(0));
  } else if constexpr (N == 48) {
    TF_MMA_RS(48, TF_R0 TF_R8 TF_R16, 24, 25, 26, 27, 28, 29, TF_ACC16(0), TF_ACC8(16));
  } else if constexpr (N == 64) {
    TF_MMA_RS(64, TF_R0 TF_R8 TF_R16 TF_R24, 32, 33, 34, 35, 36, 37, TF_ACC16(0),
              TF_ACC16(16));
  } else if constexpr (N == 96) {
    TF_MMA_RS(96, TF_R0 TF_R8 TF_R16 TF_R24 TF_R32 TF_R40, 48, 49, 50, 51, 52, 53,
              TF_ACC16(0), TF_ACC16(16), TF_ACC16(32));
  } else {
    TF_MMA_RS(128, TF_R0 TF_R8 TF_R16 TF_R24 TF_R32 TF_R40 TF_R48 TF_R56, 64, 65, 66, 67, 68,
              69, TF_ACC16(0), TF_ACC16(16), TF_ACC16(32), TF_ACC16(48));
  }
}
#undef TF_MMA_RS
#undef TF_MMA
#undef TF_R56
#undef TF_R48
#undef TF_R40
#undef TF_R32
#undef TF_R24
#undef TF_R16
#undef TF_R8
#undef TF_R0
#undef TF_ACC16
#undef TF_ACC8

// ---- the weight ring
// The weight stream, by one thread: `passes` passes over the pack's nch
// stages at w (the first jd of sb bytes, the rest, the viewdir layer's, of
// sb / 2), one after another into an ns-stage ring of mbarrier-tracked 1-D
// bulk copies; a stage is refilled once every consumer warp has released it.
__device__ __forceinline__ void stream_weights_tf32(const unsigned char* w, int passes, int nch,
                                                    int jd, int sb, int ns, uint32_t ring,
                                                    uint32_t full, uint32_t empty) {
  int it = 0;
  for (int ps = 0; ps < passes; ++ps) {
    for (int c = 0; c < nch; ++c, ++it) {
      const int s = it % ns;
      const int bytes = c < jd ? sb : sb / 2;
      const size_t off = c < jd ? (size_t)c * sb : (size_t)jd * sb + (size_t)(c - jd) * (sb / 2);
      mbar_wait(empty + 8 * s, ((it / ns) & 1) ^ 1);
      mbar_expect_tx(full + 8 * s, bytes);
      bulk_load(ring + s * sb, w + off, bytes, full + 8 * s);
    }
  }
}

// A consumer warp's view of the ring: stages are taken and released in
// order.
struct Tf32Ring {
  uint32_t ring, full, empty;
  int ns, sb, lane;
  int hs = 0, hph = 0;  // the next stage to take, and its phase
  int ts = 0;           // the next stage to release
  // wait for the next stage; its shared address
  __device__ __forceinline__ uint32_t take() {
    mbar_wait(full + 8 * hs, hph);
    const uint32_t a = ring + hs * sb;
    if (++hs == ns) {
      hs = 0;
      hph ^= 1;
    }
    return a;
  }
  // this warp is done with the oldest stage it holds
  __device__ __forceinline__ void release() {
    if (lane == 0) mbar_arrive(empty + 8 * ts);
    if (++ts == ns) ts = 0;
  }
};

// ---- products
// One K-chunk's three split terms into d, from zero: lo(A) from the area
// chunk at lo_c, hi(A) from the area chunk at hi_c (encoding) or from the
// registers ah (activation, with hi_c unused), against the stages wh, wl;
// lo.hi and hi.lo first, then hi.hi.
template <int N, bool kRegA>
__device__ __forceinline__ void chunk_terms(float (&d)[N / 2], uint32_t lo_c, uint32_t hi_c,
                                            const uint32_t* ah, uint32_t wh, uint32_t wl) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    wgmma_tf32<N>(d, kmajor_desc(lo_c + ks * 32), kmajor_desc(wh + ks * 32), ks != 0);
    if constexpr (kRegA) {
      wgmma_tf32_rs<N>(d, ah[4 * ks], ah[4 * ks + 1], ah[4 * ks + 2], ah[4 * ks + 3],
                       kmajor_desc(wl + ks * 32), 1);
    } else {
      wgmma_tf32<N>(d, kmajor_desc(hi_c + ks * 32), kmajor_desc(wl + ks * 32), 1);
    }
  }
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    if constexpr (kRegA) {
      wgmma_tf32_rs<N>(d, ah[4 * ks], ah[4 * ks + 1], ah[4 * ks + 2], ah[4 * ks + 3],
                       kmajor_desc(wh + ks * 32), 1);
    } else {
      wgmma_tf32<N>(d, kmajor_desc(hi_c + ks * 32), kmajor_desc(wh + ks * 32), 1);
    }
  }
}

// One K-chunk of the product into sum, part by part (an N-wide product
// above 64 in two, so that a part's fresh accumulator fits beside the
// layer's sum and the A fragments): each part's twelve
// products (chunk_terms) into a fresh accumulator, then added to sum in f32
// on the CUDA cores (round to nearest). The tensor cores round each k8
// step's sum into their accumulator, and 48 such roundings a layer at the
// running sum's scale would cost the f32 contract its tolerance; a fresh
// accumulator per chunk keeps them at the chunk's scale. `first` starts
// sum. B of part h starts at row h NP of the stages wh, wl.
template <int N, bool kRegA>
__device__ __forceinline__ void chunk_product(float (&sum)[N / 2], uint32_t lo_c, uint32_t hi_c,
                                              const uint32_t* ah, uint32_t wh, uint32_t wl,
                                              bool first) {
  constexpr int NP = N > 64 ? N / 2 : N;
#pragma unroll
  for (int h = 0; h < N / NP; ++h) {
    float d[NP / 2];
    fence_regs(d);
    wgmma_fence();
    chunk_terms<NP, kRegA>(d, lo_c, hi_c, ah, wh + h * NP * 128, wl + h * NP * 128);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(d);
#pragma unroll
    for (int i = 0; i < NP / 2; ++i) {
      float& s = sum[h * (NP / 2) + i];
      s = first ? d[i] : s + d[i];
    }
  }
}

// The encoding's part of a product into the [64 x N] sum: its kx K-chunks
// (hi tiles at hi_t, lo tiles at lo_t; the encoding's positions and the
// weights' rows past dx are zero), chunk by chunk as the ring delivers
// them; `first` starts sum.
template <int N>
__device__ __forceinline__ void enc_product(float (&sum)[N / 2], uint32_t hi_t, uint32_t lo_t,
                                            int kx, Tf32Ring& wr, bool first) {
  for (int c = 0; c < kx; ++c) {
    const uint32_t wh = wr.take(), wl = wr.take();
    chunk_product<N, false>(sum, lo_t + c * kChunk, hi_t + c * kChunk, nullptr, wh, wl,
                            first && c == 0);
    wr.release();
    wr.release();
  }
}

// An [64 x NO] product (NO = H, or the viewdir layer's H/2) on an H-wide
// activation into sum (from zero): hi in registers (a, the A fragments in
// K-position order), lo in the area at lo_t; chunk by chunk as
// enc_product.
template <int NO, int H>
__device__ __forceinline__ void act_product(float (&sum)[NO / 2], uint32_t (&a)[H / 2],
                                            uint32_t lo_t, Tf32Ring& wr) {
  constexpr int KCH = H / kKc;
  fence_regs(a);  // the epilogue's hi halves are in place before the first wgmma_fence
#pragma unroll
  for (int c = 0; c < KCH; ++c) {
    const uint32_t wh = wr.take(), wl = wr.take();
    chunk_product<NO, true>(sum, lo_t + c * kChunk, 0, a + 16 * c, wh, wl, c == 0);
    wr.release();
    wr.release();
  }
}

// The thread's values of columns 8 j + 2 q (v0: row g, v2: row g + 8) and
// 8 j + 2 q + 1 (v1, v3) of an [64 x H] activation, split: hi into a (the
// next product's A fragments, in K-position order), lo into the area at
// lo_t (row0 = 16 w + g).
template <int H>
__device__ __forceinline__ void split_frag(int j, float v0, float v1, float v2, float v3,
                                           uint32_t (&a)[H / 2], uint32_t lo_t, int row0, int q) {
  // features col, col + 1 sit at K positions 8 j + q, 8 j + q + 4
  uint32_t l0, l1, l2, l3;
  split_tf32(v0, a[4 * j], l0);
  split_tf32(v2, a[4 * j + 1], l2);
  split_tf32(v1, a[4 * j + 2], l1);
  split_tf32(v3, a[4 * j + 3], l3);
  const int p0 = 8 * j + q;
  sts32(lo_t + area_off(row0, p0), l0);
  sts32(lo_t + area_off(row0, p0 + 4), l1);
  sts32(lo_t + area_off(row0 + 8, p0), l2);
  sts32(lo_t + area_off(row0 + 8, p0 + 4), l3);
}

// Epilogue of a hidden layer on an [64 x H] accumulator: v = act(acc +
// bias) in f32, split (split_frag). With head, also the sigma head v . wa +
// b_alpha of rows g and g + 8 of the warp into sig_rows. sink(j, v0, v1, v2,
// v3) also receives each 8-column block's f32 values (as split_frag's).
template <int H, bool relu, bool head, class Sink = NoSink>
__device__ __forceinline__ void hidden_epilogue_tf32(const float (&acc)[H / 2], const float* bias,
                                                     uint32_t (&a)[H / 2], uint32_t lo_t,
                                                     const float* wa, float b_alpha,
                                                     float* sig_rows, Sink sink = Sink()) {
  const int t = threadIdx.x & 127, lane = t & 31, g = lane >> 2, q = lane & 3;
  const int row0 = 16 * (t >> 5) + g;
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int j = 0; j < H / 8; ++j) {
    const int col = 8 * j + 2 * q;
    const float2 b = *reinterpret_cast<const float2*>(bias + col);
    float v0 = acc[4 * j] + b.x, v1 = acc[4 * j + 1] + b.y;
    float v2 = acc[4 * j + 2] + b.x, v3 = acc[4 * j + 3] + b.y;
    if (relu) {
      v0 = fmaxf(v0, 0.f);
      v1 = fmaxf(v1, 0.f);
      v2 = fmaxf(v2, 0.f);
      v3 = fmaxf(v3, 0.f);
    }
    if (head) {
      const float2 w = *reinterpret_cast<const float2*>(wa + col);
      s0 = fmaf(v1, w.y, fmaf(v0, w.x, s0));
      s1 = fmaf(v3, w.y, fmaf(v2, w.x, s1));
    }
    sink(j, v0, v1, v2, v3);
    split_frag<H>(j, v0, v1, v2, v3, a, lo_t, row0, q);
  }
  if (head) {
    s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
    s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
    if (q == 0) {
      sig_rows[g] = s0 + b_alpha;
      sig_rows[g + 8] = s1 + b_alpha;
    }
  }
}

// The viewdir layer's epilogue for one tile, rows r0 + 16 w + g and + 8 (r0
// counts from the first row of dirb's first ray): y = ReLU(acc + the ray's
// viewdir bias), accumulated into the rgb head's sums c[row][3].
template <int H>
__device__ __forceinline__ void dir_epilogue_tf32(const float (&ad)[H / 4], int r0, int S,
                                                  int nrays, const float* dirb,
                                                  const float* w_rgb, float (&c)[2][3]) {
  constexpr int H2 = H / 2;
  const int t = threadIdx.x & 127, lane = t & 31, g = lane >> 2, q = lane & 3;
  const int r = r0 + 16 * (t >> 5) + g;
  const float* db0 = dirb + min(r / S, nrays - 1) * H2;
  const float* db1 = dirb + min((r + 8) / S, nrays - 1) * H2;
#pragma unroll
  for (int j = 0; j < H2 / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * j + 2 * q + e;
      const float* wr = w_rgb + col * 3;
      const float y0 = fmaxf(ad[4 * j + e] + db0[col], 0.f);
      const float y1 = fmaxf(ad[4 * j + 2 + e] + db1[col], 0.f);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        c[0][k] = fmaf(y0, wr[k], c[0][k]);
        c[1][k] = fmaf(y1, wr[k], c[1][k]);
      }
    }
  }
}

}  // namespace
