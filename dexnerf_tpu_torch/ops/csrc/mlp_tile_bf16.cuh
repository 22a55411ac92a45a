// The bf16 FlexibleNeRF forward tile on Hopper's tensor cores, shared by the
// served frame's fused render (fused_render_bf16.cu) and the training
// forward of kernels 2-4 (fused_train_loss_bf16.cu): persistent CTAs of
// kCons consumer warpgroups, each running its own 64-row tiles through the
// whole MLP on wgmma m64nNk16, and one warpgroup whose first thread streams
// the weights (ops/fused_render.py::pack_flex_weights_bf16: [N][64] K-chunks
// already in wgmma's 128 B-swizzled layout, in consumption order) by 1-D bulk
// copies into an mbarrier ring that every consumer reads.
//
// The bf16 contract (dexnerf_tpu/ops/fused_mlp.py::split_flex_params +
// _forward_block_parts): the operands of layer1, of every trunk layer (h
// and, on a skip layer, the xyz encoding), of fc_feat and of layers_dir.0
// are rounded to bf16 and accumulated in f32; bias, ReLU and the chain stay
// f32; the sigma head reads the f32 trunk output and the rgb head the f32
// viewdir-layer output, both with f32 weights. Layer1 and the skip layer
// read the encoding from a consumer's K-major, 128 B-swizzled tile in shared
// memory; every other layer reads its A operand from registers: the previous
// layer's accumulator after bias, ReLU and the bf16 rounding is already in
// the register layout of wgmma's A fragment.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kCons = 3;                     // consumer warpgroups, each a worker
constexpr int kThreads = 128 * (kCons + 1);  // + the weight stream's warpgroup
constexpr int kTile = 64;                    // rows of a tile (wgmma's M)
constexpr int kKc = 64;                      // K of a weight chunk: one 128 B swizzle row
constexpr int kMaxStages = 10;               // weight ring depth, as shared memory allows
constexpr int kMaxDx = 128;                  // xyz encoding width
constexpr int kMaxKx = kMaxDx / kKc;         // its K-chunks
constexpr int kEncChunk = kTile * 128;       // bytes of a [64][64] bf16 encoding chunk
constexpr int kSmemMax = 232448;

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

// Floats of the aux buffer before the viewdir rows (biases and heads, each
// padded to 4 floats at most): what the epilogues read, kept in shared
// memory.
__host__ __device__ inline int aux_head_max(int H, int nt) {
  return (nt + 3) * H + 4 * (H / 2) + 8 + 4 * (nt + 7);
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}
// pack_bf16(ReLU(lo), ReLU(hi)) in one instruction (ReLU and the rounding
// commute: both keep the sign, and a negative value becomes 0 either way)
__device__ __forceinline__ uint32_t pack_bf16_relu(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

// Byte offset of element (row, col) of a consumer's [64][64 k] tile: [col /
// 64] K-chunks of [64 rows][128 B], 16 B units swizzled by row % 8 (wgmma's
// 128 B swizzle, K-major; TMA's SWIZZLE_128B box layout).
__device__ __forceinline__ int tile_off(int row, int col) {
  return (col >> 6) * kEncChunk + row * 128 + ((((col & 63) >> 3) ^ (row & 7)) << 4) +
         (col & 7) * 2;
}
__device__ __forceinline__ void store_enc(unsigned char* enc, int row, int col, float v) {
  *reinterpret_cast<bf16*>(enc + tile_off(row, col)) = __float2bfloat16_rn(v);
}

// Coordinate d of row i's point pt into a consumer's encoding tile, by one
// of the row's two threads (half = 0, 1): pt itself (half 0, when included),
// then sin and cos of the frequencies half, half + 2, ... (band(f)). The
// argument is rounded as written and sincosf is the accurate one (the top
// frequency multiplies any error by up to 2^9); only the encoding is
// rounded to bf16.
template <class Band>
__device__ __forceinline__ void encode_coord(unsigned char* enc, int i, int d, float pt, int half,
                                             int fx, int inc_x, Band band) {
  const int cx = inc_x ? 3 : 0;
  if (inc_x && half == 0) store_enc(enc, i, d, pt);
  for (int f = half; f < fx; f += 2) {
    float sn, cs;
    sincosf(__fmul_rn(pt, band(f)), &sn, &cs);
    store_enc(enc, i, cx + 6 * f + d, sn);
    store_enc(enc, i, cx + 6 * f + 3 + d, cs);
  }
}

// Epilogue of a hidden layer on an [64 x H] accumulator: v = act(acc +
// bias) in f32, rounded to bf16 into a, the next layer's A fragments. With
// head, also the sigma head v . wa + b_alpha of rows g and g + 8 of the
// warp into sig_rows.
template <int H, bool relu, bool head>
__device__ __forceinline__ void hidden_epilogue(const float (&acc)[H / 2],
                                                const float* bias,
                                                uint32_t (&a)[H / 4],
                                                const float* wa, float b_alpha,
                                                float* sig_rows) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int j = 0; j < H / 8; ++j) {
    const int col = 8 * j + 2 * q;
    const float2 b = *reinterpret_cast<const float2*>(bias + col);
    float v0 = acc[4 * j] + b.x, v1 = acc[4 * j + 1] + b.y;
    float v2 = acc[4 * j + 2] + b.x, v3 = acc[4 * j + 3] + b.y;
    if (relu && !head) {
      a[2 * j] = pack_bf16_relu(v0, v1);
      a[2 * j + 1] = pack_bf16_relu(v2, v3);
      continue;
    }
    if (relu) {  // the sigma head reads the f32 values after ReLU
      v0 = fmaxf(v0, 0.f);
      v1 = fmaxf(v1, 0.f);
      v2 = fmaxf(v2, 0.f);
      v3 = fmaxf(v3, 0.f);
    }
    a[2 * j] = pack_bf16(v0, v1);
    a[2 * j + 1] = pack_bf16(v2, v3);
    if (head) {
      const float2 w = *reinterpret_cast<const float2*>(wa + col);
      s0 = fmaf(v1, w.y, fmaf(v0, w.x, s0));
      s1 = fmaf(v3, w.y, fmaf(v2, w.x, s1));
    }
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

// The encoding's part of a product into the [64 x H] accumulator: its kx
// K-chunks (the encoding's columns and the weights' rows past dx are zero)
// against the ring stages st_of; `first` starts the sum.
template <int H>
__device__ __forceinline__ void enc_product(float (&acc)[H / 2], uint32_t enc, int kx,
                                            const uint32_t (&st_of)[kMaxKx], bool first) {
#pragma unroll
  for (int c = 0; c < kMaxKx; ++c) {
    if (c < kx) {
      const uint32_t st = st_of[c];
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        wgmma_bf16<H, 0, 0>(acc, kmajor_desc(enc + c * kEncChunk + ks * 32),
                            kmajor_desc(st + ks * 32), !(first && c == 0 && ks == 0));
      }
    }
  }
}

// An [64 x NO] product (NO = H, or a part of the viewdir layer's H/2) on
// the A fragments of an H-wide activation in registers, against the ring
// stages st_of (B from row b_off / 128 of each stage on).
template <int NO, int H>
__device__ __forceinline__ void reg_product(float (&acc)[NO / 2], const uint32_t (&a)[H / 4],
                                            const uint32_t (&st_of)[(H + kKc - 1) / kKc],
                                            uint32_t b_off = 0) {
  constexpr int KCH = (H + kKc - 1) / kKc;
#pragma unroll
  for (int c = 0; c < KCH; ++c) {
    const uint32_t st = st_of[c] + b_off;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const int kk = 4 * c + ks;
      if (kk < H / 16) {
        wgmma_bf16_rs<NO>(acc, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3],
                          kmajor_desc(st + ks * 32), kk != 0);
      }
    }
  }
}

// The viewdir layer's epilogue for columns c0 .. c0 + NH - 1 of one tile,
// rows r0 + 16 w + g and + 8 (r0 counts from the first row of dirb's first
// ray): y = ReLU(acc + the ray's viewdir bias), accumulated (kRgb) into the
// rgb head's sums c[row][3] (each head weight loaded once for both rows)
// and (kY) rounded to bf16 into the consumer's swizzled tile at the shared
// address ytile.
template <int H, int NH, bool kRgb = true, bool kY = false>
__device__ __forceinline__ void dir_epilogue(const float (&ad)[NH / 2], int c0, int r0, int S,
                                             int nrays, const float* dirb, const float* w_rgb,
                                             float (&c)[2][3], uint32_t ytile = 0) {
  constexpr int H2 = H / 2;
  const int t = threadIdx.x & 127, lane = t & 31, g = lane >> 2, q = lane & 3;
  const int r = r0 + 16 * (t >> 5) + g;
  const float* db0 = dirb + min(r / S, nrays - 1) * H2;
  const float* db1 = dirb + min((r + 8) / S, nrays - 1) * H2;
#pragma unroll
  for (int j = 0; j < NH / 8; ++j) {
    float y0[2], y1[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = c0 + 8 * j + 2 * q + e;
      float w0 = 0.f, w1 = 0.f, w2 = 0.f;
      if (kRgb) {
        const float* wr = w_rgb + col * 3;
        w0 = wr[0];
        w1 = wr[1];
        w2 = wr[2];
      }
      y0[e] = fmaxf(ad[4 * j + e] + db0[col], 0.f);
      y1[e] = fmaxf(ad[4 * j + 2 + e] + db1[col], 0.f);
      if (kRgb) {
        c[0][0] = fmaf(y0[e], w0, c[0][0]);
        c[0][1] = fmaf(y0[e], w1, c[0][1]);
        c[0][2] = fmaf(y0[e], w2, c[0][2]);
        c[1][0] = fmaf(y1[e], w0, c[1][0]);
        c[1][1] = fmaf(y1[e], w1, c[1][1]);
        c[1][2] = fmaf(y1[e], w2, c[1][2]);
      }
    }
    if (kY) {
      const int row = 16 * (t >> 5) + g, col = c0 + 8 * j + 2 * q;
      sts32(ytile + tile_off(row, col), pack_bf16(y0[0], y0[1]));
      sts32(ytile + tile_off(row + 8, col), pack_bf16(y1[0], y1[1]));
    }
  }
}

// The weight stream, by one thread: `passes` passes over the pack's nch
// chunks at w (the first jd of sb bytes, the rest, the viewdir layer's, of
// sb / 2), chunk after chunk into the next stage of an ns-stage ring of
// mbarrier-tracked 1-D bulk copies; a stage is refilled once every consumer
// warp has released it.
__device__ __forceinline__ void stream_weights(const unsigned char* w, int passes, int nch,
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

// A consumer warp's view of the weight ring: the position of the next chunk
// to consume, its stage ws and phase wph.
struct WeightRing {
  uint32_t ring, full, empty;
  int ns, sb, lane;
  int ws = 0, wph = 0;
  // stage ws + c (c < ns) and its phase
  __device__ __forceinline__ int stage_of(int c, int& ph) const {
    const int st = ws + c;
    ph = wph ^ (st >= ns);
    return st >= ns ? st - ns : st;
  }
  // this warp's part of the next n chunks is done: release them
  __device__ __forceinline__ void release(int n) {
    for (int c = 0; c < n; ++c) {
      if (lane == 0) mbar_arrive(empty + 8 * ws);
      if (++ws == ns) {
        ws = 0;
        wph ^= 1;
      }
    }
  }
  // wait for the next n chunks (before a product's wgmmas, so that no wait
  // lies between them)
  __device__ __forceinline__ void wait(int n) const {
    for (int c = 0; c < n; ++c) {
      int ph;
      const int st = stage_of(c, ph);
      mbar_wait(full + 8 * st, ph);
    }
  }
  // the ring address of the next chunk + c
  __device__ __forceinline__ uint32_t at(int c) const {
    int ph;
    return ring + stage_of(c, ph) * sb;
  }
};

}  // namespace
