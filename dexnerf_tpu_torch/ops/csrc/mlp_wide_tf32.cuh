// The wide route of the float32 (split TF32) FlexibleNeRF kernels: padded
// widths above 128, up to kWtMaxHidden, where the narrow tile
// (mlp_tile_tf32.cuh) does not fit. That tile keeps a layer's 64 x H f32 sum
// and the next layer's hi A fragments in registers (at H = 256 the sum alone
// is 128 registers a thread, and each K-chunk's fresh accumulator takes as
// many again) and its lo half in shared memory. The wide tile instead keeps
// the layer's input in shared memory as one f32 tile a consumer, and
// computes the output in column blocks of at most 128 (column_block), so that a
// block's sum and its chunk's fresh accumulator are at most 64 registers
// each:
// * A from registers: per K-chunk of 32, each thread loads its 16 values of
//   the input tile and splits them there (split_tf32: hi = tf32(x), lo =
//   tf32(x - hi), round to nearest, ties away), then issues lo.hi, hi.lo and
//   hi.hi (wgmma m64nNk8 .tf32, A from registers) into a fresh accumulator,
//   added to the block's sum in f32: the narrow tile's numerics, term for
//   term and in its order.
// * B from a ring of stages, each the hi piece and the lo piece of one
//   K-chunk's rows c0 .. c0 + bn - 1 (a [bn][32] piece of a [N][32] chunk is
//   contiguous in the pre-split pack: ops/fused_render.py::
//   pack_flex_weights_tf32 and ops/fused_train_loss.py::
//   pack_backward_weights_tf32), streamed by one thread in 1-D bulk copies.
// * The input tile is feature-major ([features][64 rows] f32, rows swizzled
//   by feature: ft_off), so that a thread's A values, its epilogue's stores
//   and a copy of whole feature rows are all free of bank conflicts. Two f32
//   tiles of a 576-wide layer (288 KB) do not fit beside the weights, so a
//   layer's output goes to device memory, feature-major, and is copied back
//   into the tile before the next layer: the training kernels' scratch
//   (which stores every activation and cotangent anyway), or a buffer of
//   [Hp][64] floats a worker (kernels 1 and 2), read back from L2.
// * The xyz encoding has an f32 tile of its own, read by layer1 and the skip
//   layers (split on load, as the activations).
//
// The design is right first and keeps one CTA per SM; what bounds it and
// what it takes are in PERF.md (sections 5 and 6).
#pragma once

#include "mlp_tile_tf32.cuh"

namespace {

// Hp at most: the largest padded width whose plans fit at the kernels'
// widest encodings (ops/fused_render.py::tf32_wide_fits)
constexpr int kWtMaxHidden = 608;
constexpr int kWtMaxCons = 2;  // consumer warpgroups at most
// registers a thread after setmaxnreg: the producer's, each consumer's
// (128 x (40 + 2 x 232) <= 65536)
constexpr int kWtProdRegs = 40, kWtConsRegs = 232;
constexpr int kWtThreads = 128 * (kWtMaxCons + 1);
constexpr int kWtMaxStages = 8;
constexpr int kWtMinStages = 2;

// Bytes of a feature-major f32 tile of n features.
__host__ __device__ inline size_t ft_bytes(int n) { return (size_t)n * kTile * 4; }

// Byte offset of (feature f, row r) in a feature-major tile: feature f's
// 64 rows at 256 f, row r at position r ^ 8 ((f / 2) % 4). A thread of a
// warp reads features 8 k + 2 q (+ 1) of rows 16 w + g (+ 8), and writes
// the same: g + 8 q + 16 w spans the 32 banks.
__device__ __forceinline__ uint32_t ft_off(int f, int r) {
  return (uint32_t)(f * kTile + (r ^ (((f >> 1) & 3) << 3))) * 4u;
}

// A ring stage: the hi piece, then (at bmax * 128 bytes) the lo piece of
// up to bmax rows.
__host__ __device__ inline int wt_stage_bytes(int bmax) { return 2 * bmax * 128; }

// A wide kernel's shared-memory plan: from the 1024-aligned base, `stages`
// ring stages of pieces of up to `bmax` rows, then `cons` consumer blocks
// of cons_bytes (a multiple of 16), then a full and an empty mbarrier per
// stage; `smem` bytes in all with the slack that aligns the base. The most
// consumers (up to kWtMaxCons), then the largest pieces (bfirst rows: 128,
// else 64; or 64), then the most stages (up to kWtMaxStages, at least
// kWtMinStages) that fit; cons = 0 if none fits.
struct WtPlan {
  int cons, bmax, stages;
  size_t smem;
};

__host__ __device__ inline WtPlan wt_plan(size_t cons_bytes, int bfirst = 128) {
  for (int c = kWtMaxCons; c >= 1; --c) {
    for (int bmax = bfirst; bmax >= 64; bmax -= 64) {
      for (int ns = kWtMaxStages; ns >= kWtMinStages; --ns) {
        const size_t total = 1024 + (size_t)ns * (wt_stage_bytes(bmax) + 16) + c * cons_bytes;
        if (total <= (size_t)kSmemMax) return WtPlan{c, bmax, ns, total};
      }
    }
  }
  return WtPlan{0, 0, 0, 0};
}

// The column blocks of an n-wide output (hopper.cuh's column_block).
__host__ __device__ inline int wt_blocks(int n, int bmax) {
  int k = 0;
  for (int c0 = 0; c0 < n; c0 += column_block(n, c0, bmax)) ++k;
  return k;
}

// Pieces of one pass over the forward pack (with layer1's when it runs on
// the tensor cores), and of one tile's pass over the backward pack.
__host__ __device__ inline int wt_fwd_pieces(int hp, int kx, int nt, int skip_mask, int bmax,
                                             bool layer1) {
  int nskip = 0;
  for (int i = 0; i < nt; ++i) nskip += (skip_mask >> i) & 1;
  return wt_blocks(hp, bmax) * ((layer1 ? kx : 0) + kx * nskip + (nt + 1) * (hp / kKc)) +
         wt_blocks(hp / 2, bmax) * (hp / kKc);
}
__host__ __device__ inline int wt_chain_pieces(int hp, int nt, int bmax) {
  return wt_blocks(hp, bmax) * ((hp / 2 + kKc - 1) / kKc + (nt + 1) * (hp / kKc));
}

// ---- the weight ring
// A consumer warp's view: stages are acquired and released in stream order.
struct WtRing {
  uint32_t ring, full, empty;
  int ns, bmax, lane;
  int head = 0, tail = 0;
  __device__ __forceinline__ uint32_t acquire() {
    const int s = head % ns;
    mbar_wait(full + 8 * s, (head / ns) & 1);
    ++head;
    return ring + s * wt_stage_bytes(bmax);
  }
  __device__ __forceinline__ void release() {
    if (lane == 0) mbar_arrive(empty + 8 * (tail % ns));
    ++tail;
  }
};

// The producer's side, one thread.
struct WtStream {
  const unsigned char* w;
  uint32_t ring, full, empty;
  int ns, bmax;
  int it = 0;
  // one stage: the hi piece at w + hi and the lo piece at w + lo, bytes each
  __device__ __forceinline__ void put(size_t hi, size_t lo, int bytes) {
    const int s = it % ns;
    const uint32_t st = ring + s * wt_stage_bytes(bmax);
    mbar_wait(empty + 8 * s, ((it / ns) & 1) ^ 1);
    mbar_expect_tx(full + 8 * s, 2 * bytes);
    bulk_load(st, w + hi, bytes, full + 8 * s);
    bulk_load(st + bmax * 128, w + lo, bytes, full + 8 * s);
    ++it;
  }
  // the stages of one product, in the consumers' order: per column block of
  // the n-wide output, nh K-chunks of the operand at oh, then ne of the one
  // at oe (both n rows: a chunk is its [n][32] hi half, then its lo half)
  __device__ __forceinline__ void product(size_t oh, int nh, size_t oe, int ne, int n) {
    const size_t ch = (size_t)n * 256;
    for (int c0 = 0; c0 < n; c0 += column_block(n, c0, bmax)) {
      const int bytes = column_block(n, c0, bmax) * 128;
      for (int c = 0; c < nh + ne; ++c) {
        const size_t o = (c < nh ? oh + c * ch : oe + (c - nh) * ch) + (size_t)c0 * 128;
        put(o, o + (size_t)n * 128, bytes);
      }
    }
  }
  // `passes` passes over the forward pack of a model of padded width hp, kx
  // encoding chunks, nt trunk layers (skip_mask: those that read the
  // encoding): layer1 (when `layer1`: else it runs on the CUDA cores and its
  // stages are skipped), the trunk, fc_feat, the feat rows of layers_dir.0
  __device__ void forward(int passes, int hp, int kx, int nt, int skip_mask, bool layer1) {
    const int kch = hp / kKc;
    const size_t ch = (size_t)hp * 256;  // bytes of a K-chunk's hi and lo of hp rows
    for (int ps = 0; ps < passes; ++ps) {
      if (layer1) product(0, 0, 0, kx, hp);
      size_t off = kx * ch;
      for (int i = 0; i < nt; ++i) {
        const size_t oh = off;
        off += kch * ch;
        if ((skip_mask >> i) & 1) {
          product(oh, kch, off, kx, hp);
          off += kx * ch;
        } else {
          product(oh, kch, 0, 0, hp);
        }
      }
      product(off, kch, 0, 0, hp);
      off += kch * ch;
      product(off, kch, 0, 0, hp / 2);
    }
  }
  // `passes` tiles' passes over the backward pack: layers_dir.0's feat rows
  // (K = hp / 2 padded to a chunk), fc_feat, the trunk from the last layer
  __device__ void chain(int passes, int hp, int nt) {
    const int kd = (hp / 2 + kKc - 1) / kKc, kch = hp / kKc;
    const size_t ch = (size_t)hp * 256;
    for (int ps = 0; ps < passes; ++ps) {
      product(0, kd, 0, 0, hp);
      for (int pi = 0; pi <= nt; ++pi) product((kd + (size_t)pi * kch) * ch, kch, 0, 0, hp);
    }
  }
};

// Coordinate d of a point pt into its encoding features, by one of the
// row's two threads (half = 0, 1): put(feature, value) with pt itself (half
// 0, when included), then sin and cos of the frequencies half, half + 2,
// ...; the argument rounded as written and the accurate sincosf, as
// encode_coord_tf32.
template <class Put>
__device__ __forceinline__ void wt_encode_coord(int d, float pt, int half, int fx, int inc_x,
                                                const float* bands, Put put) {
  const int cx = inc_x ? 3 : 0;
  if (inc_x && half == 0) put(d, pt);
  for (int f = half; f < fx; f += 2) {
    float sn, cs;
    sincosf(__fmul_rn(pt, bands[f]), &sn, &cs);
    put(cx + 6 * f + d, sn);
    put(cx + 6 * f + 3 + d, cs);
  }
}

// ---- products
// sum[64 x BN] = A B over nh K-chunks of the feature-major tile at in, then
// ne chunks of the one at enc, each against the next ring stage: each
// chunk's twelve products into a fresh accumulator (lo.hi and hi.lo per k8
// step, then hi.hi, as chunk_terms), added to the sum in f32; a block wider
// than 64 in two halves of the columns (as chunk_product), so that a half's
// fresh accumulator, the block's sum and the A fragments fit beside each
// other in the registers. The next chunk's 16 A values are loaded under the
// current chunk's first group, so their shared-memory latency is hidden.
template <int BN>
__device__ __forceinline__ void wt_product(float (&sum)[BN / 2], uint32_t in, int nh,
                                           uint32_t enc, int ne, WtRing& wr) {
  constexpr int NP = BN > 64 ? BN / 2 : BN;
  const int t = threadIdx.x & 127, lane = t & 31, g = lane >> 2, q = lane & 3;
  const int r0 = 16 * (t >> 5) + g, n = nh + ne;
  // the thread's A values of chunk c (see wgmma_tf32_rs): rows r0, r0 + 8 at
  // K positions q, q + 4, which hold features 2 q, 2 q + 1 of the k8 step
  auto load = [&](int c, float(&x)[16]) {
    const uint32_t base = c < nh ? in : enc;
    const int f0 = kKc * (c < nh ? c : c - nh) + 2 * q;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        x[4 * ks + e] =
            __uint_as_float(lds32(base + ft_off(f0 + 8 * ks + (e >> 1), r0 + 8 * (e & 1))));
      }
    }
  };
  float xv[16];
  load(0, xv);
  for (int c = 0; c < n; ++c) {
    uint32_t ah[16], al[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) split_tf32(xv[i], ah[i], al[i]);
    const uint32_t st = wr.acquire();
#pragma unroll
    for (int hh = 0; hh < BN / NP; ++hh) {
      const uint32_t wh = st + hh * NP * 128, wl = wh + wr.bmax * 128;
      float d[NP / 2];
      fence_regs(d);
      fence_regs(ah);
      fence_regs(al);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        wgmma_tf32_rs<NP>(d, al[4 * ks], al[4 * ks + 1], al[4 * ks + 2], al[4 * ks + 3],
                          kmajor_desc(wh + ks * 32), ks != 0);
        wgmma_tf32_rs<NP>(d, ah[4 * ks], ah[4 * ks + 1], ah[4 * ks + 2], ah[4 * ks + 3],
                          kmajor_desc(wl + ks * 32), 1);
      }
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        wgmma_tf32_rs<NP>(d, ah[4 * ks], ah[4 * ks + 1], ah[4 * ks + 2], ah[4 * ks + 3],
                          kmajor_desc(wh + ks * 32), 1);
      }
      wgmma_commit();
      if (hh == 0 && c + 1 < n) load(c + 1, xv);
      wgmma_wait0();
      fence_regs(d);
      fence_regs(ah);
      fence_regs(al);
#pragma unroll
      for (int i = 0; i < NP / 2; ++i) {
        float& s = sum[hh * (NP / 2) + i];
        s = c == 0 ? d[i] : s + d[i];
      }
    }
    wr.release();
  }
}

// The [64 x n] layer output at src (feature f's 64 rows at src + f k;
// features from nvalid on are zero) into the tile at dst, by the
// warpgroup's 128 threads (16 B a load, from L2), eight loads a thread in
// flight before their stores: a load at a time left each one's L2 latency
// exposed (PERF.md; perf_tools/train_wide_f32_variants.py: readback1).
__device__ __forceinline__ void wt_load_tile(uint32_t dst, const float* src, long long k,
                                             int nvalid, int n) {
  constexpr int U = 8;
  const int t = threadIdx.x & 127, total = n * 16;
  for (int i0 = t; i0 < total; i0 += 128 * U) {
    float4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + 128 * u, f = i >> 4, r = (i & 15) * 4;
      v[u] = i < total && f < nvalid ? __ldcs(reinterpret_cast<const float4*>(src + f * k + r))
                                     : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + 128 * u;
      if (i < total) sts128(dst + ft_off(i >> 4, (i & 15) * 4), v[u]);
    }
  }
}

// layer1 on the CUDA cores for the column block c0 (the training kernels':
// each output a sequential f32 FMA chain over the encoding in feature order,
// as the narrow forward and the plain version's GEMM sum it): w1 [dx][hp].
// The encoding and weights of U features at a time (U at most L1U, 1 at
// blocks wider than 64) are loaded into one of two register sets while the
// other set's multiply-adds run: a feature at a time left each load's
// latency exposed (PERF.md; perf_tools/train_wide_f32_variants.py:
// no_layer1, layer1_u1).
template <int BN, int L1U>
__device__ __forceinline__ void wt_layer1_fma(float (&acc)[BN / 2], uint32_t enc, const float* w1,
                                              int dx, int hp, int c0) {
  constexpr int NJ = BN / 8, U = BN > 64 ? 1 : L1U;
  const int t = threadIdx.x & 127, lane = t & 31, g = lane >> 2, q = lane & 3;
  const int r0 = 16 * (t >> 5) + g;
#pragma unroll
  for (int e = 0; e < BN / 2; ++e) acc[e] = 0.f;
  // features k0 .. k0 + U - 1 (one past dx loads feature dx - 1, unused)
  auto load = [&](int k0, float(&xv)[U][2], float2(&wv)[U][NJ]) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = min(k0 + u, dx - 1);
      xv[u][0] = __uint_as_float(lds32(enc + ft_off(k, r0)));
      xv[u][1] = __uint_as_float(lds32(enc + ft_off(k, r0 + 8)));
      const float* wk = w1 + (size_t)k * hp + c0 + 2 * q;
#pragma unroll
      for (int j = 0; j < NJ; ++j) wv[u][j] = __ldg(reinterpret_cast<const float2*>(wk + 8 * j));
    }
  };
  auto fmas = [&](int k0, const float(&xv)[U][2], const float2(&wv)[U][NJ]) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (k0 + u < dx) {
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          acc[4 * j] = fmaf(xv[u][0], wv[u][j].x, acc[4 * j]);
          acc[4 * j + 1] = fmaf(xv[u][0], wv[u][j].y, acc[4 * j + 1]);
          acc[4 * j + 2] = fmaf(xv[u][1], wv[u][j].x, acc[4 * j + 2]);
          acc[4 * j + 3] = fmaf(xv[u][1], wv[u][j].y, acc[4 * j + 3]);
        }
      }
    }
  };
  float xa[U][2], xb[U][2];
  float2 wa[U][NJ], wb[U][NJ];
  load(0, xa, wa);
  for (int k0 = 0; k0 < dx; k0 += 2 * U) {
    if (k0 + U < dx) load(k0 + U, xb, wb);
    fmas(k0, xa, wa);
    if (k0 + U < dx) {
      if (k0 + 2 * U < dx) load(k0 + 2 * U, xa, wa);
      fmas(k0 + U, xb, wb);
    }
  }
}

// ---- the forward
// One consumer's wide tile: its input tile and encoding tile (feature-major
// f32), the model's shape and its aux buffer (device memory, offsets as the
// narrow kernels'), layer1's f32 weights for the CUDA-core layer1 (null:
// layer1 on the tensor cores), the warpgroup's barrier.
struct WtTile {
  uint32_t in, enc;
  const float* aux;
  const int* aux_off;
  const float* w1;
  int hp, kx, dx, nt, skip_mask, bar;
};

// Where the forward's layer outputs go (and are read back from): layer l
// (a_0 .. a_nt, then feat) at base + l step, feature f at + f k, features
// below nvalid stored; y (nvalid / 2 features) at y, or nowhere. With masks
// (a thread's word 0 of the tile's mask words, words 128 apart), the ReLU
// masks of a_1 .. a_nt, feat (mw words each) and y, as the narrow forward
// writes them.
struct WtOut {
  float* base;
  long long k, step;
  int nvalid;
  float* y;
  uint32_t* masks;
  int mw;
};

// The 64 rows of the encoding tile (written, and visible to the warpgroup)
// through the whole MLP: sig_out[row] (sigma logits) and rgb_out[row * 3 +
// k] (rgb logits) for rows 0..63, written to shared memory (visible to the
// warpgroup once it syncs). db0, db1: the viewdir layer's bias of the
// thread's rows r0 and r0 + 8 (their rays'). Each layer's output is stored
// by O (the default cache policy, so that it is still in L2) and copied back
// into the input tile (evict-first). L1U: layer1's features a load group
// (wt_layer1_fma).
template <int L1U = 2>
__device__ __forceinline__ void wt_forward(const WtTile& T, WtRing& wr, const WtOut& O,
                                           const float* db0, const float* db1, float* sig_out,
                                           float* rgb_out) {
  const int t = threadIdx.x & 127, lane = t & 31, g = lane >> 2, q = lane & 3;
  const int row = 16 * (t >> 5) + g;
  const int hp = T.hp, h2 = hp / 2, nt = T.nt, kch = hp / kKc, bmax = wr.bmax;
  const float* aux = T.aux;
  const float* w_alpha = aux + T.aux_off[nt + 3];
  const float b_alpha = __ldg(aux + T.aux_off[nt + 4]);
  // ---- layer1 (no activation), the trunk, fc_feat: layer l = 0 .. nt + 1
  for (int l = 0; l <= nt + 1; ++l) {
    const bool skip = l >= 1 && l <= nt && ((T.skip_mask >> (l - 1)) & 1);
    const bool head = l == nt;
    const float* bias = aux + T.aux_off[l];
    float* dst = O.base + l * O.step;
    float s0 = 0.f, s1 = 0.f;  // the sigma head's partial sums of rows row, row + 8
    for (int c0 = 0; c0 < hp; c0 += column_block(hp, c0, bmax)) {
      with_bn(column_block(hp, c0, bmax), [&](auto bn) {
        constexpr int BN = decltype(bn)::value;
        float acc[BN / 2];
        if (l > 0) {
          wt_product<BN>(acc, T.in, kch, T.enc, skip ? T.kx : 0, wr);
        } else if (T.w1 != nullptr) {
          wt_layer1_fma<BN, L1U>(acc, T.enc, T.w1, T.dx, hp, c0);
        } else {
          wt_product<BN>(acc, 0, 0, T.enc, T.kx, wr);
        }
        uint32_t m[2] = {0u, 0u};
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int col = c0 + 8 * j + 2 * q;
          const float2 b = __ldg(reinterpret_cast<const float2*>(bias + col));
          float v0 = acc[4 * j] + b.x, v1 = acc[4 * j + 1] + b.y;
          float v2 = acc[4 * j + 2] + b.x, v3 = acc[4 * j + 3] + b.y;
          if (l > 0) {
            v0 = fmaxf(v0, 0.f);
            v1 = fmaxf(v1, 0.f);
            v2 = fmaxf(v2, 0.f);
            v3 = fmaxf(v3, 0.f);
          }
          if (head) {
            const float2 w = __ldg(reinterpret_cast<const float2*>(w_alpha + col));
            s0 = fmaf(v1, w.y, fmaf(v0, w.x, s0));
            s1 = fmaf(v3, w.y, fmaf(v2, w.x, s1));
          }
          if (col < O.nvalid) {
            float* d0 = dst + col * O.k + row;
            __stwb(d0, v0);
            __stwb(d0 + O.k, v1);
            __stwb(d0 + 8, v2);
            __stwb(d0 + O.k + 8, v3);
          }
          const int bit = (4 * j) & 31;
          m[(4 * j) >> 5] |= (v0 > 0.f ? 1u : 0u) << bit | (v1 > 0.f ? 2u : 0u) << bit |
                             (v2 > 0.f ? 4u : 0u) << bit | (v3 > 0.f ? 8u : 0u) << bit;
        }
        if (O.masks != nullptr && l > 0) {
#pragma unroll
          for (int w = 0; w < (BN + 63) / 64; ++w) {
            __stcs(O.masks + ((l - 1) * O.mw + c0 / 64 + w) * 128, m[w]);
          }
        }
      });
    }
    if (head) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
      s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
      s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
      s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
      if (q == 0) {
        sig_out[row] = s0 + b_alpha;
        sig_out[row + 8] = s1 + b_alpha;
      }
    }
    wg_sync(T.bar);  // the output is stored and every warp is done with the input tile
    wt_load_tile(T.in, dst, O.k, O.nvalid, hp);
    wg_sync(T.bar);
  }
  // ---- layers_dir.0 on feat, + the rays' bias: y (saved, its mask); the rgb head
  const float* w_rgb = aux + T.aux_off[nt + 5];
  const float* b_rgb = aux + T.aux_off[nt + 6];
  float c[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
  for (int c0 = 0; c0 < h2; c0 += column_block(h2, c0, bmax)) {
    with_bn(column_block(h2, c0, bmax), [&](auto bn) {
      constexpr int BN = decltype(bn)::value;
      float ad[BN / 2];
      wt_product<BN>(ad, T.in, kch, 0, 0, wr);
      uint32_t ym[2] = {0u, 0u};
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = c0 + 8 * j + 2 * q + e;
          const float* wrg = w_rgb + col * 3;
          const float y0 = fmaxf(ad[4 * j + e] + db0[col], 0.f);
          const float y1 = fmaxf(ad[4 * j + 2 + e] + db1[col], 0.f);
#pragma unroll
          for (int kk = 0; kk < 3; ++kk) {
            const float wk = __ldg(wrg + kk);
            c[0][kk] = fmaf(y0, wk, c[0][kk]);
            c[1][kk] = fmaf(y1, wk, c[1][kk]);
          }
          if (O.y != nullptr && col < O.nvalid / 2) {
            __stcs(O.y + col * O.k + row, y0);
            __stcs(O.y + col * O.k + row + 8, y1);
          }
          const int b = 4 * j + e;
          ym[b >> 5] |= (y0 > 0.f ? 1u : 0u) << (b & 31) | (y1 > 0.f ? 1u : 0u) << ((b + 2) & 31);
        }
      }
      if (O.masks != nullptr) {
#pragma unroll
        for (int w = 0; w < (BN + 63) / 64; ++w) {
          __stcs(O.masks + ((nt + 1) * O.mw + c0 / 64 + w) * 128, ym[w]);
        }
      }
    });
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int x = 1; x < 4; x <<= 1) {
#pragma unroll
      for (int kk = 0; kk < 3; ++kk) c[h][kk] += __shfl_xor_sync(0xffffffffu, c[h][kk], x);
    }
    if (q == 0) {
#pragma unroll
      for (int kk = 0; kk < 3; ++kk) {
        rgb_out[(row + 8 * h) * 3 + kk] = c[h][kk] + __ldg(b_rgb + kk);
      }
    }
  }
}

}  // namespace
