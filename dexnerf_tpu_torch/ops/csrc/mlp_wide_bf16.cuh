// The wide route of the bf16 FlexibleNeRF kernels: widths above 128 (up to
// kWideMaxHidden), where kernel 1's tile (mlp_tile_bf16.cuh) does not fit.
// That tile keeps a 64 x H f32 accumulator and the next layer's A fragments
// in registers (at H = 256 the accumulator alone is 128 registers a thread)
// and streams whole [H][64] K-chunks (32 KB at 256) through a ring that
// already fills the 227 KB of shared memory at H = 128. The wide tile
// instead keeps a layer's input and output in shared memory, as two K-major
// 128 B-swizzled [64][Hp] bf16 tiles a consumer (the encoding tile's layout,
// tile_off), and computes each layer's output in column blocks of 64
// (wide_bn), both operands from shared memory: A from the input tile, B
// from a ring of [64][64] K-chunk pieces that one thread streams by 1-D
// bulk copies out of the same pre-swizzled pack
// (ops/fused_render.py::pack_flex_weights_bf16; a piece is rows c0 .. c0 +
// bn - 1 of a [Hp][64] chunk, contiguous in the pack). A piece is released
// once every wgmma group that reads it is done, so the ring (whose stages
// every consumer reads) needs only a few stages however wide the layer.
//
// What bounds it on the H100 at 8x256: kernel 1 by its multiply-adds (~0.6 M
// a sample, a 400x400 frame of 64 + 128 samples ~36 TFLOP: 36.7 ms at the
// 989 TFLOP/s bf16 peak), the training forward and chain by the scratch they
// store and read (~5 KB a sample each), as the narrow route. The design keeps
// registers and shared memory within one CTA per SM. The training forward
// also writes the ReLU mask words that the chain reads in place of the saved
// activations (wide_mask_words): the chain's 32 scalar mask loads a thread a
// column block were most of its time (PERF.md section 6,
// perf_tools/train_chain_wide_variants.py).
//
// The bf16 contract is the narrow tile's: operands rounded to bf16, f32
// accumulation, bias, ReLU and the chain in f32, the sigma head from the f32
// trunk output and the rgb head from the f32 viewdir-layer output with f32
// weights; PE in f32 by encode_coord. The tensor cores round each k16
// step's sum toward zero into their accumulator, so a running accumulator
// over a layer's whole K biases a sum over many terms one way (ROADMAP
// Queue 3 fault 9). wide_product therefore gives every span of kWideSpan
// k16 steps (a K-chunk, one ring piece) a fresh accumulator and adds it to
// the block's f32 sum on the CUDA cores, to nearest; two fresh accumulators
// alternate, so one span's add runs while the next span's products do. At
// 64-column blocks the sum and the two fresh accumulators are 96 registers
// a thread, within the 168 that ptxas gives each thread at 384 threads (at
// 128 columns, 192 would not fit; a third fresh accumulator at 64 spills).
// Spans of 1 and 2 steps came no nearer the exact contract on the card and
// missed chip_smoke.py's phase 22 (PERF.md section 6). What it costs against
// one accumulator over the whole K at 128 columns: twice the wgmma groups,
// each half as wide, both operands from shared memory (PERF.md section 6).
// Biases and heads are read from the aux buffer in device memory (through
// L1).
#pragma once

#include "mlp_tile_bf16.cuh"

namespace {

// Hp at most: the largest padded width whose plans (wide_plan) fit at the
// kernels' widest encodings (ops/fused_render.py::wide_fits)
constexpr int kWideMaxHidden = 576;
constexpr int kWideMaxCons = 2;  // consumer warpgroups at most
// registers a thread after setmaxnreg: the producer's, each consumer's
// (128 x (40 + 2 x 232) <= 65536)
constexpr int kWideProdRegs = 40, kWideConsRegs = 232;
constexpr int kWideThreads = 128 * (kWideMaxCons + 1);
constexpr int kWideBlock = 64;  // columns of a block at most
constexpr int kWideStage = kWideBlock * 128;  // bytes of a ring stage: a [64][64] bf16 piece
constexpr int kWideMaxStages = 16;
// at least four stages: as many bytes in flight as two [128][64] pieces
constexpr int kWideMinStages = 4;
// k16 steps a fresh accumulator in wide_product (a span; a K-chunk, one
// ring piece, holds 4: a fresh accumulator a piece)
constexpr int kWideSpan = 4;

// The width of the column block at c0 of an n-wide output: 64-column
// blocks (hopper.cuh's column_block), the last one narrower.
__host__ __device__ inline int wide_bn(int n, int c0) { return column_block(n, c0, kWideBlock); }

// Bytes of a consumer's two activation tiles at width hp.
__host__ __device__ inline size_t wide_act_bytes(int hp) {
  return 2 * (size_t)((hp + kKc - 1) / kKc) * kEncChunk;
}

__host__ __device__ inline size_t align1024(size_t x) { return (x + 1023) & ~(size_t)1023; }

// The ReLU mask words the training forward writes for the chain (kernels 3
// and 4): per 64-row tile, wide_mask_words words for each thread of the
// consumer warpgroup, [tile][word][thread]. Word c / 64 of layer l (a_1 ..
// a_nt, feat: ceil(hp / 64) words each; y's ceil(hp / 128) last) holds the
// thread's accumulator entry of row 16 w + g + 8 h and column c + 8 j + 2 q
// + e (w the warp, g = lane / 4, q = lane % 4, j < 8) at bit wide_mask_bit(j,
// h, e) (ops/fused_train_loss.py::wide_mask_layout): 1 where the saved bf16
// activation is > 0.
__host__ __device__ inline int wide_mask_words(int hp, int nt) {
  return (nt + 1) * ((hp + 63) / 64) + (hp / 2 + 63) / 64;
}
__host__ __device__ constexpr int wide_mask_bit(int j, int h, int e) {
  return (h ? 7 : 15) + 16 * e - j;
}

// The mask bits of a packed pair of ReLU outputs in bf16 (low half e = 0) of
// rows h, at wide_mask_bit(j, h, e): a half is > 0 where it is not +-0 (no
// negative or NaN half leaves a ReLU), so (half & 0x7fff) + 0x7fff sets its
// top bit, and nothing carries out of the low half.
__device__ __forceinline__ uint32_t mask_flags(uint32_t pair, int j, int h) {
  const int s = j + (h ? 8 : 0);
  return (((pair & 0x7fff7fffu) + 0x7fff7fffu) >> s) & (0x80008000u >> s);
}

// A wide kernel's shared-memory plan: from the 1024-aligned base, `stages`
// ring stages, then `cons` consumer blocks of cons_bytes (a multiple of
// 1024), then a full and an empty mbarrier per stage; `smem` bytes in all
// with the slack that aligns the base. The most consumers (up to
// kWideMaxCons), then the most stages (up to kWideMaxStages, at least
// kWideMinStages) that fit; cons = 0 if none fits.
struct WidePlan {
  int cons, stages;
  size_t smem;
};

__host__ __device__ inline WidePlan wide_plan(size_t cons_bytes) {
  for (int c = kWideMaxCons; c >= 1; --c) {
    for (int ns = kWideMaxStages; ns >= kWideMinStages; --ns) {
      const size_t total = 1024 + (size_t)ns * (kWideStage + 16) + c * cons_bytes;
      if (total <= (size_t)kSmemMax) return WidePlan{c, ns, total};
    }
  }
  return WidePlan{0, 0, 0};
}

__device__ __forceinline__ void wgmma_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// A consumer warp's view of the wide ring: pieces are acquired and released
// in stream order.
struct WideRing {
  uint32_t ring, full, empty;
  int ns, lane;
  int head = 0, tail = 0;
  __device__ __forceinline__ uint32_t acquire() {
    const int s = head % ns;
    mbar_wait(full + 8 * s, (head / ns) & 1);
    ++head;
    return ring + s * kWideStage;
  }
  __device__ __forceinline__ void release() {
    if (lane == 0) mbar_arrive(empty + 8 * (tail % ns));
    ++tail;
  }
};

// The producer's side: one piece of `bytes` at w + off into the next stage.
struct WideStream {
  const unsigned char* w;
  uint32_t ring, full, empty;
  int ns;
  int it = 0;
  __device__ __forceinline__ void put(size_t off, int bytes) {
    const int s = it % ns;
    mbar_wait(empty + 8 * s, ((it / ns) & 1) ^ 1);
    mbar_expect_tx(full + 8 * s, bytes);
    bulk_load(ring + s * kWideStage, w + off, bytes, full + 8 * s);
    ++it;
  }
  // the pieces of one product, in the consumers' order: per column block of
  // the n-wide output, nh K-chunks of the operand at oh, then ne of the one
  // at oe (both packed as [chunks][n][64])
  __device__ __forceinline__ void product(size_t oh, int nh, size_t oe, int ne, int n) {
    for (int c0 = 0; c0 < n; c0 += wide_bn(n, c0)) {
      const int bytes = wide_bn(n, c0) * 128;
      for (int c = 0; c < nh; ++c) put(oh + ((size_t)c * n + c0) * 128, bytes);
      for (int c = 0; c < ne; ++c) put(oe + ((size_t)c * n + c0) * 128, bytes);
    }
  }
  // `passes` passes over the forward pack of a model of padded width hp, kx
  // encoding chunks, nt trunk layers (skip_mask: those that read the
  // encoding): layer1, the trunk, fc_feat, the feat rows of layers_dir.0
  __device__ void forward(int passes, int hp, int kx, int nt, int skip_mask) {
    const int kch = (hp + kKc - 1) / kKc;
    const size_t ch = (size_t)hp * 128;  // bytes of a [hp][64] chunk
    for (int ps = 0; ps < passes; ++ps) {
      size_t off = 0;
      product(off, kx, 0, 0, hp);
      off += kx * ch;
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
};

// Pieces of one pass over the forward pack (a consumer with no tile in a
// pass releases them all).
__host__ __device__ inline int wide_fwd_pieces(int hp, int kx, int nt, int skip_mask) {
  const int kch = (hp + kKc - 1) / kKc;
  auto blocks = [](int n) {
    int k = 0;
    for (int c0 = 0; c0 < n; c0 += wide_bn(n, c0)) ++k;
    return k;
  };
  int nskip = 0;
  for (int i = 0; i < nt; ++i) nskip += (skip_mask >> i) & 1;
  return blocks(hp) * (kx * (1 + nskip) + (nt + 1) * kch) + blocks(hp / 2) * kch;
}

// acc[64 x BN] = A B over nh K-chunks of the tile at ah (kh16 valid k16 steps
// in all: columns past them are never read) and ne chunks of the tile at ae
// (all four steps), each against the next ring piece. Each span of
// kWideSpan k16 steps of a chunk (fewer at a short chunk's end) goes into a
// fresh accumulator (scale-d 0 on its first step), one wgmma group; the
// spans alternate between f0 and f1, and once span i + 1 is issued, span i
// is waited for (wgmma.wait_group 1) and added to acc in f32, to nearest, in
// span order. A piece is released when the last span that reads it is done.
template <int BN>
__device__ __forceinline__ void wide_product(float (&acc)[BN / 2], uint32_t ah, int nh, int kh16,
                                             uint32_t ae, int ne, WideRing& wr) {
  const int n = nh + ne;
  int c = 0, k = 0, steps = 0;  // the next span's chunk and first step; the chunk's steps
  uint32_t a = 0, st = 0;
  // the next span into f; whether it ends its chunk
  auto issue = [&](float(&f)[BN / 2]) {
    if (k == 0) {
      st = wr.acquire();
      const bool h = c < nh;
      a = h ? ah + c * kEncChunk : ae + (c - nh) * kEncChunk;
      steps = h ? min(4, kh16 - 4 * c) : 4;
    }
    fence_regs(f);
    wgmma_fence();
#pragma unroll
    for (int i = 0; i < kWideSpan; ++i) {
      if (i == 0 || k + i < steps) {
        wgmma_bf16<BN, 0, 0>(f, kmajor_desc(a + (k + i) * 32), kmajor_desc(st + (k + i) * 32),
                             i > 0);
      }
    }
    wgmma_commit();
    k += kWideSpan;
    const bool ends = k >= steps;
    if (ends) {
      k = 0;
      ++c;
    }
    return ends;
  };
  // the span in f is done: into the sum, and its piece released if it ends it
  auto retire = [&](float(&f)[BN / 2], bool ends) {
    fence_regs(f);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] += f[i];
    if (ends) wr.release();
  };
  float f0[BN / 2], f1[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  bool e0 = issue(f0), e1;
  while (true) {
    if (c == n) {
      wgmma_wait0();
      retire(f0, e0);
      break;
    }
    e1 = issue(f1);
    wgmma_wait1();
    retire(f0, e0);
    if (c == n) {
      wgmma_wait0();
      retire(f1, e1);
      break;
    }
    e0 = issue(f0);
    wgmma_wait1();
    retire(f1, e1);
  }
  fence_regs(acc);
}

// f(BN) with BN a compile-time width for the run-time width bn of a block
// (wide_bn of a multiple of 16: 64, the last 48, 32 or 16).
template <class F>
__device__ __forceinline__ void with_wide_bn(int bn, F&& f) {
  switch (bn) {
    case 64: f(std::integral_constant<int, 64>{}); break;
    case 48: f(std::integral_constant<int, 48>{}); break;
    case 32: f(std::integral_constant<int, 32>{}); break;
    default: f(std::integral_constant<int, 16>{}); break;
  }
}

// A hidden layer's epilogue on the column block c0 of an [64 x BN]
// accumulator: act(acc + bias) in f32, rounded to bf16 into the tile at out;
// with wa, the sigma head's partial sums v . wa of rows g (s0) and g + 8 (s1);
// with words (a shared [ceil(hp / 64)][128] buffer), the layer's mask words.
template <int BN>
__device__ __forceinline__ void wide_hidden_epilogue(const float (&acc)[BN / 2], int c0,
                                                     const float* bias, bool relu,
                                                     const float* wa, float& s0, float& s1,
                                                     uint32_t out, uint32_t words) {
  const int t = threadIdx.x & 127, lane = t & 31, g = lane >> 2, q = lane & 3;
  const int row = 16 * (t >> 5) + g;
  uint32_t word = 0;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = c0 + 8 * j + 2 * q;
    const float2 b = __ldg(reinterpret_cast<const float2*>(bias + col));
    float v0 = acc[4 * j] + b.x, v1 = acc[4 * j + 1] + b.y;
    float v2 = acc[4 * j + 2] + b.x, v3 = acc[4 * j + 3] + b.y;
    if (relu) {
      v0 = fmaxf(v0, 0.f);
      v1 = fmaxf(v1, 0.f);
      v2 = fmaxf(v2, 0.f);
      v3 = fmaxf(v3, 0.f);
    }
    const uint32_t p01 = pack_bf16(v0, v1), p23 = pack_bf16(v2, v3);
    sts32(out + tile_off(row, col), p01);
    sts32(out + tile_off(row + 8, col), p23);
    if (words != 0) {
      word |= mask_flags(p01, j & 7, 0) | mask_flags(p23, j & 7, 1);
      if ((j & 7) == 7 || j == BN / 8 - 1) {
        sts32(words + (((c0 >> 6) + (j >> 3)) * 128 + t) * 4, word);
        word = 0;
      }
    }
    if (wa != nullptr) {
      const float2 w = __ldg(reinterpret_cast<const float2*>(wa + col));
      s0 = fmaf(v1, w.y, fmaf(v0, w.x, s0));
      s1 = fmaf(v3, w.y, fmaf(v2, w.x, s1));
    }
  }
}

// The viewdir layer's epilogue on the column block c0 (rows r0 + 16 w + g
// and + 8; r0 counts from dirb's first ray): y = ReLU(acc + the ray's
// viewdir bias, h2 wide), into the rgb head's sums c and, with ytile, rounded
// to bf16 into that tile; with words, y's mask words (as
// wide_hidden_epilogue's).
template <int BN>
__device__ __forceinline__ void wide_dir_epilogue(const float (&ad)[BN / 2], int c0, int h2,
                                                  int r0, int S, int nrays, const float* dirb,
                                                  const float* w_rgb, float (&c)[2][3],
                                                  uint32_t ytile, uint32_t words) {
  const int t = threadIdx.x & 127, lane = t & 31, g = lane >> 2, q = lane & 3;
  const int row = 16 * (t >> 5) + g, r = r0 + row;
  const float* db0 = dirb + (size_t)min(r / S, nrays - 1) * h2;
  const float* db1 = dirb + (size_t)min((r + 8) / S, nrays - 1) * h2;
  uint32_t word = 0;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = c0 + 8 * j + 2 * q;
    float y0[2], y1[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float* wr = w_rgb + (col + e) * 3;
      const float w0 = __ldg(wr), w1 = __ldg(wr + 1), w2 = __ldg(wr + 2);
      y0[e] = fmaxf(ad[4 * j + e] + db0[col + e], 0.f);
      y1[e] = fmaxf(ad[4 * j + 2 + e] + db1[col + e], 0.f);
      c[0][0] = fmaf(y0[e], w0, c[0][0]);
      c[0][1] = fmaf(y0[e], w1, c[0][1]);
      c[0][2] = fmaf(y0[e], w2, c[0][2]);
      c[1][0] = fmaf(y1[e], w0, c[1][0]);
      c[1][1] = fmaf(y1[e], w1, c[1][1]);
      c[1][2] = fmaf(y1[e], w2, c[1][2]);
    }
    if (ytile != 0) {
      const uint32_t p0 = pack_bf16(y0[0], y0[1]), p1 = pack_bf16(y1[0], y1[1]);
      sts32(ytile + tile_off(row, col), p0);
      sts32(ytile + tile_off(row + 8, col), p1);
      if (words != 0) {
        word |= mask_flags(p0, j & 7, 0) | mask_flags(p1, j & 7, 1);
        if ((j & 7) == 7 || j == BN / 8 - 1) {
          sts32(words + (((c0 >> 6) + (j >> 3)) * 128 + t) * 4, word);
          word = 0;
        }
      }
    }
  }
}

// One consumer's wide tile: its two activation tiles, its encoding tile, the
// model's shape and its aux buffer (device memory, offsets as the narrow
// kernels').
struct WideTile {
  uint32_t act[2], enc;
  const float* aux;
  const int* aux_off;
  int hp, kx, nt, skip_mask, bar;
  uint32_t words;  // the mask words' two shared [ceil(hp / 64)][128] buffers, or 0
};

// The 64 rows of the encoding tile (written and fenced) through the whole
// MLP: sig_out[row] (sigma logits) and rgb_out[row * 3 + k] (rgb logits) for
// rows 0..63, written to shared memory and visible to the warpgroup on
// return. With maps, every activation is stored by TMA to its scratch block
// (a_0 .. a_nt, feat, y: blocks 1 .. nt + 3 of maps) at rows row0 ..
// row0 + 63 once its tile is complete, and with masks (the tile's mask
// words in device memory; T.words their shared buffers) the ReLU mask words
// of a_1 .. a_nt, feat and y (wide_mask_words), each layer's written to a
// buffer and stored by a bulk copy with its tile. r0, S, nrays and dirb place
// the rows for the per-ray viewdir bias (see wide_dir_epilogue).
__device__ __forceinline__ void wide_tile(const WideTile& T, WideRing& wr, int r0, int S, int nrays,
                                          const float* dirb, float* sig_out, float* rgb_out,
                                          const CUtensorMap* maps, int row0,
                                          uint32_t* masks = nullptr) {
  const int t = threadIdx.x & 127, lane = t & 31, g = lane >> 2, q = lane & 3;
  const int row = 16 * (t >> 5) + g;
  const int hp = T.hp, h2 = hp / 2, nt = T.nt, kch = (hp + kKc - 1) / kKc;
  const int mw = (hp + 63) / 64;  // mask words of a layer
  // mask words i (layer i + 1; y's last) go to buffer (i + 1) % 2: the
  // store of the words two layers back has read it when the tile has
  auto wbuf = [&](int i) {
    return masks != nullptr ? T.words + (uint32_t)((i + 1) & 1) * mw * 512u : 0u;
  };
  const float* aux = T.aux;
  const float* w_alpha = aux + T.aux_off[nt + 3];
  const float b_alpha = __ldg(aux + T.aux_off[nt + 4]);
  // the layer's output tile is complete: fence it for wgmma and TMA, and
  // store it as `boxes` [64][64] boxes to scratch block blk
  // (and mask words i, nw of them, in the same bulk group)
  auto finish = [&](uint32_t out, int blk, int boxes, int i, int nw) {
    fence_async_smem();
    wg_sync(T.bar);
    if (maps != nullptr) {
      if (t == 0) {
        for (int x = 0; x < boxes; ++x) tma_store_2d(maps + blk, 64 * x, row0, out + x * kEncChunk);
        if (masks != nullptr && i >= 0) bulk_store(masks + i * mw * 128, wbuf(i), nw * 512);
        bulk_commit();
        bulk_wait_read<1>();  // the store before it (the tile written next) has read it
      }
      wg_sync(T.bar);
    }
  };
  auto head = [&](float s0, float s1) {  // the sigma logits of rows g, g + 8
    s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
    s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
    if (q == 0) {
      sig_out[row] = s0 + b_alpha;
      sig_out[row + 8] = s1 + b_alpha;
    }
  };
  // ---- layer1 (no activation), the trunk, fc_feat: layer l = 0 .. nt + 1
  int cur = 0;
  for (int l = 0; l <= nt + 1; ++l) {
    const bool skip = l >= 1 && l <= nt && ((T.skip_mask >> (l - 1)) & 1);
    const bool has_head = l == (nt > 0 ? nt : 0);
    const uint32_t in = T.act[cur], out = T.act[l == 0 ? 0 : cur ^ 1];
    const float* bias = aux + T.aux_off[l];
    const uint32_t words = l > 0 ? wbuf(l - 1) : 0u;
    float s0 = 0.f, s1 = 0.f;
    // the layer's A: layer1 the encoding alone, a skip layer the encoding after the input
    const uint32_t ah = l == 0 ? 0u : in;
    const int nh = l == 0 ? 0 : kch, kh16 = l == 0 ? 0 : hp / 16, ne = l == 0 || skip ? T.kx : 0;
    for (int c0 = 0; c0 < hp; c0 += wide_bn(hp, c0)) {
      with_wide_bn(wide_bn(hp, c0), [&](auto bn) {
        constexpr int BN = decltype(bn)::value;
        float acc[BN / 2];
        wide_product<BN>(acc, ah, nh, kh16, T.enc, ne, wr);
        wide_hidden_epilogue<BN>(acc, c0, bias, l > 0, has_head ? w_alpha : nullptr, s0, s1, out,
                                 words);
      });
    }
    if (has_head) head(s0, s1);
    finish(out, 1 + l, kch, l - 1, mw);
    cur = l == 0 ? 0 : cur ^ 1;
  }
  // ---- layers_dir.0 on feat, + the per-ray bias; y to the other tile when
  // saved; the rgb head
  const float* w_rgb = aux + T.aux_off[nt + 5];
  const float* b_rgb = aux + T.aux_off[nt + 6];
  const uint32_t ytile = maps != nullptr ? T.act[cur ^ 1] : 0u;
  float crgb[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
  for (int c0 = 0; c0 < h2; c0 += wide_bn(h2, c0)) {
    with_wide_bn(wide_bn(h2, c0), [&](auto bn) {
      constexpr int BN = decltype(bn)::value;
      float ad[BN / 2];
      wide_product<BN>(ad, T.act[cur], kch, hp / 16, 0, 0, wr);
      wide_dir_epilogue<BN>(ad, c0, h2, r0, S, nrays, dirb, w_rgb, crgb, ytile, wbuf(nt + 1));
    });
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int x = 1; x < 4; x <<= 1) {
#pragma unroll
      for (int k = 0; k < 3; ++k) crgb[h][k] += __shfl_xor_sync(0xffffffffu, crgb[h][k], x);
    }
    if (q == 0) {
#pragma unroll
      for (int k = 0; k < 3; ++k) rgb_out[(row + 8 * h) * 3 + k] = crgb[h][k] + __ldg(b_rgb + k);
    }
  }
  finish(ytile, nt + 3, (h2 + kKc - 1) / kKc, nt + 1, (h2 + 63) / 64);
}

}  // namespace
