// The weight gradients of the float32 training kernels (kernel 4's pass and
// kernel 3's field backward, both in fused_train_loss.cu)
// on Hopper's tensor cores, in split TF32, for the H100 (sm_90a).
//
// Replaces the dW contraction of dexnerf_tpu/ops/fused_mlp_train.py::
// _backward_chain_parts (matT), which the Pallas kernels of
// fused_train_loss.py:99 and fused_mlp_train.py:221 run in their bodies:
// dW = delta^T a over every sample of a chunk, f32 operands, f32 sums.
//
// The pass kernels leave a feature-major f32 scratch (Rows in
// train_rows.cuh): row = feature, contiguous along the chunk's k samples,
// the K-major layout TF32 wgmma reads from shared memory. The launch is
// bound by the bytes of that scratch (~10 KB a sample for 8x128, 4.7 ms a
// step at 3.35 TB/s); its multiply-adds, three TF32 products each, take
// ~3.0 ms at the 495 TFLOP/s TF32 peak.
//
// Design (ops/_weight_grads.py::tf32_dw_plan builds the plan):
// * Units (up to a width of 128; above it each product is split to the
//   limits below, at most 128 cotangent rows and two 128-row operand pieces
//   a unit, and the plan launched in parts of at most kDwMaxUnits units,
//   reduced together: ops/_weight_grads.py::_tf32_units, reduce_slots):
//   the products that share a cotangent block read it once: layer1
//   (d_0 x e), each trunk layer (d_{i+1} x a_i, with d_{i+1} x e on a skip
//   layer), fc_feat with the fc_alpha head (d_feat x a_nt, d_sigma x
//   a_nt), layers_dir.0's feat rows with the fc_rgb head (d_y x feat,
//   d_rgb x y). A stage of a unit is its boxes of 32 samples: [64 rows][32]
//   f32 TMA boxes in the 128 B swizzle (the cotangent block's first), and
//   for a head its [8][32] cotangent box, last.
// * Persistent CTAs, one per SM, each taking an equal share of the plan's
//   bytes over K (dw_span, as the bf16 route's dW kernel); each part of a
//   unit goes to its own slot of partial sums, and dw_tf32_reduce_kernel
//   sums the slots in a fixed order: two runs are bitwise equal.
// * Warpgroup 0, the producer: its first thread issues the stages' TMA
//   loads into an n_stages ring, each as soon as its ring slot is free;
//   its other warps take the viewdir rows of layers_dir.0 (K = rays, off
//   TMA).
// * Warpgroup 1, the transform: its four warps split each stage's B
//   (activation) boxes, x = hi + lo with hi = x as wgmma reads it (the
//   tensor cores read the top 19 bits of an f32 word: x truncated to TF32,
//   no store needed) and lo = tf32(x - hi) (round to nearest, ties away),
//   into one of two lo buffers.
// * Warpgroups 2 and 3, the consumers: m64nNk8 .tf32 wgmma with A, the
//   cotangent box (M = 64 output rows), from registers (each consumer
//   loads and splits its own A box) and B, the activation boxes (N = 64 or
//   128), from shared memory: three products (lo.hi, hi.lo, hi.hi; lo.lo,
//   ~2^-20 of a product, dropped) of each 32-sample stage into a fresh
//   accumulator of one or two stages (two where the registers hold the
//   accumulators and both stages' fragments: the second stage's products
//   are issued while the first's run), then added to the part's sum in f32
//   on the CUDA cores: the tensor cores truncate each k8 step into their
//   accumulator, which over a long K would cost the f32 contract its
//   tolerance, so their sums stay short. While the products run, the CUDA
//   cores sum the A box's bias rows and take the thin heads (fc_alpha N =
//   1, fc_rgb N = 3).
//   Shared memory bandwidth decided the split of roles: the transform
//   writing every operand's lo and wgmma reading A from shared memory
//   moved ~1.8x the bytes a stage that the SM could move in the stage's
//   share of HBM time (PERF.md).

#include <cuda.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <string.h>

#include "dw_split.cuh"
#include "mlp_tile_tf32.cuh"

namespace {

constexpr int kBoxRows = 64;
constexpr int kBox = kChunk;  // bytes of a [64][32] f32 box
constexpr int kHeadRows = 8;
constexpr int kHeadBox = kHeadRows * 128;
constexpr int kMaxBoxes = 8;
constexpr int kMaxParts = 2;
constexpr int kLoBufs = 2;
constexpr int kMaxDwStages = 8;
constexpr int kDwThreads = 512;     // producer, transform, two consumer warpgroups
constexpr int kProducerRegs = 24;   // setmaxnreg: 128 (24 + 40) + 256 x 224 = 512 x 128
constexpr int kTransformRegs = 40;
constexpr int kConsumerRegs = 224;

// The plan, mirrored by ops/_weight_grads.py (_Tf32Part, _Tf32Wg,
// _Tf32Unit, _Tf32Args). A consumer part: D[r][c] = sum_k A[r][k] B[c][k]
// over the B boxes b..b + nb - 1, written to partial[slot][base + r ldw +
// c] for r < n_lim, c < m_lim.
struct Tf32Part {
  int b, nb;
  int base, ldw, m_lim;
};

// A consumer warpgroup's share of a unit: its A box and parts; shape codes
// the parts' box counts: 0 none, 1 (1), 2 (2), 3 (1, 1), 4 (2, 1), 5 (2, 2).
struct Tf32Wg {
  int a, n_lim, shape, pad;
  Tf32Part part[kMaxParts];
};

// A unit: its boxes in stage order (the n_a cotangent boxes, the other
// operand boxes, a head's operand box if it is no operand, the head box
// last), each a tensor map (0: activations, 1: cotangents, 2: cotangents
// in [8][32] boxes), first row and byte offset in the stage; the
// cotangent block's valid rows and bias offset (-1: none); the head (h_rows
// cotangent rows, 0 for none) over the boxes h_box0.., dW_head[c][m] at
// h_w + c h_ldw + m (m < h_mlim), its bias at h_bias + c (-1: none).
struct Tf32Unit {
  int n_box, n_op, tx, cost;  // boxes, operand boxes (first), bytes a stage, cost a stage
  int map[kMaxBoxes], row[kMaxBoxes], off[kMaxBoxes];
  int n_a, a_rows, bias;
  int h_rows, h_box0, h_nbox, h_w, h_ldw, h_mlim, h_bias;
  Tf32Wg wg[2];
};

struct Tf32Args {
  CUtensorMap maps[3];  // act in [64][32] boxes, dlt the same, dlt in [8][32]
  Tf32Unit units[kDwMaxUnits];
  float* partial;         // [chunks][max_pieces][n_params]
  float* vd;              // [chunks][H/2][dd] the viewdir rows' dW of each chunk
  const float* dy_sum;    // [H/2][rays] of this chunk
  const float* dir_enc;   // [dd][rays]
  long long n_params;
  int n_units, total_cost, grid, max_pieces;
  int n_stages, stage_bytes, lo_bytes, n_st;  // n_st: stages of 32 samples of this chunk
  int chunk, rays, dd, h2;
  int pad[2];
};
static_assert(sizeof(Tf32Args) % 64 == 0 && offsetof(Tf32Args, pad) + 8 == sizeof(Tf32Args),
              "Tf32Args is mirrored without tail padding");

// ---- shared memory
// Byte offset of row r's 16 B group g in a 128 B-swizzled [rows][32] box.
__device__ __forceinline__ uint32_t grp(int r, int g) {
  return r * 128 + ((g ^ (r & 7)) << 4);
}

// The split's low half: x - hi, hi = x truncated to TF32 (what wgmma reads
// of x), rounded to TF32; x - hi is exact in f32.
__device__ __forceinline__ float lo_tf32(float x) {
  const float hi = __uint_as_float(__float_as_uint(x) & 0xffffe000u);
  return __uint_as_float(tf32_bits(__fsub_rn(x, hi)));
}

// ---- helpers of both roles
// The low halves of a float4 (see lo_tf32).
__device__ __forceinline__ float4 lo4(float4 v) {
  return make_float4(lo_tf32(v.x), lo_tf32(v.y), lo_tf32(v.z), lo_tf32(v.w));
}

// Thread (r, h) = (t / 2, t % 2) of a [64][32] box reads row r, 16 B
// groups 4h..4h+3. The sum of its 16 values, in order.
__device__ __forceinline__ float row_sum(uint32_t box, int r, int h) {
  float s = 0.f;
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    const float4 v = lds128(box + grp(r, 4 * h + jj));
    s += v.x;
    s += v.y;
    s += v.z;
    s += v.w;
  }
  return s;
}

// acc + the dot product of the thread's 16 values of box row r with the
// same positions of the head box's row c (f32 FMA, in order).
__device__ __forceinline__ float head_dot(uint32_t box, uint32_t head, int r, int h, int c,
                                          float acc) {
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    const float4 v = lds128(box + grp(r, 4 * h + jj));
    const float4 w = lds128(head + grp(c, 4 * h + jj));
    acc = fmaf(v.x, w.x, acc);
    acc = fmaf(v.y, w.y, acc);
    acc = fmaf(v.z, w.z, acc);
    acc = fmaf(v.w, w.w, acc);
  }
  return acc;
}

// ---- the producer warpgroup
// The loads of the CTA's stages, in order, each once its ring slot is free
// (thread 0).
__device__ __forceinline__ void produce(const Tf32Args& p, int b, uint32_t ring, uint32_t full,
                                        uint32_t empty) {
  const int NS = p.n_stages;
  int it = 0, pre = 0;
  for (int u = 0; u < p.n_units; ++u) {
    const Tf32Unit& U = p.units[u];
    int piece, j0, j1;
    const bool mine = dw_span(p.n_st, pre, U.cost, p.total_cost, p.grid, b, &piece, &j0, &j1);
    pre += U.cost;
    if (!mine) continue;
    for (int j = j0; j < j1; ++j, ++it) {
      const int s = it % NS;
      const uint32_t st = ring + s * p.stage_bytes;
      mbar_wait(empty + 8 * s, ((it / NS) & 1) ^ 1);
      mbar_expect_tx(full + 8 * s, U.tx);
      for (int x = 0; x < U.n_box; ++x) {
        tma_load_2d(st + U.off[x], &p.maps[U.map[x]], j * kKc, U.row[x], full + 8 * s);
      }
    }
  }
}

// The viewdir rows of layers_dir.0 (warps 1-3 of the producer warpgroup):
// dW[c][H + jd] = sum over the chunk's rays of dy_sum[c] dir_enc[jd],
// entry o = c dd + jd taken by warp (o - b) / G % 3 + 1 of CTA o % G; lanes
// stride the rays, then a fixed tree.
__device__ __forceinline__ void viewdir(const Tf32Args& p, int b, int warp, int lane) {
  const int n_vd = p.h2 * p.dd;
  for (int o = b + p.grid * (warp - 1); o < n_vd; o += 3 * p.grid) {
    const int c = o / p.dd, jd = o - c * p.dd;
    const float* dy = p.dy_sum + (long long)c * p.rays;
    const float* de = p.dir_enc + (long long)jd * p.rays;
    float acc = 0.f;
    for (int q = lane; q < p.rays; q += 32) acc = fmaf(dy[q], de[q], acc);
#pragma unroll
    for (int x = 16; x > 0; x >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, x);
    if (lane == 0) p.vd[(long long)p.chunk * n_vd + o] = acc;
  }
}

// ---- the transform warpgroup
// Each stage's B boxes split (x = hi + lo, the lo halves into lo buffer
// it % 2, box x at (x - n_a) boxes) once its loads have landed and the
// consumers are done with the buffer's last stage.
__device__ __forceinline__ void transform(const Tf32Args& p, int b, uint32_t ring, uint32_t lo0,
                                          uint32_t full, uint32_t ready, uint32_t empty) {
  const int NS = p.n_stages;
  const int t = threadIdx.x & 127, r = t >> 1, h = t & 1, lane = t & 31;
  int it = 0, pre = 0;
  for (int u = 0; u < p.n_units; ++u) {
    const Tf32Unit& U = p.units[u];
    int piece, j0, j1;
    const bool mine = dw_span(p.n_st, pre, U.cost, p.total_cost, p.grid, b, &piece, &j0, &j1);
    pre += U.cost;
    if (!mine) continue;
    for (int j = j0; j < j1; ++j, ++it) {
      const int s = it % NS;
      mbar_wait(full + 8 * s, (it / NS) & 1);
      if (it >= kLoBufs) {
        const int q = it - kLoBufs;
        mbar_wait(empty + 8 * (q % NS), (q / NS) & 1);
      }
      const uint32_t st = ring + s * p.stage_bytes, lo = lo0 + (it & 1) * p.lo_bytes;
      for (int x = U.n_a; x < U.n_op; ++x) {
        const uint32_t src = st + U.off[x], dst = lo + (x - U.n_a) * kBox;
        float4 v[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) v[jj] = lds128(src + grp(r, 4 * h + jj));
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) sts128(dst + grp(r, 4 * h + jj), lo4(v[jj]));
      }
      fence_async_smem();  // the lo halves, visible to wgmma
      __syncwarp();
      if (lane == 0) mbar_arrive(ready + 8 * s);
    }
  }
}

// ---- the consumers
// The thread's part of the A box's stage as wgmma's A fragments (rows ra,
// ra + 8, K positions 8 ks + q and + 4; see wgmma_tf32_rs), split: hi the
// word as it lies (wgmma reads its TF32 bits), lo = lo_tf32. Adds the
// values to the rows' bias sums b0, b1 (k8 steps in order, position q
// then q + 4).
__device__ __forceinline__ void load_a(uint32_t abox, int ra, int q, uint32_t (&ah)[16],
                                       uint32_t (&al)[16], float& b0, float& b1) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = ra + 8 * (e & 1), pos = 8 * ks + q + 4 * (e >> 1);
      const uint32_t x = lds32(abox + row * 128 + (((pos >> 2) ^ (row & 7)) << 4) + (pos & 3) * 4);
      ah[4 * ks + e] = x;
      al[4 * ks + e] = __float_as_uint(lo_tf32(__uint_as_float(x)));
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (e & 1) {
        b1 += __uint_as_float(ah[4 * ks + e]);
      } else {
        b0 += __uint_as_float(ah[4 * ks + e]);
      }
    }
  }
}

// One stage's three products of a part into d (from zero when fresh),
// issued, not waited for: A from the fragments ah, al, B (hi at bh, lo at
// bl) [64 NB][32]; lo.hi and hi.lo per k8 step, then hi.hi.
template <int NB>
__device__ __forceinline__ void part_issue(float (&d)[32 * NB], const uint32_t (&ah)[16],
                                           const uint32_t (&al)[16], uint32_t bh, uint32_t bl,
                                           bool fresh) {
  constexpr int N = 64 * NB;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    wgmma_tf32_rs<N>(d, al[4 * ks], al[4 * ks + 1], al[4 * ks + 2], al[4 * ks + 3],
                     kmajor_desc(bh + ks * 32), !fresh || ks != 0);
    wgmma_tf32_rs<N>(d, ah[4 * ks], ah[4 * ks + 1], ah[4 * ks + 2], ah[4 * ks + 3],
                     kmajor_desc(bl + ks * 32), 1);
  }
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    wgmma_tf32_rs<N>(d, ah[4 * ks], ah[4 * ks + 1], ah[4 * ks + 2], ah[4 * ks + 3],
                     kmajor_desc(bh + ks * 32), 1);
  }
}

__device__ __forceinline__ void wgmma_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

template <int NB>
__device__ __forceinline__ void store_part(const float (&sum)[32 * NB], const Tf32Part& P,
                                           int n_lim, float* out) {
  const int t = threadIdx.x & 127;
  const int row0 = 16 * (t >> 5) + ((t & 31) >> 2), col0 = 2 * (t & 3);
#pragma unroll
  for (int e = 0; e < 32 * NB; ++e) {
    const int rr = row0 + 8 * ((e >> 1) & 1), c = 8 * (e >> 2) + col0 + (e & 1);
    if (rr < n_lim && c < P.m_lim) out[P.base + (long long)rr * P.ldw + c] = sum[e];
  }
}

// A consumer warpgroup's work of one unit (see consume): its per-stage
// CUDA-core parts, and where its sums go.
struct Consumer {
  const Tf32Args& p;
  const Tf32Unit& U;
  const Tf32Wg& W;
  int cw, t, lane, q, r, h, ra;
  bool bias, head, head_bias;
  float b0 = 0.f, b1 = 0.f, hb = 0.f, hp[3] = {0.f, 0.f, 0.f};

  __device__ __forceinline__ Consumer(const Tf32Args& p_, const Tf32Unit& U_, const Tf32Wg& W_,
                                      int cw_, bool has_parts)
      : p(p_), U(U_), W(W_), cw(cw_) {
    t = threadIdx.x & 127;
    lane = t & 31;
    q = lane & 3;
    r = t >> 1;
    h = t & 1;
    ra = 16 * (t >> 5) + (lane >> 2);
    bias = has_parts && U.bias >= 0 && (U.n_a > 1 || cw == 0);
    head = U.h_rows > 0 && cw < U.h_nbox;
    head_bias = U.h_rows > 0 && U.h_bias >= 0 && cw == 1;
  }
  // The stage at st: its A fragments (when the warpgroup has parts) and
  // bias sums.
  __device__ __forceinline__ void load(uint32_t st, uint32_t (&ah)[16], uint32_t (&al)[16]) {
    float c0 = 0.f, c1 = 0.f;
    load_a(st + U.off[W.a], ra, q, ah, al, c0, c1);
    if (bias) {
      b0 += c0;
      b1 += c1;
    }
  }
  // The stage's heads, on the CUDA cores while its products run.
  __device__ __forceinline__ void heads(uint32_t st) {
    const uint32_t hd = st + U.off[U.n_box - 1];
    if (head) {
      const uint32_t bx = st + U.off[U.h_box0 + cw];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        if (c < U.h_rows) hp[c] = head_dot(bx, hd, r, h, c, hp[c]);
      }
    }
    if (head_bias && r < U.h_rows) hb += row_sum(hd, r, h);
  }
  __device__ __forceinline__ void release(uint32_t empty, int it) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * (it % p.n_stages));
  }
  // The bias of rows ra, ra + 8 (the four q lanes' sums in one order), the
  // head's dW of operand rows 64 cw + r and its bias (the two halves of a
  // row) into the slot at out.
  __device__ __forceinline__ void finish(float* out) {
    b0 += __shfl_xor_sync(0xffffffffu, b0, 1);
    b1 += __shfl_xor_sync(0xffffffffu, b1, 1);
    b0 += __shfl_xor_sync(0xffffffffu, b0, 2);
    b1 += __shfl_xor_sync(0xffffffffu, b1, 2);
    if (bias && q == 0) {
      const int row = kBoxRows * W.a + ra;
      if (row < U.a_rows) out[U.bias + row] = b0;
      if (row + 8 < U.a_rows) out[U.bias + row + 8] = b1;
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float v = hp[c] + __shfl_xor_sync(0xffffffffu, hp[c], 1);
      const int m = kBoxRows * cw + r;
      if (head && h == 0 && c < U.h_rows && m < U.h_mlim) out[U.h_w + c * U.h_ldw + m] = v;
    }
    const float hbs = hb + __shfl_xor_sync(0xffffffffu, hb, 1);
    if (head_bias && h == 0 && r < U.h_rows) out[U.h_bias + r] = hbs;
  }
};

// Consumer warpgroup cw's part of one unit over stages [j0, j1) (it counts
// the CTA's stages): its parts of NB0 and NB1 boxes (0: none). Each stage:
// the A fragments from the raw A box, the parts' products issued and,
// while they run, on the CUDA cores, the A box's bias sums (the warpgroup
// that owns them: its own A box, or consumer 0 of a shared one), the
// head's products with its operand box cw and, on consumer 1, the head's
// bias sums. A fresh accumulator takes two stages where the accumulators
// and both stages' fragments fit the registers (at most 64 columns of
// accumulators: the second stage's products are issued while the first's
// run), one stage otherwise; it is then added to the part's sum in f32.
// Every warp releases each stage once its products are done; the sums go
// to the slot at out.
template <int NB0, int NB1>
__device__ __forceinline__ void consume(const Tf32Args& p, const Tf32Unit& U, const Tf32Wg& W,
                                        int cw, int j0, int j1, int& it, uint32_t ring,
                                        uint32_t lo0, uint32_t ready, uint32_t empty,
                                        float* out) {
  constexpr int S0 = 32 * (NB0 > 0 ? NB0 : 1), S1 = 32 * (NB1 > 0 ? NB1 : 1);
  constexpr int kPair = NB0 + NB1 <= 2;  // two stages a fresh accumulator
  Consumer C(p, U, W, cw, NB0 > 0);
  const int NS = p.n_stages;
  const auto stage = [&](int i) { return ring + (i % NS) * p.stage_bytes; };
  const auto lo_of = [&](int i, const Tf32Part& P) {
    return lo0 + (i & 1) * p.lo_bytes + (P.b - U.n_a) * kBox;
  };
  if constexpr (NB0 == 0) {
    for (int j = j0; j < j1; ++j, ++it) {
      mbar_wait(ready + 8 * (it % NS), (it / NS) & 1);
      C.heads(stage(it));
      C.release(empty, it);
    }
  } else {
    float s0[S0], s1[S1], d0[S0], d1[S1];
#pragma unroll
    for (int i = 0; i < S0; ++i) s0[i] = 0.f;
#pragma unroll
    for (int i = 0; i < S1; ++i) s1[i] = 0.f;
    uint32_t ah[16], al[16], bh[16], bl[16];
    for (int j = j0; j < j1;) {
      const bool two = kPair && j + 1 < j1;
      // the chunk's first stage
      mbar_wait(ready + 8 * (it % NS), (it / NS) & 1);
      uint32_t st = stage(it);
      C.load(st, ah, al);
      fence_regs(d0);
      if constexpr (NB1 > 0) fence_regs(d1);
      wgmma_fence();
      part_issue<NB0>(d0, ah, al, st + U.off[W.part[0].b], lo_of(it, W.part[0]), true);
      if constexpr (kPair && NB1 > 0) {
        part_issue<NB1>(d1, ah, al, st + U.off[W.part[1].b], lo_of(it, W.part[1]), true);
      }
      wgmma_commit();
      C.heads(st);
      if (two) {  // the second stage, issued while the first's products run
        mbar_wait(ready + 8 * ((it + 1) % NS), ((it + 1) / NS) & 1);
        st = stage(it + 1);
        C.load(st, bh, bl);
        wgmma_fence();
        part_issue<NB0>(d0, bh, bl, st + U.off[W.part[0].b], lo_of(it + 1, W.part[0]), false);
        if constexpr (kPair && NB1 > 0) {
          part_issue<NB1>(d1, bh, bl, st + U.off[W.part[1].b], lo_of(it + 1, W.part[1]),
                          false);
        }
        wgmma_commit();
        C.heads(st);
        wgmma_wait1();
        fence_regs(ah);  // the first stage's fragments stay until its products are done
        fence_regs(al);
        C.release(empty, it);
        ++it;
        ++j;
      }
      wgmma_wait0();
      fence_regs(d0);
      fence_regs(ah);
      fence_regs(al);
      if constexpr (kPair) {
        fence_regs(bh);
        fence_regs(bl);
      }
#pragma unroll
      for (int i = 0; i < S0; ++i) s0[i] += d0[i];
      if constexpr (NB1 > 0) {
        if constexpr (kPair) {
          fence_regs(d1);
        } else {  // the second part after the first: one accumulator's registers at a time
          wgmma_fence();
          part_issue<NB1>(d1, ah, al, st + U.off[W.part[1].b], lo_of(it, W.part[1]), true);
          wgmma_commit();
          wgmma_wait0();
          fence_regs(d1);
          fence_regs(ah);
          fence_regs(al);
        }
#pragma unroll
        for (int i = 0; i < S1; ++i) s1[i] += d1[i];
      }
      C.release(empty, it);
      ++it;
      ++j;
    }
    store_part<NB0>(s0, W.part[0], W.n_lim, out);
    if constexpr (NB1 > 0) store_part<NB1>(s1, W.part[1], W.n_lim, out);
  }
  C.finish(out);
}

// ---- weight gradients of one chunk (see the head of the file)
__global__ void __launch_bounds__(kDwThreads, 1)
    dw_tf32_kernel(const __grid_constant__ Tf32Args p) {
  extern __shared__ unsigned char dw_smem[];
  const uint32_t ring = (smem_u32(dw_smem) + 1023u) & ~1023u;  // the swizzle's atoms
  const int NS = p.n_stages;
  const uint32_t lo0 = ring + NS * p.stage_bytes;
  const uint32_t full = lo0 + kLoBufs * p.lo_bytes, ready = full + 8 * NS,
                 empty = ready + 8 * NS;
  const int tid = threadIdx.x, wg = tid >> 7;
  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(ready + 8 * s, 4);  // the transform's warps
      mbar_init(empty + 8 * s, 8);  // the consumers' warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int b = blockIdx.x;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int warp = tid >> 5;
    if (warp > 0) {
      viewdir(p, b, warp, tid & 31);
    } else if (tid == 0) {
      produce(p, b, ring, full, empty);
    }
    return;
  }
  if (wg == 1) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kTransformRegs));
    transform(p, b, ring, lo0, full, ready, empty);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int cw = wg - 2;
  int it = 0, pre = 0;
  for (int u = 0; u < p.n_units; ++u) {
    const Tf32Unit& U = p.units[u];
    int piece, j0, j1;
    const bool mine = dw_span(p.n_st, pre, U.cost, p.total_cost, p.grid, b, &piece, &j0, &j1);
    pre += U.cost;
    if (!mine) continue;
    float* out = p.partial + ((long long)p.chunk * p.max_pieces + piece) * p.n_params;
    const Tf32Wg& W = U.wg[cw];
    switch (W.shape) {
      case 1: consume<1, 0>(p, U, W, cw, j0, j1, it, ring, lo0, ready, empty, out); break;
      case 2: consume<2, 0>(p, U, W, cw, j0, j1, it, ring, lo0, ready, empty, out); break;
      case 3: consume<1, 1>(p, U, W, cw, j0, j1, it, ring, lo0, ready, empty, out); break;
      case 4: consume<2, 1>(p, U, W, cw, j0, j1, it, ring, lo0, ready, empty, out); break;
      case 5: consume<2, 2>(p, U, W, cw, j0, j1, it, ring, lo0, ready, empty, out); break;
      default: consume<0, 0>(p, U, W, cw, j0, j1, it, ring, lo0, ready, empty, out); break;
    }
  }
}

// The gradient of every parameter from the dW slots of the plan's parts
// and, as aux rows, the chunks' viewdir entries: see reduce_slots.
__global__ void dw_tf32_reduce_kernel(const DwParts parts, int n_chunks, int n_st_full,
                                      int n_st_last, long long n_params, const float* vd,
                                      int n_vd, const int* map, float* grad) {
  reduce_slots(parts, n_chunks, n_st_full, n_st_last, n_params, vd, n_chunks, n_vd, map, grad);
}

// Shared-memory bytes of the dW kernel by the plan in a, or 0 when the
// plan breaks a limit of the kernel.
size_t dw_tf32_smem(const Tf32Args& a) {
  if (a.n_units < 1 || a.n_units > kDwMaxUnits || a.grid < 1 || a.max_pieces < 1 ||
      a.n_stages < 2 || a.n_stages > kMaxDwStages || a.stage_bytes < kBox ||
      a.stage_bytes % 1024 != 0 || a.lo_bytes < kBox || a.lo_bytes % kBox != 0 ||
      a.n_params < 1 || a.dd < 0 || a.h2 < 0) {
    return 0;
  }
  int total = 0;
  for (int u = 0; u < a.n_units; ++u) {
    const Tf32Unit& U = a.units[u];
    if (U.n_a < 1 || U.n_a > 2 || U.n_op < U.n_a + 1 || U.n_box < U.n_op ||
        U.n_box > kMaxBoxes || (U.n_op - U.n_a) * kBox > a.lo_bytes || U.cost < 1 ||
        U.tx > a.stage_bytes || U.a_rows < 1 || U.a_rows > kBoxRows * U.n_a ||
        U.h_rows < 0 || U.h_rows > 3) {
      return 0;
    }
    total += U.cost;
    int tx = 0;
    for (int x = 0; x < U.n_box; ++x) {
      const int bytes = U.map[x] == 2 ? kHeadBox : kBox;
      if (U.map[x] < 0 || U.map[x] > 2 || (x < U.n_op && U.map[x] == 2) || U.off[x] < 0 ||
          U.off[x] % 1024 != 0 || U.off[x] + bytes > a.stage_bytes || U.row[x] < 0) {
        return 0;
      }
      tx += bytes;
    }
    if (tx != U.tx) return 0;
    if (U.h_rows > 0 && (U.map[U.n_box - 1] != 2 || U.h_nbox < 1 || U.h_nbox > 2 ||
                         U.h_box0 < U.n_a || U.h_box0 + U.h_nbox > U.n_box - 1 ||
                         U.h_mlim < 1 || U.h_mlim > kBoxRows * U.h_nbox)) {
      return 0;
    }
    for (int w = 0; w < 2; ++w) {
      const Tf32Wg& W = U.wg[w];
      static const int nb0[6] = {0, 1, 2, 1, 2, 2}, nb1[6] = {0, 0, 0, 1, 1, 2};
      if (W.shape < 0 || W.shape > 5) return 0;
      if (W.shape == 0) continue;
      if (W.a < 0 || W.a >= U.n_a || W.n_lim < 1 || W.n_lim > kBoxRows) return 0;
      const int nb[2] = {nb0[W.shape], nb1[W.shape]};
      for (int k = 0; k < 2; ++k) {
        const Tf32Part& P = W.part[k];
        if (nb[k] == 0) continue;
        if (P.nb != nb[k] || P.b < U.n_a || P.b + P.nb > U.n_op || P.m_lim < 1 ||
            P.m_lim > kBoxRows * P.nb || P.ldw < 1) {
          return 0;
        }
        for (int x = P.b + 1; x < P.b + P.nb; ++x) {
          if (U.off[x] != U.off[x - 1] + kBox) return 0;
        }
      }
    }
  }
  if (total != a.total_cost) return 0;
  const size_t bytes = 1024 + (size_t)a.n_stages * (a.stage_bytes + 24) +
                       (size_t)kLoBufs * a.lo_bytes;
  return bytes <= (size_t)kSmemMax ? bytes : 0;
}

}  // namespace

extern "C" {

int dexnerf_dw_tf32_args_size() { return (int)sizeof(Tf32Args); }

// The dW kernel's shared-memory bytes by the plan in args (a Tf32Args), 0
// if the plan is out of its limits.
int dexnerf_dw_tf32_smem(const void* args) {
  Tf32Args a;
  memcpy(&a, args, sizeof a);
  return (int)dw_tf32_smem(a);
}

// A tensor map of the [rows][k] f32 scratch at ptr into out (128 bytes):
// [box_rows][32] boxes (box_rows 64 or 8), 128 B swizzle, zeros past the
// last row. Returns a cudaError_t.
int dexnerf_dw_tf32_tensor_map(void* out, const void* ptr, long long k, long long rows,
                               int box_rows) {
  PFN_encodeTiled encode;
  const cudaError_t err = tensor_map_encoder(&encode);
  if (err != cudaSuccess) return (int)err;
  if (k < kKc || k % kKc != 0 || rows < 1 || (box_rows != kBoxRows && box_rows != kHeadRows)) {
    return (int)cudaErrorInvalidValue;
  }
  const cuuint64_t dims[2] = {(cuuint64_t)k, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)k * 4};
  const cuuint32_t box[2] = {(cuuint32_t)kKc, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(static_cast<CUtensorMap*>(out), CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                            const_cast<void*>(ptr), dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The weight gradients of one chunk by the plan and chunk fields in args
// (a Tf32Args). Returns a cudaError_t.
int dexnerf_dw_tf32(const void* args, void* stream) {
  Tf32Args a;  // an aligned copy of the caller's block
  memcpy(&a, args, sizeof a);
  const size_t smem = dw_tf32_smem(a);
  if (smem == 0 || a.n_st < 1 || a.chunk < 0 || a.rays < 1 || a.partial == nullptr ||
      (a.h2 * a.dd > 0 && (a.vd == nullptr || a.dy_sum == nullptr || a.dir_enc == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err =
      cudaFuncSetAttribute(dw_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dw_tf32_kernel<<<a.grid, kDwThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// The gradient of every parameter (see dw_tf32_reduce_kernel; n_chunks
// chunks, the last of n_st_last stages, the others of n_st_full, by the
// plan's n_parts parts: Tf32Args one after another at args). Returns a
// cudaError_t.
int dexnerf_dw_tf32_reduce(const void* args, int n_parts, int n_chunks, int n_st_full,
                           int n_st_last, const float* vd, int n_vd, const int* map, float* grad,
                           void* stream) {
  if (n_parts < 1 || n_parts > kDwMaxParts || n_chunks < 1 || n_st_full < 1 || n_st_last < 1 ||
      n_vd < 0) {
    return (int)cudaErrorInvalidValue;
  }
  DwParts parts;
  long long n_params = -1;
  Tf32Args a;
  for (int k = 0; k < n_parts; ++k) {
    memcpy(&a, static_cast<const unsigned char*>(args) + k * sizeof(Tf32Args), sizeof a);
    if (dw_tf32_smem(a) == 0 || (k > 0 && a.n_params != n_params)) {
      return (int)cudaErrorInvalidValue;
    }
    n_params = a.n_params;
    parts.sp[k] = dw_spans_of(a.n_units, a.total_cost, a.grid, a.max_pieces,
                              [&](int u) { return a.units[u].cost; });
    parts.partial[k] = a.partial;
  }
  dw_tf32_reduce_kernel<<<(unsigned)((n_params + 255) / 256), 256, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      parts, n_chunks, n_st_full, n_st_last, n_params, vd, n_vd, map, grad);
  return (int)cudaGetLastError();
}

// CTAs per SM of the dW kernel with `smem` bytes of shared memory.
int dexnerf_dw_tf32_occupancy(int smem, int* ctas) {
  cudaError_t err =
      cudaFuncSetAttribute(dw_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, dw_tf32_kernel, kDwThreads, smem);
  }
  return (int)err;
}

}  // extern "C"
