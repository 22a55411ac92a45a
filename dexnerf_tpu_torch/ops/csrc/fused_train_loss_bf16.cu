// Fused NeRF training loss pass at compute_dtype = dw_dtype = bfloat16, on
// the tensor cores of NVIDIA Hopper (sm_90a): positional encoding ->
// FlexibleNeRF MLP -> sigma-noise -> alpha compositing -> per-ray squared
// error (+ optional depth term) -> compositing backward -> MLP backward ->
// dW/db summed over every ray of the batch.
//
// Replaces dexnerf_tpu/ops/fused_train_loss.py:99 (_make_loss_kernel, the
// Pallas kernel of make_fused_pass_loss) at compute_dtype = dw_dtype =
// bfloat16, the JAX package's default for training. Same inputs and
// outputs as fused_train_loss.cu (the f32 route). The bf16 contract is
// that of dexnerf_tpu/ops/fused_mlp.py (split_flex_params,
// _forward_block_parts) and dexnerf_tpu/ops/fused_mlp_train.py
// (_backward_chain_parts); its plain version is
// ops/fused_train_loss.py::flex_forward_train:
// * forward: the operands of layer1, the trunk (h and, on a skip layer,
//   the xyz encoding), fc_feat and layers_dir.0 are rounded to bf16 and
//   accumulated in f32; bias, ReLU and the chain stay f32; the sigma head
//   reads the unrounded trunk output, the rgb head the unrounded
//   viewdir-layer output, both with f32 weights;
// * saved activations are bf16 (ReLU masks come from saved > 0);
// * cotangent chain: the cotangent is rounded to the weight's dtype, bf16
//   against the bf16 weights and f32 against the f32 heads;
// * dW: both operands bf16, f32 accumulation; bias gradients sum the f32
//   cotangents.
// Compositing, the loss and the compositing backward are f32.
//
// What bounds it on the H100: the bf16 scratch, ~5 KB per sample written
// and read back (~19 GB a step of the 8x128 model at batch 8192 with 64 +
// 128 samples per ray: >= 5.8 ms at 3.35 TB/s; forward 1.2, chain 2.2, dW
// 2.4), ahead of its 1.42 TFLOP of bf16 multiply-adds (1.435 ms at the 989
// TFLOP/s dense peak, 700 W).
//
// Design, one group of launches per chunk of rays (the scratch is capped by
// ops/fused_train_loss.py's SCRATCH_SAMPLES), rows of the scratch = the
// chunk's samples, ray-major (row k = ray * S + s), padded to whole
// 128-sample tiles:
// * train_prep_kernel: per ray, the viewdir encoding (f32 sincosf, rounded
//   to bf16) and the viewdir layer's per-ray bias.
// * train_fwd_bf16_kernel: kernel 1's tile (mlp_tile_bf16.cuh, shared with
//   fused_render_bf16.cu) on the chunk's rows: persistent CTAs, one per SM,
//   of three consumer warpgroups that each run their own 64-row tiles
//   through the whole MLP on wgmma (A from registers after layer1), fed by
//   one thread's bulk copies of the pre-swizzled weight pack
//   (ops/fused_render.py::pack_flex_weights_bf16) into an mbarrier ring;
//   heads in f32 from the accumulators. Every layer's bf16 activations are
//   written once into a swizzled staging tile and stored to the scratch by
//   TMA while the next products run (sample-major [row][feature] blocks, the
//   boxes of the chain's and dW's tensor maps), and the raw outputs (rgb
//   logits, sigma logit) go to an f32 [rows][4] buffer.
// * train_composite_kernel: one warp per ray, f32: the transmittance as a
//   warp product scan, the loss, and the compositing backward (the suffix
//   sum as a warp scan from the last sample), giving the f32 cotangent of
//   each sample's raw output.
// * train_chain_bf16_kernel: persistent CTAs, one per SM, the cotangent
//   chain of 64-sample tiles on wgmma against a bf16 pack of the transposed
//   weights (ops/fused_train_loss.py::pack_backward_weights_bf16, [H][64]
//   K-chunks) that a producer warp streams with TMA, as it streams each
//   tile's ReLU masks (the saved activations); the rgb head's chain (3
//   wide) and the sigma head's term (gs x w_alpha) are f32. Each layer's
//   cotangent is rounded to bf16 into a swizzled shared tile, the next
//   product's operand, and stored to the scratch by TMA while that product
//   runs; the bias sums (f32 cotangents) and the viewdir rows' dW (bf16
//   encoding x the ray's sum of bf16 cotangents) accumulate per consumer
//   warpgroup in a fixed order into its own slot.
// * train_dw_bf16_kernel: dW = cotangents^T x activations over the chunk's
//   samples. Bound by the bytes of the scratch blocks it reads (~5 KB per
//   sample for 8x128, >= 2.4 ms a step at 3.35 TB/s; its 0.49 TFLOP of
//   multiply-adds take 0.5 ms), so it reads each block once per unit: the
//   products that share an operand form one unit of the plan
//   (ops/fused_train_loss.py::dw_plan), whose boxes one TMA producer warp
//   streams into a shared-memory ring (128 B swizzle, mbarriers) and two
//   consumer warpgroups multiply with wgmma, both operands transposed from
//   shared memory. Persistent CTAs, one per SM, take equal shares of the
//   plan's bytes, each part of a unit into its own slot: no atomics.
// * reduce_bf16_kernel sums the slots (weights) and the chain CTAs' slots
//   (biases, viewdir rows) in a fixed order: runs are bitwise repeatable.
// Hidden widths that are not a multiple of 32 run zero-padded to one
// (exact: padded units are ReLU(0 + 0) = 0 and meet zero weights).
// Padded widths above 128 (up to kWideMaxHidden) take the wide route, chosen
// by the launchers from the width alone: train_fwd_wide_kernel and
// train_chain_wide_kernel on mlp_wide_bf16.cuh's tile, with the same prep,
// compositing, scratch layout, tensor maps and reduction (and the forward's
// ReLU mask words, TrainArgs::masks, which the chain reads); their dW plan
// (ops/fused_train_loss.py::dw_plan) splits products into units within
// train_dw_bf16_kernel's limits, runs in parts of at most kDwMaxUnits units
// (reduce_bf16_kernel sums them) and gives each 64-sample stage a fresh
// accumulator (DwArgs::fresh).
//
// The field kernels at compute_dtype (= dw_dtype) = bfloat16 are launches
// of the same kernels (dexnerf_field_bf16_pass), with the sample points
// read from pts [N, S, 3] instead of o + d z:
// * kernel 2, the field forward (replaces dexnerf_tpu/ops/fused_mlp.py:481,
//   _make_fwd_kernel): prep and forward, raw written straight to the
//   [N, S, 4] output, no scratch;
// * kernel 3, the field backward (replaces
//   dexnerf_tpu/ops/fused_mlp_train.py:221, _make_bwd_kernel): prep, the
//   forward again (scratch only), and the chain on the caller's cotangent
//   of raw (graw); no sigma-noise and no compositing. Its weight gradients
//   are the dW and reduce launches above.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is found at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "dw_split.cuh"
#include "mlp_tile_bf16.cuh"
#include "mlp_wide_bf16.cuh"
#include "train_composite.cuh"

namespace {

constexpr int kRowTile = 128;  // scratch rows of a chunk are padded to whole ones
constexpr int kEncPad = 32;    // the scratch's encoding block: dx padded to a multiple
constexpr int kStageBufs = 2;  // forward: staging tiles of the activation stores, a consumer
constexpr int kMaxLayers = 40;
constexpr int kMaxFreq = 16;
constexpr int kMaxSamples = 256;
constexpr int kMaxDD = 3 + 6 * kMaxFreq;
constexpr int kAux = kMaxLayers + 8;
constexpr int kMaxBlocks = kMaxLayers + 8;
constexpr int kRayWarps = 4;   // composite: rays per CTA, one warp each
constexpr int kPrepWarps = 8;  // prep: rays per CTA
constexpr int kSumThreads = 1024;
// dW: a TMA box and a wgmma block are 64 x 64 (64 samples of K, 64 features
// of 128 B: one 128 B swizzle row each)
constexpr int kDwBox = 64;
constexpr int kDwBoxBytes = kDwBox * kDwBox * 2;
constexpr int kDwMaxMaps = 2 * kMaxLayers - 8;  // scratch blocks: 2 num_trunk + 9 <= 71
constexpr int kDwMaxBoxes = 6;                  // of a unit: one ring stage
constexpr int kDwMaxBlocks = 8;                 // output blocks of a unit
constexpr int kDwThreads = 384;  // warpgroup 0 the TMA producer, 1-2 wgmma consumers
constexpr int kDwSmemMax = 232448;
// Who launches a prep or forward kernel, a template argument so that a
// profile tells them apart: the fused train loss (kernel 4), the field
// forward (kernel 2) and the field backward's recomputed forward (kernel 3).
constexpr int kLoss = 4, kFieldFwd = 2, kFieldBwd = 3;

// Mirrored field by field by ops/fused_train_loss.py::_Bf16TrainArgs.
struct TrainArgs {
  const float* origins;     // [N, 3]
  const float* dirs;        // [N, 3]
  const float* viewdirs;    // [N, 3]
  const float* pts;         // [N, S, 3] sample points (field kernels) or null
  const float* z;           // [N, S]
  const float* dists;       // [N, S]
  const float* noise;       // [N, S] or null
  const float* target;      // [N, 3]
  const float* depth_gt;    // [N] or null
  const float* depth_coef;  // [N] or null
  const bf16* wq;           // forward K-chunks, swizzled: fused_render.py::pack_flex_weights_bf16
  const float* aux;         // its f32 biases, heads and bf16-rounded viewdir rows
  const bf16* wbq;          // backward K-chunks, pack_backward_weights_bf16
  float* weights_out;       // [N, S]
  float* rgb_out;           // [N, 3]
  float* loss_ray;          // [N]
  bf16* scratch;            // activation and cotangent blocks, [rows][width] each
  float* raw;               // [rows][4] rgb logits, sigma logit
  float* graw;              // [rows][4] their cotangents
  float* dir_enc;           // [n_rays][dd] viewdir encodings, bf16-rounded
  float* dirb;              // [n_rays][H/2] per-ray viewdir-layer bias
  float* aux_part;          // [chain CTAs][aux_size] bias sums, viewdir-row dW
  uint32_t* masks;          // wide route: [64-row tiles][wide_mask_words][128] ReLU mask words
  // element offsets in scratch: act e, a_0..a_nt, feat, y; dlt d_0..d_nt,
  // feat, y, rgb (8 wide), sigma (8 wide)
  long long act_off[kMaxBlocks];
  long long dlt_off[kMaxBlocks];
  int ray0, n_rays, n_samples, hidden, num_trunk, skip_mask;
  int fx, fd, inc_x, inc_d, dx, dxp, dd;
  int white_bg, luma, has_noise, has_depth, chain_ctas;
  int fwd_ctas;  // the forward's persistent CTAs: SMs x CTAs per SM
  int aux_off[kAux];
  float bands_x[kMaxFreq];
  float bands_d[kMaxFreq];
};

// The weight-gradient plan (ops/fused_train_loss.py::dw_plan), mirrored by
// _DwBlock, _DwUnit and _DwArgs there. A unit is a set of products read
// together: its boxes are [64 samples][64 features] tiles of scratch
// blocks (one TMA tensor map per block; an 8-wide block, a head's
// cotangents, is loaded as [64][8]), the cotangent (A) boxes first, then
// the activation (B) boxes, each in an 8 KB slot of the stage; each output
// block is one 64 x 64 wgmma accumulator, dW[n0 + r][m0 + c] = sum_k
// A[k][r] B[k][c], written to partial[slot][base + r * ldw + c] for
// r < n_lim, c < m_lim.
struct DwBlock {
  int a, b;   // A box, B box (indices into the unit's boxes)
  int small;  // the A box is an 8-wide one
  int base, ldw, n_lim, m_lim, pad;
};

struct DwUnit {
  int n_a, n_b, n_blocks;
  int cost;  // HBM bytes / 16 read per sample
  int tx;    // bytes of one stage
  int pad[3];
  int map[kDwMaxBoxes], col[kDwMaxBoxes];
  DwBlock blk[kDwMaxBlocks];
};

struct DwArgs {
  CUtensorMap maps[kDwMaxMaps];  // one per scratch block, [rows][width] bf16
  DwUnit units[kDwMaxUnits];
  float* partial;  // [chunks][max_pieces][n_params]
  long long n_params;
  int n_units, total_cost, grid, max_pieces, n_stages, stage_bytes;
  int fresh;  // 1: each stage's products into a fresh accumulator (the wide route's plans)
  int pad[5];
};
static_assert(sizeof(DwArgs) % 64 == 0, "DwArgs is mirrored without tail padding");

// Per chain CTA, floats: the bias sums of layer1 and each trunk layer (H
// each), fc_feat (H), layers_dir.0 (H/2), fc_alpha (1), fc_rgb (3), then
// the viewdir rows' dW [dd][H/2].
__host__ __device__ inline int aux_bias(int layer, int H) { return layer * H; }
__host__ __device__ inline int aux_dir(int H, int nt) { return (nt + 2) * H; }
__host__ __device__ inline int aux_alpha(int H, int nt) { return aux_dir(H, nt) + H / 2; }
__host__ __device__ inline int aux_rgb(int H, int nt) { return aux_alpha(H, nt) + 1; }
__host__ __device__ inline int aux_vd(int H, int nt) { return aux_rgb(H, nt) + 3; }
__host__ __device__ inline int aux_size(int H, int nt, int dd) {
  return aux_vd(H, nt) + dd * (H / 2);
}

// Encoding of one coordinate: [x (if included), sin(f0 x), cos(f0 x), ...]
// rows d, 3 + d, ... of dst; the argument rounded as written and sincosf
// the accurate one (the top frequency multiplies any error by up to 2^9).
__device__ __forceinline__ void encode_f32(float v, int d, int n_freq, int include,
                                           const float* bands, float* dst) {
  int row = 0;
  if (include) {
    dst[d] = v;
    row = 3;
  }
  for (int f = 0; f < n_freq; ++f) {
    float sn, cs;
    sincosf(__fmul_rn(v, bands[f]), &sn, &cs);
    dst[row + 6 * f + d] = sn;
    dst[row + 6 * f + 3 + d] = cs;
  }
}

// ---- per ray: viewdir encoding (bf16-rounded) and the viewdir layer's
// per-ray bias b + enc . W_dir[:, H:] (bf16 operands, f32 sum), one warp
// per ray
template <int kOwner>
__global__ void __launch_bounds__(kPrepWarps * 32) train_prep_kernel(const TrainArgs p) {
  __shared__ float dtmp[kPrepWarps][kMaxDD];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = blockIdx.x * kPrepWarps + warp;
  if (r >= p.n_rays) return;
  const long long ray = (long long)p.ray0 + r;
  const int H2 = p.hidden / 2, nt = p.num_trunk, dd = p.dd;
  float* e = dtmp[warp];
  if (lane < 3) encode_f32(p.viewdirs[ray * 3 + lane], lane, p.fd, p.inc_d, p.bands_d, e);
  __syncwarp();
  for (int k = lane; k < dd; k += 32) p.dir_enc[(size_t)r * dd + k] = bf16_round(e[k]);
  const float* wdv = p.aux + p.aux_off[nt + 7];
  const float* bdir = p.aux + p.aux_off[nt + 2];
  for (int c = lane; c < H2; c += 32) {
    float v = __ldg(bdir + c);
    for (int k = 0; k < dd; ++k) v = fmaf(bf16_round(e[k]), __ldg(wdv + k * H2 + c), v);
    p.dirb[(size_t)r * H2 + c] = v;
  }
}

// ---- compositing, loss and compositing backward, f32, one warp per ray
// (composite_ray, train_composite.cuh, shared with the f32 route): weights,
// rgb and the per-ray loss out, and the cotangent of each sample's raw
// output (rgb logits, sigma logit) into graw.
__global__ void __launch_bounds__(kRayWarps * 32) train_composite_kernel(const TrainArgs p) {
  extern __shared__ float csm[];
  const int warp = threadIdx.x >> 5;
  const int r = blockIdx.x * kRayWarps + warp;
  if (r >= p.n_rays) return;
  composite_ray(p, r, p.n_samples, csm + (size_t)warp * 7 * p.n_samples);
}

// A consumer warpgroup's part of one unit: its NB blocks (cw, cw + 2, ...)
// over stages [j0, j1) of the ring (it counts the CTA's stages), then the
// blocks into the slot at out. Every warp releases each stage it has read.
// kFresh: each stage's products of a block go into a fresh accumulator that
// is added to the block's sum in f32 on the CUDA cores, the tensor cores
// rounding only within a stage's 64 samples (the wide route's plans: a small
// unit's share of a pass runs to thousands of stages a CTA); else every
// stage accumulates in the block's wgmma accumulator. The fresh accumulators
// cost the wide dW under 2%, and overlapping one block's products with the
// previous block's f32 add gained nothing (PERF.md section 6).
template <int NB, bool kFresh>
__device__ __forceinline__ void dw_consume(const DwUnit& U, int cw, int j0, int j1, int& it,
                                           uint32_t base, int SB, int NS, uint32_t full,
                                           uint32_t empty, float* out) {
  float acc[NB > 0 ? NB : 1][32];
#pragma unroll
  for (int i = 0; i < NB; ++i)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[i][e] = 0.f;
  uint32_t ao[NB > 0 ? NB : 1], bo[NB > 0 ? NB : 1];
  bool small[NB > 0 ? NB : 1];
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    ao[i] = U.blk[cw + 2 * i].a * kDwBoxBytes;
    bo[i] = U.blk[cw + 2 * i].b * kDwBoxBytes;
    small[i] = U.blk[cw + 2 * i].small != 0;
  }
  const int t = threadIdx.x & 127;
  for (int j = j0; j < j1; ++j, ++it) {
    const int s = it % NS;
    mbar_wait(full + 8 * s, (it / NS) & 1);
    if (NB > 0 && !kFresh) {
      const uint32_t st = base + s * SB;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kDwBox / 16; ++ks) {
#pragma unroll
        for (int i = 0; i < NB; ++i) {
          wgmma_bf16<64, 1, 1>(acc[i],
                               small[i] ? small_desc(st + ao[i] + ks * 256)
                                        : sw128_desc(st + ao[i] + ks * 2048),
                               sw128_desc(st + bo[i] + ks * 2048));
        }
      }
      wgmma_commit();
      wgmma_wait0();
    } else if (NB > 0) {
      const uint32_t st = base + s * SB;
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        float part[32];
        fence_regs(part);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < kDwBox / 16; ++ks) {
          wgmma_bf16<64, 1, 1>(part,
                               small[i] ? small_desc(st + ao[i] + ks * 256)
                                        : sw128_desc(st + ao[i] + ks * 2048),
                               sw128_desc(st + bo[i] + ks * 2048), ks > 0);
        }
        wgmma_commit();
        wgmma_wait0();
        fence_regs(part);
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[i][e] += part[e];
      }
    }
    if ((t & 31) == 0) mbar_arrive(empty + 8 * s);
  }
  const int row0 = 16 * (t >> 5) + ((t & 31) >> 2), col0 = 2 * (t & 3);
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    const DwBlock& k = U.blk[cw + 2 * i];
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int r = row0 + 8 * ((e >> 1) & 1), c = 8 * (e >> 2) + col0 + (e & 1);
      if (r < k.n_lim && c < k.m_lim) out[k.base + (long long)r * k.ldw + c] = acc[i][e];
    }
  }
}

// ---- weight gradients of one chunk: persistent CTAs, one per SM, each
// owning an equal share of the plan's work (see dw_span). Warpgroup 0's
// first thread streams the boxes of each 64-sample stage through an
// n_stages ring of TMA loads (128 B swizzle, one mbarrier pair per stage);
// warpgroups 1 and 2 each hold up to four 64 x 64 f32 accumulators (the
// unit's blocks cw, cw + 2, ...) and run wgmma on both operands transposed
// from shared memory. Each scratch block is read once per unit that uses it,
// and every box of a stage serves each block that needs it. At the end of
// its part of a unit a CTA writes its blocks to its slot: no atomics, and
// reduce_bf16_kernel sums the slots in a fixed order.
template <bool kFresh>
__global__ void __launch_bounds__(kDwThreads, 1)
    train_dw_bf16_kernel(const __grid_constant__ DwArgs p, int n_st, int chunk) {
  extern __shared__ unsigned char dw_ring[];
  const uint32_t base = (smem_u32(dw_ring) + 1023u) & ~1023u;  // the swizzle's atoms
  const int NS = p.n_stages, SB = p.stage_bytes;
  const uint32_t full = base + NS * SB, empty = full + 8 * NS;
  const int tid = threadIdx.x, wg = tid >> 7;
  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);  // each consumer warp releases the stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int b = blockIdx.x;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid != 0) return;
    int it = 0, pre = 0;
    for (int u = 0; u < p.n_units; ++u) {
      const DwUnit& U = p.units[u];
      int piece, j0, j1;
      const bool mine = dw_span(n_st, pre, U.cost, p.total_cost, p.grid, b, &piece, &j0, &j1);
      pre += U.cost;
      if (!mine) continue;
      const int nbox = U.n_a + U.n_b;
      for (int j = j0; j < j1; ++j, ++it) {
        const int s = it % NS;
        mbar_wait(empty + 8 * s, ((it / NS) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, U.tx);
        for (int x = 0; x < nbox; ++x) {
          tma_load_2d(base + s * SB + x * kDwBoxBytes, &p.maps[U.map[x]], U.col[x], j * kDwBox,
                      full + 8 * s);
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int cw = wg - 1;
  int it = 0, pre = 0;
  for (int u = 0; u < p.n_units; ++u) {
    const DwUnit& U = p.units[u];
    int piece, j0, j1;
    const bool mine = dw_span(n_st, pre, U.cost, p.total_cost, p.grid, b, &piece, &j0, &j1);
    pre += U.cost;
    if (!mine) continue;
    float* out = p.partial + ((long long)chunk * p.max_pieces + piece) * p.n_params;
    switch ((U.n_blocks - cw + 1) / 2) {  // this warpgroup's blocks cw, cw + 2, ...
      case 0: dw_consume<0, kFresh>(U, cw, j0, j1, it, base, SB, NS, full, empty, out); break;
      case 1: dw_consume<1, kFresh>(U, cw, j0, j1, it, base, SB, NS, full, empty, out); break;
      case 2: dw_consume<2, kFresh>(U, cw, j0, j1, it, base, SB, NS, full, empty, out); break;
      case 3: dw_consume<3, kFresh>(U, cw, j0, j1, it, base, SB, NS, full, empty, out); break;
      default: dw_consume<4, kFresh>(U, cw, j0, j1, it, base, SB, NS, full, empty, out); break;
    }
  }
}

// ---- the cotangent chain on wgmma, for the H100 (sm_90a). Bound by its
// bytes (the saved activations it reads as ReLU masks, ~2.2 KB a sample for
// 8x128, and the cotangent blocks it writes, ~2.5 KB: >= 2.2 ms a step at
// 3.35 TB/s; its multiply-adds take 0.45 ms), so every transfer is an
// asynchronous TMA one and the tensor cores never wait on a store. One CTA
// per SM: warpgroup 0 streams the transposed weights (one [H][64] K-chunk a
// ring stage, shared by both consumers: 128 samples per pass over the
// weights) and each consumer's masks; consumer warpgroups 1 and 2 each run
// the whole chain of their own 64-sample tiles (worker v = 2 b + cw takes
// tiles v, v + 2 G, ...), so one's epilogue overlaps the other's wgmma. A
// cotangent tile lives in shared memory as two 128 B-swizzled [64][64]
// halves: the K-major A operand of the next product and the source of its
// TMA store to the scratch, double-buffered so the store of one product
// runs under the next. Each worker sums its bias entries and viewdir rows'
// dW into its own slot aux_part[v] (each entry owned by one thread; kept in
// shared memory while the kernel runs when it fits, then copied out once).
constexpr int kCStages = 4;           // weight ring
constexpr int kCTile = 64;            // samples per consumer tile
constexpr int kCHalf = kCTile * 128;  // bytes of a [64][64] bf16 half-tile
constexpr int kChainThreads = 384;

struct ChainSmem {
  size_t ring, cot, mask, gsh, colsum, bars, slot, total;
};

// The chain's shared memory at width H, with each consumer's slot of
// n_slot floats (0: the slots stay in device memory).
__host__ __device__ inline ChainSmem chain_smem(int H, int n_slot) {
  ChainSmem s;
  s.ring = 0;                                         // kCStages x [H][64] bf16
  s.cot = s.ring + (size_t)kCStages * H * 128;        // [2 WG][2 buffers][2 halves]
  s.mask = s.cot + 8 * (size_t)kCHalf;                // [2 WG][2 slots][2 halves]
  s.gsh = s.mask + 8 * (size_t)kCHalf;                // [2 WG][64][4] f32
  s.colsum = s.gsh + 2 * kCTile * 4 * 4;              // [2 WG][4 warps][H] f32
  s.bars = s.colsum + 2 * 4 * (size_t)H * 4;          // weight full/empty, mask full/empty
  s.slot = s.bars + (2 * kCStages + 8) * 8;           // [2 WG][n_slot] f32
  s.total = s.slot + 2 * (size_t)n_slot * 4 + 1024;   // + slack to align the base
  return s;
}

// The chain's shared memory for a, the slots inside when they fit.
__host__ __device__ inline ChainSmem chain_smem_for(const TrainArgs& a) {
  const ChainSmem in = chain_smem(a.hidden, aux_size(a.hidden, a.num_trunk, a.dd));
  return in.total <= (size_t)kDwSmemMax ? in : chain_smem(a.hidden, 0);
}

// dst[k H2] += enc[k] seg for k < dd: one viewdir row's dW of one column
__device__ __forceinline__ void vd_flush(float* __restrict__ dst, const float* __restrict__ enc,
                                         int dd, int H2, float seg) {
#pragma unroll 4
  for (int k = 0; k < dd; ++k) dst[k * H2] += __ldg(enc + k) * seg;
}

// The tensor maps of the chain (mirrored by _ChainMaps in
// ops/fused_train_loss.py): the backward pack as [rows][64] with [H][64]
// boxes, and the scratch blocks, as DwArgs::maps.
struct ChainMaps {
  CUtensorMap w;
  CUtensorMap blocks[kDwMaxMaps];
};
static_assert(sizeof(ChainMaps) % 64 == 0, "ChainMaps is mirrored without tail padding");

// Order of a tile's work: the y cotangent (mask y), then product pi = 0 ..
// nt + 1 against K-chunks of pack_backward_weights_bf16 (layers_dir.0's feat
// rows, fc_feat, layers_xyz from the last), whose output is the cotangent
// block d_{nt + 1 - pi} (d_{nt + 1} = feat), masked by the saved activation
// block nt + 2 - pi (feat, a_nt, ..., a_1) while pi < nt + 1, and whose
// bias sums go to aux_bias(nt + 1 - pi); product 1 adds the sigma head's
// gs x w_alpha. The masks stream in the order y, feat, a_nt, ..., a_1:
// activation blocks nt + 3 - k.
template <int NTM>
__global__ void __launch_bounds__(kChainThreads, 1)
    train_chain_bf16_kernel(const TrainArgs p, const __grid_constant__ ChainMaps m, int n_real,
                            int n_tiles) {
  constexpr int H = NTM * 16;
  constexpr int H2 = H / 2;
  constexpr int KCH = (H + 63) / 64;  // 64-wide K-chunks of a product on H
  const int S = p.n_samples, nt = p.num_trunk, dd = p.dd;
  const int n_act = nt + 4;  // m.blocks: activation blocks, then cotangent blocks
  const int per_tile = 1 + (nt + 1) * KCH;
  extern __shared__ unsigned char chain_raw[];
  const uint32_t sbase = (smem_u32(chain_raw) + 1023u) & ~1023u;
  unsigned char* gbase = chain_raw + (sbase - smem_u32(chain_raw));
  const ChainSmem L = chain_smem_for(p);
  const uint32_t ring = sbase + (uint32_t)L.ring;
  const uint32_t wfull = sbase + (uint32_t)L.bars, wempty = wfull + 8 * kCStages;
  const uint32_t mfull = wempty + 8 * kCStages, mempty = mfull + 8 * 4;  // [WG][slot]
  const int tid = threadIdx.x, wg = tid >> 7;
  const int G = gridDim.x, b = blockIdx.x;
  const int passes = 2 * b < n_tiles ? (n_tiles - 1 - 2 * b) / (2 * G) + 1 : 0;
  if (tid == 0) {
    for (int s = 0; s < kCStages; ++s) {
      mbar_init(wfull + 8 * s, 1);
      mbar_init(wempty + 8 * s, 8);  // every consumer warp releases a weight stage
    }
    for (int s = 0; s < 4; ++s) {
      mbar_init(mfull + 8 * s, 1);
      mbar_init(mempty + 8 * s, 4);  // every warp of its consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // zero the cotangent tiles: the columns past H (and past H/2 in the y
  // tile's first K-chunk) stay zero
  for (int i = tid; i < 8 * kCHalf / 16; i += kChainThreads) {
    reinterpret_cast<uint4*>(gbase + L.cot)[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  fence_async_smem();
  __syncthreads();
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    const int warp = tid >> 5;
    if ((tid & 31) != 0 || warp > 2) return;
    if (warp == 0) {  // the weights, the same chunks every pass
      int it = 0;
      for (int ps = 0; ps < passes; ++ps) {
        for (int c = 0; c < per_tile; ++c, ++it) {
          const int s = it % kCStages;
          mbar_wait(wempty + 8 * s, ((it / kCStages) & 1) ^ 1);
          mbar_expect_tx(wfull + 8 * s, H * 128);
          tma_load_2d(ring + s * H * 128, &m.w, 0, c * H, wfull + 8 * s);
        }
      }
    } else {  // warps 1 and 2: the masks of consumer warp - 1
      const int cw = warp - 1;
      int it = 0;
      for (int t = 2 * b + cw; t < n_tiles; t += 2 * G) {
        for (int k = 0; k < nt + 2; ++k, ++it) {
          const int slot = 2 * cw + (it & 1);
          mbar_wait(mempty + 8 * slot, ((it >> 1) & 1) ^ 1);
          const int nbox = k == 0 ? (H2 + 63) / 64 : KCH;
          mbar_expect_tx(mfull + 8 * slot, nbox * kCHalf);
          for (int x = 0; x < nbox; ++x) {
            tma_load_2d(sbase + (uint32_t)L.mask + slot * 2 * kCHalf + x * kCHalf,
                        &m.blocks[nt + 3 - k], 64 * x, t * kCTile, mfull + 8 * slot);
          }
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int cw = wg - 1, t = tid & 127, warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, q = lane & 3, bar_id = 1 + cw, v = 2 * b + cw;
  const uint32_t cot = sbase + (uint32_t)L.cot + cw * 4 * kCHalf;  // buffer x at + x 2 kCHalf
  float* gsh = reinterpret_cast<float*>(gbase + L.gsh) + cw * kCTile * 4;
  const uint32_t gsh_s = sbase + (uint32_t)L.gsh + cw * kCTile * 16;
  const uint32_t mask_s = sbase + (uint32_t)L.mask + cw * 4 * kCHalf;
  float* colsum = reinterpret_cast<float*>(gbase + L.colsum) + cw * 4 * H;
  const int n_slot = aux_size(H, nt, dd);
  float* const slot_out = p.aux_part + (size_t)v * n_slot;
  const bool slot_smem = L.total > L.slot + 1024;
  float* mine = slot_smem ? reinterpret_cast<float*>(gbase + L.slot) + cw * n_slot : slot_out;
  for (int i = t; i < n_slot; i += 128) mine[i] = 0.f;
  const float* w_rgb = p.aux + p.aux_off[nt + 5];    // [H2][3] f32
  const float* w_alpha = p.aux + p.aux_off[nt + 3];  // [H] f32
  bf16* const S0 = p.scratch;
  int wit = 0, mit = 0;  // weight chunks and masks consumed
  for (int ps = 0; ps < passes; ++ps) {
    const int tile = v + ps * 2 * G;
    if (tile >= n_tiles) {  // the other consumer's pass: release its weights
      for (int c = 0; c < per_tile; ++c, ++wit) {
        const int s = wit % kCStages;
        mbar_wait(wfull + 8 * s, (wit / kCStages) & 1);
        if (lane == 0) mbar_arrive(wempty + 8 * s);
      }
      continue;
    }
    const long long k0 = (long long)tile * kCTile;
    if (t == 0) bulk_wait_read<0>();  // the last tile's stores have read their tiles
    wg_sync(bar_id);
    // ---- raw cotangents of the tile; rgb and sigma ones to the scratch in bf16
    if (t < kCTile) {
      const int r = t;
      const float4 gr = k0 + r < n_real ? reinterpret_cast<const float4*>(p.graw)[k0 + r]
                                        : make_float4(0.f, 0.f, 0.f, 0.f);
      reinterpret_cast<float4*>(gsh)[r] = gr;
      __align__(16) __nv_bfloat162 rgb8[4], sig8[4];
      const __nv_bfloat162 z2 = __floats2bfloat162_rn(0.f, 0.f);
      rgb8[0] = __floats2bfloat162_rn(gr.x, gr.y);
      rgb8[1] = __floats2bfloat162_rn(gr.z, 0.f);
      rgb8[2] = rgb8[3] = z2;
      sig8[0] = __floats2bfloat162_rn(gr.w, 0.f);
      sig8[1] = sig8[2] = sig8[3] = z2;
      __stcs(reinterpret_cast<float4*>(S0 + p.dlt_off[nt + 3] + (k0 + r) * 8),
             *reinterpret_cast<const float4*>(rgb8));
      __stcs(reinterpret_cast<float4*>(S0 + p.dlt_off[nt + 4] + (k0 + r) * 8),
             *reinterpret_cast<const float4*>(sig8));
    }
    wg_sync(bar_id);
    if (t < 4) {  // rgb and sigma bias sums
      float s = 0.f;
      for (int r = 0; r < kCTile; ++r) s += gsh[r * 4 + t];
      mine[t < 3 ? aux_rgb(H, nt) + t : aux_alpha(H, nt)] += s;
    }
    // ---- y cotangent (g_rgb . W_rgb^T, f32) masked by y > 0, one thread a
    // column: the viewdir layer's bias sum (f32) and its viewdir rows' dW
    // (each ray's encoding x its sum of the bf16 cotangent), into buffer 0
    {
      const int slot = 2 * cw + (mit & 1);
      mbar_wait(mfull + 8 * slot, (mit >> 1) & 1);
      const uint32_t mk = mask_s + (mit & 1) * 2 * kCHalf;
      if (t < H2) {
        const int col = t;
        const float* wr = w_rgb + col * 3;
        const float w0 = __ldg(wr), w1 = __ldg(wr + 1), w2 = __ldg(wr + 2);
        float* vd = mine + aux_vd(H, nt) + col;
        float bsum = 0.f, seg = 0.f;
        int ray = (int)(k0 / S), pos = (int)(k0 - (long long)ray * S);
        for (int r0 = 0; r0 < kCTile; r0 += 16) {  // 16 rows' loads at once
          uint32_t yb[16];
          float4 gg[16];
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            yb[i] = lds16(mk + tile_off(r0 + i, col));
            gg[i] = lds128(gsh_s + (r0 + i) * 16);
          }
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            const int r = r0 + i;
            const float dy = fmaf(gg[i].z, w2, fmaf(gg[i].y, w1, gg[i].x * w0));
            const float vv = __uint_as_float(yb[i] << 16) > 0.f ? dy : 0.f;
            const bf16 vb = __float2bfloat16_rn(vv);
            sts16(cot + tile_off(r, col), __bfloat16_as_ushort(vb));
            if (k0 + r < n_real) {
              bsum += vv;
              seg += __bfloat162float(vb);
              if (++pos == S) {  // the ray's last sample
                vd_flush(vd, p.dir_enc + (size_t)ray * dd, dd, H2, seg);
                seg = 0.f;
                pos = 0;
                ++ray;
              }
            }
          }
        }
        if (pos > 0) vd_flush(vd, p.dir_enc + (size_t)ray * dd, dd, H2, seg);  // continues
        mine[aux_dir(H, nt) + col] += bsum;
      } else if (t < 64) {  // the K-chunk's columns past H/2
        for (int r = 0; r < kCTile; ++r) {
          sts16(cot + tile_off(r, t), 0);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(mempty + 8 * slot);
      ++mit;
    }
    fence_async_smem();
    wg_sync(bar_id);
    if (t == 0) {
      tma_store_2d(&m.blocks[n_act + nt + 2], 0, (int)k0, cot);
      bulk_commit();
    }
    // ---- the products
    int cur = 0;
    for (int pi = 0; pi < nt + 2; ++pi) {
      const int kch = pi == 0 ? 1 : KCH;
      float acc[H / 2];
#pragma unroll
      for (int e = 0; e < H / 2; ++e) acc[e] = 0.f;
      const uint32_t a0 = cot + cur * 2 * kCHalf;
      wgmma_fence();
      for (int c = 0; c < kch; ++c) {
        const int s = (wit + c) % kCStages;
        mbar_wait(wfull + 8 * s, ((wit + c) / kCStages) & 1);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          wgmma_bf16<H, 0, 0>(acc, kmajor_desc(a0 + c * kCHalf + ks * 32),
                              kmajor_desc(ring + s * H * 128 + ks * 32));
        }
      }
      wgmma_commit();
      wgmma_wait0();
      if (lane == 0) {
        for (int c = 0; c < kch; ++c) mbar_arrive(wempty + 8 * ((wit + c) % kCStages));
      }
      wit += kch;
      // ---- epilogue: (+ gs w_alpha), mask, bf16 into the other buffer
      const int nxt = cur ^ 1;
      if (t == 0) bulk_wait_read<1>();  // its store two products ago has read it
      wg_sync(bar_id);
      const bool masked = pi < nt + 1;
      const int slot = 2 * cw + (mit & 1);
      const uint32_t mk = mask_s + (mit & 1) * 2 * kCHalf;
      if (masked) mbar_wait(mfull + 8 * slot, (mit >> 1) & 1);
      const uint32_t dst = cot + nxt * 2 * kCHalf;
      const int r0 = 16 * warp + g;
      float gs[2] = {0.f, 0.f};
      if (pi == 1) {
        gs[0] = gsh[r0 * 4 + 3];
        gs[1] = gsh[(r0 + 8) * 4 + 3];
      }
      // in two halves of the columns: every mask load of a half is issued
      // before its values are stored, and its column sums reduce together
#pragma unroll
      for (int j0 = 0; j0 < H / 8; j0 += H / 16) {
        constexpr int NJ = H / 16;
        uint32_t mw[NJ][2];
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            mw[j][h] = masked ? lds32(mk + tile_off(r0 + 8 * h, 8 * (j0 + j) + 2 * q)) : 0x3f803f80u;
        float cs[NJ][2];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int jj = j0 + j, col = 8 * jj + 2 * q;
          float wa0 = 0.f, wa1 = 0.f;
          if (pi == 1) {
            wa0 = __ldg(w_alpha + col);
            wa1 = __ldg(w_alpha + col + 1);
          }
          cs[j][0] = cs[j][1] = 0.f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float v0 = acc[4 * jj + 2 * h], v1 = acc[4 * jj + 2 * h + 1];
            if (pi == 1) {
              v0 = fmaf(gs[h], wa0, v0);
              v1 = fmaf(gs[h], wa1, v1);
            }
            if (!(__uint_as_float(mw[j][h] << 16) > 0.f)) v0 = 0.f;
            if (!(__uint_as_float(mw[j][h] & 0xffff0000u) > 0.f)) v1 = 0.f;
            const __nv_bfloat162 pk = __floats2bfloat162_rn(v0, v1);
            sts32(dst + tile_off(r0 + 8 * h, col), *reinterpret_cast<const uint32_t*>(&pk));
            cs[j][0] += v0;
            cs[j][1] += v1;
          }
        }
#pragma unroll
        for (int x = 4; x < 32; x <<= 1)
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            cs[j][0] += __shfl_xor_sync(0xffffffffu, cs[j][0], x);
            cs[j][1] += __shfl_xor_sync(0xffffffffu, cs[j][1], x);
          }
        if (g == 0) {
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const int col = 8 * (j0 + j) + 2 * q;
            colsum[warp * H + col] = cs[j][0];
            colsum[warp * H + col + 1] = cs[j][1];
          }
        }
      }
      if (masked) {
        __syncwarp();
        if (lane == 0) mbar_arrive(mempty + 8 * slot);
        ++mit;
      }
      fence_async_smem();
      wg_sync(bar_id);
      if (t == 0) {
        for (int x = 0; x < KCH; ++x) {
          tma_store_2d(&m.blocks[n_act + nt + 1 - pi], 64 * x, (int)k0,
                       cot + nxt * 2 * kCHalf + x * kCHalf);
        }
        bulk_commit();
      }
      float* bias = mine + aux_bias(nt + 1 - pi, H);
      for (int c = t; c < H; c += 128) {
        bias[c] += (colsum[c] + colsum[H + c]) + (colsum[2 * H + c] + colsum[3 * H + c]);
      }
      cur = nxt;
    }
  }
  if (slot_smem) {
    wg_sync(bar_id);
    for (int i = t; i < n_slot; i += 128) slot_out[i] = mine[i];
  }
  if (t == 0) bulk_wait_all();
}

// ---- the forward of the training routes (kernels 4, 2 and 3 by kOwner),
// kernel 1's tile (mlp_tile_bf16.cuh) on the chunk's rows. Bound by the
// activations it saves (e, a_0 .. a_nt, feat, y: ~2.6 KB a sample for 8x128,
// >= 1.2 ms a step at 3.35 TB/s) ahead of its multiply-adds (0.49 TFLOP,
// 0.5 ms at the bf16 peak), so those stores are asynchronous TMA ones that
// run under the next products. Persistent CTAs, one per SM: warpgroup 3's
// first thread streams the weights; consumer warpgroup cw of CTA b is
// worker v = kCons b + cw and takes the 64-row tiles v, v + kCons G, ... of
// the launch, each through the whole MLP. A layer's bf16 A fragments are
// written once into one of the consumer's two 128 B-swizzled staging tiles
// (the box layout of the scratch blocks' tensor maps) and stored from there
// by TMA; the encoding tile, already in that layout, is stored as it is.
// Rows past n_real (the chunk's padding to whole 128-row tiles, which the
// chain and dW read) get a zero encoding. The heads are f32 from the
// accumulators: sigma in the last trunk layer's epilogue, rgb in the viewdir
// layer's, each row's float4 of raw written once by the lane that holds both.
// Tiles have fixed workers and no atomics: runs are bitwise repeatable.
struct NoMaps {};
template <int kOwner>
using FwdMaps = typename std::conditional<kOwner == kFieldFwd, NoMaps, ChainMaps>::type;

// The forward's shared memory from the 1024-aligned base: the weight ring of
// ns stages, each consumer's encoding tile (kx chunks) and its nbuf staging
// tiles (a chunk per 64 columns of H), the biases and heads, each
// consumer's sigma logits [64], the ring's barriers.
struct FwdSmem {
  size_t ring, enc, stage, aux, sig, bars, total;
};

__host__ __device__ inline FwdSmem fwd_smem(int H, int nt, int kx, int nbuf, int ns) {
  FwdSmem s;
  s.ring = 0;
  s.enc = (size_t)ns * H * 128;
  s.stage = s.enc + kCons * (size_t)kx * kEncChunk;
  s.aux = s.stage + kCons * (size_t)nbuf * ((H + kKc - 1) / kKc) * kEncChunk;
  s.sig = s.aux + align16((size_t)aux_head_max(H, nt) * 4);
  s.bars = s.sig + kCons * kTile * 4;
  s.total = s.bars + 2 * (size_t)ns * 8 + 1024;  // + slack to align the base
  return s;
}

// The forward's ring stages, as many as fit up to kMaxStages (a consumer
// waits for all of a layer's chunks before its products, so at least
// those), and its shared memory; 0 if they do not fit.
inline int fwd_stages(int H, int dx, int nt, int skip_mask, int nbuf, size_t* smem) {
  const int kx = (dx + kKc - 1) / kKc, kch = (H + kKc - 1) / kKc;
  int need = kx > kch ? kx : kch;
  for (int l = 0; l < nt; ++l) {
    const int cur = kch + (((skip_mask >> l) & 1) ? kx : 0);
    need = need > cur ? need : cur;
  }
  for (int ns = kMaxStages; ns >= need; --ns) {
    *smem = fwd_smem(H, nt, kx, nbuf, ns).total;
    if (*smem <= (size_t)kSmemMax) return ns;
  }
  return 0;
}

// The consumer's TMA store of `boxes` [64][64] chunks of the tile at src to
// rows r0 .. r0 + 63, columns 64 x .. of the scratch block of map, by its
// first thread, as one bulk group; then it waits until all but that group
// have read their tiles (a later barrier hands that on: the tile two
// stores back may be refilled).
__device__ __forceinline__ void store_tile(const CUtensorMap* map, int boxes, int r0,
                                           uint32_t src) {
  if ((threadIdx.x & 127) == 0) {
    for (int x = 0; x < boxes; ++x) tma_store_2d(map, 64 * x, r0, src + x * kEncChunk);
    bulk_commit();
    bulk_wait_read<1>();
  }
}

// The A fragments of an H-wide activation (rows 16 w + g and + 8, see
// wgmma_bf16_rs) into the consumer's swizzled staging tile at dst.
template <int H>
__device__ __forceinline__ void stage_frags(uint32_t dst, const uint32_t (&a)[H / 4]) {
  const int t = threadIdx.x & 127, g = (t & 31) >> 2, q = t & 3;
  const int row = 16 * (t >> 5) + g;
#pragma unroll
  for (int j = 0; j < H / 8; ++j) {
    sts32(dst + tile_off(row, 8 * j + 2 * q), a[2 * j]);
    sts32(dst + tile_off(row + 8, 8 * j + 2 * q), a[2 * j + 1]);
  }
}

// The encoding of the training forward's 64-row tile at row r0 of the chunk
// into the consumer's encoding tile encg, two threads a row (encode_coord:
// f32, rounded to bf16): the points are o + d z (kLoss) or pts (the fields);
// rows past n_real (the chunk's padding to whole scratch tiles, which the
// chain and dW read) get zeros where the activations are saved.
template <int kOwner>
__device__ __forceinline__ void encode_tile(const TrainArgs& p, unsigned char* encg, int r0,
                                            int n_real, int kx) {
  const int t = threadIdx.x & 127, i = t & 63, half = t >> 6, S = p.n_samples;
  const int r = r0 + i;
  if (r < n_real) {
    const long long ks = (long long)p.ray0 * S + r;  // the sample
    const long long rg = ((long long)p.ray0 + r / S) * 3;
    for (int d = 0; d < 3; ++d) {
      const float pt = kOwner != kLoss
                           ? p.pts[ks * 3 + d]
                           : __fadd_rn(p.origins[rg + d], __fmul_rn(p.dirs[rg + d], p.z[ks]));
      encode_coord(encg, i, d, pt, half, p.fx, p.inc_x, [&](int f) { return p.bands_x[f]; });
    }
  } else if (kOwner != kFieldFwd) {
    for (int c = half; c < 8 * kx; c += 2) {
      *reinterpret_cast<uint4*>(encg + (c >> 3) * kEncChunk + i * 128 + (c & 7) * 16) =
          make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// kOwner: the points are o + d z (kLoss) or pts (the fields); the
// activations go to the scratch (kLoss, kFieldBwd: m holds the blocks'
// tensor maps) or nowhere (kFieldFwd); raw goes to the [rows][4] buffer
// (kLoss, every row of the tiles), the [n_real][4] output (kFieldFwd) or
// nowhere (kFieldBwd). n_tiles 64-row tiles, ns ring stages.
template <int kOwner, int NTM>
__global__ void __launch_bounds__(kThreads, 1)
    train_fwd_bf16_kernel(const __grid_constant__ TrainArgs p,
                          const __grid_constant__ FwdMaps<kOwner> m, int n_real, int n_tiles,
                          int ns) {
  constexpr bool kSave = kOwner != kFieldFwd, kRaw = kOwner != kFieldBwd;
  constexpr int H = NTM * 16;
  constexpr int H2 = H / 2;
  constexpr int KCH = (H + kKc - 1) / kKc;  // K-chunks of a product on H
  constexpr int SB = H * 128;               // bytes of a ring stage
  constexpr int NBUF = kSave ? kStageBufs : 0;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sbase = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the swizzle's atoms
  unsigned char* gbase = smem_raw + (sbase - smem_u32(smem_raw));
  const int S = p.n_samples, nt = p.num_trunk, kx = (p.dx + kKc - 1) / kKc;
  const FwdSmem L = fwd_smem(H, nt, kx, NBUF, ns);
  const uint32_t ring = sbase + (uint32_t)L.ring;
  const uint32_t full = sbase + (uint32_t)L.bars, empty = full + 8 * ns;
  int nskip = 0;
  for (int i = 0; i < nt; ++i) nskip += (p.skip_mask >> i) & 1;
  const int nch = kx * (1 + nskip) + (nt + 2) * KCH;  // chunks of a pass over the weights
  const int G = gridDim.x, b = blockIdx.x;
  // worker kCons b + cw takes tiles kCons b + cw, + kCons G, ...; worker
  // kCons b has the CTA's most, and one pass over the weights a tile
  auto tiles_of = [&](int w) { return w < n_tiles ? (n_tiles - 1 - w) / (kCons * G) + 1 : 0; };
  const int passes = tiles_of(kCons * b);
  // the warpgroup, shuffled so that the compiler knows it is warp-uniform
  const int tid = threadIdx.x, cw = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int n_aux = p.aux_off[nt + 7];  // the biases and heads: to shared memory
  float* aux = reinterpret_cast<float*>(gbase + L.aux);
  for (int i = tid; i < n_aux; i += kThreads) aux[i] = __ldg(p.aux + i);
  if (tid == 0) {
    for (int s = 0; s < ns; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * kCons);  // every consumer warp releases a stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the encoding tiles' columns past dx stay zero
  for (int i = tid; i < kCons * kx * kEncChunk / 16; i += kThreads) {
    reinterpret_cast<uint4*>(gbase + L.enc)[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  fence_async_smem();
  __syncthreads();

  const int t = tid & 127, warp = t >> 5, lane = t & 31, g = lane >> 2, q = lane & 3;
  if (cw == kCons) {  // ---- the weight stream, one thread
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (t != 0) return;
    stream_weights(reinterpret_cast<const unsigned char*>(p.wq), passes, nch, nch - KCH, SB, ns,
                   ring, full, empty);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 152;\n");
  const int bar = 1 + cw, v = kCons * b + cw;
  const uint32_t enc = sbase + (uint32_t)L.enc + cw * kx * kEncChunk;
  unsigned char* encg = gbase + L.enc + cw * kx * kEncChunk;
  const uint32_t stage = sbase + (uint32_t)L.stage + cw * NBUF * KCH * kEncChunk;
  float* sig = reinterpret_cast<float*>(gbase + L.sig) + cw * kTile;  // sigma logits
  const float* w_alpha = aux + p.aux_off[nt + 3];
  const float b_alpha = aux[p.aux_off[nt + 4]];
  const float* w_rgb = aux + p.aux_off[nt + 5];
  const float* b_rgb = aux + p.aux_off[nt + 6];
  WeightRing wr{ring, full, empty, ns, SB, lane};
  int buf = 0;  // the staging tile of the next activation store

  const int mine = tiles_of(v);
  for (int k = 0; k < mine; ++k) {
    const int r0 = (v + kCons * G * k) * kTile;  // the tile's first row of the chunk
    // ---- positional encoding of the tile's rows (two threads a row)
    encode_tile<kOwner>(p, encg, r0, n_real, kx);
    fence_async_smem();
    wg_sync(bar);  // the encoding is written
    if constexpr (kSave) store_tile(&m.blocks[0], kx, r0, enc);

    float* sig_rows = sig + 16 * warp;
    float acc[H / 2];
    uint32_t a[H / 4];
    // the staging tile buf, written since the last barrier, to `boxes`
    // chunks of scratch block blk
    auto flush = [&](int blk, int boxes) {
      if constexpr (kSave) {
        fence_async_smem();
        wg_sync(bar);
        store_tile(&m.blocks[blk], boxes, r0, stage + buf * KCH * kEncChunk);
        buf ^= 1;
      }
    };
    // the activation just computed (a) to scratch block blk
    auto save = [&](int blk) {
      if constexpr (kSave) {
        wg_sync(bar);  // the first thread's last wait: the tile two stores back is read
        stage_frags<H>(stage + buf * KCH * kEncChunk, a);
        flush(blk, KCH);
      }
    };
    // ---- layer1: no activation
    wr.wait(kx);
    uint32_t se[kMaxKx], sh[KCH];
#pragma unroll
    for (int c = 0; c < kMaxKx; ++c) se[c] = wr.at(c < kx ? c : 0);
    fence_regs(acc);
    wgmma_fence();
    enc_product<H>(acc, enc, kx, se, true);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(acc);
    wr.release(kx);
    if (kRaw && nt == 0) {
      hidden_epilogue<H, false, true>(acc, aux + p.aux_off[0], a, w_alpha, b_alpha, sig_rows);
    } else {
      hidden_epilogue<H, false, false>(acc, aux + p.aux_off[0], a, w_alpha, b_alpha, sig_rows);
    }
    save(1);
    // ---- trunk, then fc_feat (layer nt + 1)
    for (int i = 0; i <= nt; ++i) {
      const bool skip = i < nt && ((p.skip_mask >> i) & 1);
      const int n = KCH + (skip ? kx : 0);
      wr.wait(n);
#pragma unroll
      for (int c = 0; c < KCH; ++c) sh[c] = wr.at(c);
#pragma unroll
      for (int c = 0; c < kMaxKx; ++c) se[c] = wr.at(KCH + (c < kx ? c : 0));
      fence_regs(a);
      fence_regs(acc);
      wgmma_fence();
      reg_product<H, H>(acc, a, sh);
      if (skip) enc_product<H>(acc, enc, kx, se, false);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(acc);
      wr.release(n);
      const float* bias = aux + p.aux_off[1 + i];
      if (kRaw && i == nt - 1) {
        hidden_epilogue<H, true, true>(acc, bias, a, w_alpha, b_alpha, sig_rows);
      } else {
        hidden_epilogue<H, true, false>(acc, bias, a, w_alpha, b_alpha, sig_rows);
      }
      save(2 + i);
    }
    // ---- layers_dir.0 on feat, + the per-ray bias: y (bf16, to the
    // staging tile) and the rgb head. At width 128 in two products of 32
    // columns, as kernel 1 (registers)
    constexpr int NSPLIT = H2 == 64 ? 2 : 1, NH = H2 / NSPLIT;
    wr.wait(KCH);
#pragma unroll
    for (int c = 0; c < KCH; ++c) sh[c] = wr.at(c);
    const uint32_t ytile = stage + buf * KCH * kEncChunk;
    if (kSave) wg_sync(bar);  // the staging tile is free (see save)
    float crgb[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
#pragma unroll
    for (int hs = 0; hs < NSPLIT; ++hs) {
      float ad[NH / 2];
      fence_regs(a);
      fence_regs(ad);
      wgmma_fence();
      reg_product<NH, H>(ad, a, sh, hs * NH * 128);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(ad);
      dir_epilogue<H, NH, kRaw, kSave>(ad, hs * NH, r0, S, p.n_rays, p.dirb, w_rgb, crgb, ytile);
    }
    wr.release(KCH);
    flush(nt + 3, 1);
    if constexpr (kRaw) {  // each row's sums over its four lanes; raw by the first
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int x = 1; x < 4; x <<= 1) {
#pragma unroll
          for (int c = 0; c < 3; ++c) crgb[h][c] += __shfl_xor_sync(0xffffffffu, crgb[h][c], x);
        }
        const int rl = 16 * warp + g + 8 * h;  // the row of the tile; sig[rl] is this lane's
        if (q == 0 && (kOwner == kLoss || r0 + rl < n_real)) {
          reinterpret_cast<float4*>(p.raw)[r0 + rl] =
              make_float4(crgb[h][0] + b_rgb[0], crgb[h][1] + b_rgb[1], crgb[h][2] + b_rgb[2],
                          sig[rl]);
        }
      }
    }
  }
  // worker kCons b has more tiles: release the chunks of its other passes
  for (int c = mine * nch; c < passes * nch; ++c) {
    wr.wait(1);
    wr.release(1);
  }
  if (kSave && t == 0) bulk_wait_all();
}

__global__ void __launch_bounds__(kSumThreads) sum_rays_bf16_kernel(const float* v, int n,
                                                                    float* out) {
  __shared__ float buf[kSumThreads];
  float s = 0.f;
  for (int i = threadIdx.x; i < n; i += kSumThreads) s += v[i];
  buf[threadIdx.x] = s;
  __syncthreads();
  for (int w = kSumThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) buf[threadIdx.x] += buf[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) *out = buf[0];
}

// ---- the wide route (padded widths above 128, mlp_wide_bf16.cuh): the
// forward of kernels 4, 2 and 3 by kOwner and the chain of kernels 4 and 3.
// Same scratch layout, tensor maps, prep, compositing, dW and reduction as
// the narrow route; only the forward and the chain change.
//
// The forward: persistent CTAs of `C` consumer warpgroups (C = 2 up to a
// padded width of 256, 1 above: wide_plan on wide_fwd_cons_bytes) and one
// warpgroup whose first thread streams the forward pack in [64][64] pieces
// (WideStream::forward). Worker v = C b + cw takes the 64-row tiles v, v +
// C G, ...; a tile's encoding is written and stored as the narrow forward's,
// then wide_tile runs it through the MLP, storing every activation by TMA
// and (kernels 4 and 3) the ReLU mask words the wide chain reads
// (wide_mask_words), and raw goes out as the narrow forward's. Bound, as the
// narrow one, by its
// activation stores (~5 KB a sample at 8x256) ahead of its multiply-adds
// (~0.6 M a sample).
__host__ __device__ inline size_t wide_fwd_cons_bytes(int hp, int kx) {
  // the activation tiles, the encoding tile, sigma [64] and rgb [64][3], two
  // layers' mask words [2][ceil(hp / 64)][128]
  return align1024(wide_act_bytes(hp) + (size_t)kx * kEncChunk + kTile * 4 * 4 +
                   2 * (size_t)((hp + 63) / 64) * 512);
}

template <int kOwner>
__global__ void __launch_bounds__(kWideThreads, 1)
    train_fwd_wide_kernel(const __grid_constant__ TrainArgs p,
                          const __grid_constant__ FwdMaps<kOwner> m, int n_real, int n_tiles,
                          int ns) {
  constexpr bool kSave = kOwner != kFieldFwd, kRaw = kOwner != kFieldBwd;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sbase = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the swizzle's atoms
  unsigned char* gbase = smem_raw + (sbase - smem_u32(smem_raw));
  const int C = blockDim.x / 128 - 1;
  const int S = p.n_samples, nt = p.num_trunk, hp = p.hidden, kx = (p.dx + kKc - 1) / kKc;
  const size_t cons_bytes = wide_fwd_cons_bytes(hp, kx), act_bytes = wide_act_bytes(hp);
  const uint32_t ring = sbase, cons0 = sbase + (uint32_t)ns * kWideStage;
  const uint32_t full = cons0 + (uint32_t)(C * cons_bytes), empty = full + 8 * ns;
  const int G = gridDim.x, b = blockIdx.x;
  auto tiles_of = [&](int w) { return w < n_tiles ? (n_tiles - 1 - w) / (C * G) + 1 : 0; };
  const int passes = tiles_of(C * b);
  const int tid = threadIdx.x, cw = __shfl_sync(0xffffffffu, tid >> 7, 0);
  if (tid == 0) {
    for (int s = 0; s < ns; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * C);  // every consumer warp releases a stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the consumers' blocks start zero: the encoding tiles' columns past dx stay so
  for (size_t i = tid; i < C * cons_bytes / 16; i += blockDim.x) {
    reinterpret_cast<uint4*>(gbase + ns * kWideStage)[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  fence_async_smem();
  __syncthreads();
  const int t = tid & 127, lane = t & 31;
  if (cw == C) {  // ---- the weight stream, one thread
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kWideProdRegs));
    if (t == 0) {
      WideStream st{reinterpret_cast<const unsigned char*>(p.wq), ring, full, empty, ns};
      st.forward(passes, hp, kx, nt, p.skip_mask);
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kWideConsRegs));
  const int v = C * b + cw;
  const uint32_t own = cons0 + (uint32_t)(cw * cons_bytes);
  unsigned char* ownp = gbase + ns * kWideStage + cw * cons_bytes;
  unsigned char* encg = ownp + act_bytes;
  float* sig = reinterpret_cast<float*>(encg + kx * kEncChunk);
  float* rgb = sig + kTile;
  const WideTile T{{own, own + (uint32_t)(act_bytes / 2)}, own + (uint32_t)act_bytes, p.aux,
                   p.aux_off, hp, kx, nt, p.skip_mask, 1 + cw,
                   own + (uint32_t)(act_bytes + kx * kEncChunk + kTile * 4 * 4)};
  const CUtensorMap* maps = nullptr;
  if constexpr (kSave) maps = m.blocks;
  WideRing wr{ring, full, empty, ns, lane};
  const int mine = tiles_of(v);
  for (int k = 0; k < mine; ++k) {
    const int r0 = (v + C * G * k) * kTile;  // the tile's first row of the chunk
    if (kSave && t == 0) bulk_wait_read<0>();  // the last tile's stores have read their tiles
    wg_sync(T.bar);
    // ---- positional encoding of the tile's rows (two threads a row)
    encode_tile<kOwner>(p, encg, r0, n_real, kx);
    fence_async_smem();
    wg_sync(T.bar);  // the encoding is written
    if (kSave && t == 0) {
      for (int x = 0; x < kx; ++x) tma_store_2d(maps, 64 * x, r0, T.enc + x * kEncChunk);
      bulk_commit();
    }
    wide_tile(T, wr, r0, S, p.n_rays, p.dirb, sig, rgb, maps, r0,
              kSave ? p.masks + (size_t)(r0 / kTile) * wide_mask_words(hp, nt) * 128 : nullptr);
    if (kRaw && t < kTile && (kOwner == kLoss || r0 + t < n_real)) {
      reinterpret_cast<float4*>(p.raw)[r0 + t] =
          make_float4(rgb[3 * t], rgb[3 * t + 1], rgb[3 * t + 2], sig[t]);
    }
  }
  // worker C b has more tiles: release the pieces of its other passes
  const int per_pass = wide_fwd_pieces(hp, kx, nt, p.skip_mask);
  for (int c = mine * per_pass; c < passes * per_pass; ++c) {
    wr.acquire();
    wr.release();
  }
  if (kSave && t == 0) bulk_wait_all();
}

// The wide chain: the narrow chain's work per 64-sample tile (raw
// cotangents, the y cotangent with the viewdir layer's bias sum and viewdir
// rows' dW, then products pi = 0 .. nt + 1 on the transposed weights), with
// each product's output in column blocks of 64 (wide_product, A
// the previous cotangent tile in shared memory). Persistent CTAs of C
// consumer warpgroups (wide_plan on wide_chain_cons_bytes) and one warpgroup
// whose first thread streams [64][64] pieces of pack_backward_weights_bf16
// by TMA (the pack's tensor map with [64][64] boxes). Each consumer's two
// cotangent tiles alternate as a product's input and output, and each
// output is stored to the scratch by TMA while the next product runs.
//
// Bound by its bytes (the cotangent blocks it writes, ~4.9 KB a sample at
// 8x256) ahead of its multiply-adds. Nothing that a thread waits for on
// device memory lies between a product's wgmma and its epilogue: the ReLU
// masks are the forward's mask words (wide_mask_words: 272 B a sample at
// 8x256, where the saved activations are 4.4 KB), each thread's own copied
// by cp.async into shared memory one product ahead (y's at the tile's
// start, for the y-cotangent step, a thread a column); a product's column
// sums (the bias sums, f32) are a reduce-scatter over the 8 lanes that share
// a column, then a sum over the 4 warps in shared memory; the bias sums and
// the viewdir rows' dW go to the worker's slot in device memory by
// red.global.add, each entry owned by one thread (so its adds land in
// program order: bitwise-repeatable runs). The raw cotangents sit in the
// output tile of product 0 until it is written. What the earlier design's
// time was made of (its 32 scalar mask loads a thread a column block), and
// this one's: PERF.md section 6, from perf_tools/train_chain_wide_variants.py.
__host__ __device__ inline size_t wide_chain_cons_bytes(int hp) {
  // the cotangent tiles, the column sums [4][hp], two products' mask words
  // [2][ceil(hp / 64)][128]
  return align1024(wide_act_bytes(hp) + 4 * (size_t)hp * 4 +
                   2 * (size_t)((hp + 63) / 64) * 512);
}

// A 4-byte asynchronous copy from device to shared memory (cp.async), its
// group's commit and the wait for all but the newest N groups.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Pieces of one tile's pass over the backward pack at padded width hp.
__host__ __device__ inline int wide_chain_pieces(int hp, int nt) {
  int blocks = 0;
  for (int c0 = 0; c0 < hp; c0 += wide_bn(hp, c0)) ++blocks;
  return blocks * ((hp / 2 + kKc - 1) / kKc + (nt + 1) * ((hp + kKc - 1) / kKc));
}

// f(BN) for the chain's column blocks (hp a multiple of 32: 64, the last 32).
template <class F>
__device__ __forceinline__ void with_bn32(int bn, F&& f) {
  if (bn == 64) {
    f(std::integral_constant<int, 64>{});
  } else {
    f(std::integral_constant<int, 32>{});
  }
}

// A block's column sums: cs[2 j + e] holds the thread's rows g and g + 8 of
// column 8 j + 2 q + e. A reduce-scatter over the 8 lanes of a q (lane bits
// X = 16, 8, 4: halves, quarters, eighths of cs) leaves lane g the warp's
// sums of k = g V / 8 .. + V / 8 - 1 in cs[0 .. V / 8 - 1]. Each step is its
// own instance, so every index is a constant and cs stays in registers (a
// loop over the steps left cs in local memory and serialized the chain's
// wgmma: ptxas C7514).
template <int V, int N = V / 2, int X = 16>
__device__ __forceinline__ void colsum_scatter(float (&cs)[V], int lane) {
  static_assert(V % 8 == 0, "a block of a multiple of 32 columns");
  const bool up = (lane & X) != 0;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const float send = up ? cs[k] : cs[k + N], keep = up ? cs[k + N] : cs[k];
    cs[k] = keep + __shfl_xor_sync(0xffffffffu, send, X);
  }
  if constexpr (X > 4) colsum_scatter<V, N / 2, X / 2>(cs, lane);
}

// dst[k H2] += enc[k] seg for k < dd by red.global.add (dst owned by the
// calling thread: its adds land in program order), eight loads at a time.
__device__ __forceinline__ void vd_red(float* dst, const float* __restrict__ enc, int dd, int H2,
                                       float seg) {
  for (int k0 = 0; k0 < dd; k0 += 8) {
    float e[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) e[i] = k0 + i < dd ? __ldg(enc + k0 + i) : 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (k0 + i < dd) atomicAdd(dst + (k0 + i) * H2, e[i] * seg);
    }
  }
}

__global__ void __launch_bounds__(kWideThreads, 1)
    train_chain_wide_kernel(const TrainArgs p, const __grid_constant__ ChainMaps m, int n_real,
                            int n_tiles, int ns) {
  const int C = blockDim.x / 128 - 1;
  const int S = p.n_samples, nt = p.num_trunk, dd = p.dd, hp = p.hidden, h2 = hp / 2;
  const int kch = (hp + kKc - 1) / kKc, k2 = (h2 + kKc - 1) / kKc;
  const int mw = (hp + 63) / 64, my = (h2 + 63) / 64, n_words = wide_mask_words(hp, nt);
  const int n_act = nt + 4;  // m.blocks: activation blocks, then cotangent blocks
  extern __shared__ unsigned char chain_raw[];
  const uint32_t sbase = (smem_u32(chain_raw) + 1023u) & ~1023u;
  unsigned char* gbase = chain_raw + (sbase - smem_u32(chain_raw));
  const size_t cons_bytes = wide_chain_cons_bytes(hp), act_bytes = wide_act_bytes(hp);
  const uint32_t ring = sbase, cons0 = sbase + (uint32_t)ns * kWideStage;
  const uint32_t full = cons0 + (uint32_t)(C * cons_bytes), empty = full + 8 * ns;
  const int tid = threadIdx.x, cw = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int G = gridDim.x, b = blockIdx.x;
  auto tiles_of = [&](int w) { return w < n_tiles ? (n_tiles - 1 - w) / (C * G) + 1 : 0; };
  const int passes = tiles_of(C * b);
  if (tid == 0) {
    for (int s = 0; s < ns; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * C);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int t = tid & 127, warp = t >> 5, lane = t & 31, g = lane >> 2, q = lane & 3;
  if (cw == C) {  // ---- the transposed weights, the same pieces every pass
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kWideProdRegs));
    if (t == 0) {
      int it = 0;
      for (int ps = 0; ps < passes; ++ps) {
        for (int pi = 0; pi < nt + 2; ++pi) {
          const int kc = pi == 0 ? k2 : kch;
          const int rb = pi == 0 ? 0 : (k2 + (pi - 1) * kch) * hp;  // the product's first row
          for (int c0 = 0; c0 < hp; c0 += wide_bn(hp, c0)) {
            for (int c = 0; c < kc; ++c, ++it) {
              const int s = it % ns;
              mbar_wait(empty + 8 * s, ((it / ns) & 1) ^ 1);
              mbar_expect_tx(full + 8 * s, kWideStage);
              tma_load_2d(ring + s * kWideStage, &m.w, 0, rb + c * hp + c0, full + 8 * s);
            }
          }
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kWideConsRegs));
  const int v = C * b + cw;
  const uint32_t own = cons0 + (uint32_t)(cw * cons_bytes);
  const uint32_t cot0 = own, cot1 = own + (uint32_t)(act_bytes / 2);  // the cotangent tiles
  unsigned char* ownp = gbase + ns * kWideStage + cw * cons_bytes;
  // the raw cotangents [64][4] f32, in tile 1 until product 0 writes it
  const float* gsh = reinterpret_cast<const float*>(ownp + act_bytes / 2);
  float* colsum = reinterpret_cast<float*>(ownp + act_bytes);  // [4 warps][hp]
  // two products' mask words [2][mw][128] (y's in buffer 1 for the y cotangent)
  const uint32_t msm = own + (uint32_t)(act_bytes + 4 * (size_t)hp * 4);
  const uint32_t* msg = reinterpret_cast<const uint32_t*>(ownp + act_bytes + 4 * (size_t)hp * 4);
  const int bar = 1 + cw;
  const int n_slot = aux_size(hp, nt, dd);
  float* const mine = p.aux_part + (size_t)v * n_slot;
  for (int i = t; i < n_slot; i += 128) mine[i] = 0.f;
  const float* w_rgb = p.aux + p.aux_off[nt + 5];    // [h2][3] f32
  const float* w_alpha = p.aux + p.aux_off[nt + 3];  // [hp] f32
  bf16* const S0 = p.scratch;
  WideRing wr{ring, full, empty, ns, lane};
  const int n_mine = tiles_of(v);
  for (int k = 0; k < n_mine; ++k) {
    const int tile = v + k * C * G;
    const long long k0 = (long long)tile * kCTile;
    const uint32_t* tm = p.masks + (size_t)tile * n_words * 128 + t;  // the thread's words
    // the thread's mask words of product pi (pi <= nt) or y's (pi < 0) into
    // buffer x, as one cp.async group
    auto copy_words = [&](int pi, int x) {
      const int first = pi < 0 ? (nt + 1) * mw : (nt - pi) * mw, n = pi < 0 ? my : mw;
      if (pi <= nt) {
        for (int w = 0; w < n; ++w) {
          cp_async4(msm + ((x * mw + w) * 128 + t) * 4, tm + (first + w) * 128);
        }
      }
      cp_async_commit();
    };
    if (t == 0) bulk_wait_read<0>();  // the last tile's stores have read their tiles
    wg_sync(bar);
    copy_words(-1, 1);
    copy_words(0, 0);
    // ---- raw cotangents of the tile; rgb and sigma ones to the scratch in bf16
    if (t < kCTile) {
      const int r = t;
      const float4 gr = k0 + r < n_real ? reinterpret_cast<const float4*>(p.graw)[k0 + r]
                                        : make_float4(0.f, 0.f, 0.f, 0.f);
      reinterpret_cast<float4*>(ownp + act_bytes / 2)[r] = gr;
      __align__(16) __nv_bfloat162 rgb8[4], sig8[4];
      const __nv_bfloat162 z2 = __floats2bfloat162_rn(0.f, 0.f);
      rgb8[0] = __floats2bfloat162_rn(gr.x, gr.y);
      rgb8[1] = __floats2bfloat162_rn(gr.z, 0.f);
      rgb8[2] = rgb8[3] = z2;
      sig8[0] = __floats2bfloat162_rn(gr.w, 0.f);
      sig8[1] = sig8[2] = sig8[3] = z2;
      __stcs(reinterpret_cast<float4*>(S0 + p.dlt_off[nt + 3] + (k0 + r) * 8),
             *reinterpret_cast<const float4*>(rgb8));
      __stcs(reinterpret_cast<float4*>(S0 + p.dlt_off[nt + 4] + (k0 + r) * 8),
             *reinterpret_cast<const float4*>(sig8));
    }
    cp_async_wait<1>();  // y's words (the thread's own), then everyone's
    wg_sync(bar);
    if (t < 4) {  // rgb and sigma bias sums
      float s = 0.f;
      for (int r = 0; r < kCTile; ++r) s += gsh[r * 4 + t];
      atomicAdd(mine + (t < 3 ? aux_rgb(hp, nt) + t : aux_alpha(hp, nt)), s);
    }
    // ---- y cotangent (g_rgb . W_rgb^T, f32) masked by y > 0 (its mask
    // words), one thread a column: the viewdir layer's bias sum (f32) and its
    // viewdir rows' dW (each ray's encoding x its sum of the bf16
    // cotangent), into tile 0
    for (int col = t; col < h2; col += 128) {
      const float* wr3 = w_rgb + col * 3;
      const float w0 = __ldg(wr3), w1 = __ldg(wr3 + 1), w2 = __ldg(wr3 + 2);
      float* vd = mine + aux_vd(hp, nt) + col;
      // row 16 w + i's bit: word 32 w + 4 (i % 8) + q of the column's group,
      // bit yb - 8 (i / 8)
      const uint32_t* ycol = msg + (mw + (col >> 6)) * 128 + ((col & 7) >> 1);
      const int yb = wide_mask_bit((col & 63) >> 3, 0, col & 1);
      float bsum = 0.f, seg = 0.f;
      int ray = (int)(k0 / S), pos = (int)(k0 - (long long)ray * S);
      for (int r0 = 0; r0 < kCTile; r0 += 16) {  // warp r0 / 16's rows: 8 words, 2 bits each
        uint32_t wd[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) wd[i] = ycol[2 * r0 + 4 * i];
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int r = r0 + i;
          const float4 gg = reinterpret_cast<const float4*>(gsh)[r];
          const float dy = fmaf(gg.z, w2, fmaf(gg.y, w1, gg.x * w0));
          const float vv = (wd[i & 7] >> (yb - 8 * (i >> 3))) & 1u ? dy : 0.f;
          const bf16 vb = __float2bfloat16_rn(vv);
          sts16(cot0 + tile_off(r, col), __bfloat16_as_ushort(vb));
          if (k0 + r < n_real) {
            bsum += vv;
            seg += __bfloat162float(vb);
            if (++pos == S) {  // the ray's last sample
              vd_red(vd, p.dir_enc + (size_t)ray * dd, dd, h2, seg);
              seg = 0.f;
              pos = 0;
              ++ray;
            }
          }
        }
      }
      if (pos > 0) vd_red(vd, p.dir_enc + (size_t)ray * dd, dd, h2, seg);  // continues
      atomicAdd(mine + aux_dir(hp, nt) + col, bsum);
    }
    const int r0 = 16 * warp + g;
    const float gs[2] = {gsh[r0 * 4 + 3], gsh[(r0 + 8) * 4 + 3]};  // sigma's, for product 1
    fence_async_smem();
    wg_sync(bar);
    if (t == 0) {
      for (int x = 0; x < k2; ++x) {
        tma_store_2d(&m.blocks[n_act + nt + 2], 64 * x, (int)k0, cot0 + x * kEncChunk);
      }
      bulk_commit();
    }
    // ---- the products
    for (int pi = 0; pi < nt + 2; ++pi) {
      // product pi reads tile pi % 2 and writes the other
      const uint32_t in = pi & 1 ? cot1 : cot0, out = pi & 1 ? cot0 : cot1;
      if (t == 0) bulk_wait_read<1>();  // out's store two products ago has read it
      wg_sync(bar);
      copy_words(pi + 1, (pi + 1) & 1);  // the next product's, under this one's wgmma
      const uint32_t* words = msg + (pi & 1) * mw * 128 + t;  // this product's (the thread's)
      for (int c0 = 0; c0 < hp; c0 += wide_bn(hp, c0)) {
        with_bn32(wide_bn(hp, c0), [&](auto bn) {
          constexpr int BN = decltype(bn)::value, V = BN / 4;
          float acc[BN / 2];
          wide_product<BN>(acc, in, pi == 0 ? k2 : kch, (pi == 0 ? h2 : hp) / 16, 0, 0, wr);
          cp_async_wait<1>();  // this product's words: all but the newest group
          // the block's mask word (all ones on the last product)
          const bool masked = pi <= nt;
          const uint32_t mwd = masked ? words[(c0 >> 6) * 128] : 0xffffffffu;
          float cs[V];
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
            const int col = c0 + 8 * j + 2 * q;
            float wa0 = 0.f, wa1 = 0.f;
            if (pi == 1) {
              wa0 = __ldg(w_alpha + col);
              wa1 = __ldg(w_alpha + col + 1);
            }
            cs[2 * j] = cs[2 * j + 1] = 0.f;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
              if (pi == 1) {
                v0 = fmaf(gs[h], wa0, v0);
                v1 = fmaf(gs[h], wa1, v1);
              }
              const int bit = wide_mask_bit(j & 7, h, 0);  // e = 1: bit + 16
              if (!((mwd >> bit) & 1u)) v0 = 0.f;
              if (!((mwd >> (bit + 16)) & 1u)) v1 = 0.f;
              sts32(out + tile_off(r0 + 8 * h, col), pack_bf16(v0, v1));
              cs[2 * j] += v0;
              cs[2 * j + 1] += v1;
            }
          }
          colsum_scatter<V>(cs, lane);
#pragma unroll
          for (int i = 0; i < V / 8; ++i) {
            const int kk = g * (V / 8) + i;
            colsum[warp * hp + c0 + 8 * (kk >> 1) + 2 * q + (kk & 1)] = cs[i];
          }
        });
      }
      fence_async_smem();
      wg_sync(bar);
      if (t == 0) {
        for (int x = 0; x < kch; ++x) {
          tma_store_2d(&m.blocks[n_act + nt + 1 - pi], 64 * x, (int)k0, out + x * kEncChunk);
        }
        bulk_commit();
      }
      float* bias = mine + aux_bias(nt + 1 - pi, hp);
      for (int c = t; c < hp; c += 128) {
        atomicAdd(bias + c,
                  (colsum[c] + colsum[hp + c]) + (colsum[2 * hp + c] + colsum[3 * hp + c]));
      }
    }
  }
  // worker C b has more tiles: release the pieces of its other passes
  const int per_pass = wide_chain_pieces(hp, nt);
  for (int c = n_mine * per_pass; c < passes * per_pass; ++c) {
    wr.acquire();
    wr.release();
  }
  if (t == 0) bulk_wait_all();
}

// The gradient of every parameter from the dW slots of a plan in parts
// (each part a DwArgs of its own, launched on its own slots; one part up to
// a padded width of 128) and, as aux rows, the chain CTAs' slots (bias
// sums, viewdir rows): dw_split.cuh's reduce_slots.
__global__ void reduce_bf16_kernel(const DwParts parts, int n_chunks, int n_st_full,
                                   int n_st_last, long long n_params, const float* aux,
                                   int n_aux_parts, int n_aux, const int* map, float* grad) {
  reduce_slots(parts, n_chunks, n_st_full, n_st_last, n_params, aux, n_aux_parts, n_aux, map,
               grad);
}

template <class K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// The forward's launch on a chunk of n_real rows in `tiles` scratch tiles of
// kRowTile: its 64-row tiles are the scratch's where the activations are
// saved (the chain and dW read whole tiles), else the rows'; one persistent
// CTA per kCons of them, at most fwd_ctas.
template <int kOwner, int NTM>
cudaError_t launch_fwd(const TrainArgs& a, const FwdMaps<kOwner>& m, int n_real, int tiles,
                       cudaStream_t s) {
  constexpr bool kSave = kOwner != kFieldFwd;
  size_t smem = 0;
  const int ns = fwd_stages(NTM * 16, a.dx, a.num_trunk, a.skip_mask, kSave ? kStageBufs : 0,
                            &smem);
  if (ns == 0) return cudaErrorInvalidValue;
  const cudaError_t err = set_smem(train_fwd_bf16_kernel<kOwner, NTM>, smem);
  if (err != cudaSuccess) return err;
  const int n_tiles = kSave ? tiles * (kRowTile / kTile) : (n_real + kTile - 1) / kTile;
  const int want = (n_tiles + kCons - 1) / kCons, grid = want < a.fwd_ctas ? want : a.fwd_ctas;
  train_fwd_bf16_kernel<kOwner, NTM><<<grid, kThreads, smem, s>>>(a, m, n_real, n_tiles, ns);
  return cudaGetLastError();
}

template <int NTM>
int launch_pass(const TrainArgs& a, const ChainMaps& cm, int n_real, int tiles, cudaStream_t s) {
  const size_t cs = chain_smem_for(a).total;
  const size_t ps = (size_t)kRayWarps * 7 * a.n_samples * sizeof(float);
  cudaError_t err = set_smem(train_chain_bf16_kernel<NTM>, cs);
  if (err == cudaSuccess) err = set_smem(train_composite_kernel, ps);
  if (err != cudaSuccess) return (int)err;
  if (a.n_rays == 0) return 0;
  train_prep_kernel<kLoss><<<(a.n_rays + kPrepWarps - 1) / kPrepWarps, kPrepWarps * 32, 0, s>>>(
      a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if ((err = launch_fwd<kLoss, NTM>(a, cm, n_real, tiles, s)) != cudaSuccess) return (int)err;
  train_composite_kernel<<<(a.n_rays + kRayWarps - 1) / kRayWarps, kRayWarps * 32, ps, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  train_chain_bf16_kernel<NTM><<<a.chain_ctas / 2, kChainThreads, cs, s>>>(a, cm, n_real,
                                                                           2 * tiles);
  return (int)cudaGetLastError();
}

// The field kernels' launches (see the head of this file): kernel 2's prep
// and forward, or kernel 3's prep, forward and chain.
template <int kOwner, int NTM>
int launch_field(const TrainArgs& a, const ChainMaps* cm, int n_real, int tiles, cudaStream_t s) {
  const size_t cs = chain_smem_for(a).total;
  cudaError_t err = kOwner == kFieldBwd ? set_smem(train_chain_bf16_kernel<NTM>, cs) : cudaSuccess;
  if (err != cudaSuccess) return (int)err;
  if (a.n_rays == 0) return 0;
  train_prep_kernel<kOwner><<<(a.n_rays + kPrepWarps - 1) / kPrepWarps, kPrepWarps * 32, 0,
                              s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if constexpr (kOwner == kFieldFwd) {
    return (int)launch_fwd<kOwner, NTM>(a, NoMaps{}, n_real, tiles, s);
  } else {
    if ((err = launch_fwd<kOwner, NTM>(a, *cm, n_real, tiles, s)) != cudaSuccess) return (int)err;
    train_chain_bf16_kernel<NTM><<<a.chain_ctas / 2, kChainThreads, cs, s>>>(a, *cm, n_real,
                                                                             2 * tiles);
    return (int)cudaGetLastError();
  }
}

template <int kOwner>
int launch_field_width(const TrainArgs& a, const ChainMaps* cm, int n_real, int tiles,
                       cudaStream_t s) {
  switch (a.hidden / 32) {
    case 1: return launch_field<kOwner, 2>(a, cm, n_real, tiles, s);
    case 2: return launch_field<kOwner, 4>(a, cm, n_real, tiles, s);
    case 3: return launch_field<kOwner, 6>(a, cm, n_real, tiles, s);
    default: return launch_field<kOwner, 8>(a, cm, n_real, tiles, s);
  }
}

// ---- the wide route's launches (padded widths above 128)
inline WidePlan wide_fwd_plan(const TrainArgs& a) {
  return wide_plan(wide_fwd_cons_bytes(a.hidden, (a.dx + kKc - 1) / kKc));
}

template <int kOwner>
cudaError_t launch_fwd_wide(const TrainArgs& a, const FwdMaps<kOwner>& m, int n_real, int tiles,
                            cudaStream_t s) {
  constexpr bool kSave = kOwner != kFieldFwd;
  const WidePlan w = wide_fwd_plan(a);
  if (w.cons == 0) return cudaErrorInvalidValue;
  const cudaError_t err = set_smem(train_fwd_wide_kernel<kOwner>, w.smem);
  if (err != cudaSuccess) return err;
  const int n_tiles = kSave ? tiles * (kRowTile / kTile) : (n_real + kTile - 1) / kTile;
  const int want = (n_tiles + w.cons - 1) / w.cons, grid = want < a.fwd_ctas ? want : a.fwd_ctas;
  train_fwd_wide_kernel<kOwner><<<grid, 128 * (w.cons + 1), w.smem, s>>>(a, m, n_real, n_tiles,
                                                                         w.stages);
  return cudaGetLastError();
}

// The wide chain on a.chain_ctas workers (a multiple of its consumers).
cudaError_t launch_chain_wide(const TrainArgs& a, const ChainMaps& cm, int n_real, int tiles,
                              cudaStream_t s) {
  const WidePlan w = wide_plan(wide_chain_cons_bytes(a.hidden));
  if (w.cons == 0 || a.chain_ctas % w.cons != 0) return cudaErrorInvalidValue;
  const cudaError_t err = set_smem(train_chain_wide_kernel, w.smem);
  if (err != cudaSuccess) return err;
  train_chain_wide_kernel<<<a.chain_ctas / w.cons, 128 * (w.cons + 1), w.smem, s>>>(
      a, cm, n_real, 2 * tiles, w.stages);
  return cudaGetLastError();
}

int launch_pass_wide(const TrainArgs& a, const ChainMaps& cm, int n_real, int tiles,
                     cudaStream_t s) {
  const size_t ps = (size_t)kRayWarps * 7 * a.n_samples * sizeof(float);
  cudaError_t err = set_smem(train_composite_kernel, ps);
  if (err != cudaSuccess) return (int)err;
  if (a.n_rays == 0) return 0;
  train_prep_kernel<kLoss><<<(a.n_rays + kPrepWarps - 1) / kPrepWarps, kPrepWarps * 32, 0, s>>>(
      a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if ((err = launch_fwd_wide<kLoss>(a, cm, n_real, tiles, s)) != cudaSuccess) return (int)err;
  train_composite_kernel<<<(a.n_rays + kRayWarps - 1) / kRayWarps, kRayWarps * 32, ps, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return (int)launch_chain_wide(a, cm, n_real, tiles, s);
}

template <int kOwner>
int launch_field_wide(const TrainArgs& a, const ChainMaps* cm, int n_real, int tiles,
                      cudaStream_t s) {
  if (a.n_rays == 0) return 0;
  train_prep_kernel<kOwner><<<(a.n_rays + kPrepWarps - 1) / kPrepWarps, kPrepWarps * 32, 0,
                              s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if constexpr (kOwner == kFieldFwd) {
    return (int)launch_fwd_wide<kOwner>(a, NoMaps{}, n_real, tiles, s);
  } else {
    if ((err = launch_fwd_wide<kOwner>(a, *cm, n_real, tiles, s)) != cudaSuccess) return (int)err;
    return (int)launch_chain_wide(a, *cm, n_real, tiles, s);
  }
}

// A wide kernel's residency into out: CTAs per SM, shared bytes per CTA,
// ring stages, consumer warpgroups.
template <class K>
cudaError_t wide_residency(K kernel, const WidePlan& w, int* out) {
  out[1] = (int)w.smem;
  out[2] = w.stages;
  out[3] = w.cons;
  const cudaError_t err = set_smem(kernel, w.smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel, 128 * (w.cons + 1), w.smem);
}

// The forward's residency for kOwner into out: CTAs per SM, shared bytes
// per CTA, ring stages, staging tiles per consumer.
template <int kOwner, int NTM>
cudaError_t fwd_residency(const TrainArgs& a, int* out) {
  constexpr int nbuf = kOwner != kFieldFwd ? kStageBufs : 0;
  size_t smem = 0;
  const int ns = fwd_stages(NTM * 16, a.dx, a.num_trunk, a.skip_mask, nbuf, &smem);
  if (ns == 0) return cudaErrorInvalidValue;
  out[1] = (int)smem;
  out[2] = ns;
  out[3] = nbuf;
  const cudaError_t err = set_smem(train_fwd_bf16_kernel<kOwner, NTM>, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, train_fwd_bf16_kernel<kOwner, NTM>,
                                                       kThreads, smem);
}

// out: the forward's residency saving the activations (kernels 4 and 3),
// without (kernel 2), then the chain's CTAs per SM and shared bytes.
template <int NTM>
int occupancy(const TrainArgs& a, int* out) {
  cudaError_t err = fwd_residency<kLoss, NTM>(a, out);
  if (err == cudaSuccess) err = fwd_residency<kFieldFwd, NTM>(a, out + 4);
  const size_t cs = chain_smem_for(a).total;
  out[9] = (int)cs;
  if (err == cudaSuccess) err = set_smem(train_chain_bf16_kernel<NTM>, cs);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 8, train_chain_bf16_kernel<NTM>,
                                                        kChainThreads, cs);
  }
  return (int)err;
}

// The dW kernel's dynamic shared memory for the plan in a (slack to align
// the ring to 1024 B, the stages, a full and an empty mbarrier per stage),
// or 0 if the plan is not one the kernel takes.
size_t dw_smem(const DwArgs& a) {
  if (a.n_units < 1 || a.n_units > kDwMaxUnits || a.grid < 1 || a.max_pieces < 1 ||
      a.n_stages < 2 || a.stage_bytes < kDwBoxBytes || a.stage_bytes % kDwBoxBytes != 0 ||
      a.partial == nullptr || a.n_params < 1) {
    return 0;
  }
  int total = 0;
  for (int u = 0; u < a.n_units; ++u) {
    const DwUnit& U = a.units[u];
    if (U.n_a < 1 || U.n_b < 1 || U.n_a + U.n_b > kDwMaxBoxes ||
        (U.n_a + U.n_b) * kDwBoxBytes > a.stage_bytes || U.n_blocks < 1 ||
        U.n_blocks > kDwMaxBlocks || U.cost < 1 || U.tx < 1 ||
        U.tx > (U.n_a + U.n_b) * kDwBoxBytes) {
      return 0;
    }
    for (int x = 0; x < U.n_a + U.n_b; ++x) {
      if (U.map[x] < 0 || U.map[x] >= kDwMaxMaps) return 0;
    }
    for (int x = 0; x < U.n_blocks; ++x) {
      const DwBlock& k = U.blk[x];
      if (k.a < 0 || k.a >= U.n_a || k.b < U.n_a || k.b >= U.n_a + U.n_b || k.n_lim < 1 ||
          k.n_lim > kDwBox || k.m_lim < 1 || k.m_lim > kDwBox) {
        return 0;
      }
    }
    total += U.cost;
  }
  if (total != a.total_cost) return 0;
  const size_t bytes = 1024 + (size_t)a.n_stages * (a.stage_bytes + 16);
  return bytes <= (size_t)kDwSmemMax ? bytes : 0;
}

}  // namespace

extern "C" {

// sizeof the argument blocks (0: TrainArgs, 1: DwArgs, 2: ChainMaps), (3)
// the floats of one chain CTA's slot for `hidden`, `num_trunk`, `dd`, and
// (4) the wide route's mask words a thread of a 64-row tile.
int dexnerf_train_bf16_size(int which, int hidden, int num_trunk, int dd) {
  if (which == 0) return (int)sizeof(TrainArgs);
  if (which == 1) return (int)sizeof(DwArgs);
  if (which == 2) return (int)sizeof(ChainMaps);
  if (which == 4) return wide_mask_words(hidden, num_trunk);
  return aux_size(hidden, num_trunk, dd);
}

// CTA b's part of the unit at `pre` of `cost` in a dW launch over n_st
// stages, as the kernel (dw_span) and the reduction (dw_pieces) split the
// work: out = {slot, first stage, end stage, the unit's slots}. Returns 1
// if b has a part of the unit, else 0 (out untouched).
int dexnerf_train_bf16_dw_span(int n_st, int pre, int cost, int total, int grid, int b,
                               int* out) {
  int piece, j0, j1;
  if (!dw_span(n_st, pre, cost, total, grid, b, &piece, &j0, &j1)) return 0;
  out[0] = piece;
  out[1] = j0;
  out[2] = j1;
  out[3] = dw_pieces(n_st, pre, cost, total, grid);
  return 1;
}

// The prep, forward, compositing and chain launches of one chunk: n_real =
// n_rays * n_samples scratch rows in `tiles` tiles of 128; maps is the
// chain's ChainMaps. Returns a cudaError_t (0 on success); launches are
// asynchronous on `stream`.
int dexnerf_train_bf16_pass(const void* args, const void* maps, int n_real, int tiles,
                            void* stream) {
  const TrainArgs& a = *static_cast<const TrainArgs*>(args);
  if (a.n_samples < 1 || a.n_samples > kMaxSamples || a.num_trunk < 0 || a.num_trunk > 31 ||
      a.num_trunk + 8 > kAux || a.num_trunk + 5 > kMaxBlocks || a.fx > kMaxFreq ||
      a.fd > kMaxFreq || a.dd > kMaxDD || a.dx < 1 || a.dx > kMaxDx || a.dxp % kEncPad != 0 ||
      a.dxp < a.dx || a.hidden % 32 != 0 || a.hidden < 32 || a.hidden > kWideMaxHidden ||
      a.chain_ctas < 1 || (a.hidden <= 128 && a.chain_ctas % 2 != 0) || a.fwd_ctas < 1 ||
      maps == nullptr || (a.hidden > 128 && a.masks == nullptr) ||
      (long long)n_real != (long long)a.n_rays * a.n_samples ||
      tiles != (n_real + kRowTile - 1) / kRowTile) {
    return (int)cudaErrorInvalidValue;
  }
  ChainMaps cm;  // an aligned copy of the caller's maps
  memcpy(&cm, maps, sizeof cm);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.hidden > 128) return launch_pass_wide(a, cm, n_real, tiles, s);
  switch (a.hidden / 32) {
    case 1: return launch_pass<2>(a, cm, n_real, tiles, s);
    case 2: return launch_pass<4>(a, cm, n_real, tiles, s);
    case 3: return launch_pass<6>(a, cm, n_real, tiles, s);
    default: return launch_pass<8>(a, cm, n_real, tiles, s);
  }
}

// The field kernels at bf16 on one chunk of n_rays rays (n_real = n_rays *
// n_samples rows in `tiles` tiles of 128): kernel 2's forward (backward =
// 0: raw into [n_real][4], no scratch) or kernel 3's forward and chain
// (backward = 1: the scratch, the chain's slots and ChainMaps maps, graw =
// the cotangent of raw). The points come from pts. Returns a cudaError_t.
int dexnerf_field_bf16_pass(const void* args, const void* maps, int n_real, int tiles,
                            int backward, void* stream) {
  const TrainArgs& a = *static_cast<const TrainArgs*>(args);
  if (a.n_samples < 1 || a.num_trunk < 0 || a.num_trunk > 31 || a.num_trunk + 8 > kAux ||
      a.num_trunk + 5 > kMaxBlocks || a.fx > kMaxFreq || a.fd > kMaxFreq || a.dd > kMaxDD ||
      a.dx < 1 || a.dx > kMaxDx || a.dxp % kEncPad != 0 || a.dxp < a.dx || a.hidden % 32 != 0 ||
      a.hidden < 32 || a.hidden > kWideMaxHidden || a.fwd_ctas < 1 || a.pts == nullptr ||
      (backward ? a.chain_ctas < 1 || (a.hidden <= 128 && a.chain_ctas % 2 != 0) ||
                      a.scratch == nullptr || a.graw == nullptr || maps == nullptr ||
                      (a.hidden > 128 && a.masks == nullptr)
                : a.raw == nullptr) ||
      (long long)n_real != (long long)a.n_rays * a.n_samples ||
      tiles != (n_real + kRowTile - 1) / kRowTile) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = a.hidden > 128;
  if (!backward) {
    return wide ? launch_field_wide<kFieldFwd>(a, nullptr, n_real, tiles, s)
                : launch_field_width<kFieldFwd>(a, nullptr, n_real, tiles, s);
  }
  ChainMaps cm;
  memcpy(&cm, maps, sizeof cm);
  return wide ? launch_field_wide<kFieldBwd>(a, &cm, n_real, tiles, s)
              : launch_field_width<kFieldBwd>(a, &cm, n_real, tiles, s);
}

// A tensor map of one [rows][width] bf16 block at ptr for the dW and chain
// kernels, into out (128 bytes): [box_rows][64] boxes, 128 B swizzle, zeros
// past the block's width; [64][8] boxes, unswizzled, for an 8-wide block.
// Returns 0, cudaErrorInvalidValue for arguments outside these, or the
// driver's CUresult.
int dexnerf_train_bf16_tensor_map(void* out, const void* ptr, long long width, long long rows,
                                  int box_rows) {
  PFN_encodeTiled encode;
  const cudaError_t err = tensor_map_encoder(&encode);
  if (err != cudaSuccess) return (int)err;
  if (width < 8 || width % 8 != 0 || rows < 1 || box_rows < 8 || box_rows > 256) {
    return (int)cudaErrorInvalidValue;
  }
  const cuuint64_t dims[2] = {(cuuint64_t)width, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)width * 2};
  const cuuint32_t box[2] = {width == 8 ? 8u : (cuuint32_t)kDwBox, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(static_cast<CUtensorMap*>(out), CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                            const_cast<void*>(ptr), dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE,
                            width == 8 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return (int)r;  // the driver's CUresult (0 on success)
}

// The weight-gradient products of chunk `chunk` (n_st stages of 64 scratch
// rows) by the plan in args (a DwArgs). Returns a cudaError_t.
int dexnerf_train_bf16_dw(const void* args, int n_st, int chunk, void* stream) {
  DwArgs a;  // an aligned copy of the caller's block
  memcpy(&a, args, sizeof a);
  const size_t smem = dw_smem(a);
  if (smem == 0 || n_st < 1 || chunk < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (a.fresh) {
    err = set_smem(train_dw_bf16_kernel<true>, smem);
    if (err != cudaSuccess) return (int)err;
    train_dw_bf16_kernel<true><<<a.grid, kDwThreads, smem, s>>>(a, n_st, chunk);
  } else {
    err = set_smem(train_dw_bf16_kernel<false>, smem);
    if (err != cudaSuccess) return (int)err;
    train_dw_bf16_kernel<false><<<a.grid, kDwThreads, smem, s>>>(a, n_st, chunk);
  }
  return (int)cudaGetLastError();
}

// The gradient of every parameter (see reduce_bf16_kernel): dw_args holds
// the plan's n_parts DwArgs one after another; the dW slots of n_chunks
// chunks, the last of n_st_last stages, the others of n_st_full; and, when
// loss is not null, the sum of the n_rays per-ray losses into *loss.
int dexnerf_train_bf16_reduce(const void* dw_args, int n_parts, int n_chunks, int n_st_full,
                              int n_st_last, const float* aux_part, int n_aux_parts, int n_aux,
                              const int* map, float* grad, const float* loss_ray, int n_rays,
                              float* loss, void* stream) {
  if (n_parts < 1 || n_parts > kDwMaxParts || n_chunks < 1 || n_st_full < 1 || n_st_last < 1) {
    return (int)cudaErrorInvalidValue;
  }
  DwParts parts;
  long long n_params = -1;
  DwArgs a;
  for (int k = 0; k < n_parts; ++k) {
    memcpy(&a, static_cast<const unsigned char*>(dw_args) + k * sizeof(DwArgs), sizeof a);
    if (dw_smem(a) == 0 || (k > 0 && a.n_params != n_params)) return (int)cudaErrorInvalidValue;
    n_params = a.n_params;
    parts.sp[k] = dw_spans_of(a.n_units, a.total_cost, a.grid, a.max_pieces,
                              [&](int u) { return a.units[u].cost; });
    parts.partial[k] = a.partial;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  reduce_bf16_kernel<<<(unsigned)((n_params + 255) / 256), 256, 0, s>>>(
      parts, n_chunks, n_st_full, n_st_last, n_params, aux_part, n_aux_parts, n_aux, map, grad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || loss == nullptr) return (int)err;
  sum_rays_bf16_kernel<<<1, kSumThreads, 0, s>>>(loss_ray, n_rays, loss);
  return (int)cudaGetLastError();
}

// The residency of the wide route's kernels at padded width `hidden` (a
// multiple of 32 above 128, at most kWideMaxHidden) into out[12]: the
// forward saving the activations (kernels 4 and 3), the forward of kernel
// 2 and the chain, each as CTAs per SM, shared bytes per CTA, ring stages
// and consumer warpgroups.
int dexnerf_train_bf16_wide_occupancy(int hidden, int dx, int num_trunk, int dd, int skip_mask,
                                      int* out) {
  if (hidden % 32 != 0 || hidden <= 128 || hidden > kWideMaxHidden || dx < 1 || dx > kMaxDx ||
      num_trunk < 0 || num_trunk > 31) {
    return (int)cudaErrorInvalidValue;
  }
  TrainArgs a;
  a.hidden = hidden;
  a.dx = dx;
  a.num_trunk = num_trunk;
  a.skip_mask = skip_mask;
  a.dd = dd;
  const WidePlan f = wide_fwd_plan(a), c = wide_plan(wide_chain_cons_bytes(hidden));
  if (f.cons == 0 || c.cons == 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = wide_residency(train_fwd_wide_kernel<kLoss>, f, out);
  if (err == cudaSuccess) err = wide_residency(train_fwd_wide_kernel<kFieldFwd>, f, out + 4);
  if (err == cudaSuccess) err = wide_residency(train_chain_wide_kernel, c, out + 8);
  return (int)err;
}

// CTAs per SM of the dW kernel with `smem` bytes of shared memory.
int dexnerf_train_bf16_dw_occupancy(int smem, int* ctas) {
  cudaError_t err = set_smem(train_dw_bf16_kernel<false>, smem);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, train_dw_bf16_kernel<false>,
                                                        kDwThreads, smem);
  }
  return (int)err;
}

// The residency of the forward and chain kernels at width `hidden` (a
// multiple of 32) with a dx-wide xyz encoding, num_trunk trunk layers
// (skip_mask: those that read the encoding) and a dd-wide viewdir
// encoding, into out[10]: the forward saving the activations (kernels 4
// and 3) and the forward of kernel 2, each as CTAs per SM, shared bytes per
// CTA, weight ring stages and staging tiles per consumer; then the chain's
// CTAs per SM and shared bytes.
int dexnerf_train_bf16_occupancy(int hidden, int dx, int num_trunk, int dd, int skip_mask,
                                 int* out) {
  if (hidden % 32 != 0 || hidden < 32 || hidden > 128 || dx < 1 || dx > kMaxDx ||
      num_trunk < 0 || num_trunk > 31) {
    return (int)cudaErrorInvalidValue;
  }
  TrainArgs a;
  a.hidden = hidden;
  a.dx = dx;
  a.num_trunk = num_trunk;
  a.skip_mask = skip_mask;
  a.dd = dd;
  switch (hidden / 32) {
    case 1: return occupancy<2>(a, out);
    case 2: return occupancy<4>(a, out);
    case 3: return occupancy<6>(a, out);
    default: return occupancy<8>(a, out);
  }
}

}  // extern "C"
