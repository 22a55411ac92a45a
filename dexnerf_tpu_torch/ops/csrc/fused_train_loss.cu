// Fused NeRF training loss pass at compute_dtype = dw_dtype = float32 on the
// tensor cores of NVIDIA Hopper (sm_90a): positional encoding ->
// FlexibleNeRF MLP -> sigma-noise -> alpha compositing -> per-ray squared
// error (+ optional depth term) -> compositing backward -> MLP backward ->
// dW/db summed over every ray of the batch.
//
// Replaces dexnerf_tpu/ops/fused_train_loss.py::_make_loss_kernel (the
// Pallas kernel of make_fused_pass_loss) at float32. Same contract: per-ray
// origins, directions, viewdirs, [N, S] z, dists and sigma-noise, targets,
// optional per-ray depth_gt/depth_coef in; the UNNORMALIZED loss sum, the
// weights [N, S], the composited rgb [N, 3] and the gradient of the loss
// sum with respect to every model parameter out (nothing flows to the
// inputs). Compositing and its backward are the plain guarded cumprod (1 -
// alpha + 1e-10), differentiated exactly: -suffix / (1 - alpha + 1e-10).
//
// What bounds it on the H100: the multiply-adds. The 8x128 FlexibleNeRF
// costs ~156k per sample forward, ~140k to carry the cotangent back through
// the layers and ~156k for the weight gradients: 1.42 TFLOP a train step at
// batch 8192 with 64 + 128 samples per ray, 21.2 ms at the 67 TFLOP/s f32
// FMA peak of an H100 SXM (700 W), 8.6 ms as three TF32 products each
// (split TF32, below) at the 495 TFLOP/s dense TF32 peak. Next the scratch:
// every activation (5,116 B a sample) and cotangent (4,880 B) written once
// and read once by the weight gradients, ~2.4 ms each way a step at 3.35
// TB/s. Measured times and their split: PERF.md.
//
// Design, per chunk of rays (the scratch is capped by
// ops/fused_train_loss.py's SCRATCH_SAMPLES), on the scratch's columns (ray
// r's sample s at column r s_pad + s, s_pad a multiple of 64, so a 64-column
// tile lies in one ray), every product in split TF32 on wgmma m64nNk8.tf32
// (mlp_tile_tf32.cuh, kernel 1's f32 tile: each f32 operand as hi = tf32(x)
// and lo = tf32(x - hi), lo.hi + hi.lo + hi.hi, each K-chunk of 32 into a
// fresh accumulator added to the layer's sum in f32):
// * train_prep_tf32_kernel: per ray, one warp, the viewdir encoding (f32,
//   the accurate sincosf) into dir_enc and the viewdir layer's per-ray bias
//   into dirb.
// * train_fwd_tf32_kernel: kernel 1's f32 tile without compositing, on
//   persistent CTAs (one per SM) of two consumer warpgroups at 232
//   registers, each taking 64-column tiles v, v + 2 G, ... through the whole
//   MLP, and a warpgroup whose first thread streams the pre-split pack
//   (ops/fused_render.py::pack_flex_weights_tf32) through an mbarrier ring
//   of bulk copies, all but layer1: layer1 (K = the encoding, 5% of the
//   products) runs on the CUDA cores as a sequential f32 FMA chain over the
//   features, as the plain version's GEMM sums it, because the gradients
//   of the lower trunk follow its rounding more closely than any other
//   layer's (the fine pass's layers_xyz.0 leaf moves by 2.7e-4 of its
//   largest entry with layer1 in split TF32, by 1.7e-5 with every other
//   layer so: PERF.md). Every layer's f32 activation goes straight from the
//   accumulator registers to the scratch with streaming stores (8 lanes hold
//   8 consecutive columns of one feature: whole 32 B sectors), and the ReLU
//   masks of a_1..a_nt, feat and y as bits in the accumulator's own thread
//   order ("mask words": word w of layer l of tile t at [t][l][w][thread]),
//   read back by the same thread of the chain with no shuffles. The raw
//   outputs go to an f32 [columns][4] buffer.
// * train_composite_tf32_kernel: compositing, the loss and its backward,
//   one warp per ray (train_composite.cuh, shared with the bf16 route):
//   weights, rgb, the per-ray loss, and the raw cotangents (0 on padding
//   columns).
// * train_chain_tf32_kernel: the forward tile run backwards, persistent CTAs
//   as the forward's, each consumer taking whole rays (its tiles in order).
//   A is the layer's cotangent (hi in registers, lo in the consumer's
//   area); B a split pack of the transposed matrices
//   (ops/fused_train_loss.py::pack_backward_weights_tf32: layers_dir.0's
//   feat rows, fc_feat, then layers_xyz from the last). The rgb head's step
//   (3 wide) and the sigma head's term are f32 on the CUDA cores; each
//   epilogue masks by the forward's bits and stores the cotangent to the
//   scratch from registers. dy_sum: the viewdir layer's cotangent summed
//   per ray, over each tile's columns and then the ray's tiles in order.
// * the weight gradients: the split-TF32 launch of dw_tf32.cu over the
//   scratch (ops/_weight_grads.py), with its fixed-order reduction;
//   sum_rays_kernel sums the per-ray losses in a fixed order. No atomics:
//   runs are bitwise repeatable.
// The kernels take a launcher tag (kOwner) so that a profile names them.
// Hidden widths that are not a multiple of 32 run zero-padded to one (the
// tile's widths); the scratch, the masks and dy_sum keep the model's own.
// Padded widths above 128 (up to kWtMaxHidden) take the wide route, chosen
// by the launchers from the width alone: train_fwd_wide_tf32_kernel and
// train_chain_wide_tf32_kernel on mlp_wide_tf32.cuh's tile, with the same
// prep, compositing, scratch, mask words and dW (its plan split to its
// limits, in parts: ops/_weight_grads.py).
//
// The same kernels are the f32 routes of the field kernels
// (dexnerf_field_tf32_pass), which replace
// dexnerf_tpu/ops/fused_mlp.py::_make_fwd_kernel and
// dexnerf_tpu/ops/fused_mlp_train.py::_make_bwd_kernel at float32: they
// read the sample points from pts [N, S, 3] (padding samples at the
// origin) instead of o + d z, and run no compositing.
// * Kernel 2, the field forward (owner 2): prep and forward over every ray
//   in one launch pair, raw straight to its [N, S, 4] output, nothing to the
//   scratch (no activations, encodings or mask words: kSave is false).
// * Kernel 3, the field backward (owner 3), per chunk of rays: prep, the
//   forward with kernel 4's scratch stores, then the chain on the caller's
//   cotangent g [N, S, 4] (zero on padding columns) in place of the
//   compositing's; then kernel 4's dW launch and reduction.
// Layer1 is the same sequential f32 FMA chain in all three, so the raw of
// kernel 2 and the activations that kernel 3 recomputes are one arithmetic,
// bit for bit. Neither needs kernel 4's cap on the samples (its compositing
// keeps 7 S floats a warp in shared memory): the forward and the chain take
// any S, tile by tile of a ray.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mlp_wide_tf32.cuh"
#include "train_composite.cuh"
#include "train_rows.cuh"

namespace {

constexpr int kMaxLayers = 40;
constexpr int kMaxFreq = 16;
constexpr int kMaxSamplesPad = 256;  // kernel 4: its compositing keeps 7 S floats a warp
constexpr int kMaxDD = 3 + 6 * kMaxFreq;
constexpr int kAux = kMaxLayers + 8;
constexpr int kRayWarps = 4;   // composite: rays per CTA, one warp each
constexpr int kPrepWarps = 8;  // prep: rays per CTA
constexpr int kSumThreads = 1024;
// who launches the pass kernels (a template argument, so that a profile
// tells them apart): the fused train loss (kernel 4), the field forward
// (kernel 2) and the field backward (kernel 3)
constexpr int kLoss = 4, kFieldFwd = 2, kFieldBwd = 3;

// Mirrored field by field by ops/fused_train_loss.py::_TrainArgs.
struct TrainArgs {
  const float* origins;     // [N, 3]
  const float* dirs;        // [N, 3]
  const float* viewdirs;    // [N, 3]
  const float* pts;         // [N, S, 3] sample points (the field kernels) or null
  const float* z;           // [N, S]
  const float* dists;       // [N, S]
  const float* noise;       // [N, S] or null
  const float* target;      // [N, 3]
  const float* depth_gt;    // [N] or null
  const float* depth_coef;  // [N] or null
  const uint32_t* wq;       // forward hi/lo K-chunks: fused_render.py::pack_flex_weights_tf32
  const float* aux;         // its f32 biases, heads and viewdir rows
  const uint32_t* wbq;      // chain hi/lo K-chunks: pack_backward_weights_tf32
  const float* w1;          // layer1's weights [dx][Hp] f32: pack_layer1_f32
  float* weights_out;       // [N, S]
  float* rgb_out;           // [N, 3]
  float* loss_ray;          // [N]
  float* act;               // [act rows][k] saved activations (Rows)
  float* dlt;               // [delta rows][k] layer cotangents
  float* dir_enc;           // [dd][n_rays] per-ray viewdir encodings
  float* dy_sum;            // [H/2][n_rays] per-ray sums of the viewdir-layer delta
  float* dirb;              // [n_rays][Hp/2] per-ray viewdir-layer bias
  float* raw;               // [k][4] rgb logits, sigma logit; kernel 2: [N, S, 4]
  float* graw;              // [k][4] their cotangents; kernel 3: the caller's g [N, S, 4]
  uint32_t* masks;          // [k / 64][tile_words][128] ReLU mask words
  float* wbuf;              // kernel 2's wide route: [hp][64] a worker (layer outputs)
  long long k;              // scratch columns: n_rays * s_pad
  int ray0, n_rays, n_samples, s_pad;
  int hidden, hp, num_trunk, skip_mask;  // the model's width, the padded one
  int fx, fd, inc_x, inc_d, dx, kx, dd;
  int white_bg, luma, has_noise, has_depth;
  int sms, fwd_stages, chain_stages;
  int parts;  // the kernels to launch: bits 1 prep, 2 forward, 4 compositing, 8 chain
  int aux_off[kAux];
  float bands_x[kMaxFreq];
  float bands_d[kMaxFreq];
};

// Mask words of a thread for one layer of width H (padded): its H / 2
// values' bits, bit 4 j + e for accumulator entry 4 j + e; and per tile the
// words of a_1..a_nt and feat, then y's (H / 2 wide: one word up to 128).
__host__ __device__ inline int mask_words(int H) { return (H + 63) / 64; }
__host__ __device__ inline int tile_words(int H, int nt) {
  return (nt + 1) * mask_words(H) + mask_words(H / 2);
}

// ---- per ray: viewdir encoding (f32) and the viewdir layer's per-ray bias
// b + sum_k enc[k] W_dir[H + k] (f32 FMA from 0, then the bias), one warp
// per ray
template <int kOwner>
__global__ void __launch_bounds__(kPrepWarps * 32) train_prep_tf32_kernel(const TrainArgs p) {
  __shared__ float dtmp[kPrepWarps][kMaxDD];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = blockIdx.x * kPrepWarps + warp;
  if (r >= p.n_rays) return;
  const long long ray = (long long)p.ray0 + r;
  const int H2 = p.hp / 2, nt = p.num_trunk, dd = p.dd;
  float* e = dtmp[warp];
  if (lane < 3) {
    const float vv = p.viewdirs[ray * 3 + lane];
    int row = 0;
    if (p.inc_d) {
      e[lane] = vv;
      row = 3;
    }
    for (int f = 0; f < p.fd; ++f) {
      float sn, cs;
      sincosf(__fmul_rn(vv, p.bands_d[f]), &sn, &cs);
      e[row + 6 * f + lane] = sn;
      e[row + 6 * f + 3 + lane] = cs;
    }
  }
  __syncwarp();
  if (kOwner != kFieldFwd) {  // the viewdir weights' dW reads it
    for (int k = lane; k < dd; k += 32) p.dir_enc[(size_t)k * p.n_rays + r] = e[k];
  }
  const float* wdv = p.aux + p.aux_off[nt + 7];
  const float* bdir = p.aux + p.aux_off[nt + 2];
  for (int c = lane; c < H2; c += 32) {
    float v = 0.f;
    for (int k = 0; k < dd; ++k) v = fmaf(e[k], __ldg(wdv + k * H2 + c), v);
    p.dirb[(size_t)r * H2 + c] = __ldg(bdir + c) + v;
  }
}

// ---- the forward
// Shared memory from the 1024-aligned base: the weight ring of ns stages,
// each consumer's area, the biases and heads, each consumer's sigma [64]
// and rgb [64][3] logits, the ring's barriers.
struct FwdSmem {
  size_t ring, area, area_bytes, aux, own, bars, total;
};
constexpr size_t kOwnBytes = kTile * 4 * 4;

__host__ __device__ inline FwdSmem fwd_smem(int H, int nt, int kx, int ns) {
  FwdSmem s;
  s.ring = 0;
  s.area = (size_t)ns * H * 128;
  s.area_bytes = area_bytes(H, kx);
  s.aux = s.area + kCons * s.area_bytes;
  s.own = s.aux + align16((size_t)aux_head_max(H, nt) * 4);
  s.bars = s.own + kCons * kOwnBytes;
  s.total = s.bars + 2 * (size_t)ns * 8 + 1024;  // + slack to align the base
  return s;
}

// The f32 activation of one 8-column block (split_frag's v0..v3) to the
// scratch rows at dst (row0's column of feature 0; features < hm) with
// streaming stores (kStore), its ReLU bits (entries 4 j .. 4 j + 3) into m.
template <int MW, bool kStore, bool kMask>
__device__ __forceinline__ void save_block(float* dst, long long k, int hm, int j, int q,
                                           float v0, float v1, float v2, float v3,
                                           uint32_t (&m)[MW]) {
  const int col = 8 * j + 2 * q;
  if (kStore && col < hm) {
    float* d0 = dst + (long long)col * k;
    __stcs(d0, v0);
    __stcs(d0 + k, v1);
    __stcs(d0 + 8, v2);
    __stcs(d0 + k + 8, v3);
  }
  if (kMask) {
    const int b = (4 * j) & 31;
    m[(4 * j) >> 5] |= (v0 > 0.f ? 1u : 0u) << b | (v1 > 0.f ? 2u : 0u) << b |
                       (v2 > 0.f ? 4u : 0u) << b | (v3 > 0.f ? 8u : 0u) << b;
  }
}

// n_tiles 64-column tiles of the chunk; worker kCons b + cw takes tiles
// kCons b + cw, + kCons G, ... Kernel 2 (kOwner kFieldFwd) saves nothing
// and writes raw to its [N, S, 4] output.
template <int kOwner, int NTM>
__global__ void __launch_bounds__(kThreads, 1)
    train_fwd_tf32_kernel(const __grid_constant__ TrainArgs p, int n_tiles) {
  constexpr bool kSave = kOwner != kFieldFwd;  // activations, encodings, mask words
  constexpr int H = NTM * 16;
  constexpr int H2 = H / 2;
  constexpr int KCH = H / kKc;  // K-chunks of a product on H
  constexpr int SB = H * 128;   // bytes of a ring stage
  constexpr int MW = (H + 63) / 64;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sbase = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the swizzle's atoms
  unsigned char* gbase = smem_raw + (sbase - smem_u32(smem_raw));
  const int nt = p.num_trunk, kx = p.kx, NS = p.fwd_stages;
  const FwdSmem L = fwd_smem(H, nt, kx, NS);
  const uint32_t ring = sbase + (uint32_t)L.ring;
  const uint32_t full = sbase + (uint32_t)L.bars, empty = full + 8 * NS;
  int nskip = 0;
  for (int i = 0; i < nt; ++i) nskip += (p.skip_mask >> i) & 1;
  // stages of a pass over the weights, a hi and a lo stage per K-chunk: the
  // pack's, but layer1's (the first 2 kx), which runs on the CUDA cores
  const int nch = 2 * (kx * nskip + (nt + 2) * KCH);
  const int G = gridDim.x, b = blockIdx.x;
  auto tiles_of = [&](int w) { return w < n_tiles ? (n_tiles - 1 - w) / (kCons * G) + 1 : 0; };
  const int passes = tiles_of(kCons * b);  // worker kCons b has the CTA's most
  const int tid = threadIdx.x, cw = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int n_aux = p.aux_off[nt + 7];  // the biases and heads: to shared memory
  float* aux = reinterpret_cast<float*>(gbase + L.aux);
  for (int i = tid; i < n_aux; i += kThreads) aux[i] = __ldg(p.aux + i);
  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * kCons);  // every consumer warp releases a stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the areas start zero, so that no padding position ever holds a NaN
  for (int i = tid; i < kCons * (int)L.area_bytes / 16; i += kThreads) {
    reinterpret_cast<uint4*>(gbase + L.area)[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  fence_async_smem();
  __syncthreads();

  const int t = tid & 127, warp = t >> 5, lane = t & 31, g = lane >> 2, q = lane & 3;
  if (cw == kCons) {  // ---- the weight stream, one thread
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (t != 0) return;
    stream_weights_tf32(reinterpret_cast<const unsigned char*>(p.wq) + (size_t)2 * kx * SB,
                        passes, nch, nch - 2 * KCH, SB, NS, ring, full, empty);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int bar = 1 + cw, v = kCons * b + cw;
  const uint32_t area = sbase + (uint32_t)(L.area + cw * L.area_bytes);
  const uint32_t enc_hi = area, enc_lo = area + kx * kChunk;  // the encoding's halves
  // layer1's f32 encoding, [dx][64 rows], in the area before layer1's epilogue
  float* encf = reinterpret_cast<float*>(gbase + L.area + cw * L.area_bytes);
  float* sig = reinterpret_cast<float*>(gbase + L.own + cw * kOwnBytes);  // [64]
  float* rgbr = sig + kTile;                                              // [64][3]
  const float* w_alpha = aux + p.aux_off[nt + 3];
  const float b_alpha = aux[p.aux_off[nt + 4]];
  const float* w_rgb = aux + p.aux_off[nt + 5];
  const float* b_rgb = aux + p.aux_off[nt + 6];
  const int S = p.n_samples, SP = p.s_pad, hm = p.hidden, dxp = kx * kKc;
  const long long K = p.k;
  const Rows R{K, p.dx, hm, nt};
  const int TW = tile_words(H, nt), row0 = 16 * warp + g;
  Tf32Ring wr{ring, full, empty, NS, SB, lane};

  const int mine = tiles_of(v);
  for (int it = 0; it < mine; ++it) {
    const int tile = v + kCons * G * it;
    const long long col0 = (long long)tile * kTile;
    const int rl = (int)(col0 / SP), s0 = (int)(col0 - (long long)rl * SP);
    const long long ray = (long long)p.ray0 + rl;
    uint32_t* mk = p.masks + (size_t)tile * TW * 128 + t;
    float* acol = p.act + col0 + row0;  // this thread's first column, feature 0

    // the xyz encoding of the tile by the two lanes of each row of the
    // warp's own 16 rows (a warp's wgmma reads only its own rows of A), the
    // argument rounded as written and the accurate sincosf. The point is o +
    // d z (kernel 4) or read from pts (the field kernels); padding samples
    // (s >= S) take z = 0 or the origin: finite points. For layer1 (first):
    // f32 into encf and the scratch's e rows; for a skip layer: split into
    // the area.
    auto encode_tile = [&](bool first) {
      const int i = 16 * warp + (lane & 15), half = lane >> 4, s = s0 + i;
      const float zz = kOwner == kLoss && s < S ? p.z[ray * S + s] : 0.f;
      float* ecol = p.act + R.e() + col0 + i;
      for (int d = 0; d < 3; ++d) {
        const float pt =
            kOwner == kLoss ? __fadd_rn(p.origins[ray * 3 + d], __fmul_rn(p.dirs[ray * 3 + d], zz))
            : s < S         ? p.pts[(ray * S + s) * 3 + d]
                            : 0.f;
        if (first) {
          const int cx = p.inc_x ? 3 : 0;
          auto put = [&](int f, float val) {
            encf[f * kTile + i] = val;
            if (kSave) __stcs(ecol + (long long)f * K, val);
          };
          if (p.inc_x && half == 0) put(d, pt);
          for (int f = half; f < p.fx; f += 2) {
            float sn, cs;
            sincosf(__fmul_rn(pt, p.bands_x[f]), &sn, &cs);
            put(cx + 6 * f + d, sn);
            put(cx + 6 * f + 3 + d, cs);
          }
        } else {
          encode_coord_tf32(enc_hi, enc_lo, i, d, pt, half, p.fx, p.inc_x,
                            [&](int f) { return p.bands_x[f]; });
        }
      }
      if (first) {
        __syncwarp();
        return;
      }
      for (int f = p.dx + half; f < dxp; f += 2) store_split(enc_hi, enc_lo, i, f, 0.f);
      fence_async_smem();
      wg_sync(bar);
    };

    encode_tile(true);
    float* sig_rows = sig + 16 * warp;
    float acc[H / 2];  // the layer's sum
    uint32_t a[H / 2];
    // ---- layer1 on the CUDA cores: each output a sequential f32 FMA chain
    // over the encoding in feature order, then the bias (in the epilogue),
    // as the plain version's GEMM sums it: the fine pass's gradients follow
    // this product's rounding more closely than any other's (PERF.md); its
    // output a_0 saved, no mask
#pragma unroll
    for (int e = 0; e < H / 2; ++e) acc[e] = 0.f;
    for (int k = 0; k < p.dx; ++k) {
      const float x0 = encf[k * kTile + row0], x1 = encf[k * kTile + row0 + 8];
      const float* wk = p.w1 + k * H + 2 * q;
#pragma unroll
      for (int j = 0; j < H / 8; ++j) {
        const float2 w = __ldg(reinterpret_cast<const float2*>(wk + 8 * j));
        acc[4 * j] = fmaf(x0, w.x, acc[4 * j]);
        acc[4 * j + 1] = fmaf(x0, w.y, acc[4 * j + 1]);
        acc[4 * j + 2] = fmaf(x1, w.x, acc[4 * j + 2]);
        acc[4 * j + 3] = fmaf(x1, w.y, acc[4 * j + 3]);
      }
    }
    wg_sync(bar);  // every warp is done with encf before the epilogue writes the area
    {
      uint32_t m[MW];
      auto sink = [&](int j, float v0, float v1, float v2, float v3) {
        save_block<MW, kSave, false>(acol + R.a(0), K, hm, j, q, v0, v1, v2, v3, m);
      };
      if (nt > 0) {
        hidden_epilogue_tf32<H, false, false>(acc, aux + p.aux_off[0], a, area, w_alpha,
                                              b_alpha, sig_rows, sink);
      } else {
        hidden_epilogue_tf32<H, false, true>(acc, aux + p.aux_off[0], a, area, w_alpha,
                                             b_alpha, sig_rows, sink);
      }
    }
    fence_async_smem();
    wg_sync(bar);
    // ---- trunk, then fc_feat (layer nt + 1): a_1..a_nt, feat saved, masks
    for (int i = 0; i <= nt; ++i) {
      act_product<H, H>(acc, a, area, wr);
      if (i < nt && ((p.skip_mask >> i) & 1)) {  // the encoding again, into the area
        encode_tile(false);
        enc_product<H>(acc, enc_hi, enc_lo, kx, wr, false);
      }
      const float* bias = aux + p.aux_off[1 + i];
      uint32_t m[MW];
#pragma unroll
      for (int w = 0; w < MW; ++w) m[w] = 0u;
      float* dst = acol + (i < nt ? R.a(i + 1) : R.feat());
      auto sink = [&](int j, float v0, float v1, float v2, float v3) {
        save_block<MW, kSave, kSave>(dst, K, hm, j, q, v0, v1, v2, v3, m);
      };
      if (i == nt - 1) {
        hidden_epilogue_tf32<H, true, true>(acc, bias, a, area, w_alpha, b_alpha, sig_rows, sink);
      } else {
        hidden_epilogue_tf32<H, true, false>(acc, bias, a, area, w_alpha, b_alpha, sig_rows,
                                             sink);
      }
      if (kSave) {
#pragma unroll
        for (int w = 0; w < MW; ++w) __stcs(mk + (i * MW + w) * 128, m[w]);
      }
      fence_async_smem();
      wg_sync(bar);
    }
    // ---- layers_dir.0 on feat, + the ray's bias: y saved, its mask; the rgb head
    float ad[H2 / 2];
    act_product<H2, H>(ad, a, area, wr);
    {
      const float* db = p.dirb + (size_t)rl * H2;
      float* ydst = acol + R.y();
      float c[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
      uint32_t ym = 0u;
#pragma unroll
      for (int j = 0; j < H2 / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + 2 * q + e;
          const float* wrg = w_rgb + col * 3;
          const float dbc = __ldg(db + col);
          const float y0 = fmaxf(ad[4 * j + e] + dbc, 0.f);
          const float y1 = fmaxf(ad[4 * j + 2 + e] + dbc, 0.f);
#pragma unroll
          for (int kk = 0; kk < 3; ++kk) {
            c[0][kk] = fmaf(y0, wrg[kk], c[0][kk]);
            c[1][kk] = fmaf(y1, wrg[kk], c[1][kk]);
          }
          if (kSave && col < hm / 2) {
            __stcs(ydst + (long long)col * K, y0);
            __stcs(ydst + (long long)col * K + 8, y1);
          }
          ym |= (y0 > 0.f ? 1u : 0u) << (4 * j + e) | (y1 > 0.f ? 1u : 0u) << (4 * j + 2 + e);
        }
      }
      if (kSave) __stcs(mk + (nt + 1) * MW * 128, ym);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int x = 1; x < 4; x <<= 1) {
#pragma unroll
          for (int kk = 0; kk < 3; ++kk) c[h][kk] += __shfl_xor_sync(0xffffffffu, c[h][kk], x);
        }
        if (q == 0) {
#pragma unroll
          for (int kk = 0; kk < 3; ++kk) rgbr[(row0 + 8 * h) * 3 + kk] = c[h][kk] + b_rgb[kk];
        }
      }
    }
    wg_sync(bar);  // every row's sigma and rgb logits are written
    if (t < kTile) {
      const float4 out = make_float4(rgbr[3 * t], rgbr[3 * t + 1], rgbr[3 * t + 2], sig[t]);
      if (kOwner != kFieldFwd) {
        reinterpret_cast<float4*>(p.raw)[col0 + t] = out;
      } else if (s0 + t < S) {
        reinterpret_cast<float4*>(p.raw)[ray * S + s0 + t] = out;
      }
    }
  }
  // worker kCons b has more tiles: release the stages of its other passes
  for (int c = mine * nch; c < passes * nch; ++c) {
    wr.take();
    wr.release();
  }
}

// ---- compositing, loss and compositing backward (train_composite.cuh)
__global__ void __launch_bounds__(kRayWarps * 32) train_composite_tf32_kernel(const TrainArgs p) {
  extern __shared__ float csm[];
  const int warp = threadIdx.x >> 5;
  const int r = blockIdx.x * kRayWarps + warp;
  if (r >= p.n_rays) return;
  composite_ray(p, r, p.s_pad, csm + (size_t)warp * 7 * p.n_samples);
}

// ---- the cotangent chain
// Shared memory from the 1024-aligned base: the weight ring of ns stages,
// each consumer's area (the lo half of an H-wide cotangent), the biases and
// heads, each consumer's column sums [4 warps][H/2], the ring's barriers.
struct ChainSmem {
  size_t ring, area, area_bytes, aux, colsum, bars, total;
};

__host__ __device__ inline ChainSmem chain_smem(int H, int nt, int ns) {
  ChainSmem s;
  s.ring = 0;
  s.area = (size_t)ns * H * 128;
  s.area_bytes = (size_t)(H / kKc) * kChunk;
  s.aux = s.area + kCons * s.area_bytes;
  s.colsum = s.aux + align16((size_t)aux_head_max(H, nt) * 4);
  s.bars = s.colsum + kCons * 4 * (size_t)(H / 2) * 4;
  s.total = s.bars + 2 * (size_t)ns * 8 + 1024;  // + slack to align the base
  return s;
}

// The epilogue of a chain product on an [64 x H] accumulator: (+ the sigma
// head's term gs w_alpha, f32 FMA), masked by the forward's bits m (when
// masked), stored to the scratch rows at dst (row0's column of feature 0;
// features < hm) and, with kSplit, split into the next product's A (a, the
// area at lo_t).
template <int H, int MW, bool kSplit, bool kHead>
__device__ __forceinline__ void chain_epilogue(const float (&acc)[H / 2], uint32_t (&a)[H / 2],
                                               uint32_t lo_t, const uint32_t (&m)[MW],
                                               bool masked, float gs0, float gs1,
                                               const float* wa, float* dst, long long k,
                                               int hm) {
  const int t = threadIdx.x & 127, lane = t & 31, g = lane >> 2, q = lane & 3;
  const int row0 = 16 * (t >> 5) + g;
#pragma unroll
  for (int j = 0; j < H / 8; ++j) {
    const int col = 8 * j + 2 * q;
    float v0 = acc[4 * j], v1 = acc[4 * j + 1], v2 = acc[4 * j + 2], v3 = acc[4 * j + 3];
    if (kHead) {
      const float2 w = *reinterpret_cast<const float2*>(wa + col);
      v0 = fmaf(gs0, w.x, v0);
      v1 = fmaf(gs0, w.y, v1);
      v2 = fmaf(gs1, w.x, v2);
      v3 = fmaf(gs1, w.y, v3);
    }
    if (masked) {
      const uint32_t bits = m[(4 * j) >> 5] >> ((4 * j) & 31);
      v0 = bits & 1u ? v0 : 0.f;
      v1 = bits & 2u ? v1 : 0.f;
      v2 = bits & 4u ? v2 : 0.f;
      v3 = bits & 8u ? v3 : 0.f;
    }
    if (col < hm) {
      float* d0 = dst + (long long)col * k;
      __stcs(d0, v0);
      __stcs(d0 + k, v1);
      __stcs(d0 + 8, v2);
      __stcs(d0 + k + 8, v3);
    }
    if (kSplit) split_frag<H>(j, v0, v1, v2, v3, a, lo_t, row0, q);
  }
}

// Worker kCons b + cw takes the chunk's rays kCons b + cw, + kCons G, ...,
// each ray's s_pad / 64 tiles in order. Per tile: the raw cotangents (the
// compositing's, or kernel 3's caller's g) to the scratch; the y cotangent
// (g_rgb W_rgb^T, f32, masked by y > 0) and its column sums; then product 0 (layers_dir.0's feat rows, K = H/2 padded to
// a K-chunk) -> d_feat masked by feat, product 1 (fc_feat, + gs w_alpha)
// -> d_nt masked by a_nt, products 2.. (layers_xyz from the last) -> d_i
// masked by a_i (d_0, layer1's output cotangent, unmasked).
template <int kOwner, int NTM>
__global__ void __launch_bounds__(kThreads, 1)
    train_chain_tf32_kernel(const __grid_constant__ TrainArgs p) {
  constexpr int H = NTM * 16;
  constexpr int H2 = H / 2;
  constexpr int KCH = H / kKc;
  constexpr int KD = (H2 + kKc - 1) / kKc * kKc;  // K of product 0
  constexpr int SB = H * 128;
  constexpr int MW = (H + 63) / 64;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sbase = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (sbase - smem_u32(smem_raw));
  const int nt = p.num_trunk, NS = p.chain_stages, SP = p.s_pad, TPR = SP / kTile;
  const ChainSmem L = chain_smem(H, nt, NS);
  const uint32_t ring = sbase + (uint32_t)L.ring;
  const uint32_t full = sbase + (uint32_t)L.bars, empty = full + 8 * NS;
  const int nch = 2 * (KD / kKc + (nt + 1) * KCH);
  const int G = gridDim.x, b = blockIdx.x, n_rays = p.n_rays;
  auto rays_of = [&](int w) { return w < n_rays ? (n_rays - 1 - w) / (kCons * G) + 1 : 0; };
  const int passes = TPR * rays_of(kCons * b);
  const int tid = threadIdx.x, cw = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int n_aux = p.aux_off[nt + 7];
  float* aux = reinterpret_cast<float*>(gbase + L.aux);
  for (int i = tid; i < n_aux; i += kThreads) aux[i] = __ldg(p.aux + i);
  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * kCons);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < kCons * (int)L.area_bytes / 16; i += kThreads) {
    reinterpret_cast<uint4*>(gbase + L.area)[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  fence_async_smem();
  __syncthreads();

  const int t = tid & 127, warp = t >> 5, lane = t & 31, g = lane >> 2, q = lane & 3;
  if (cw == kCons) {  // ---- the weight stream, one thread: every stage [H][32]
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (t != 0) return;
    stream_weights_tf32(reinterpret_cast<const unsigned char*>(p.wbq), passes, nch, nch, SB, NS,
                        ring, full, empty);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int bar = 1 + cw, v = kCons * b + cw;
  const uint32_t area = sbase + (uint32_t)(L.area + cw * L.area_bytes);
  float* colsum = reinterpret_cast<float*>(gbase + L.colsum) + cw * 4 * H2;
  const float* w_alpha = aux + p.aux_off[nt + 3];
  const float* w_rgb = aux + p.aux_off[nt + 5];
  const int hm = p.hidden, hm2 = hm / 2, S = p.n_samples;
  const long long K = p.k;
  const Rows R{K, p.dx, hm, nt};
  const int TW = tile_words(H, nt), row0 = 16 * warp + g;
  const float4* graw = reinterpret_cast<const float4*>(p.graw);
  Tf32Ring wr{ring, full, empty, NS, SB, lane};

  const int mine = rays_of(v);
  for (int it = 0; it < mine; ++it) {
    const int rl = v + kCons * G * it;
    const long long ray = (long long)p.ray0 + rl;
    float dys = 0.f;  // thread t < hm2: column t's sum over the ray
    for (int tt = 0; tt < TPR; ++tt) {
      const int tile = rl * TPR + tt;
      const long long col0 = (long long)tile * kTile;
      const uint32_t* mk = p.masks + (size_t)tile * TW * 128 + t;
      float* dcol = p.dlt + col0 + row0;
      // the cotangent of raw at column i of the tile: the compositing's
      // [k][4] (kernel 4), or the caller's g [N, S, 4] (kernel 3), 0 on
      // padding columns
      auto g_at = [&](int i) {
        if (kOwner == kLoss) return graw[col0 + i];
        const int s = tt * kTile + i;
        return s < S ? graw[ray * S + s] : make_float4(0.f, 0.f, 0.f, 0.f);
      };
      // ---- raw cotangents to the scratch: rgb rows, sigma row
      if (t < kTile) {
        const float4 gv = g_at(t);
        float* d = p.dlt + col0 + t;
        __stcs(d + R.drgb(0), gv.x);
        __stcs(d + R.drgb(1), gv.y);
        __stcs(d + R.drgb(2), gv.z);
        __stcs(d + R.dsig(), gv.w);
      }
      const float4 gr0 = g_at(row0), gr1 = g_at(row0 + 8);
      // ---- y cotangent, f32, in the accumulator layout; its column sums
      uint32_t a[H / 2];
      {
        const uint32_t ym = __ldcs(mk + (nt + 1) * MW * 128);
        uint32_t ad[KD / 2];
        float* ydst = dcol + R.dy();
#pragma unroll
        for (int j = 0; j < KD / 8; ++j) {
          float vv[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 8 * j + 2 * q + (e & 1);
            const float4 gg = e < 2 ? gr0 : gr1;
            float x = 0.f;
            if (j < H2 / 8) {
              const float* wrg = w_rgb + col * 3;
              x = fmaf(gg.z, wrg[2], fmaf(gg.y, wrg[1], gg.x * wrg[0]));
              x = (ym >> (4 * j + e)) & 1u ? x : 0.f;
            }
            vv[e] = x;
          }
          const int col = 8 * j + 2 * q;
          if (j < H2 / 8) {
            if (col < hm2) {
              __stcs(ydst + (long long)col * K, vv[0]);
              __stcs(ydst + (long long)(col + 1) * K, vv[1]);
              __stcs(ydst + (long long)col * K + 8, vv[2]);
              __stcs(ydst + (long long)(col + 1) * K + 8, vv[3]);
            }
            float s0 = vv[0] + vv[2], s1 = vv[1] + vv[3];
#pragma unroll
            for (int x = 4; x < 32; x <<= 1) {
              s0 += __shfl_xor_sync(0xffffffffu, s0, x);
              s1 += __shfl_xor_sync(0xffffffffu, s1, x);
            }
            if (g == 0) {
              colsum[warp * H2 + col] = s0;
              colsum[warp * H2 + col + 1] = s1;
            }
          }
          split_frag<KD>(j, vv[0], vv[1], vv[2], vv[3], ad, area, row0, q);
        }
        fence_async_smem();
        wg_sync(bar);
        if (t < hm2) {
          dys += (colsum[t] + colsum[H2 + t]) + (colsum[2 * H2 + t] + colsum[3 * H2 + t]);
        }
        // ---- product 0: d_feat = dy W_dir[:, :H], masked by feat
        uint32_t m[MW];
#pragma unroll
        for (int w = 0; w < MW; ++w) m[w] = __ldcs(mk + (nt * MW + w) * 128);
        float acc[H / 2];
        act_product<H, KD>(acc, ad, area, wr);
        chain_epilogue<H, MW, true, false>(acc, a, area, m, true, 0.f, 0.f, nullptr,
                                           dcol + R.dfeat(), K, hm);
      }
      fence_async_smem();
      wg_sync(bar);
      // ---- product 1: d_nt = d_feat W_feat + gs w_alpha, masked by a_nt
      {
        uint32_t m[MW];
#pragma unroll
        for (int w = 0; w < MW; ++w) m[w] = nt > 0 ? __ldcs(mk + ((nt - 1) * MW + w) * 128) : 0u;
        float acc[H / 2];
        act_product<H, H>(acc, a, area, wr);
        if (nt > 0) {
          chain_epilogue<H, MW, true, true>(acc, a, area, m, true, gr0.w, gr1.w, w_alpha,
                                            dcol + R.d(nt), K, hm);
        } else {
          chain_epilogue<H, MW, false, true>(acc, a, area, m, false, gr0.w, gr1.w, w_alpha,
                                             dcol + R.d(0), K, hm);
        }
      }
      fence_async_smem();
      wg_sync(bar);
      // ---- products 2..: d_i = d_{i+1} W_i[:, :H], masked by a_i (i > 0)
      for (int i = nt - 1; i >= 0; --i) {
        uint32_t m[MW];
#pragma unroll
        for (int w = 0; w < MW; ++w) m[w] = i > 0 ? __ldcs(mk + ((i - 1) * MW + w) * 128) : 0u;
        float acc[H / 2];
        act_product<H, H>(acc, a, area, wr);
        if (i > 0) {
          chain_epilogue<H, MW, true, false>(acc, a, area, m, true, 0.f, 0.f, nullptr,
                                             dcol + R.d(i), K, hm);
        } else {
          chain_epilogue<H, MW, false, false>(acc, a, area, m, false, 0.f, 0.f, nullptr,
                                              dcol + R.d(0), K, hm);
        }
        fence_async_smem();
        wg_sync(bar);
      }
    }
    if (t < hm2) p.dy_sum[(size_t)t * n_rays + rl] = dys;
  }
  // worker kCons b has more rays: release the stages of its other passes
  for (int c = mine * TPR * nch; c < passes * nch; ++c) {
    wr.take();
    wr.release();
  }
}

// ---- the wide route (padded widths above 128, mlp_wide_tf32.cuh): the
// forward of kernels 4, 2 and 3 by kOwner and the chain of kernels 4 and 3,
// with the narrow route's prep, compositing, scratch layout, mask words and
// dW. Persistent CTAs of C consumer warpgroups (wt_plan on their blocks: 2
// while two fit, else 1) and one warpgroup whose first thread streams the
// pack in pieces (WtStream).
//
// The forward: worker v = C b + cw takes the chunk's 64-column tiles v, v +
// C G, ...; per tile the encoding (f32) into the consumer's encoding tile
// and the scratch's e rows, then wt_forward: layer1 on the CUDA cores (the
// narrow forward's FMA chain), every other product split TF32, each layer's
// output stored to the scratch (kernel 2: to its worker's buffer) and read
// back as the next layer's input, the ReLU mask words as the narrow
// forward's; raw as the narrow forward's.
__host__ __device__ inline size_t wide_fwd_cons_bytes(int hp, int kx) {
  // the input tile, the encoding tile, sigma [64] and rgb [64][3]
  return align16(ft_bytes(hp) + ft_bytes(kx * kKc) + kTile * 4 * 4);
}

template <int kOwner>
__global__ void __launch_bounds__(kWtThreads, 1)
    train_fwd_wide_tf32_kernel(const __grid_constant__ TrainArgs p, int n_tiles) {
  constexpr bool kSave = kOwner != kFieldFwd;  // activations, encodings, mask words
  // layer1's features a load group: kernel 2's launch ran faster at one,
  // kernels 3-4's at two (PERF.md; perf_tools/train_wide_f32_variants.py:
  // layer1_u1)
  constexpr int kLayer1U = kOwner == kFieldFwd ? 1 : 2;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sbase = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (sbase - smem_u32(smem_raw));
  const int C = blockDim.x / 128 - 1;
  const int hp = p.hp, nt = p.num_trunk, kx = p.kx, NS = p.fwd_stages;
  const size_t cons_bytes = wide_fwd_cons_bytes(hp, kx);
  const int bmax = wt_plan(cons_bytes).bmax;
  const uint32_t ring = sbase, cons0 = sbase + (uint32_t)(NS * wt_stage_bytes(bmax));
  const uint32_t full = cons0 + (uint32_t)(C * cons_bytes), empty = full + 8 * NS;
  const int G = gridDim.x, b = blockIdx.x;
  auto tiles_of = [&](int w) { return w < n_tiles ? (n_tiles - 1 - w) / (C * G) + 1 : 0; };
  const int passes = tiles_of(C * b);  // worker C b has the CTA's most
  const int tid = threadIdx.x, cw = __shfl_sync(0xffffffffu, tid >> 7, 0);
  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * C);  // every consumer warp releases a stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the consumers' blocks start zero: the encoding tiles' features past dx stay so
  for (size_t i = tid; i < C * cons_bytes / 16; i += blockDim.x) {
    reinterpret_cast<uint4*>(gbase + (cons0 - sbase))[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  const int t = tid & 127, warp = t >> 5, lane = t & 31;
  if (cw == C) {  // ---- the weight stream, one thread: all but layer1's stages
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kWtProdRegs));
    if (t == 0) {
      WtStream st{reinterpret_cast<const unsigned char*>(p.wq), ring, full, empty, NS, bmax};
      st.forward(passes, hp, kx, nt, p.skip_mask, false);
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kWtConsRegs));
  const int v = C * b + cw, bar = 1 + cw;
  const uint32_t own = cons0 + (uint32_t)(cw * cons_bytes);
  const WtTile T{own, own + (uint32_t)ft_bytes(hp), p.aux, p.aux_off, p.w1,
                 hp, kx, p.dx, nt, p.skip_mask, bar};
  float* sig = reinterpret_cast<float*>(gbase + (own - sbase) + ft_bytes(hp) + ft_bytes(kx * kKc));
  float* rgbr = sig + kTile;  // [64][3]
  const int S = p.n_samples, SP = p.s_pad, hm = p.hidden;
  const long long K = p.k;
  const Rows R{K, p.dx, hm, nt};
  const int TW = tile_words(hp, nt);
  WtRing wr{ring, full, empty, NS, bmax, lane};
  const int mine = tiles_of(v);
  for (int it = 0; it < mine; ++it) {
    const int tile = v + C * G * it;
    const long long col0 = (long long)tile * kTile;
    const int rl = (int)(col0 / SP), s0 = (int)(col0 - (long long)rl * SP);
    const long long ray = (long long)p.ray0 + rl;
    // the xyz encoding of the tile (two lanes a row), as the narrow forward's
    // first: f32 into the encoding tile and the scratch's e rows; padding
    // samples (s >= S) take z = 0 or the origin
    {
      const int i = 16 * warp + (lane & 15), half = lane >> 4, s = s0 + i;
      const float zz = kOwner == kLoss && s < S ? p.z[ray * S + s] : 0.f;
      float* ecol = p.act + R.e() + col0 + i;
      for (int d = 0; d < 3; ++d) {
        const float pt =
            kOwner == kLoss ? __fadd_rn(p.origins[ray * 3 + d], __fmul_rn(p.dirs[ray * 3 + d], zz))
            : s < S         ? p.pts[(ray * S + s) * 3 + d]
                            : 0.f;
        wt_encode_coord(d, pt, half, p.fx, p.inc_x, p.bands_x, [&](int f, float x) {
          sts32(T.enc + ft_off(f, i), __float_as_uint(x));
          if (kSave) __stcs(ecol + (long long)f * K, x);
        });
      }
    }
    wg_sync(bar);  // the encoding is written
    const float* db = p.dirb + (size_t)rl * (hp / 2);
    if constexpr (kSave) {
      const WtOut O{p.act + R.a(0) + col0, K, (long long)hm * K, hm, p.act + R.y() + col0,
                    p.masks + (size_t)tile * TW * 128 + t, mask_words(hp)};
      wt_forward<kLayer1U>(T, wr, O, db, db, sig, rgbr);
    } else {
      const WtOut O{p.wbuf + (size_t)v * hp * kTile, kTile, 0, hp, nullptr, nullptr, 0};
      wt_forward<kLayer1U>(T, wr, O, db, db, sig, rgbr);
    }
    wg_sync(bar);  // every row's sigma and rgb logits are written
    if (t < kTile) {
      const float4 out = make_float4(rgbr[3 * t], rgbr[3 * t + 1], rgbr[3 * t + 2], sig[t]);
      if (kOwner != kFieldFwd) {
        reinterpret_cast<float4*>(p.raw)[col0 + t] = out;
      } else if (s0 + t < S) {
        reinterpret_cast<float4*>(p.raw)[ray * S + s0 + t] = out;
      }
    }
  }
  // worker C b has more tiles: release the stages of its other passes
  const int per_pass = wt_fwd_pieces(hp, kx, nt, p.skip_mask, bmax, false);
  for (int c = mine * per_pass; c < passes * per_pass; ++c) {
    wr.acquire();
    wr.release();
  }
}

// The wide chain: the narrow chain's work (worker v = C b + cw takes the
// chunk's rays v, v + C G, ..., each ray's tiles in order; per tile the raw
// cotangents to the scratch, the y cotangent (f32 FMA, masked) into the
// input tile and the scratch with its column sums, then the products on the
// transposed pack, each masked by the forward's words, stored to the scratch
// and read back as the next product's input), in column blocks of at most
// 128. dy_sum: the viewdir layer's cotangent summed per ray, over each
// tile's columns and then the ray's tiles in order, as the narrow chain.
__host__ __device__ inline size_t wide_chain_cons_bytes(int hp) {
  // the input tile, the column sums [4 warps][hp / 2], the ray's sums [hp / 2]
  return align16(ft_bytes(hp) + (size_t)5 * (hp / 2) * 4);
}
// The chain's pieces: 64 rows, so that twice as many stages fit as of 128
// (5 against 2 at 8x256) and a column block's sum is 32 registers a thread
// (PERF.md; perf_tools/train_wide_f32_variants.py: chain_pieces128).
constexpr int kChainPieceRows = 64;

template <int kOwner>
__global__ void __launch_bounds__(kWtThreads, 1)
    train_chain_wide_tf32_kernel(const __grid_constant__ TrainArgs p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sbase = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (sbase - smem_u32(smem_raw));
  const int C = blockDim.x / 128 - 1;
  const int hp = p.hp, h2 = hp / 2, nt = p.num_trunk, NS = p.chain_stages;
  const int SP = p.s_pad, TPR = SP / kTile, n_rays = p.n_rays;
  const int kd = (h2 + kKc - 1) / kKc * kKc, kch = hp / kKc;
  const size_t cons_bytes = wide_chain_cons_bytes(hp);
  const int bmax = wt_plan(cons_bytes, kChainPieceRows).bmax;
  const uint32_t ring = sbase, cons0 = sbase + (uint32_t)(NS * wt_stage_bytes(bmax));
  const uint32_t full = cons0 + (uint32_t)(C * cons_bytes), empty = full + 8 * NS;
  const int G = gridDim.x, b = blockIdx.x;
  auto rays_of = [&](int w) { return w < n_rays ? (n_rays - 1 - w) / (C * G) + 1 : 0; };
  const int passes = TPR * rays_of(C * b);
  const int tid = threadIdx.x, cw = __shfl_sync(0xffffffffu, tid >> 7, 0);
  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * C);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int t = tid & 127, warp = t >> 5, lane = t & 31, g = lane >> 2, q = lane & 3;
  if (cw == C) {  // ---- the weight stream, one thread
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kWtProdRegs));
    if (t == 0) {
      WtStream st{reinterpret_cast<const unsigned char*>(p.wbq), ring, full, empty, NS, bmax};
      st.chain(passes, hp, nt);
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kWtConsRegs));
  const int v = C * b + cw, bar = 1 + cw;
  const uint32_t in = cons0 + (uint32_t)(cw * cons_bytes);
  float* colsum = reinterpret_cast<float*>(gbase + (in - sbase) + ft_bytes(hp));  // [4][h2]
  float* dys = colsum + 4 * h2;  // [h2]: the ray's sums, column c by thread c % 128
  const float* w_alpha = p.aux + p.aux_off[nt + 3];
  const float* w_rgb = p.aux + p.aux_off[nt + 5];
  const int hm = p.hidden, hm2 = hm / 2, S = p.n_samples;
  const long long K = p.k;
  const Rows R{K, p.dx, hm, nt};
  const int TW = tile_words(hp, nt), MW = mask_words(hp), row0 = 16 * warp + g;
  const float4* graw = reinterpret_cast<const float4*>(p.graw);
  WtRing wr{ring, full, empty, NS, bmax, lane};
  const int mine = rays_of(v);
  for (int it = 0; it < mine; ++it) {
    const int rl = v + C * G * it;
    const long long ray = (long long)p.ray0 + rl;
    for (int c = t; c < h2; c += 128) dys[c] = 0.f;
    for (int tt = 0; tt < TPR; ++tt) {
      const int tile = rl * TPR + tt;
      const long long col0 = (long long)tile * kTile;
      const uint32_t* mk = p.masks + (size_t)tile * TW * 128 + t;
      // the cotangent of raw at column i of the tile: the compositing's
      // [k][4] (kernel 4), or the caller's g [N, S, 4] (kernel 3), 0 on
      // padding columns
      auto g_at = [&](int i) {
        if (kOwner == kLoss) return graw[col0 + i];
        const int s = tt * kTile + i;
        return s < S ? graw[ray * S + s] : make_float4(0.f, 0.f, 0.f, 0.f);
      };
      wg_sync(bar);  // every warp is done with the last tile's input tile
      // ---- raw cotangents to the scratch: rgb rows, sigma row
      if (t < kTile) {
        const float4 gv = g_at(t);
        float* d = p.dlt + col0 + t;
        __stcs(d + R.drgb(0), gv.x);
        __stcs(d + R.drgb(1), gv.y);
        __stcs(d + R.drgb(2), gv.z);
        __stcs(d + R.dsig(), gv.w);
      }
      const float4 gr0 = g_at(row0), gr1 = g_at(row0 + 8);
      // ---- y cotangent (g_rgb W_rgb^T, f32, masked by y > 0) into the input
      // tile (zero past h2: product 0's K is kd) and the scratch; its column
      // sums
      {
        float* ydst = p.dlt + R.dy() + col0 + row0;
        uint32_t ym = 0u;
        for (int j = 0; j < kd / 8; ++j) {
          if (((4 * j) & 31) == 0 && j < h2 / 8) ym = __ldcs(mk + ((nt + 1) * MW + (4 * j) / 32) * 128);
          const int col = 8 * j + 2 * q;
          float vv[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float4 gg = e < 2 ? gr0 : gr1;
            float x = 0.f;
            if (j < h2 / 8) {
              const float* wrg = w_rgb + (col + (e & 1)) * 3;
              x = fmaf(gg.z, __ldg(wrg + 2), fmaf(gg.y, __ldg(wrg + 1), gg.x * __ldg(wrg)));
              x = (ym >> ((4 * j + e) & 31)) & 1u ? x : 0.f;
            }
            vv[e] = x;
          }
          if (j < h2 / 8) {
            if (col < hm2) {
              __stcs(ydst + (long long)col * K, vv[0]);
              __stcs(ydst + (long long)(col + 1) * K, vv[1]);
              __stcs(ydst + (long long)col * K + 8, vv[2]);
              __stcs(ydst + (long long)(col + 1) * K + 8, vv[3]);
            }
            float s0 = vv[0] + vv[2], s1 = vv[1] + vv[3];
#pragma unroll
            for (int x = 4; x < 32; x <<= 1) {
              s0 += __shfl_xor_sync(0xffffffffu, s0, x);
              s1 += __shfl_xor_sync(0xffffffffu, s1, x);
            }
            if (g == 0) {
              colsum[warp * h2 + col] = s0;
              colsum[warp * h2 + col + 1] = s1;
            }
          }
          sts32(in + ft_off(col, row0), __float_as_uint(vv[0]));
          sts32(in + ft_off(col + 1, row0), __float_as_uint(vv[1]));
          sts32(in + ft_off(col, row0 + 8), __float_as_uint(vv[2]));
          sts32(in + ft_off(col + 1, row0 + 8), __float_as_uint(vv[3]));
        }
      }
      wg_sync(bar);
      for (int c = t; c < hm2; c += 128) {
        dys[c] += (colsum[c] + colsum[h2 + c]) + (colsum[2 * h2 + c] + colsum[3 * h2 + c]);
      }
      // ---- product pi: 0 d_feat = dy W_dir[:, :H] (masked by feat), 1 d_nt
      // = d_feat W_feat + gs w_alpha (masked by a_nt), then d_i = d_{i+1}
      // W_i[:, :H] (masked by a_i; d_0, layer1's output cotangent, unmasked):
      // the output d_li, li = nt + 1 - pi, masked by the words of layer li - 1
      for (int pi = 0; pi <= nt + 1; ++pi) {
        const int li = nt + 1 - pi;
        float* dst = p.dlt + R.d(li) + col0;
        for (int c0 = 0; c0 < hp; c0 += column_block(hp, c0, bmax)) {
          with_bn(column_block(hp, c0, bmax), [&](auto bn) {
            constexpr int BN = decltype(bn)::value;
            uint32_t m[2] = {0u, 0u};
            if (li > 0) {
#pragma unroll
              for (int w = 0; w < (BN + 63) / 64; ++w) {
                m[w] = __ldcs(mk + ((li - 1) * MW + c0 / 64 + w) * 128);
              }
            }
            float acc[BN / 2];
            wt_product<BN>(acc, in, pi == 0 ? kd / kKc : kch, 0, 0, wr);
#pragma unroll
            for (int j = 0; j < BN / 8; ++j) {
              const int col = c0 + 8 * j + 2 * q;
              float v0 = acc[4 * j], v1 = acc[4 * j + 1], v2 = acc[4 * j + 2], v3 = acc[4 * j + 3];
              if (pi == 1) {
                const float2 w = __ldg(reinterpret_cast<const float2*>(w_alpha + col));
                v0 = fmaf(gr0.w, w.x, v0);
                v1 = fmaf(gr0.w, w.y, v1);
                v2 = fmaf(gr1.w, w.x, v2);
                v3 = fmaf(gr1.w, w.y, v3);
              }
              if (li > 0) {
                const uint32_t bits = m[(4 * j) >> 5] >> ((4 * j) & 31);
                v0 = bits & 1u ? v0 : 0.f;
                v1 = bits & 2u ? v1 : 0.f;
                v2 = bits & 4u ? v2 : 0.f;
                v3 = bits & 8u ? v3 : 0.f;
              }
              if (col < hm) {
                float* d0 = dst + (long long)col * K + row0;
                __stwb(d0, v0);
                __stwb(d0 + K, v1);
                __stwb(d0 + 8, v2);
                __stwb(d0 + K + 8, v3);
              }
            }
          });
        }
        if (li > 0) {  // the next product's input
          wg_sync(bar);
          wt_load_tile(in, dst, K, hm, hp);
          wg_sync(bar);
        }
      }
    }
    for (int c = t; c < hm2; c += 128) p.dy_sum[(size_t)c * n_rays + rl] = dys[c];
  }
  // worker C b has more rays: release the stages of its other passes
  const int per_pass = wt_chain_pieces(hp, nt, bmax);
  for (int c = mine * TPR * per_pass; c < passes * per_pass; ++c) {
    wr.acquire();
    wr.release();
  }
}

// As many ring stages as fit (up to kMaxStages), with their shared-memory
// bytes, for the forward (chain = 0) or the chain; 0 below kMinStages.
int stages_for(int H, int nt, int kx, int chain, size_t* smem) {
  for (int ns = kMaxStages; ns >= kMinStages; --ns) {
    *smem = chain ? chain_smem(H, nt, ns).total : fwd_smem(H, nt, kx, ns).total;
    if (*smem <= (size_t)kSmemMax) return ns;
  }
  return 0;
}

// kOwner's kernels of one chunk, those of `parts` (bits 1 prep, 2 forward,
// 4 compositing (kernel 4's only), 8 chain (not kernel 2's)).
template <int kOwner, int NTM>
int launch_parts(const TrainArgs& a, int parts, cudaStream_t st) {
  constexpr bool kChain = kOwner != kFieldFwd;
  size_t fwd_bytes = 0, chain_bytes = 0;
  if (stages_for(a.hp, a.num_trunk, a.kx, 0, &fwd_bytes) != a.fwd_stages ||
      stages_for(a.hp, a.num_trunk, a.kx, 1, &chain_bytes) != a.chain_stages || a.dx < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(train_fwd_tf32_kernel<kOwner, NTM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)fwd_bytes);
  if (err != cudaSuccess) return (int)err;
  if constexpr (kChain) {
    err = cudaFuncSetAttribute(train_chain_tf32_kernel<kOwner, NTM>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)chain_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  if (a.n_rays == 0) return 0;
  const int n_tiles = (int)(a.k / kTile);
  const int fwd_want = (n_tiles + kCons - 1) / kCons, chain_want = (a.n_rays + kCons - 1) / kCons;
  const int fwd_grid = fwd_want < a.sms ? fwd_want : a.sms;
  const int chain_grid = chain_want < a.sms ? chain_want : a.sms;
  if (parts & 1) {
    train_prep_tf32_kernel<kOwner><<<(a.n_rays + kPrepWarps - 1) / kPrepWarps, kPrepWarps * 32,
                                     0, st>>>(a);
  }
  if (parts & 2) {
    train_fwd_tf32_kernel<kOwner, NTM><<<fwd_grid, kThreads, fwd_bytes, st>>>(a, n_tiles);
  }
  if constexpr (kOwner == kLoss) {
    if (parts & 4) {
      train_composite_tf32_kernel<<<(a.n_rays + kRayWarps - 1) / kRayWarps, kRayWarps * 32,
                                    kRayWarps * 7 * a.n_samples * sizeof(float), st>>>(a);
    }
  }
  if constexpr (kChain) {
    if (parts & 8) {
      train_chain_tf32_kernel<kOwner, NTM><<<chain_grid, kThreads, chain_bytes, st>>>(a);
    }
  }
  return (int)cudaGetLastError();
}

// The wide route's plans: the forward's and the chain's.
inline WtPlan wide_fwd_plan(const TrainArgs& a) { return wt_plan(wide_fwd_cons_bytes(a.hp, a.kx)); }
inline WtPlan wide_chain_plan(const TrainArgs& a) {
  return wt_plan(wide_chain_cons_bytes(a.hp), kChainPieceRows);
}

// kOwner's wide kernels of one chunk (see launch_parts).
template <int kOwner>
int launch_parts_wide(const TrainArgs& a, int parts, cudaStream_t st) {
  constexpr bool kChain = kOwner != kFieldFwd;
  const WtPlan f = wide_fwd_plan(a), c = wide_chain_plan(a);
  if (f.cons == 0 || c.cons == 0 || f.stages != a.fwd_stages || c.stages != a.chain_stages ||
      a.dx < 1 || (kOwner == kFieldFwd && a.wbuf == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(train_fwd_wide_tf32_kernel<kOwner>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)f.smem);
  if (err != cudaSuccess) return (int)err;
  if constexpr (kChain) {
    err = cudaFuncSetAttribute(train_chain_wide_tf32_kernel<kOwner>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)c.smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (a.n_rays == 0) return 0;
  const int n_tiles = (int)(a.k / kTile);
  const int fwd_want = (n_tiles + f.cons - 1) / f.cons;
  const int chain_want = (a.n_rays + c.cons - 1) / c.cons;
  if (parts & 1) {
    train_prep_tf32_kernel<kOwner><<<(a.n_rays + kPrepWarps - 1) / kPrepWarps, kPrepWarps * 32,
                                     0, st>>>(a);
  }
  if (parts & 2) {
    train_fwd_wide_tf32_kernel<kOwner><<<fwd_want < a.sms ? fwd_want : a.sms,
                                         128 * (f.cons + 1), f.smem, st>>>(a, n_tiles);
  }
  if constexpr (kOwner == kLoss) {
    if (parts & 4) {
      train_composite_tf32_kernel<<<(a.n_rays + kRayWarps - 1) / kRayWarps, kRayWarps * 32,
                                    kRayWarps * 7 * a.n_samples * sizeof(float), st>>>(a);
    }
  }
  if constexpr (kChain) {
    if (parts & 8) {
      train_chain_wide_tf32_kernel<kOwner><<<chain_want < a.sms ? chain_want : a.sms,
                                             128 * (c.cons + 1), c.smem, st>>>(a);
    }
  }
  return (int)cudaGetLastError();
}

template <int kOwner>
int launch_width(const TrainArgs& a, int parts, cudaStream_t s) {
  if (a.hp > 128) return launch_parts_wide<kOwner>(a, parts, s);
  switch (a.hp / 32) {
    case 1: return launch_parts<kOwner, 2>(a, parts, s);
    case 2: return launch_parts<kOwner, 4>(a, parts, s);
    case 3: return launch_parts<kOwner, 6>(a, parts, s);
    default: return launch_parts<kOwner, 8>(a, parts, s);
  }
}

// The argument block's shapes and model within the kernels' limits (any
// number of samples: kernel 4's own cap is its entry's).
bool args_ok(const TrainArgs& a) {
  return a.n_samples >= 1 && a.s_pad >= a.n_samples && a.s_pad % kTile == 0 &&
         a.num_trunk >= 0 && a.num_trunk + 8 <= kAux && a.num_trunk <= 31 && a.fx <= kMaxFreq &&
         a.fd <= kMaxFreq && a.hidden >= 1 && a.hp % 32 == 0 &&
         a.hp >= a.hidden && a.hp <= kWtMaxHidden && a.dd <= kMaxDD &&
         a.dx == 3 * a.inc_x + 6 * a.fx && a.dd == 3 * a.inc_d + 6 * a.fd &&
         a.kx == (a.dx + kKc - 1) / kKc && a.kx * kKc <= kMaxDx && a.sms >= 1 &&
         a.k == (long long)a.n_rays * a.s_pad;
}

template <int NTM>
int occupancy(int hp, int nt, int kx, int* out) {
  size_t fb = 0, cb = 0;
  const int fs = stages_for(hp, nt, kx, 0, &fb), cs = stages_for(hp, nt, kx, 1, &cb);
  if (fs == 0 || cs == 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(train_fwd_tf32_kernel<kLoss, NTM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)fb);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(train_chain_tf32_kernel<kLoss, NTM>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)cb);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0],
                                                        train_fwd_tf32_kernel<kLoss, NTM>,
                                                        kThreads, fb);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[3],
                                                        train_chain_tf32_kernel<kLoss, NTM>,
                                                        kThreads, cb);
  }
  out[1] = (int)fb;
  out[2] = fs;
  out[4] = (int)cb;
  out[5] = cs;
  return (int)err;
}

__global__ void __launch_bounds__(kSumThreads)
sum_rays_kernel(const float* v, int n, float* out) {
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

}  // namespace

extern "C" {

// sizeof the argument block, so the Python mirror can be checked.
int dexnerf_train_args_size() { return (int)sizeof(TrainArgs); }

// The scratch layout of Rows (train_rows.cuh), in rows: act and dlt row
// counts, then the first row of e, feat, y, the sigma, y and rgb
// cotangents, then
// a_0..a_nt, then delta_0..delta_{nt+1} (the last is feat's): 2 nt + 11
// ints in `rows`, whose length is `n`.
int dexnerf_train_rows(int dx, int hidden, int num_trunk, int* rows, int n) {
  if (n != 2 * num_trunk + 11) return (int)cudaErrorInvalidValue;
  const Rows R{1, dx, hidden, num_trunk};
  const long long named[] = {R.act_end(), R.dlt_end(), R.e(), R.feat(),
                             R.y(), R.dsig(), R.dy(), R.drgb(0)};
  int j = 0;
  for (long long v : named) rows[j++] = (int)v;
  for (int i = 0; i <= num_trunk; ++i) rows[j++] = (int)R.a(i);
  for (int i = 0; i <= num_trunk + 1; ++i) rows[j++] = (int)R.d(i);
  return 0;
}

// The mask words of one 64-column tile (tile_words) at padded width hp.
int dexnerf_train_tile_words(int hp, int num_trunk) { return tile_words(hp, num_trunk); }

// The pass kernels' residency at padded width hp with num_trunk trunk layers
// and a kx-chunk xyz encoding: out[0..2] the forward's CTAs per SM, shared
// bytes and ring stages, out[3..5] the chain's, out[6..7] their consumer
// warpgroups (the wide route's above 128).
int dexnerf_train_tf32_occupancy(int hp, int num_trunk, int kx, int* out) {
  if (hp % 32 != 0 || hp < 32 || hp > kWtMaxHidden || num_trunk < 0 || num_trunk > 31 ||
      kx < 1 || kx * kKc > kMaxDx) {
    return (int)cudaErrorInvalidValue;
  }
  if (hp > 128) {
    TrainArgs a;
    a.hp = hp;
    a.kx = kx;
    const WtPlan f = wide_fwd_plan(a), c = wide_chain_plan(a);
    if (f.cons == 0 || c.cons == 0) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(train_fwd_wide_tf32_kernel<kLoss>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)f.smem);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(train_chain_wide_tf32_kernel<kLoss>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)c.smem);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &out[0], train_fwd_wide_tf32_kernel<kLoss>, 128 * (f.cons + 1), f.smem);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &out[3], train_chain_wide_tf32_kernel<kLoss>, 128 * (c.cons + 1), c.smem);
    }
    out[1] = (int)f.smem;
    out[2] = f.stages;
    out[4] = (int)c.smem;
    out[5] = c.stages;
    out[6] = f.cons;
    out[7] = c.cons;
    return (int)err;
  }
  out[6] = out[7] = kCons;
  switch (hp / 32) {
    case 1: return occupancy<2>(hp, num_trunk, kx, out);
    case 2: return occupancy<4>(hp, num_trunk, kx, out);
    case 3: return occupancy<6>(hp, num_trunk, kx, out);
    default: return occupancy<8>(hp, num_trunk, kx, out);
  }
}

// Each entry point returns a cudaError_t (0 on success); launches are
// asynchronous on `stream`. `args` points to a host TrainArgs, copied into
// the kernels' parameter blocks at launch: one chunk's prep, forward,
// compositing and chain.
int dexnerf_train_pass(const void* args, void* stream) {
  const TrainArgs& a = *static_cast<const TrainArgs*>(args);
  if (!args_ok(a) || a.s_pad > kMaxSamplesPad) return (int)cudaErrorInvalidValue;
  return launch_width<kLoss>(a, a.parts, static_cast<cudaStream_t>(stream));
}

// The field kernels at float32 on rays [ray0, ray0 + n_rays) of pts [N, S,
// 3] and viewdirs: kernel 2's prep and forward (backward = 0: raw into its
// [N, S, 4] output, dirb for the launch's rays, nothing else) or kernel 3's
// prep, forward and chain on one chunk (backward = 1: graw = the caller's g
// [N, S, 4]; the scratch, dir_enc, dy_sum, the mask words and raw's [k][4]
// as kernel 4's pass fills them). Any S >= 1.
int dexnerf_field_tf32_pass(const void* args, int backward, void* stream) {
  const TrainArgs& a = *static_cast<const TrainArgs*>(args);
  if (!args_ok(a) || a.pts == nullptr || a.viewdirs == nullptr || a.raw == nullptr ||
      a.dirb == nullptr ||
      (backward && (a.graw == nullptr || a.act == nullptr || a.dlt == nullptr ||
                    a.dir_enc == nullptr || a.dy_sum == nullptr || a.masks == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return backward ? launch_width<kFieldBwd>(a, 1 | 2 | 8, s)
                  : launch_width<kFieldFwd>(a, 1 | 2, s);
}

// The sum of the n_rays per-ray losses into *loss, in a fixed order.
int dexnerf_train_loss_sum(const float* loss_ray, int n_rays, float* loss, void* stream) {
  sum_rays_kernel<<<1, kSumThreads, 0, static_cast<cudaStream_t>(stream)>>>(loss_ray, n_rays,
                                                                             loss);
  return (int)cudaGetLastError();
}

}  // extern "C"
