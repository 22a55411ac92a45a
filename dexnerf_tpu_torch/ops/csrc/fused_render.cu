// Fused NeRF render pass at compute_dtype=float32 on the tensor cores of
// NVIDIA Hopper (sm_90a): PE -> FlexibleNeRF MLP -> alpha compositing ->
// Dex-NeRF sigma-threshold depth, in one kernel.
//
// Replaces dexnerf_tpu/ops/fused_render.py::_make_render_kernel (the Pallas
// kernel of make_fused_render) at compute_dtype=float32. Same contract:
// per-ray origins/directions/viewdirs, [N, S] z and dists in; rgb [N,3],
// disparity/accumulation/depth [N], weights [N,S] and the first-crossing
// depths [T,N] out. The sample positions, the encodings, the activations
// and the raw [N,S,4] field never reach device memory. The plain version
// is ops/fused_render.py::fused_render_reference (f32 throughout).
//
// What bounds it on the H100: the multiply-adds. The 8x128 FlexibleNeRF
// costs ~157k per sample, so one 400x400 frame (64 + 128 samples per ray)
// is 9.57 TFLOP: 142.8 ms at the 67 TFLOP/s f32 FMA peak of the CUDA
// cores, and 58.0 ms as three TF32 products each (split TF32, below) at the
// 495 TFLOP/s dense TF32 peak of the tensor cores. Then the weight stream:
// hi + lo of the ~620 KB of weights, ~1.24 MB read from L2 per 128 rows.
//
// Design: split TF32 on wgmma (mlp_tile_tf32.cuh): every f32 operand of
// layer1, the trunk, the skip layer, fc_feat and layers_dir.0 becomes hi =
// tf32(x) and lo = tf32(x - hi), and each product is lo.hi + hi.lo + hi.hi
// in f32 accumulators (relative error ~2^-21 per product, against f32 FMA's
// 2^-24). The sigma and rgb heads, the biases, ReLU and the viewdir fold
// stay f32 FMA; the Dex compare reads the f32 sigma.
// * Persistent CTAs, one per SM, over the work plan of
//   ops/fused_render.py::render_plan with two workers a CTA: the rays are
//   cut into units of rpu whole rays, rows = rpu * S rounded up to a
//   multiple of 64; consumer warpgroup cw of CTA b is worker v = 2 b + cw
//   and takes units v, v + 2 G, ... in order (bitwise repeatable, no
//   atomics).
// * Warpgroup 2: one thread streams the pre-split pack
//   (pack_flex_weights_tf32: per K-chunk of 32 a [N][32] hi stage and a lo
//   stage, swizzled as wgmma reads them, in consumption order) through a
//   ring of up to kMaxStages mbarrier-tracked bulk copies, pass after pass
//   for as long as the CTA's busiest worker has tiles.
// * Warpgroups 0-1, the consumers: 64-row tiles through the whole MLP on
//   wgmma m64nNk8.tf32, chunk by chunk (K = 32) as the ring delivers the
//   weights. The tensor cores round each k8 step's sum into their
//   accumulator (toward zero, by what the card's results show), and 48 such
//   roundings a layer at the running sum's scale cost the f32 contract its
//   tolerance on a frame's tail; so each chunk's twelve products go into a
//   fresh accumulator, added to the layer's sum in f32 on the CUDA cores
//   (as accurate as f32 FMA in a model of the rounding), at widths above
//   64 in two parts of the output columns. Registers bound the design: the
//   sum (64 a thread at width 128), a part's accumulator (32) and the
//   activation's hi half as A fragments (64) leave no room for its lo half,
//   which goes to the consumer's area in shared memory (32 KB at width
//   128), read by wgmma from there. Two consumers at 232 registers a
//   thread (setmaxnreg) beside the weight stream's warpgroup at 40.
// * The viewdir part of layers_dir.0 is a per-ray f32 bias, made once per
//   unit; pts = o + d*z and the PE arguments use __fmul_rn/__fadd_rn and the
//   accurate sincosf, in f32 (the top PE frequency multiplies any error by
//   up to 2^9); the encoding is split only after that.
// * Compositing, per unit by its consumer, one warp per ray: the
//   transmittance as a warp product scan over chunks of 32 samples, per-ray
//   sums as fixed-order butterflies; the Dex first crossing by warp ballots,
//   one warp per (ray, threshold) (no hit -> z[0]).
//
// Padded widths above 128 (up to kWtMaxHidden) take the wide route,
// fused_render_wide_tf32_kernel, chosen by the launcher from the width
// alone: the same work plan, unit prologue and compositing around
// mlp_wide_tf32.cuh's tile (each layer's input an f32 tile in shared
// memory, its output in column blocks of at most 128 to a worker's buffer
// in device memory and back).

#include <cuda_runtime.h>
#include <stdint.h>

#include "mlp_wide_tf32.cuh"

namespace {

constexpr int kMaxUnitRows = 256;
constexpr int kMaxRpu = 16;     // rays per unit
constexpr int kMaxLayers = 40;
constexpr int kMaxFreq = 16;
constexpr int kMaxThresholds = 64;
constexpr int kMaxSamples = 256;
constexpr int kAux = kMaxLayers + 8;

struct Params {
  const float* origins;   // [N, 3]
  const float* dirs;      // [N, 3]
  const float* viewdirs;  // [N, 3]
  const float* z;         // [N, S]
  const float* dists;     // [N, S]
  const uint32_t* wq;     // hi/lo K-chunks, see ops/fused_render.py::pack_flex_weights_tf32
  const float* aux;       // f32 biases, heads, viewdir weights
  float* rgb;             // [N, 3]
  float* disp;            // [N]
  float* acc;             // [N]
  float* depth;           // [N]
  float* weights;         // [N, S]
  float* dex;             // [T, N]
  float* wbuf;            // the wide route's per-worker layer buffers (wide_wbuf_floats)
  int n_rays, n_samples, hidden, num_trunk, skip_mask, rpu;
  int dx, kx, dd, fx, fd, inc_x, inc_d;
  int n_thr, white_bg, n_stages;
  // aux offsets (floats): [0] layer1 bias, [1 + i] trunk i bias, then
  // fc_feat bias, layers_dir.0 bias, w_alpha [H], b_alpha, w_rgb [H/2][3],
  // b_rgb [3], viewdir rows of layers_dir.0 [dd][H/2]
  int aux_off[kAux];
  float bands_x[kMaxFreq];
  float bands_d[kMaxFreq];
  float thr[kMaxThresholds];
};

__host__ __device__ inline int unit_rows(int rpu, int S) {
  return (rpu * S + kTile - 1) / kTile * kTile;
}

// Shared memory from the 1024-aligned base: the weight ring of ns stages,
// each consumer's area, the biases and heads, each consumer's block of
// per-unit floats (z, dists, sigma, rgb logits [rows][3], the viewdir bias
// [rpu][H/2] and encoding [rpu][dd]; offsets within the block), the ring's
// barriers.
struct Smem {
  size_t ring, area, area_bytes, aux, own, own_bytes, zs, ds, sig, rgb, dirb, dtmp, bars, total;
};

__host__ __device__ inline Smem smem_layout(int H, int nt, int kx, int rows, int rpu, int dd,
                                            int ns) {
  Smem s;
  s.ring = 0;
  s.area = (size_t)ns * H * 128;
  s.area_bytes = area_bytes(H, kx);
  s.aux = s.area + kCons * s.area_bytes;
  s.own = s.aux + align16((size_t)aux_head_max(H, nt) * 4);
  size_t o = 0;
  s.zs = o;   o += (size_t)rows * 4;
  s.ds = o;   o += (size_t)rows * 4;
  s.sig = o;  o += (size_t)rows * 4;
  s.rgb = o;  o += (size_t)rows * 12;
  s.dirb = o; o += (size_t)rpu * (H / 2) * 4;
  s.dtmp = o; o += (size_t)rpu * dd * 4;
  s.own_bytes = align16(o);
  s.bars = s.own + kCons * s.own_bytes;
  s.total = s.bars + 2 * (size_t)ns * 8 + 1024;  // + slack to align the base
  return s;
}

// The rgb head's sums of rows r0 + 16 w + g (+ 8): over the four lanes of
// the row, + b_rgb, into rgbr.
__device__ __forceinline__ void store_rgb(float (&c)[2][3], int r0, const float* b_rgb,
                                          float* rgbr) {
  const int t = threadIdx.x & 127, lane = t & 31, g = lane >> 2, q = lane & 3;
  const int r = r0 + 16 * (t >> 5) + g;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int x = 1; x < 4; x <<= 1) {
#pragma unroll
      for (int k = 0; k < 3; ++k) c[h][k] += __shfl_xor_sync(0xffffffffu, c[h][k], x);
    }
    if (q == 0) {
#pragma unroll
      for (int k = 0; k < 3; ++k) rgbr[(r + 8 * h) * 3 + k] = c[h][k] + b_rgb[k];
    }
  }
}

// The unit's depths and intervals (rows of it; 0 past its nrays S real
// samples) into zs, ds, its rays' viewdir encodings (f32, the accurate
// sincosf) into dtmp [rpu][dd], then their viewdir bias bdir + enc .
// W_dir into dirb [rpu][h2], by the warpgroup; visible to it on return.
__device__ __forceinline__ void unit_prologue_tf32(const Params& p, float* zs, float* ds,
                                                   float* dtmp, float* dirb, int ray0, int nrays,
                                                   int rows, int h2, const float* bdir,
                                                   const float* wdv, int bar) {
  const int t = threadIdx.x & 127, S = p.n_samples, dd = p.dd, nreal = nrays * S;
  const size_t s0 = (size_t)ray0 * S;
  for (int r = t; r < rows; r += 128) {
    const bool ok = r < nreal;
    zs[r] = ok ? p.z[s0 + r] : 0.f;
    ds[r] = ok ? p.dists[s0 + r] : 0.f;
  }
  for (int i = t; i < nrays * 3; i += 128) {  // viewdir encodings, f32
    const int rr = i / 3, d = i - 3 * rr;
    const float vv = p.viewdirs[(size_t)(ray0 + rr) * 3 + d];
    float* e = dtmp + rr * dd;
    int col = 0;
    if (p.inc_d) {
      e[d] = vv;
      col = 3;
    }
    for (int f = 0; f < p.fd; ++f) {
      float sn, cs;
      sincosf(__fmul_rn(vv, p.bands_d[f]), &sn, &cs);
      e[col + 6 * f + d] = sn;
      e[col + 6 * f + 3 + d] = cs;
    }
  }
  wg_sync(bar);
  for (int i = t; i < nrays * h2; i += 128) {
    const int rr = i / h2, c = i - rr * h2;
    const float* e = dtmp + rr * dd;
    float val = 0.f;
    for (int kk = 0; kk < dd; ++kk) val = fmaf(e[kk], __ldg(wdv + kk * h2 + c), val);
    dirb[i] = bdir[c] + val;
  }
  wg_sync(bar);  // the unit's data is written
}

// Compositing of the unit's nrays rays from ray0 (sigma and rgb logits of
// every row in sig, rgbr), one warp per ray, then the Dex first crossings,
// one warp per (ray, threshold); into the launch's outputs.
__device__ __forceinline__ void composite_unit_tf32(const Params& p, const float* zs,
                                                    const float* ds, const float* sig,
                                                    const float* rgbr, int ray0, int nrays) {
  const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31, S = p.n_samples, N = p.n_rays;
  for (int rr = warp; rr < nrays; rr += 4) {
    const int base = rr * S;
    const size_t ray = (size_t)ray0 + rr;
    float carry = 1.f, cr = 0.f, cg = 0.f, cb = 0.f, dep = 0.f, ac = 0.f;
    for (int j0 = 0; j0 < S; j0 += 32) {
      const int s = j0 + lane;
      const bool ok = s < S;
      const float sigma = ok ? fmaxf(sig[base + s], 0.f) : 0.f;
      const float alpha = ok ? 1.f - expf(-sigma * ds[base + s]) : 0.f;
      float incl = ok ? (1.f - alpha) + 1e-10f : 1.f;
#pragma unroll
      for (int x = 1; x < 32; x <<= 1) {
        const float tt = __shfl_up_sync(0xffffffffu, incl, x);
        if (lane >= x) incl *= tt;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = 1.f;
      const float wgt = alpha * (carry * excl);
      carry *= __shfl_sync(0xffffffffu, incl, 31);
      if (ok) {
        p.weights[ray * S + s] = wgt;
        const float* raw = rgbr + (base + s) * 3;
        cr += wgt * (1.f / (1.f + expf(-raw[0])));
        cg += wgt * (1.f / (1.f + expf(-raw[1])));
        cb += wgt * (1.f / (1.f + expf(-raw[2])));
        dep += wgt * zs[base + s];
        ac += wgt;
      }
    }
#pragma unroll
    for (int x = 16; x > 0; x >>= 1) {
      cr += __shfl_xor_sync(0xffffffffu, cr, x);
      cg += __shfl_xor_sync(0xffffffffu, cg, x);
      cb += __shfl_xor_sync(0xffffffffu, cb, x);
      dep += __shfl_xor_sync(0xffffffffu, dep, x);
      ac += __shfl_xor_sync(0xffffffffu, ac, x);
    }
    if (lane == 0) {
      if (p.white_bg) {
        cr += 1.f - ac;
        cg += 1.f - ac;
        cb += 1.f - ac;
      }
      p.rgb[ray * 3] = cr;
      p.rgb[ray * 3 + 1] = cg;
      p.rgb[ray * 3 + 2] = cb;
      p.depth[ray] = dep;
      p.acc[ray] = ac;
      p.disp[ray] = 1.f / fmaxf(1e-10f, dep / fmaxf(ac, 1e-37f));
    }
  }
  // ---- Dex: the first sample whose sigma exceeds m (no hit -> z[0]), one
  // warp per (ray, threshold)
  for (int i = warp; i < nrays * p.n_thr; i += 4) {
    const int rr = i / p.n_thr, th = i - rr * p.n_thr;
    const int base = rr * S;
    const float m = p.thr[th];
    float hit = zs[base];
    for (int j0 = 0; j0 < S; j0 += 32) {
      const int s = j0 + lane;
      const unsigned bits = __ballot_sync(0xffffffffu, s < S && fmaxf(sig[base + s], 0.f) > m);
      if (bits) {
        hit = zs[base + j0 + __ffs(bits) - 1];
        break;
      }
    }
    if (lane == 0) p.dex[(size_t)th * N + ray0 + rr] = hit;
  }
}

template <int NTM>
__global__ void __launch_bounds__(kThreads, 1)
    fused_render_tf32_kernel(const __grid_constant__ Params p) {
  constexpr int H = NTM * 16;
  constexpr int H2 = H / 2;
  constexpr int KCH = H / kKc;  // K-chunks of a product on H
  constexpr int SB = H * 128;   // bytes of a ring stage
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sbase = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the swizzle's atoms
  unsigned char* gbase = smem_raw + (sbase - smem_u32(smem_raw));
  const int S = p.n_samples, nt = p.num_trunk, rpu = p.rpu, kx = p.kx, NS = p.n_stages;
  const int rows = unit_rows(rpu, S), tiles = rows / kTile;
  const int n_units = (p.n_rays + rpu - 1) / rpu;
  const Smem L = smem_layout(H, nt, kx, rows, rpu, p.dd, NS);
  const uint32_t ring = sbase + (uint32_t)L.ring;
  const uint32_t full = sbase + (uint32_t)L.bars, empty = full + 8 * NS;
  int nskip = 0;
  for (int i = 0; i < nt; ++i) nskip += (p.skip_mask >> i) & 1;
  // stages of a pass over the weights: a hi and a lo stage per K-chunk
  const int nch = 2 * (kx * (1 + nskip) + (nt + 2) * KCH);
  const int G = gridDim.x, b = blockIdx.x;
  // worker kCons b + cw takes units kCons b + cw, + kCons G, ...; worker
  // kCons b has the CTA's most, and one pass over the weights a tile
  auto units_of = [&](int w) { return w < n_units ? (n_units - 1 - w) / (kCons * G) + 1 : 0; };
  const int passes = tiles * units_of(kCons * b);
  // the warpgroup, shuffled so that the compiler knows it is warp-uniform
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

  const int t = tid & 127, warp = t >> 5, lane = t & 31;
  // registers: 128 x 40 for the weight stream's warpgroup, 2 x 128 x 232
  // for the consumers (ptxas gives the code after each setmaxnreg its
  // count; the launch's 384 threads alone would allow 168)
  if (cw == kCons) {  // ---- the weight stream, one thread
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (t != 0) return;
    stream_weights_tf32(reinterpret_cast<const unsigned char*>(p.wq), passes, nch,
                        nch - 2 * KCH, SB, NS, ring, full, empty);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int bar = 1 + cw, v = kCons * b + cw;
  const uint32_t area = sbase + (uint32_t)(L.area + cw * L.area_bytes);
  const uint32_t enc_hi = area, enc_lo = area + kx * kChunk;  // the encoding's halves
  unsigned char* own = gbase + L.own + cw * L.own_bytes;
  float* zs = reinterpret_cast<float*>(own + L.zs);
  float* ds = reinterpret_cast<float*>(own + L.ds);
  float* sig = reinterpret_cast<float*>(own + L.sig);    // sigma logits
  float* rgbr = reinterpret_cast<float*>(own + L.rgb);   // [rows][3] rgb logits
  float* dirb = reinterpret_cast<float*>(own + L.dirb);  // [rpu][H2]
  float* dtmp = reinterpret_cast<float*>(own + L.dtmp);  // [rpu][dd]
  const float* wdv = p.aux + p.aux_off[nt + 7];  // read once per unit, from L1
  const float* bdir = aux + p.aux_off[nt + 2];
  const float* w_alpha = aux + p.aux_off[nt + 3];
  const float b_alpha = aux[p.aux_off[nt + 4]];
  const float* w_rgb = aux + p.aux_off[nt + 5];
  const float* b_rgb = aux + p.aux_off[nt + 6];
  const int N = p.n_rays, dxp = kx * kKc;

  Tf32Ring wr{ring, full, empty, NS, SB, lane};

  const int mine = units_of(v);
  for (int k = 0; k < mine; ++k) {
    const int ray0 = (v + kCons * G * k) * rpu;
    const int nrays = min(rpu, N - ray0);
    unit_prologue_tf32(p, zs, ds, dtmp, dirb, ray0, nrays, rows, H2, bdir, wdv, bar);

    // the xyz encoding of the tile at r0 into the area, split, by the two
    // lanes of each row of the warp's own 16 rows (a warp's wgmma reads
    // only its own rows of A, and other warps may still be reading theirs);
    // padding rows take the unit's last ray at z = 0
    auto encode_tile = [&](int r0) {
      const int i = 16 * warp + (lane & 15), half = lane >> 4, r = r0 + i;
      const size_t rg = (size_t)(ray0 + min(r / S, nrays - 1)) * 3;
      for (int d = 0; d < 3; ++d) {
        const float pt = __fadd_rn(p.origins[rg + d], __fmul_rn(p.dirs[rg + d], zs[r]));
        encode_coord_tf32(enc_hi, enc_lo, i, d, pt, half, p.fx, p.inc_x,
                          [&](int f) { return p.bands_x[f]; });
      }
      for (int f = p.dx + half; f < dxp; f += 2) store_split(enc_hi, enc_lo, i, f, 0.f);
      fence_async_smem();
      wg_sync(bar);
    };

    for (int tile = 0; tile < tiles; ++tile) {
      const int r0 = tile * kTile;
      encode_tile(r0);
      float* sig_rows = sig + r0 + 16 * warp;
      float acc[H / 2];  // the layer's sum
      uint32_t a[H / 2];
      // ---- layer1: no activation
      enc_product<H>(acc, enc_hi, enc_lo, kx, wr, true);
      if (nt > 0) {
        hidden_epilogue_tf32<H, false, false>(acc, aux + p.aux_off[0], a, area, w_alpha,
                                              b_alpha, sig_rows);
      } else {
        hidden_epilogue_tf32<H, false, true>(acc, aux + p.aux_off[0], a, area, w_alpha, b_alpha,
                                             sig_rows);
      }
      fence_async_smem();
      wg_sync(bar);
      // ---- trunk, then fc_feat (layer nt + 1)
      for (int i = 0; i <= nt; ++i) {
        act_product<H, H>(acc, a, area, wr);
        if (i < nt && ((p.skip_mask >> i) & 1)) {  // the encoding again, into the area
          encode_tile(r0);
          enc_product<H>(acc, enc_hi, enc_lo, kx, wr, false);
        }
        const float* bias = aux + p.aux_off[1 + i];
        if (i == nt - 1) {
          hidden_epilogue_tf32<H, true, true>(acc, bias, a, area, w_alpha, b_alpha, sig_rows);
        } else {
          hidden_epilogue_tf32<H, true, false>(acc, bias, a, area, w_alpha, b_alpha, sig_rows);
        }
        fence_async_smem();
        wg_sync(bar);
      }
      // ---- layers_dir.0 on feat, + the per-ray bias; the rgb head
      float ad[H2 / 2];
      act_product<H2, H>(ad, a, area, wr);
      float crgb[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
      dir_epilogue_tf32<H>(ad, r0, S, nrays, dirb, w_rgb, crgb);
      store_rgb(crgb, r0, b_rgb, rgbr);
    }
    wg_sync(bar);  // every row's sigma and rgb logits are written

    composite_unit_tf32(p, zs, ds, sig, rgbr, ray0, nrays);
    wg_sync(bar);  // the next unit rewrites the unit's data
  }
  // worker kCons b has more tiles: release the stages of its other passes
  for (int c = mine * tiles * nch; c < passes * nch; ++c) {
    wr.take();
    wr.release();
  }
}

// ---- the wide route (padded widths above 128): mlp_wide_tf32.cuh's tile
// under the same work plan (render_plan with the kernel's C workers a CTA),
// unit prologue and compositing. Persistent CTAs of C consumer warpgroups
// (wt_plan: 2 while two fit, else 1) and one weight-stream warpgroup; shared
// memory from the 1024-aligned base: the ring, then each consumer's block
// (its input tile, its encoding tile, its unit data: z, dists, sigma [rows],
// rgb logits [rows][3]), then the ring's barriers. In device memory a
// worker's buffer (p.wbuf, wide_wbuf_floats each): the layer outputs [hp]
// [64] and the unit's viewdir bias [rpu][hp / 2]; the unit's viewdir
// encodings go to the input tile, free during the unit's prologue.
__host__ __device__ inline size_t wide_render_cons_bytes(int hp, int kx, int rows) {
  return align16(ft_bytes(hp) + ft_bytes(kx * kKc) + (size_t)rows * 24);
}
__host__ __device__ inline size_t wide_wbuf_floats(int hp) {
  return (size_t)hp * kTile + (size_t)kMaxRpu * (hp / 2);
}

__global__ void __launch_bounds__(kWtThreads, 1)
    fused_render_wide_tf32_kernel(const __grid_constant__ Params p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sbase = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (sbase - smem_u32(smem_raw));
  const int C = blockDim.x / 128 - 1;
  const int hp = p.hidden, h2 = hp / 2, S = p.n_samples, nt = p.num_trunk, rpu = p.rpu;
  const int kx = p.kx, NS = p.n_stages, rows = unit_rows(rpu, S), tiles = rows / kTile;
  const int n_units = (p.n_rays + rpu - 1) / rpu;
  const size_t cons_bytes = wide_render_cons_bytes(hp, kx, rows);
  const int bmax = wt_plan(cons_bytes).bmax;
  const uint32_t ring = sbase, cons0 = sbase + (uint32_t)(NS * wt_stage_bytes(bmax));
  const uint32_t full = cons0 + (uint32_t)(C * cons_bytes), empty = full + 8 * NS;
  const int G = gridDim.x, b = blockIdx.x;
  // worker C b + cw takes units C b + cw, + C G, ...; worker C b has the
  // CTA's most, and one pass over the weights a tile
  auto units_of = [&](int w) { return w < n_units ? (n_units - 1 - w) / (C * G) + 1 : 0; };
  const int passes = tiles * units_of(C * b);
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
  const int t = tid & 127, warp = t >> 5, lane = t & 31, g = lane >> 2;
  if (cw == C) {  // ---- the weight stream, one thread
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kWtProdRegs));
    if (t == 0) {
      WtStream st{reinterpret_cast<const unsigned char*>(p.wq), ring, full, empty, NS, bmax};
      st.forward(passes, hp, kx, nt, p.skip_mask, true);
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kWtConsRegs));
  const int v = C * b + cw, bar = 1 + cw;
  const uint32_t own = cons0 + (uint32_t)(cw * cons_bytes);
  float* dtmp = reinterpret_cast<float*>(gbase + (own - sbase));  // [rpu][dd] in the input tile
  float* zs = reinterpret_cast<float*>(gbase + (own - sbase) + ft_bytes(hp) + ft_bytes(kx * kKc));
  float* ds = zs + rows;
  float* sig = ds + rows;
  float* rgbr = sig + rows;  // [rows][3]
  float* wb = p.wbuf + (size_t)v * wide_wbuf_floats(hp);
  float* dirb = wb + (size_t)hp * kTile;  // [rpu][h2]
  const WtTile T{own, own + (uint32_t)ft_bytes(hp), p.aux, p.aux_off, nullptr,
                 hp, kx, p.dx, nt, p.skip_mask, bar};
  const WtOut O{wb, kTile, 0, hp, nullptr, nullptr, 0};
  WtRing wr{ring, full, empty, NS, bmax, lane};
  const int mine = units_of(v);
  for (int k = 0; k < mine; ++k) {
    const int ray0 = (v + C * G * k) * rpu;
    const int nrays = min(rpu, p.n_rays - ray0);
    unit_prologue_tf32(p, zs, ds, dtmp, dirb, ray0, nrays, rows, h2, p.aux + p.aux_off[nt + 2],
                       p.aux + p.aux_off[nt + 7], bar);
    for (int tile = 0; tile < tiles; ++tile) {
      const int r0 = tile * kTile;
      // the xyz encoding of the tile's rows (two lanes a row), f32; padding
      // rows take the unit's last ray at z = 0
      {
        const int i = 16 * warp + (lane & 15), half = lane >> 4, r = r0 + i;
        const size_t rg = (size_t)(ray0 + min(r / S, nrays - 1)) * 3;
        for (int d = 0; d < 3; ++d) {
          const float pt = __fadd_rn(p.origins[rg + d], __fmul_rn(p.dirs[rg + d], zs[r]));
          wt_encode_coord(d, pt, half, p.fx, p.inc_x, p.bands_x,
                          [&](int f, float x) { sts32(T.enc + ft_off(f, i), __float_as_uint(x)); });
        }
      }
      wg_sync(bar);  // the encoding (and, on the first tile, the unit's data) is written
      const int row = r0 + 16 * warp + g;
      wt_forward(T, wr, O, dirb + min(row / S, nrays - 1) * h2,
                 dirb + min((row + 8) / S, nrays - 1) * h2, sig + r0, rgbr + 3 * r0);
    }
    wg_sync(bar);  // every row's sigma and rgb logits are written
    composite_unit_tf32(p, zs, ds, sig, rgbr, ray0, nrays);
    wg_sync(bar);  // the next unit rewrites the unit's data
  }
  // worker C b has more tiles: release the stages of its other passes
  const int per_pass = wt_fwd_pieces(hp, kx, nt, p.skip_mask, bmax, true);
  for (int c = mine * tiles * per_pass; c < passes * per_pass; ++c) {
    wr.acquire();
    wr.release();
  }
}

template <int NTM>
int occupancy(size_t smem, int* ctas) {
  cudaError_t err = cudaFuncSetAttribute(fused_render_tf32_kernel<NTM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, fused_render_tf32_kernel<NTM>,
                                                           kThreads, smem);
}

template <int NTM>
int launch(const Params& p, size_t smem, int grid, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(fused_render_tf32_kernel<NTM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (grid == 0) return 0;
  fused_render_tf32_kernel<NTM><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// The ring stages and shared memory of a launch: as many stages as fit, up
// to kMaxStages; 0 if the shape is not one the kernel takes or fewer than
// kMinStages fit (a consumer holds a chunk's two stages).
int stages_for(int hidden, int dx, int dd, int n_samples, int rpu, int num_trunk, size_t* smem) {
  if (hidden % 32 != 0 || hidden < 32 || hidden > 128 || n_samples < 1 ||
      n_samples > kMaxSamples || rpu < 1 || rpu > kMaxRpu ||
      unit_rows(rpu, n_samples) > kMaxUnitRows || dx < 1 || dx > kMaxDx || dd < 0 ||
      num_trunk < 0 || num_trunk > 31) {
    return 0;
  }
  const int kx = (dx + kKc - 1) / kKc;
  for (int ns = kMaxStages; ns >= kMinStages; --ns) {
    *smem = smem_layout(hidden, num_trunk, kx, unit_rows(rpu, n_samples), rpu, dd, ns).total;
    if (*smem <= (size_t)kSmemMax) return ns;
  }
  return 0;
}

// The wide kernel's ring stages, shared memory and consumers for a launch
// (see stages_for); 0 if the shape is not one it takes.
int wide_stages_for(int hidden, int dx, int n_samples, int rpu, int num_trunk, size_t* smem,
                    int* cons) {
  if (hidden % 32 != 0 || hidden <= 128 || hidden > kWtMaxHidden || n_samples < 1 ||
      n_samples > kMaxSamples || rpu < 1 || rpu > kMaxRpu ||
      unit_rows(rpu, n_samples) > kMaxUnitRows || dx < 1 || dx > kMaxDx || num_trunk < 0 ||
      num_trunk > 31) {
    return 0;
  }
  const WtPlan w =
      wt_plan(wide_render_cons_bytes(hidden, (dx + kKc - 1) / kKc, unit_rows(rpu, n_samples)));
  *smem = w.smem;
  *cons = w.cons;
  return w.stages;
}

int launch_wide(const Params& p, size_t smem, int cons, int grid, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(fused_render_wide_tf32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (grid == 0) return 0;
  fused_render_wide_tf32_kernel<<<grid, 128 * (cons + 1), smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success); the launch is asynchronous on
// `stream`. Pointers named *_host are host arrays, copied into the kernel's
// parameter block. The work plan (ops/fused_render.py::render_plan, two
// workers a CTA, or the wide kernel's consumers above 128): units of
// rays_per_unit rays, `grid` persistent CTAs. `hidden` is the padded width
// (a multiple of 32 up to kWtMaxHidden; above 128 the wide kernel, whose
// workers each take wide_wbuf_floats(hidden) floats of wbuf).
int dexnerf_fused_render(const float* origins, const float* dirs, const float* viewdirs,
                         const float* z, const float* dists, const void* wq, const float* aux,
                         float* rgb, float* disp, float* acc, float* depth, float* weights,
                         float* dex, float* wbuf, int n_rays, int n_samples, int hidden,
                         int num_trunk, int skip_mask, int rays_per_unit, int grid, int fx,
                         int inc_x, const float* bands_x_host, int fd, int inc_d,
                         const float* bands_d_host, int n_thr, const float* thr_host,
                         const int* aux_off_host, int white_bg, void* stream) {
  Params p;
  p.origins = origins;
  p.dirs = dirs;
  p.viewdirs = viewdirs;
  p.z = z;
  p.dists = dists;
  p.wq = static_cast<const uint32_t*>(wq);
  p.aux = aux;
  p.rgb = rgb;
  p.disp = disp;
  p.acc = acc;
  p.depth = depth;
  p.weights = weights;
  p.dex = dex;
  p.wbuf = wbuf;
  p.n_rays = n_rays;
  p.n_samples = n_samples;
  p.hidden = hidden;
  p.num_trunk = num_trunk;
  p.skip_mask = skip_mask;
  p.rpu = rays_per_unit;
  p.fx = fx;
  p.fd = fd;
  p.inc_x = inc_x;
  p.inc_d = inc_d;
  p.dx = 3 * inc_x + 6 * fx;
  p.kx = (p.dx + kKc - 1) / kKc;
  p.dd = 3 * inc_d + 6 * fd;
  p.n_thr = n_thr;
  p.white_bg = white_bg;
  size_t smem = 0;
  int cons = kCons;
  const bool wide = hidden > 128;
  p.n_stages = wide ? wide_stages_for(hidden, p.dx, n_samples, rays_per_unit, num_trunk, &smem,
                                      &cons)
                    : stages_for(hidden, p.dx, p.dd, n_samples, rays_per_unit, num_trunk, &smem);
  if (p.n_stages == 0 || n_rays < 0 || grid < 0 || (n_rays > 0 && grid < 1) ||
      num_trunk + 8 > kAux || fx > kMaxFreq || fd > kMaxFreq ||
      n_thr > kMaxThresholds || n_thr < 0 || (n_thr > 0 && dex == nullptr) ||
      (wide && wbuf == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  for (int i = 0; i < num_trunk + 8; ++i) p.aux_off[i] = aux_off_host[i];
  for (int f = 0; f < fx; ++f) p.bands_x[f] = bands_x_host[f];
  for (int f = 0; f < fd; ++f) p.bands_d[f] = bands_d_host[f];
  for (int t = 0; t < n_thr; ++t) p.thr[t] = thr_host[t];
  if (n_rays == 0) grid = 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wide) return launch_wide(p, smem, cons, grid, s);
  switch (hidden / 32) {
    case 1: return launch<2>(p, smem, grid, s);
    case 2: return launch<4>(p, smem, grid, s);
    case 3: return launch<6>(p, smem, grid, s);
    default: return launch<8>(p, smem, grid, s);
  }
}

// CTAs of the kernel that fit on one SM (registers, shared memory) for a
// model of padded width `hidden` with a dx-wide xyz and a dd-wide viewdir
// encoding, num_trunk trunk layers, units of `rays_per_unit` rays of
// `n_samples`; its shared-memory bytes per CTA into *smem_bytes and its
// ring stages into *stages.
int dexnerf_fused_render_occupancy(int hidden, int dx, int dd, int n_samples, int rays_per_unit,
                                   int num_trunk, int* ctas, int* smem_bytes, int* stages) {
  size_t smem = 0;
  *stages = stages_for(hidden, dx, dd, n_samples, rays_per_unit, num_trunk, &smem);
  if (*stages == 0) return (int)cudaErrorInvalidValue;
  *smem_bytes = (int)smem;
  switch (hidden / 32) {
    case 1: return occupancy<2>(smem, ctas);
    case 2: return occupancy<4>(smem, ctas);
    case 3: return occupancy<6>(smem, ctas);
    default: return occupancy<8>(smem, ctas);
  }
}

// The same for the wide kernel (padded widths above 128), with its consumer
// warpgroups (the render plan's workers a CTA) into *cons and the floats of
// a worker's buffer into *wbuf_floats.
int dexnerf_fused_render_wide_occupancy(int hidden, int dx, int dd, int n_samples,
                                        int rays_per_unit, int num_trunk, int* ctas,
                                        int* smem_bytes, int* stages, int* cons,
                                        int* wbuf_floats) {
  size_t smem = 0;
  *stages = wide_stages_for(hidden, dx, n_samples, rays_per_unit, num_trunk, &smem, cons);
  if (*stages == 0) return (int)cudaErrorInvalidValue;
  *smem_bytes = (int)smem;
  *wbuf_floats = (int)wide_wbuf_floats(hidden);
  const cudaError_t err = cudaFuncSetAttribute(
      fused_render_wide_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas, fused_render_wide_tf32_kernel, 128 * (*cons + 1), smem);
}

const char* dexnerf_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
