// Fused NeRF render pass at compute_dtype=bfloat16, on the tensor cores of
// NVIDIA Hopper (sm_90a): PE -> FlexibleNeRF MLP -> alpha compositing ->
// Dex-NeRF sigma-threshold depth, in one kernel.
//
// Replaces dexnerf_tpu/ops/fused_render.py::_make_render_kernel at
// compute_dtype=bfloat16 (the JAX package's default for served and
// evaluated frames). Same outputs as fused_render.cu: rgb [N,3],
// disparity/accumulation/depth [N], weights [N,S] and the first-crossing
// depths [T,N]. The bf16 contract is that of
// dexnerf_tpu/ops/fused_mlp.py::split_flex_params + _forward_block_parts:
// the operands of layer1, of every trunk layer (h and, on a skip layer, the
// xyz encoding), of fc_feat and of layers_dir.0 are rounded to bf16 and
// accumulated in f32; bias, ReLU and the chain stay f32; the sigma head
// reads the f32 trunk output and the rgb head the f32 viewdir-layer output,
// both with f32 weights. The plain version is
// ops/fused_render.py::flex_forward_bf16.
//
// What bounds it on the H100: the bf16 multiply-adds (~157k per sample for
// the 8x128 model; one 400x400 frame of 64 + 128 samples per ray is ~9.6
// TFLOP, 9.7 ms at the 989 TFLOP/s dense bf16 peak), then the weight
// stream: each pass over the ~311 KB bf16 pack serves 192 samples, read
// from L2.
//
// Design: persistent CTAs, one per SM, of four warpgroups; the tile
// (epilogues, products, PE, the weight stream) is mlp_tile_bf16.cuh, shared
// with the training forward of kernels 2-4.
// * Work plan (ops/fused_render.py::render_plan): the rays are cut into
//   units of rpu whole rays, rows = rpu * S rounded up to a multiple of 64
//   (at most 256). Consumer warpgroup cw of CTA b is worker v = 3 b + cw
//   and takes units v, v + 3 G, ... in order: every ray lies in one unit,
//   every unit has one worker, and the order is fixed, so runs are bitwise
//   repeatable (no atomics).
// * Warpgroup 3: one thread streams the weights through a ring of up to
//   kMaxStages mbarrier-tracked 1-D bulk copies, the same chunks pass after
//   pass for as long as the CTA's busiest worker has tiles (no CTA starts
//   cold). The pack (ops/fused_render.py::pack_flex_weights_bf16) holds the
//   matmul operands as [N][64] K-chunks (N = Hp rows, or Hp/2 for the
//   viewdir layer), already in the 128 B-swizzled layout that wgmma reads,
//   in consumption order. All three consumers read every stage.
// * Warpgroups 0-2, the consumers: each runs its own 64-row tiles through
//   the whole MLP on wgmma m64nNk16 (f32 accumulators in registers),
//   waiting for a layer's chunks before its products and releasing them
//   after; no block-wide barrier after the start. Layer1 and the skip layer
//   read the xyz encoding from shared memory (a K-major, 128 B-swizzled tile
//   per consumer). Every other layer reads its A operand from registers:
//   the previous layer's f32 accumulator, after bias, ReLU and the bf16
//   rounding (one cvt.rn.relu.bf16x2), is already in the register layout of
//   wgmma's A fragment. The heads run in f32 in the epilogues from the
//   accumulators (sigma = a_last . w_alpha in the last trunk layer's, rgb =
//   y . w_rgb in the viewdir layer's, at width 128 in two 32-column
//   products), each row's sum over the four lanes that hold it; biases and
//   heads are read from shared memory. While one consumer runs its scalar
//   work, the others' products keep the tensor cores busy.
// * Registers bound the design: 16 warps leave 128 a thread, which holds
//   one tile's accumulator (64), its A fragments (32) and the epilogue.
//   Past that the compiler spills and then serializes every wgmma. Two
//   tiles a consumer, overlapped by wgmma.wait_group 1, do not fit, and the
//   compiler serializes wgmmas left in flight across that wait anyway.
// * The viewdir part of layers_dir.0 is a per-ray bias from the bf16-rounded
//   encoding and weights with an f32 sum, made once per unit.
// * pts = o + d*z and the PE arguments use __fmul_rn/__fadd_rn and the
//   accurate sincosf, in f32; only the encoding is rounded to bf16.
// * Compositing, per unit by its consumer, one warp per ray: the
//   transmittance as a warp product scan over chunks of 32 samples, per-ray
//   sums as fixed-order butterflies; the Dex first crossing by warp ballots,
//   one warp per (ray, threshold).
//
// Padded widths above 128 (up to kWideMaxHidden) take the wide route,
// fused_render_wide_kernel, chosen by the launcher from the width alone: the
// same work plan, unit prologue and compositing around mlp_wide_bf16.cuh's
// tile (layers in shared memory, column blocks of 64, both wgmma operands
// from shared memory, fresh accumulators promoted into an f32 sum), 2
// consumer warpgroups up to a padded width of 320 and 1 above (the render
// plan's workers a CTA).

#include <cuda_runtime.h>
#include <stdint.h>

#include "mlp_tile_bf16.cuh"
#include "mlp_wide_bf16.cuh"

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
  const bf16* wq;         // swizzled K-chunks, see ops/fused_render.py::pack_flex_weights_bf16
  const float* aux;       // f32 biases, heads, viewdir weights (bf16-rounded)
  float* rgb;             // [N, 3]
  float* disp;            // [N]
  float* acc;             // [N]
  float* depth;           // [N]
  float* weights;         // [N, S]
  float* dex;             // [T, N]
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
// each consumer's encoding tile, the biases and heads, each consumer's
// block of per-unit floats (z, dists, sigma, rgb logits [rows][3], the
// viewdir bias [rpu][H/2] and encoding [rpu][dd]; offsets within the
// block), the ring's barriers.
struct Smem {
  size_t ring, enc, aux, own, own_bytes, zs, ds, sig, rgb, dirb, dtmp, bars, total;
};

__host__ __device__ inline Smem smem_layout(int H, int nt, int kx, int rows, int rpu, int dd,
                                            int ns) {
  Smem s;
  s.ring = 0;
  s.enc = (size_t)ns * H * 128;
  s.aux = s.enc + kCons * (size_t)kx * kEncChunk;
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

// A consumer's per-unit data in shared memory (see the kernels' layouts):
// depths, intervals, sigma logits [rows], rgb logits [rows][3], the rays'
// viewdir bias [rpu][h2] and encodings [rpu][dd].
struct UnitData {
  float *zs, *ds, *sig, *rgbr, *dirb, *dtmp;
};

// The unit's depths and intervals (zero on its padding rows), its rays'
// viewdir encodings (rounded to bf16) and their viewdir bias: the h2
// columns of bdir + enc . wdv (wdv the bf16-rounded viewdir rows [dd][h2]),
// by the consumer warpgroup (named barrier bar).
__device__ __forceinline__ void unit_prologue(const Params& p, const UnitData& u, int ray0,
                                              int nrays, int rows, int h2, const float* bdir,
                                              const float* wdv, int bar) {
  const int t = threadIdx.x & 127;
  // ---- the unit's depths and intervals, and its rays' viewdir bias
  for (int r = t; r < rows; r += 128) {
    const bool ok = r < nrays * p.n_samples;
    u.zs[r] = ok ? p.z[(size_t)ray0 * p.n_samples + r] : 0.f;
    u.ds[r] = ok ? p.dists[(size_t)ray0 * p.n_samples + r] : 0.f;
  }
  for (int i = t; i < nrays * 3; i += 128) {  // viewdir encodings, rounded to bf16
    const int rr = i / 3, d = i - 3 * rr;
    const float vv = p.viewdirs[(size_t)(ray0 + rr) * 3 + d];
    float* e = u.dtmp + rr * p.dd;
    int col = 0;
    if (p.inc_d) {
      e[d] = bf16_round(vv);
      col = 3;
    }
    for (int f = 0; f < p.fd; ++f) {
      float sn, cs;
      sincosf(__fmul_rn(vv, p.bands_d[f]), &sn, &cs);
      e[col + 6 * f + d] = bf16_round(sn);
      e[col + 6 * f + 3 + d] = bf16_round(cs);
    }
  }
  wg_sync(bar);
  for (int i = t; i < nrays * h2; i += 128) {
    const int rr = i / h2, c = i - rr * h2;
    const float* e = u.dtmp + rr * p.dd;
    float val = bdir[c];
    for (int kk = 0; kk < p.dd; ++kk) val = fmaf(e[kk], __ldg(wdv + kk * h2 + c), val);
    u.dirb[i] = val;
  }
}

// The encoding of a unit's 64-row tile at row r0 into the consumer's
// encoding tile encg, two threads a row (encode_coord: f32, rounded to
// bf16); padding rows keep an earlier, finite encoding.
__device__ __forceinline__ void encode_tile(const Params& p, const UnitData& u,
                                            unsigned char* encg, int ray0, int r0, int nreal) {
  const int t = threadIdx.x & 127, i = t & 63, half = t >> 6, S = p.n_samples;
  const int r = r0 + i;
  if (r < nreal) {
    const size_t rg = (size_t)(ray0 + r / S) * 3;
    for (int d = 0; d < 3; ++d) {
      const float pt = __fadd_rn(p.origins[rg + d], __fmul_rn(p.dirs[rg + d], u.zs[r]));
      encode_coord(encg, i, d, pt, half, p.fx, p.inc_x, [&](int f) { return p.bands_x[f]; });
    }
  }
}

// The unit's compositing, one warp per ray (the transmittance as a warp
// product scan over chunks of 32 samples, per-ray sums as fixed-order
// butterflies), then the Dex first crossings, one warp per (ray, threshold),
// from the unit's sigma and rgb logits.
__device__ __forceinline__ void composite_unit(const Params& p, const UnitData& u, int ray0,
                                               int nrays) {
  const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31, S = p.n_samples;
  // ---- compositing, one warp per ray
  for (int rr = warp; rr < nrays; rr += 4) {
    const int base = rr * S;
    const size_t ray = (size_t)ray0 + rr;
    float carry = 1.f, cr = 0.f, cg = 0.f, cb = 0.f, dep = 0.f, ac = 0.f;
    for (int j0 = 0; j0 < S; j0 += 32) {
      const int s = j0 + lane;
      const bool ok = s < S;
      const float sigma = ok ? fmaxf(u.sig[base + s], 0.f) : 0.f;
      const float alpha = ok ? 1.f - expf(-sigma * u.ds[base + s]) : 0.f;
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
        const float* raw = u.rgbr + (base + s) * 3;
        cr += wgt * (1.f / (1.f + expf(-raw[0])));
        cg += wgt * (1.f / (1.f + expf(-raw[1])));
        cb += wgt * (1.f / (1.f + expf(-raw[2])));
        dep += wgt * u.zs[base + s];
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
    float hit = u.zs[base];
    for (int j0 = 0; j0 < S; j0 += 32) {
      const int s = j0 + lane;
      const unsigned bits = __ballot_sync(0xffffffffu, s < S && fmaxf(u.sig[base + s], 0.f) > m);
      if (bits) {
        hit = u.zs[base + j0 + __ffs(bits) - 1];
        break;
      }
    }
    if (lane == 0) p.dex[(size_t)th * p.n_rays + ray0 + rr] = hit;
  }
}

template <int NTM>
__global__ void __launch_bounds__(kThreads, 1)
    fused_render_bf16_kernel(const __grid_constant__ Params p) {
  constexpr int H = NTM * 16;
  constexpr int H2 = H / 2;
  constexpr int KCH = (H + kKc - 1) / kKc;  // K-chunks of a product on H
  constexpr int SB = H * 128;               // bytes of a ring stage
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
  const int nch = kx * (1 + nskip) + (nt + 2) * KCH;  // chunks of a pass over the weights
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
  // the encoding tiles' columns past dx stay zero
  for (int i = tid; i < kCons * kx * kEncChunk / 16; i += kThreads) {
    reinterpret_cast<uint4*>(gbase + L.enc)[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  fence_async_smem();
  __syncthreads();

  const int t = tid & 127, warp = t >> 5, lane = t & 31;
  // registers: 128 x 40 for the weight stream's warpgroup, 3 x 128 x 152
  // for the consumers
  if (cw == kCons) {  // ---- the weight stream, one thread
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (t != 0) return;
    stream_weights(reinterpret_cast<const unsigned char*>(p.wq), passes, nch, nch - KCH, SB, NS,
                   ring, full, empty);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 152;\n");
  const int bar = 1 + cw, v = kCons * b + cw;
  const uint32_t enc = sbase + (uint32_t)L.enc + cw * kx * kEncChunk;
  unsigned char* encg = gbase + L.enc + cw * kx * kEncChunk;
  unsigned char* own = gbase + L.own + cw * L.own_bytes;
  const UnitData u{reinterpret_cast<float*>(own + L.zs), reinterpret_cast<float*>(own + L.ds),
                   reinterpret_cast<float*>(own + L.sig), reinterpret_cast<float*>(own + L.rgb),
                   reinterpret_cast<float*>(own + L.dirb), reinterpret_cast<float*>(own + L.dtmp)};
  float* sig = u.sig;    // sigma logits
  float* rgbr = u.rgbr;  // [rows][3] rgb logits
  const float* wdv = p.aux + p.aux_off[nt + 7];  // read once per unit, from L1
  const float* bdir = aux + p.aux_off[nt + 2];
  const float* w_alpha = aux + p.aux_off[nt + 3];
  const float b_alpha = aux[p.aux_off[nt + 4]];
  const float* w_rgb = aux + p.aux_off[nt + 5];
  const float* b_rgb = aux + p.aux_off[nt + 6];
  const int N = p.n_rays;

  // the weight ring, as this warp consumes it
  WeightRing wr{ring, full, empty, NS, SB, lane};

  const int mine = units_of(v);
  for (int k = 0; k < mine; ++k) {
    const int ray0 = (v + kCons * G * k) * rpu;
    const int nrays = min(rpu, N - ray0), nreal = nrays * S;
    unit_prologue(p, u, ray0, nrays, rows, H2, bdir, wdv, bar);

    for (int tile = 0; tile < tiles; ++tile) {
      const int r0 = tile * kTile;
      // ---- positional encoding of the tile's rows (two threads a row)
      encode_tile(p, u, encg, ray0, r0, nreal);
      fence_async_smem();
      wg_sync(bar);  // the encoding (and, on the first tile, the unit's data) is written

      float* sig_rows = sig + r0 + 16 * warp;
      float acc[H / 2];
      uint32_t a[H / 4];
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
      if (nt > 0) {
        hidden_epilogue<H, false, false>(acc, aux + p.aux_off[0], a, w_alpha, b_alpha, sig_rows);
      } else {
        hidden_epilogue<H, false, true>(acc, aux + p.aux_off[0], a, w_alpha, b_alpha, sig_rows);
      }
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
        if (i == nt - 1) {
          hidden_epilogue<H, true, true>(acc, bias, a, w_alpha, b_alpha, sig_rows);
        } else {
          hidden_epilogue<H, true, false>(acc, bias, a, w_alpha, b_alpha, sig_rows);
        }
      }
      // ---- layers_dir.0 on feat, + the per-ray bias; the rgb head. At
      // width 128 in two products of 32 columns: one 64-column accumulator
      // beside the epilogue's values would not fit the 128 registers a
      // thread has (the compiler would spill and serialize every wgmma).
      constexpr int NSPLIT = H2 == 64 ? 2 : 1, NH = H2 / NSPLIT;
      wr.wait(KCH);
#pragma unroll
      for (int c = 0; c < KCH; ++c) sh[c] = wr.at(c);
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
        dir_epilogue<H, NH>(ad, hs * NH, r0, S, nrays, u.dirb, w_rgb, crgb);
      }
      wr.release(KCH);
      store_rgb(crgb, r0, b_rgb, rgbr);
    }
    wg_sync(bar);  // every row's sigma and rgb logits are written

    composite_unit(p, u, ray0, nrays);
    wg_sync(bar);  // the next unit rewrites the unit's data
  }
  // worker kCons b has more tiles: release the chunks of its other passes
  for (int c = mine * tiles * nch; c < passes * nch; ++c) {
    wr.wait(1);
    wr.release(1);
  }
}


// ---- the wide route (padded widths above 128): mlp_wide_bf16.cuh's tile
// under the same work plan (render_plan with the kernel's C workers a CTA),
// unit prologue and compositing. Persistent CTAs of C consumer warpgroups
// (C = 2 up to a padded width of 256, 1 above) and one weight-stream
// warpgroup; shared memory from the 1024-aligned base: the ring, then each
// consumer's block (its two activation tiles, its encoding tile, its unit
// data: z, dists, sigma [rows], rgb logits [rows][3], the viewdir bias
// [rpu][H/2] and encodings [rpu][dd]), then the ring's barriers.
__host__ __device__ inline size_t wide_render_cons_bytes(int hp, int kx, int rows, int rpu,
                                                         int dd) {
  return align1024(wide_act_bytes(hp) + (size_t)kx * kEncChunk + (size_t)rows * 24 +
                   (size_t)rpu * (hp / 2 + dd) * 4);
}

__global__ void __launch_bounds__(kWideThreads, 1)
    fused_render_wide_kernel(const __grid_constant__ Params p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sbase = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the swizzle's atoms
  unsigned char* gbase = smem_raw + (sbase - smem_u32(smem_raw));
  const int C = blockDim.x / 128 - 1;
  const int hp = p.hidden, S = p.n_samples, nt = p.num_trunk, rpu = p.rpu, kx = p.kx;
  const int NS = p.n_stages, rows = unit_rows(rpu, S), tiles = rows / kTile;
  const int n_units = (p.n_rays + rpu - 1) / rpu;
  const size_t cons_bytes = wide_render_cons_bytes(hp, kx, rows, rpu, p.dd);
  const size_t act_bytes = wide_act_bytes(hp);
  const uint32_t ring = sbase, cons0 = sbase + (uint32_t)NS * kWideStage;
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
  // the consumers' blocks start zero: the encoding tiles' columns past dx stay so
  for (size_t i = tid; i < C * cons_bytes / 16; i += blockDim.x) {
    reinterpret_cast<uint4*>(gbase + NS * kWideStage)[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  fence_async_smem();
  __syncthreads();
  const int t = tid & 127, lane = t & 31;
  if (cw == C) {  // ---- the weight stream, one thread
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kWideProdRegs));
    if (t == 0) {
      WideStream st{reinterpret_cast<const unsigned char*>(p.wq), ring, full, empty, NS};
      st.forward(passes, hp, kx, nt, p.skip_mask);
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kWideConsRegs));
  const int v = C * b + cw;
  const uint32_t own = cons0 + (uint32_t)(cw * cons_bytes);
  unsigned char* ownp = gbase + NS * kWideStage + cw * cons_bytes;
  unsigned char* encg = ownp + act_bytes;
  float* unit = reinterpret_cast<float*>(encg + kx * kEncChunk);
  const UnitData u{unit, unit + rows, unit + 2 * rows, unit + 3 * rows, unit + 6 * rows,
                   unit + 6 * rows + rpu * (hp / 2)};
  const WideTile T{{own, own + (uint32_t)(act_bytes / 2)}, own + (uint32_t)act_bytes, p.aux,
                   p.aux_off, hp, kx, nt, p.skip_mask, 1 + cw};
  const float* bdir = p.aux + p.aux_off[nt + 2];
  const float* wdv = p.aux + p.aux_off[nt + 7];
  WideRing wr{ring, full, empty, NS, lane};
  const int mine = units_of(v);
  for (int k = 0; k < mine; ++k) {
    const int ray0 = (v + C * G * k) * rpu;
    const int nrays = min(rpu, p.n_rays - ray0), nreal = nrays * S;
    unit_prologue(p, u, ray0, nrays, rows, hp / 2, bdir, wdv, T.bar);
    for (int tile = 0; tile < tiles; ++tile) {
      const int r0 = tile * kTile;
      // ---- positional encoding of the tile's rows (two threads a row)
      encode_tile(p, u, encg, ray0, r0, nreal);
      fence_async_smem();
      wg_sync(T.bar);  // the encoding (and, on the first tile, the unit's data) is written
      wide_tile(T, wr, r0, S, nrays, u.dirb, u.sig + r0, u.rgbr + 3 * r0, nullptr, 0);
    }
    composite_unit(p, u, ray0, nrays);
    wg_sync(T.bar);  // the next unit rewrites the unit's data
  }
  // worker C b has more tiles: release the pieces of its other passes
  const int per_pass = wide_fwd_pieces(hp, kx, nt, p.skip_mask);
  for (int c = mine * tiles * per_pass; c < passes * per_pass; ++c) {
    wr.acquire();
    wr.release();
  }
}

// The wide kernel's plan for a launch: consumers, stages, shared memory.
inline WidePlan wide_render_plan(int hidden, int dx, int dd, int n_samples, int rpu) {
  return wide_plan(wide_render_cons_bytes(hidden, (dx + kKc - 1) / kKc,
                                          unit_rows(rpu, n_samples), rpu, dd));
}

template <int NTM>
int occupancy(size_t smem, int* ctas) {
  cudaError_t err = cudaFuncSetAttribute(fused_render_bf16_kernel<NTM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, fused_render_bf16_kernel<NTM>,
                                                           kThreads, smem);
}

template <int NTM>
int launch(const Params& p, size_t smem, int grid, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(fused_render_bf16_kernel<NTM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (grid == 0) return 0;
  fused_render_bf16_kernel<NTM><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// The ring stages and shared memory of a launch: as many stages as fit, up
// to kMaxStages; 0 if the shape is not one the kernel takes or the ring
// cannot hold the chunks of one layer (a consumer waits for all of a
// layer's chunks before its products).
int stages_for(int hidden, int dx, int dd, int n_samples, int rpu, int num_trunk, int skip_mask,
               size_t* smem) {
  if (hidden % 32 != 0 || hidden < 32 || hidden > 128 || n_samples < 1 ||
      n_samples > kMaxSamples || rpu < 1 || rpu > kMaxRpu ||
      unit_rows(rpu, n_samples) > kMaxUnitRows || dx < 1 || dx > kMaxDx || dd < 0 ||
      num_trunk < 0 || num_trunk > 31) {
    return 0;
  }
  const int kx = (dx + kKc - 1) / kKc, kch = (hidden + kKc - 1) / kKc;
  int need = kx;  // the most chunks of one layer
  for (int l = 1; l <= num_trunk; ++l) {
    const int cur = kch + (((skip_mask >> (l - 1)) & 1) ? kx : 0);
    need = need > cur ? need : cur;
  }
  for (int ns = kMaxStages; ns >= need; --ns) {
    *smem = smem_layout(hidden, num_trunk, kx, unit_rows(rpu, n_samples), rpu, dd, ns).total;
    if (*smem <= (size_t)kSmemMax) return ns;
  }
  return 0;
}

// The wide kernel's ring stages, shared memory and consumers for a launch
// (see stages_for); 0 if the shape is not one it takes.
int wide_stages_for(int hidden, int dx, int dd, int n_samples, int rpu, int num_trunk,
                    size_t* smem, int* cons) {
  if (hidden % 32 != 0 || hidden <= 128 || hidden > kWideMaxHidden || n_samples < 1 ||
      n_samples > kMaxSamples || rpu < 1 || rpu > kMaxRpu ||
      unit_rows(rpu, n_samples) > kMaxUnitRows || dx < 1 || dx > kMaxDx || dd < 0 ||
      num_trunk < 0 || num_trunk > 31) {
    return 0;
  }
  const WidePlan w = wide_render_plan(hidden, dx, dd, n_samples, rpu);
  *smem = w.smem;
  *cons = w.cons;
  return w.stages;
}

int launch_wide(const Params& p, size_t smem, int cons, int grid, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(fused_render_wide_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (grid == 0) return 0;
  fused_render_wide_kernel<<<grid, 128 * (cons + 1), smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success); the launch is asynchronous on
// `stream`. Pointers named *_host are host arrays, copied into the kernel's
// parameter block. The work plan (ops/fused_render.py::render_plan): units
// of rays_per_unit rays, `grid` persistent CTAs.
int dexnerf_fused_render_bf16(const float* origins, const float* dirs, const float* viewdirs,
                              const float* z, const float* dists, const void* wq,
                              const float* aux, float* rgb, float* disp, float* acc,
                              float* depth, float* weights, float* dex, int n_rays,
                              int n_samples, int hidden, int num_trunk, int skip_mask,
                              int rays_per_unit, int grid, int fx, int inc_x,
                              const float* bands_x_host, int fd, int inc_d,
                              const float* bands_d_host, int n_thr, const float* thr_host,
                              const int* aux_off_host, int white_bg, void* stream) {
  Params p;
  p.origins = origins;
  p.dirs = dirs;
  p.viewdirs = viewdirs;
  p.z = z;
  p.dists = dists;
  p.wq = static_cast<const bf16*>(wq);
  p.aux = aux;
  p.rgb = rgb;
  p.disp = disp;
  p.acc = acc;
  p.depth = depth;
  p.weights = weights;
  p.dex = dex;
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
  p.n_stages =
      hidden > 128
          ? wide_stages_for(hidden, p.dx, p.dd, n_samples, rays_per_unit, num_trunk, &smem, &cons)
          : stages_for(hidden, p.dx, p.dd, n_samples, rays_per_unit, num_trunk, skip_mask, &smem);
  if (p.n_stages == 0 || n_rays < 0 || grid < 0 || (n_rays > 0 && grid < 1) ||
      num_trunk + 8 > kAux || fx > kMaxFreq || fd > kMaxFreq ||
      n_thr > kMaxThresholds || n_thr < 0 || (n_thr > 0 && dex == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  for (int i = 0; i < num_trunk + 8; ++i) p.aux_off[i] = aux_off_host[i];
  for (int f = 0; f < fx; ++f) p.bands_x[f] = bands_x_host[f];
  for (int f = 0; f < fd; ++f) p.bands_d[f] = bands_d_host[f];
  for (int t = 0; t < n_thr; ++t) p.thr[t] = thr_host[t];
  if (n_rays == 0) grid = 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hidden > 128) return launch_wide(p, smem, cons, grid, s);
  switch (hidden / 32) {
    case 1: return launch<2>(p, smem, grid, s);
    case 2: return launch<4>(p, smem, grid, s);
    case 3: return launch<6>(p, smem, grid, s);
    default: return launch<8>(p, smem, grid, s);
  }
}

// CTAs of the kernel that fit on one SM (registers, shared memory) for a
// model of width `hidden` with a dx-wide xyz and a dd-wide viewdir
// encoding, num_trunk trunk layers (skip_mask: those that read the
// encoding), units of `rays_per_unit` rays of `n_samples`; its
// shared-memory bytes per CTA into *smem_bytes and its ring stages into
// *stages.
int dexnerf_fused_render_bf16_occupancy(int hidden, int dx, int dd, int n_samples,
                                        int rays_per_unit, int num_trunk, int skip_mask,
                                        int* ctas, int* smem_bytes, int* stages) {
  size_t smem = 0;
  *stages =
      stages_for(hidden, dx, dd, n_samples, rays_per_unit, num_trunk, skip_mask, &smem);
  if (*stages == 0) return (int)cudaErrorInvalidValue;
  *smem_bytes = (int)smem;
  switch (hidden / 32) {
    case 1: return occupancy<2>(smem, ctas);
    case 2: return occupancy<4>(smem, ctas);
    case 3: return occupancy<6>(smem, ctas);
    default: return occupancy<8>(smem, ctas);
  }
}

// The same for the wide route (padded widths above 128), with its consumer
// warpgroups (the render plan's workers a CTA) into *cons.
int dexnerf_fused_render_bf16_wide_occupancy(int hidden, int dx, int dd, int n_samples,
                                             int rays_per_unit, int num_trunk, int* ctas,
                                             int* smem_bytes, int* stages, int* cons) {
  size_t smem = 0;
  *stages = wide_stages_for(hidden, dx, dd, n_samples, rays_per_unit, num_trunk, &smem, cons);
  if (*stages == 0) return (int)cudaErrorInvalidValue;
  *smem_bytes = (int)smem;
  const cudaError_t err = cudaFuncSetAttribute(
      fused_render_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, fused_render_wide_kernel,
                                                           128 * (*cons + 1), smem);
}

}  // extern "C"
