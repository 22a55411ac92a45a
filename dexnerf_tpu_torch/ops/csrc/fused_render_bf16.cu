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
// traffic: every 128-sample tile streams all ~311 KB of bf16 weights from
// L2 into shared memory (~2.4 GB per 1M samples).
//
// Design:
// * A CTA of 8 warps owns rpc whole rays (rpc * S <= 384 samples) and runs
//   them through the MLP in tiles of 128 samples: two rays of a coarse pass
//   (S = 64), one of a fine pass (S = 128), or three tiles for two rays of
//   S = 192, so each pass over the weights serves 128 samples. The wrapper
//   picks rpc to minimize the padded rows per ray (ops/fused_render.py).
// * Each layer is a [128 x K] x [K x N] product of mma.sync m16n8k16
//   (bf16 in, f32 accumulate), A and B fragments from shared memory by
//   ldmatrix. Warp w computes rows 32 (w % 4) .. +32 and columns
//   (w / 4) N/2 .. +N/2. Activations live in one bf16 buffer [128][H + 8]
//   (the 8-element pad makes ldmatrix and the fragment stores free of bank
//   conflicts), overwritten in place after a barrier: the f32 accumulator
//   gets bias and ReLU in registers and is stored as the next layer's bf16
//   operand. The xyz encoding has its own bf16 buffer [128][DXP + 8], K
//   zero-padded to a multiple of 32, read by layer1 and the skip layer.
// * Weights are packed once per model (ops/fused_render.py) in bf16 as
//   [N][32] K-chunks in consumption order and streamed through a ring of 4
//   shared-memory stages with cp.async: chunk c + 3 is in flight while the
//   MMAs of chunk c run, across layer and tile boundaries.
// * The heads run in f32 on the CUDA cores in the epilogues, from the f32
//   values in registers: sigma = a_last . w_alpha in the last trunk
//   layer's, rgb = y . w_rgb in the viewdir layer's (y itself is never
//   stored); lanes of a row reduce by shuffles, the two column halves in a
//   fixed order through shared memory. The viewdir part of layers_dir.0 is
//   folded into a per-ray bias from bf16-rounded encodings and weights with
//   an f32 sum.
// * pts = o + d*z and the PE arguments use __fmul_rn/__fadd_rn and the
//   accurate sincosf, in f32; only the encoding is rounded to bf16.
// * Compositing: one warp per ray, the transmittance as a warp product scan
//   over chunks of 32 samples, per-ray sums as fixed-order butterflies, the
//   Dex first crossing by warp ballots per threshold.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // 8 warps
constexpr int kTile = 128;      // samples per MLP tile
constexpr int kKc = 32;         // K per weight chunk
constexpr int kKP = kKc + 8;    // padded row of a stage, bf16 elements
constexpr int kStages = 4;      // weight ring depth
constexpr int kMaxRows = 384;   // samples per CTA
constexpr int kMaxRpc = 32;     // rays per CTA
constexpr int kMaxLayers = 40;
constexpr int kMaxFreq = 16;
constexpr int kMaxThresholds = 64;
constexpr int kMaxSamples = 256;
constexpr int kMaxDD = 3 + 6 * kMaxFreq;
constexpr int kAux = kMaxLayers + 8;

struct Params {
  const float* origins;   // [N, 3]
  const float* dirs;      // [N, 3]
  const float* viewdirs;  // [N, 3]
  const float* z;         // [N, S]
  const float* dists;     // [N, S]
  const __nv_bfloat16* wq;  // K-chunks, see ops/fused_render.py::pack_flex_weights_bf16
  const float* aux;       // f32 biases, heads, viewdir weights (bf16-rounded)
  float* rgb;             // [N, 3]
  float* disp;            // [N]
  float* acc;             // [N]
  float* depth;           // [N]
  float* weights;         // [N, S]
  float* dex;             // [T, N]
  int n_rays, n_samples, hidden, num_trunk, skip_mask, rpc;
  int dx, dxp, dd, fx, fd, inc_x, inc_d;
  int n_thr, white_bg;
  // aux offsets (floats): [0] layer1 bias, [1 + i] trunk i bias, then
  // fc_feat bias, layers_dir.0 bias, w_alpha [H], b_alpha, w_rgb [H/2][3],
  // b_rgb [3], viewdir rows of layers_dir.0 [dd][H/2]
  int aux_off[kAux];
  float bands_x[kMaxFreq];
  float bands_d[kMaxFreq];
  float thr[kMaxThresholds];
};

struct Smem {
  size_t act, enc, ring, psig, prgb, zs, ds, sig, rgbr, dirb, dtmp, total;
};

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

__host__ __device__ inline Smem smem_layout(int H, int dxp, int rows, int rpc) {
  Smem s;
  size_t o = 0;
  s.act = o;  o = align16(o + (size_t)kTile * (H + 8) * 2);
  s.enc = o;  o = align16(o + (size_t)kTile * (dxp + 8) * 2);
  s.ring = o; o = align16(o + (size_t)kStages * H * kKP * 2);
  s.psig = o; o = align16(o + 2 * kTile * 4);
  s.prgb = o; o = align16(o + 2 * kTile * 3 * 4);
  s.zs = o;   o = align16(o + (size_t)rows * 4);
  s.ds = o;   o = align16(o + (size_t)rows * 4);
  s.sig = o;  o = align16(o + (size_t)rows * 4);
  s.rgbr = o; o = align16(o + (size_t)rows * 3 * 4);
  s.dirb = o; o = align16(o + (size_t)rpc * (H / 2) * 4);
  s.dtmp = o; o = align16(o + kMaxDD * 4);
  s.total = o;
  return s;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The weight stream of one tile: chunk j of nch, each [rows][32] bf16
// contiguous. All chunks have H rows except the viewdir layer's last H/32,
// which have H/2.
struct Stream {
  const __nv_bfloat16* w;
  int H, nch, total;  // chunks per tile, chunks of the CTA
  __device__ void load(int c, __nv_bfloat16* ring) const {
    if (c < total) {
      const int j = c % nch;
      const int jd = nch - H / kKc;
      const size_t off = j < jd ? (size_t)j * H * kKc
                                : (size_t)jd * H * kKc + (size_t)(j - jd) * (H / 2) * kKc;
      const int rows = j < jd ? H : H / 2;
      const __nv_bfloat16* src = w + off;
      __nv_bfloat16* dst = ring + (size_t)(c % kStages) * H * kKP;
      for (int i = threadIdx.x; i < rows * (kKc / 8); i += kThreads) {
        const int n = i >> 2, part = i & 3;
        cp_async16(dst + n * kKP + part * 8, src + n * kKc + part * 8);
      }
    }
    cp_async_commit();  // empty groups past the end keep the count uniform
  }
};

// Consume chunk c: wait for it, let every warp finish chunk c - 1 (whose
// stage the next load refills), start chunk c + kStages - 1, then run this
// warp's MMAs of the chunk: A rows [32 wm, +32) and K [k0, k0 + 32) of the
// bf16 buffer `a` (pitch ap), B columns [nb, nb + 8 NT) of the stage.
template <int NT, int NTM>
__device__ __forceinline__ void consume(float (&acc)[2][NTM][4], int& c, const Stream& st,
                                        __nv_bfloat16* ring, const __nv_bfloat16* a, int ap,
                                        int k0, int wm, int nb) {
  cp_async_wait<kStages - 2>();
  __syncthreads();
  st.load(c + kStages - 1, ring);
  const __nv_bfloat16* b = ring + (size_t)(c % kStages) * st.H * kKP;
  ++c;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < kKc; kk += 16) {
    uint32_t af[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      ldsm_x4(af[mi], a + (32 * wm + 16 * mi + (lane & 15)) * ap + k0 + kk + ((lane >> 4) << 3));
    }
#pragma unroll
    for (int nj = 0; nj + 1 < NT; nj += 2) {
      uint32_t bf[4];
      ldsm_x4(bf, b + (nb + 8 * nj + (lane & 7) + ((lane >> 4) << 3)) * kKP + kk +
                      (((lane >> 3) & 1) << 3));
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        mma_bf16(acc[mi][nj], af[mi], bf[0], bf[1]);
        mma_bf16(acc[mi][nj + 1], af[mi], bf[2], bf[3]);
      }
    }
    if (NT & 1) {
      uint32_t bf[2];
      ldsm_x2(bf, b + (nb + 8 * (NT - 1) + (lane & 7)) * kKP + kk + (((lane >> 3) & 1) << 3));
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) mma_bf16(acc[mi][NT - 1], af[mi], bf[0], bf[1]);
    }
  }
}

template <int NTM>
__device__ __forceinline__ void zero(float (&acc)[2][NTM][4]) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < NTM; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.f;
}

// Epilogue of a hidden layer: v = act(acc + bias) in f32, stored as the
// bf16 operand of the next layer (in place; the caller has synchronized).
// With wa != null also the sigma head's partial sums v . wa of this warp's
// columns, per row, into psig[wn][row].
template <int NTM>
__device__ __forceinline__ void store_hidden(float (&acc)[2][NTM][4], const float* __restrict__ bias,
                                             bool relu, __nv_bfloat16* act, int ap, int wm,
                                             int nb, const float* __restrict__ wa, float* psig) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    float sp[2] = {0.f, 0.f};
#pragma unroll
    for (int nj = 0; nj < NTM; ++nj) {
      const int col = nb + 8 * nj + 2 * q;
      const float b0 = __ldg(bias + col), b1 = __ldg(bias + col + 1);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v0 = acc[mi][nj][2 * h] + b0, v1 = acc[mi][nj][2 * h + 1] + b1;
        if (relu) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        const int row = 32 * wm + 16 * mi + 8 * h + g;
        *reinterpret_cast<__nv_bfloat162*>(act + row * ap + col) = __floats2bfloat162_rn(v0, v1);
        if (wa != nullptr) sp[h] = fmaf(v1, __ldg(wa + col + 1), fmaf(v0, __ldg(wa + col), sp[h]));
      }
    }
    if (wa != nullptr) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float s = sp[h];
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        if (q == 0) psig[(nb != 0) * kTile + 32 * wm + 16 * mi + 8 * h + g] = s;
      }
    }
  }
}

template <int NTM>
__global__ void __launch_bounds__(kThreads, 2) fused_render_bf16_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int H = NTM * 16;
  constexpr int H2 = H / 2;
  constexpr int NTD = NTM / 2;  // n-tiles of the viewdir layer (N = H/2)
  constexpr int AP = H + 8;
  const int S = p.n_samples, nt = p.num_trunk, rpc = p.rpc;
  const int rows = rpc * S;
  const int EP = p.dxp + 8;
  const Smem L = smem_layout(H, p.dxp, rows, rpc);
  __nv_bfloat16* act = reinterpret_cast<__nv_bfloat16*>(smem + L.act);
  __nv_bfloat16* enc = reinterpret_cast<__nv_bfloat16*>(smem + L.enc);
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem + L.ring);
  float* psig = reinterpret_cast<float*>(smem + L.psig);  // [2][kTile]
  float* prgb = reinterpret_cast<float*>(smem + L.prgb);  // [2][kTile][3]
  float* zs = reinterpret_cast<float*>(smem + L.zs);      // [rows]
  float* ds = reinterpret_cast<float*>(smem + L.ds);
  float* sig = reinterpret_cast<float*>(smem + L.sig);    // raw sigma logits
  float* rgbr = reinterpret_cast<float*>(smem + L.rgbr);  // [rows][3] raw rgb logits
  float* dirb = reinterpret_cast<float*>(smem + L.dirb);  // [rpc][H2]
  float* dtmp = reinterpret_cast<float*>(smem + L.dtmp);  // [dd]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int ray0 = blockIdx.x * rpc;
  const int nrays = min(rpc, p.n_rays - ray0);
  const int ntiles = (rows + kTile - 1) / kTile;
  const int kx = p.dxp / kKc, kh = H / kKc;
  int nskip = 0;
  for (int i = 0; i < nt; ++i) nskip += (p.skip_mask >> i) & 1;
  Stream st;
  st.w = p.wq;
  st.H = H;
  st.nch = kx * (1 + nskip) + (nt + 2) * kh;
  st.total = ntiles * st.nch;
  // the first chunks go out before anything else
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) st.load(c, ring);

  for (int i = tid; i < kTile * EP; i += kThreads) enc[i] = __float2bfloat16_rn(0.f);
  for (int r = tid; r < rows; r += kThreads) {
    const bool ok = r / S < nrays;
    zs[r] = ok ? p.z[(size_t)ray0 * S + r] : 0.f;
    ds[r] = ok ? p.dists[(size_t)ray0 * S + r] : 0.f;
  }
  // per-ray bias of the viewdir layer: its viewdir rows meet the per-ray
  // encoding (rounded to bf16, as the weights are)
  const float* aux = p.aux;
  const float* wdv = aux + p.aux_off[nt + 7];
  const float* bdir = aux + p.aux_off[nt + 2];
  for (int r = 0; r < rpc; ++r) {
    __syncthreads();
    if (tid < 3) {
      const float v = r < nrays ? p.viewdirs[(size_t)(ray0 + r) * 3 + tid] : 0.f;
      int row = 0;
      if (p.inc_d) {
        dtmp[tid] = v;
        row = 3;
      }
      for (int f = 0; f < p.fd; ++f) {
        float sn, cs;
        sincosf(__fmul_rn(v, p.bands_d[f]), &sn, &cs);
        dtmp[row + 6 * f + tid] = sn;
        dtmp[row + 6 * f + 3 + tid] = cs;
      }
    }
    __syncthreads();
    for (int c = tid; c < H2; c += kThreads) {
      float v = __ldg(bdir + c);
      for (int k = 0; k < p.dd; ++k) {
        v = fmaf(__bfloat162float(__float2bfloat16_rn(dtmp[k])), __ldg(wdv + k * H2 + c), v);
      }
      dirb[r * H2 + c] = v;
    }
  }
  __syncthreads();

  const float* b_feat = aux + p.aux_off[nt + 1];
  const float* w_alpha = aux + p.aux_off[nt + 3];
  const float b_alpha = __ldg(aux + p.aux_off[nt + 4]);
  const float* w_rgb = aux + p.aux_off[nt + 5];
  const float* b_rgb = aux + p.aux_off[nt + 6];
  const int nbm = wn * (H / 2);  // this warp's first column, hidden layers
  const int nbd = wn * (H2 / 2);  // and the viewdir layer's
  float acc[2][NTM][4];
  int c = 0;
  for (int tile = 0; tile < ntiles; ++tile) {
    // ---- positional encoding of the tile's samples, f32, rounded to bf16
    for (int i = tid; i < kTile * 3; i += kThreads) {
      const int r = i % kTile, d = i / kTile;
      const int fr = tile * kTile + r;
      const int ray = fr / S;
      __nv_bfloat16* e = enc + r * EP;
      if (fr < rows && ray < nrays) {
        const float pt = __fadd_rn(p.origins[(size_t)(ray0 + ray) * 3 + d],
                                   __fmul_rn(p.dirs[(size_t)(ray0 + ray) * 3 + d], zs[fr]));
        int col = 0;
        if (p.inc_x) {
          e[d] = __float2bfloat16_rn(pt);
          col = 3;
        }
        for (int f = 0; f < p.fx; ++f) {
          float sn, cs;
          sincosf(__fmul_rn(pt, p.bands_x[f]), &sn, &cs);
          e[col + 6 * f + d] = __float2bfloat16_rn(sn);
          e[col + 6 * f + 3 + d] = __float2bfloat16_rn(cs);
        }
      } else {
        for (int k = d; k < p.dx; k += 3) e[k] = __float2bfloat16_rn(0.f);
      }
    }
    // (the first consume's barrier orders these stores before the reads)

    // ---- layer1: no activation
    zero(acc);
    for (int k = 0; k < kx; ++k) consume<NTM>(acc, c, st, ring, enc, EP, k * kKc, wm, nbm);
    __syncthreads();
    store_hidden(acc, aux + p.aux_off[0], false, act, AP, wm, nbm,
                 nt == 0 ? w_alpha : nullptr, psig);
    // ---- trunk
    for (int i = 0; i < nt; ++i) {
      zero(acc);
      for (int k = 0; k < kh; ++k) consume<NTM>(acc, c, st, ring, act, AP, k * kKc, wm, nbm);
      if ((p.skip_mask >> i) & 1) {
        for (int k = 0; k < kx; ++k) consume<NTM>(acc, c, st, ring, enc, EP, k * kKc, wm, nbm);
      }
      __syncthreads();
      store_hidden(acc, aux + p.aux_off[1 + i], true, act, AP, wm, nbm,
                   i == nt - 1 ? w_alpha : nullptr, psig);
    }
    // ---- fc_feat
    zero(acc);
    for (int k = 0; k < kh; ++k) consume<NTM>(acc, c, st, ring, act, AP, k * kKc, wm, nbm);
    __syncthreads();
    store_hidden(acc, b_feat, true, act, AP, wm, nbm, nullptr, psig);
    // ---- layers_dir.0 on feat, + the per-ray bias; rgb head from registers
    zero(acc);
    for (int k = 0; k < kh; ++k) consume<NTD>(acc, c, st, ring, act, AP, k * kKc, wm, nbd);
    {
      const int g = lane >> 2, q = lane & 3;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = 32 * wm + 16 * mi + 8 * h + g;
          const int ray = min((tile * kTile + row) / S, rpc - 1);
          float s0 = 0.f, s1 = 0.f, s2 = 0.f;
#pragma unroll
          for (int nj = 0; nj < NTD; ++nj) {
            const int col = nbd + 8 * nj + 2 * q;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float y = fmaxf(acc[mi][nj][2 * h + e] + dirb[ray * H2 + col + e], 0.f);
              const float* wr = w_rgb + (col + e) * 3;
              s0 = fmaf(y, __ldg(wr), s0);
              s1 = fmaf(y, __ldg(wr + 1), s1);
              s2 = fmaf(y, __ldg(wr + 2), s2);
            }
          }
#pragma unroll
          for (int x = 1; x < 4; x <<= 1) {
            s0 += __shfl_xor_sync(0xffffffffu, s0, x);
            s1 += __shfl_xor_sync(0xffffffffu, s1, x);
            s2 += __shfl_xor_sync(0xffffffffu, s2, x);
          }
          if (q == 0) {
            float* o = prgb + (wn * kTile + row) * 3;
            o[0] = s0;
            o[1] = s1;
            o[2] = s2;
          }
        }
      }
    }
    __syncthreads();
    for (int r = tid; r < kTile; r += kThreads) {
      const int fr = tile * kTile + r;
      if (fr < rows) {
        sig[fr] = (psig[r] + psig[kTile + r]) + b_alpha;
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          rgbr[fr * 3 + j] = (prgb[r * 3 + j] + prgb[(kTile + r) * 3 + j]) + __ldg(b_rgb + j);
        }
      }
    }
    // the next tile's encoding overwrites enc: every warp is past the
    // skip layer here (barriers above); psig/prgb are rewritten only after
    // further barriers
  }
  cp_async_wait<0>();
  __syncthreads();

  // ---- compositing, one warp per ray
  const int N = p.n_rays;
  for (int r = warp; r < nrays; r += kThreads / 32) {
    const int base = r * S;
    const size_t ray = (size_t)ray0 + r;
    float carry = 1.f, rr = 0.f, gg = 0.f, bb = 0.f, dep = 0.f, ac = 0.f;
    for (int s0 = 0; s0 < S; s0 += 32) {
      const int s = s0 + lane;
      const bool ok = s < S;
      const float sigma = ok ? fmaxf(sig[base + s], 0.f) : 0.f;
      const float alpha = ok ? 1.f - expf(-sigma * ds[base + s]) : 0.f;
      float incl = ok ? (1.f - alpha) + 1e-10f : 1.f;
#pragma unroll
      for (int x = 1; x < 32; x <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, incl, x);
        if (lane >= x) incl *= t;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = 1.f;
      const float w = alpha * (carry * excl);
      carry *= __shfl_sync(0xffffffffu, incl, 31);
      if (ok) {
        p.weights[ray * S + s] = w;
        const float* raw = rgbr + (base + s) * 3;
        rr += w * (1.f / (1.f + expf(-raw[0])));
        gg += w * (1.f / (1.f + expf(-raw[1])));
        bb += w * (1.f / (1.f + expf(-raw[2])));
        dep += w * zs[base + s];
        ac += w;
      }
    }
#pragma unroll
    for (int x = 16; x > 0; x >>= 1) {
      rr += __shfl_xor_sync(0xffffffffu, rr, x);
      gg += __shfl_xor_sync(0xffffffffu, gg, x);
      bb += __shfl_xor_sync(0xffffffffu, bb, x);
      dep += __shfl_xor_sync(0xffffffffu, dep, x);
      ac += __shfl_xor_sync(0xffffffffu, ac, x);
    }
    if (lane == 0) {
      if (p.white_bg) {
        rr += 1.f - ac;
        gg += 1.f - ac;
        bb += 1.f - ac;
      }
      p.rgb[ray * 3] = rr;
      p.rgb[ray * 3 + 1] = gg;
      p.rgb[ray * 3 + 2] = bb;
      p.depth[ray] = dep;
      p.acc[ray] = ac;
      p.disp[ray] = 1.f / fmaxf(1e-10f, dep / fmaxf(ac, 1e-37f));
    }
    // Dex: the first sample whose sigma exceeds m (no hit -> z[0])
    for (int t = 0; t < p.n_thr; ++t) {
      const float m = p.thr[t];
      float hit = zs[base];
      for (int s0 = 0; s0 < S; s0 += 32) {
        const int s = s0 + lane;
        const unsigned b = __ballot_sync(0xffffffffu, s < S && fmaxf(sig[base + s], 0.f) > m);
        if (b) {
          hit = zs[base + s0 + __ffs(b) - 1];
          break;
        }
      }
      if (lane == 0) p.dex[(size_t)t * N + ray] = hit;
    }
  }
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

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success); the launch is asynchronous on
// `stream`. Pointers named *_host are host arrays, copied into the kernel's
// parameter block. `rpc` rays per CTA (rpc * n_samples <= 384).
int dexnerf_fused_render_bf16(const float* origins, const float* dirs, const float* viewdirs,
                              const float* z, const float* dists, const void* wq,
                              const float* aux, float* rgb, float* disp, float* acc,
                              float* depth, float* weights, float* dex, int n_rays,
                              int n_samples, int hidden, int num_trunk, int skip_mask, int rpc,
                              int fx, int inc_x, const float* bands_x_host, int fd, int inc_d,
                              const float* bands_d_host, int n_thr, const float* thr_host,
                              const int* aux_off_host, int white_bg, void* stream) {
  Params p;
  p.origins = origins;
  p.dirs = dirs;
  p.viewdirs = viewdirs;
  p.z = z;
  p.dists = dists;
  p.wq = static_cast<const __nv_bfloat16*>(wq);
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
  p.rpc = rpc;
  p.fx = fx;
  p.fd = fd;
  p.inc_x = inc_x;
  p.inc_d = inc_d;
  p.dx = 3 * inc_x + 6 * fx;
  p.dxp = (p.dx + kKc - 1) / kKc * kKc;
  p.dd = 3 * inc_d + 6 * fd;
  p.n_thr = n_thr;
  p.white_bg = white_bg;
  if (n_samples < 1 || n_samples > kMaxSamples || rpc < 1 || rpc > kMaxRpc ||
      rpc * n_samples > kMaxRows || num_trunk < 0 || num_trunk > 31 ||
      num_trunk + 8 > kAux || fx > kMaxFreq || fd > kMaxFreq || p.dx < 1 ||
      n_thr > kMaxThresholds || n_thr < 0 || (n_thr > 0 && dex == nullptr) ||
      hidden % 32 != 0 || hidden < 32 || hidden > 128) {
    return (int)cudaErrorInvalidValue;
  }
  for (int i = 0; i < num_trunk + 8; ++i) p.aux_off[i] = aux_off_host[i];
  for (int f = 0; f < fx; ++f) p.bands_x[f] = bands_x_host[f];
  for (int f = 0; f < fd; ++f) p.bands_d[f] = bands_d_host[f];
  for (int t = 0; t < n_thr; ++t) p.thr[t] = thr_host[t];
  const size_t smem = smem_layout(hidden, p.dxp, rpc * n_samples, rpc).total;
  const int grid = (n_rays + rpc - 1) / rpc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hidden / 32) {
    case 1: return launch<2>(p, smem, grid, s);
    case 2: return launch<4>(p, smem, grid, s);
    case 3: return launch<6>(p, smem, grid, s);
    default: return launch<8>(p, smem, grid, s);
  }
}

// CTAs of the kernel that fit on one SM (registers, shared memory) for a
// model of width `hidden` with a dx-wide xyz encoding, `rpc` rays of
// `n_samples` per CTA; its shared-memory bytes per CTA into *smem_bytes.
int dexnerf_fused_render_bf16_occupancy(int hidden, int dx, int n_samples, int rpc,
                                        int* ctas, int* smem_bytes) {
  if (hidden % 32 != 0 || hidden < 32 || hidden > 128) return (int)cudaErrorInvalidValue;
  const int dxp = (dx + kKc - 1) / kKc * kKc;
  const size_t smem = smem_layout(hidden, dxp, rpc * n_samples, rpc).total;
  *smem_bytes = (int)smem;
  switch (hidden / 32) {
    case 1: return occupancy<2>(smem, ctas);
    case 2: return occupancy<4>(smem, ctas);
    case 3: return occupancy<6>(smem, ctas);
    default: return occupancy<8>(smem, ctas);
  }
}

}  // extern "C"
