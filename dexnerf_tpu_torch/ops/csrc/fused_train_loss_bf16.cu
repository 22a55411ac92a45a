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
// What bounds it on the H100: the bf16 multiply-adds of the forward, the
// chain and the weight gradients (1.42 TFLOP per train step of the 8x128
// model at batch 8192 with 64 + 128 samples per ray, 1.435 ms at the 989
// TFLOP/s dense bf16 peak, 700 W), then the bf16 scratch: ~5 KB per sample
// written and read back once (~15 GB a step, >= 4.7 ms at 3.35 TB/s).
//
// Design, one group of launches per chunk of rays (the scratch is capped by
// ops/fused_train_loss.py's SCRATCH_SAMPLES), rows of the scratch = the
// chunk's samples, ray-major (row k = ray * S + s), padded to whole
// 128-sample tiles:
// * train_prep_kernel: per ray, the viewdir encoding (f32 sincosf, rounded
//   to bf16) and the viewdir layer's per-ray bias.
// * train_fwd_bf16_kernel: one CTA of 8 warps per 128-sample tile,
//   fused_render_bf16.cu's tile design: mma.sync m16n8k16 (bf16 in, f32
//   accumulate) with ldmatrix, weights as [N][32] K-chunks streamed through
//   a 4-stage cp.async ring, heads in f32 from the accumulators. Every
//   layer's bf16 activations are copied to the scratch with streaming
//   stores (__stcs), sample-major [row][feature], and the raw outputs
//   (rgb logits, sigma logit) go to an f32 [rows][4] buffer.
// * train_composite_kernel: one warp per ray, f32: the transmittance as a
//   warp product scan, the loss, and the compositing backward (the suffix
//   sum as a warp scan from the last sample), giving the f32 cotangent of
//   each sample's raw output.
// * train_chain_bf16_kernel: persistent CTAs (fixed tiles each), the
//   cotangent chain tile by tile on mma.sync against a bf16 pack of the
//   transposed weights (ops/fused_train_loss.py::pack_backward_weights_bf16)
//   streamed through the same ring; the rgb head's chain (3 wide) and the
//   sigma head's term (gs x w_alpha) are f32. Each layer's cotangent is
//   rounded to bf16 and copied to the scratch; the bias sums (f32
//   cotangents) and the viewdir rows' dW (bf16 encoding x the ray's sum of
//   bf16 cotangents) accumulate per CTA in a fixed order into its own
//   slot.
// * train_dw_bf16_kernel: dW = cotangents^T x activations over the chunk's
//   samples, one 64 x 64 tile and one K-range per CTA (ldmatrix.trans from
//   the sample-major scratch, mma.sync), each K-range into its own slot of
//   partial sums: no atomics.
// * reduce_bf16_kernel sums the slots (weights) and the chain CTAs' slots
//   (biases, viewdir rows) in a fixed order: runs are bitwise repeatable.
// Hidden widths that are not a multiple of 32 run zero-padded to one
// (exact: padded units are ReLU(0 + 0) = 0 and meet zero weights).
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;  // 8 warps: forward and chain
constexpr int kTile = 128;     // samples per MLP tile
constexpr int kKc = 32;        // K per weight chunk
constexpr int kKP = kKc + 8;   // padded row of a ring stage, bf16 elements
constexpr int kStages = 4;     // weight ring depth
constexpr int kMaxLayers = 40;
constexpr int kMaxFreq = 16;
constexpr int kMaxSamples = 256;
constexpr int kMaxDD = 3 + 6 * kMaxFreq;
constexpr int kAux = kMaxLayers + 8;
constexpr int kMaxBlocks = kMaxLayers + 8;
constexpr int kMaxItems = 40;
constexpr int kRayWarps = 4;   // composite: rays per CTA, one warp each
constexpr int kPrepWarps = 8;  // prep: rays per CTA
constexpr int kGT = 64;        // dW tile edge
constexpr int kGK = 32;        // dW k-step
constexpr int kGP = kGT + 8;   // padded row of a dW operand stage
constexpr int kGemmThreads = 128;
constexpr int kSumThreads = 1024;
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
  const bf16* wq;           // forward K-chunks, ops/fused_render.py::pack_flex_weights_bf16
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
  // element offsets in scratch: act e, a_0..a_nt, feat, y; dlt d_0..d_nt,
  // feat, y, rgb (8 wide), sigma (8 wide)
  long long act_off[kMaxBlocks];
  long long dlt_off[kMaxBlocks];
  int ray0, n_rays, n_samples, hidden, num_trunk, skip_mask;
  int fx, fd, inc_x, inc_d, dx, dxp, dd;
  int white_bg, luma, has_noise, has_depth, chain_ctas;
  int aux_off[kAux];
  float bands_x[kMaxFreq];
  float bands_d[kMaxFreq];
};

// One dW product: out[w_off + n * ldw + col_off + m] = sum_k d[k][n] a[k][m]
// for n < N, m < M. Mirrored by ops/fused_train_loss.py::_Bf16GemmItem.
struct GemmItem {
  const bf16* d;  // [K][ldd] cotangents (the layer's output side)
  const bf16* a;  // [K][lda] activations (its input)
  int ldd, lda;
  int n, m, m_tiles, tile0;
  int w_off, ldw, col_off, pad;
};

struct GemmArgs {
  GemmItem items[kMaxItems];
  float* partial;  // [parts][n_params]
  long long n_params, k;
  int n_items, n_splits, part0, pad;
};

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}
// 16 bytes, or zeros when !ok (nothing is read then)
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 16 : 0));
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
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
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

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The weight stream of one tile: chunk j of nch, each [rows][32] bf16
// contiguous; chunks before jd have H rows, the rest H/2 (the forward's
// viewdir layer; the backward stream has jd = nch).
struct Stream {
  const bf16* w;
  int H, nch, jd, total;  // chunks per tile, chunks of the CTA
  __device__ void load(int c, bf16* ring) const {
    if (c < total) {
      const int j = c % nch;
      const size_t off = j < jd ? (size_t)j * H * kKc
                                : (size_t)jd * H * kKc + (size_t)(j - jd) * (H / 2) * kKc;
      const int rows = j < jd ? H : H / 2;
      const bf16* src = w + off;
      bf16* dst = ring + (size_t)(c % kStages) * H * kKP;
      for (int i = threadIdx.x; i < rows * (kKc / 8); i += kThreads) {
        const int n = i >> 2, part = i & 3;
        cp_async16(dst + n * kKP + part * 8, src + n * kKc + part * 8);
      }
    }
    cp_async_commit();  // empty groups past the end keep the count uniform
  }
};

// Consume chunk c (as fused_render_bf16.cu): wait for it, let every warp
// finish chunk c - 1 (whose stage the next load refills), start chunk
// c + kStages - 1, then this warp's MMAs of the chunk: A rows [32 wm, +32)
// and K [k0, k0 + 32) of the bf16 buffer `a` (pitch ap), B columns
// [nb, nb + 8 NT) of the stage.
template <int NT, int NTM>
__device__ __forceinline__ void consume(float (&acc)[2][NTM][4], int& c, const Stream& st,
                                        bf16* ring, const bf16* a, int ap, int k0, int wm,
                                        int nb) {
  cp_async_wait<kStages - 2>();
  __syncthreads();
  st.load(c + kStages - 1, ring);
  const bf16* b = ring + (size_t)(c % kStages) * st.H * kKP;
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

// Epilogue of a hidden forward layer: v = act(acc + bias) in f32, stored as
// the bf16 operand of the next layer (in place; the caller has synced).
// With wa != null also the sigma head's partial sums v . wa of this warp's
// columns, per row, into psig[wn][row].
template <int NTM>
__device__ __forceinline__ void store_hidden(float (&acc)[2][NTM][4],
                                             const float* __restrict__ bias, bool relu,
                                             bf16* act, int ap, int wm, int nb,
                                             const float* __restrict__ wa, float* psig) {
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

// The tile's [kTile][width] bf16 block from shared memory (pitch `pitch`)
// to the scratch rows at dst, 16 bytes per store, streaming: the scratch is
// read back by other kernels and must not evict the weights from L2.
__device__ __forceinline__ void copy_tile(const bf16* src, int pitch, bf16* dst, int width) {
  const int per_row = width / 8;
  for (int i = threadIdx.x; i < kTile * per_row; i += kThreads) {
    const int r = i / per_row, c = (i % per_row) * 8;
    __stcs(reinterpret_cast<float4*>(dst + (size_t)r * width + c),
           *reinterpret_cast<const float4*>(src + r * pitch + c));
  }
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

struct FwdSmem {
  size_t act, enc, ring, psig, prgb, total;
};

__host__ __device__ inline FwdSmem fwd_smem(int H, int dxp) {
  FwdSmem s;
  s.act = 0;
  s.enc = s.act + (size_t)kTile * (H + 8) * 2;
  s.ring = s.enc + (size_t)kTile * (dxp + 8) * 2;
  s.psig = s.ring + (size_t)kStages * H * kKP * 2;
  s.prgb = s.psig + 2 * kTile * 4;
  s.total = s.prgb + 2 * kTile * 3 * 4;
  return s;
}

// ---- forward of one 128-sample tile (rows k0 .. k0 + 127 of the chunk;
// rows >= n_real are padding with a zero encoding). kOwner: the points are
// o + d z (kLoss) or pts (the fields); the activations go to the scratch
// (kLoss, kFieldBwd) or nowhere (kFieldFwd); raw goes to [tiles * 128][4]
// (kLoss), to the [n_real][4] output (kFieldFwd) or nowhere (kFieldBwd).
template <int kOwner, int NTM>
__global__ void __launch_bounds__(kThreads, 2) train_fwd_bf16_kernel(const TrainArgs p,
                                                                     int n_real) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kSave = kOwner != kFieldFwd;
  constexpr int H = NTM * 16;
  constexpr int H2 = H / 2;
  constexpr int NTD = NTM / 2;  // n-tiles of the viewdir layer (N = H/2)
  constexpr int AP = H + 8;
  const int S = p.n_samples, nt = p.num_trunk;
  const int EP = p.dxp + 8;
  const FwdSmem L = fwd_smem(H, p.dxp);
  bf16* act = reinterpret_cast<bf16*>(smem + L.act);
  bf16* enc = reinterpret_cast<bf16*>(smem + L.enc);
  bf16* ring = reinterpret_cast<bf16*>(smem + L.ring);
  float* psig = reinterpret_cast<float*>(smem + L.psig);  // [2][kTile]
  float* prgb = reinterpret_cast<float*>(smem + L.prgb);  // [2][kTile][3]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const long long k0 = (long long)blockIdx.x * kTile;
  const int kx = p.dxp / kKc, kh = H / kKc;
  int nskip = 0;
  for (int i = 0; i < nt; ++i) nskip += (p.skip_mask >> i) & 1;
  Stream st;
  st.w = p.wq;
  st.H = H;
  st.nch = kx * (1 + nskip) + (nt + 2) * kh;
  st.jd = st.nch - kh;
  st.total = st.nch;
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) st.load(c, ring);

  // ---- positional encoding of the tile's samples, f32, rounded to bf16
  for (int i = tid; i < kTile * EP; i += kThreads) enc[i] = __float2bfloat16_rn(0.f);
  __syncthreads();
  for (int i = tid; i < kTile * 3; i += kThreads) {
    const int r = i % kTile, d = i / kTile;
    const long long k = k0 + r;
    if (k < n_real) {
      const long long ray = (long long)p.ray0 + k / p.n_samples;
      const float pt = kOwner != kLoss
                           ? p.pts[((long long)p.ray0 * S + k) * 3 + d]
                           : __fadd_rn(p.origins[ray * 3 + d],
                                       __fmul_rn(p.dirs[ray * 3 + d],
                                                 p.z[(long long)p.ray0 * S + k]));
      bf16* e = enc + r * EP;
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
    }
  }
  __syncthreads();
  if (kSave) copy_tile(enc, EP, p.scratch + p.act_off[0] + k0 * p.dxp, p.dxp);

  const float* aux = p.aux;
  const float* w_alpha = aux + p.aux_off[nt + 3];
  const int nbm = wn * (H / 2);   // this warp's first column, hidden layers
  const int nbd = wn * (H2 / 2);  // and the viewdir layer's
  float acc[2][NTM][4];
  int c = 0;
  // ---- layer1: no activation
  zero(acc);
  for (int k = 0; k < kx; ++k) consume<NTM>(acc, c, st, ring, enc, EP, k * kKc, wm, nbm);
  __syncthreads();
  store_hidden(acc, aux + p.aux_off[0], false, act, AP, wm, nbm, nt == 0 ? w_alpha : nullptr,
               psig);
  __syncthreads();
  if (kSave) copy_tile(act, AP, p.scratch + p.act_off[1] + k0 * H, H);
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
    __syncthreads();
    if (kSave) copy_tile(act, AP, p.scratch + p.act_off[2 + i] + k0 * H, H);
  }
  // ---- fc_feat
  zero(acc);
  for (int k = 0; k < kh; ++k) consume<NTM>(acc, c, st, ring, act, AP, k * kKc, wm, nbm);
  __syncthreads();
  store_hidden(acc, aux + p.aux_off[nt + 1], true, act, AP, wm, nbm, nullptr, psig);
  __syncthreads();
  if (kSave) copy_tile(act, AP, p.scratch + p.act_off[nt + 2] + k0 * H, H);
  // ---- layers_dir.0 on feat, + the per-ray bias; rgb head from the f32
  // values, then y rounded to bf16 for the scratch
  zero(acc);
  for (int k = 0; k < kh; ++k) consume<NTD>(acc, c, st, ring, act, AP, k * kKc, wm, nbd);
  const float* w_rgb = aux + p.aux_off[nt + 5];
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 32 * wm + 16 * mi + 8 * h + g;
      const long long ray = min((k0 + row) / S, (long long)p.n_rays - 1);
      const float* db = p.dirb + ray * H2;
      float s0 = 0.f, s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int nj = 0; nj < NTD; ++nj) {
        const int col = nbd + 8 * nj + 2 * q;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float y = fmaxf(acc[mi][nj][2 * h + e] + __ldg(db + col + e), 0.f);
          acc[mi][nj][2 * h + e] = y;
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
  __syncthreads();  // every warp is done reading feat from act
  if (kSave) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int nj = 0; nj < NTD; ++nj) {
        const int col = nbd + 8 * nj + 2 * q;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = 32 * wm + 16 * mi + 8 * h + g;
          *reinterpret_cast<__nv_bfloat162*>(act + row * AP + col) =
              __floats2bfloat162_rn(acc[mi][nj][2 * h], acc[mi][nj][2 * h + 1]);
        }
      }
    }
    __syncthreads();
    copy_tile(act, AP, p.scratch + p.act_off[nt + 3] + k0 * H2, H2);
  }
  const float b_alpha = __ldg(aux + p.aux_off[nt + 4]);
  const float* b_rgb = aux + p.aux_off[nt + 6];
  for (int r = tid; r < kTile; r += kThreads) {
    if (kOwner == kFieldBwd || (kOwner == kFieldFwd && k0 + r >= n_real)) break;
    float4 o;
    o.x = (prgb[r * 3] + prgb[(kTile + r) * 3]) + __ldg(b_rgb);
    o.y = (prgb[r * 3 + 1] + prgb[(kTile + r) * 3 + 1]) + __ldg(b_rgb + 1);
    o.z = (prgb[r * 3 + 2] + prgb[(kTile + r) * 3 + 2]) + __ldg(b_rgb + 2);
    o.w = (psig[r] + psig[kTile + r]) + b_alpha;
    reinterpret_cast<float4*>(p.raw)[k0 + r] = o;
  }
  cp_async_wait<0>();
}

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

// ---- compositing, loss and compositing backward, f32, one warp per ray:
// weights, rgb and the per-ray loss out, and the cotangent of each
// sample's raw output (rgb logits, sigma logit) into graw. The guarded
// cumprod (1 - alpha + 1e-10), differentiated exactly: -suffix / (1 -
// alpha + 1e-10).
__global__ void __launch_bounds__(kRayWarps * 32) train_composite_kernel(const TrainArgs p) {
  extern __shared__ float csm[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = blockIdx.x * kRayWarps + warp;
  if (r >= p.n_rays) return;
  const int S = p.n_samples;
  float* sw = csm + (size_t)warp * 7 * S;  // weights
  float* stn = sw + S;                      // transmittance before the sample
  float* sal = stn + S;                     // alpha
  float* ssg = sal + S;                     // sigma logit + noise
  float* sc = ssg + S;                      // [3][S] sigmoid(rgb logits)
  const long long ray = (long long)p.ray0 + r;
  const float4* raw = reinterpret_cast<const float4*>(p.raw) + (size_t)r * S;
  float carry = 1.f, rr = 0.f, gg = 0.f, bb = 0.f, dep = 0.f, ac = 0.f;
  for (int s0 = 0; s0 < S; s0 += 32) {
    const int s = s0 + lane;
    const bool ok = s < S;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    float sp = 0.f, ds = 0.f;
    if (ok) {
      v = raw[s];
      sp = v.w + (p.has_noise ? p.noise[ray * S + s] : 0.f);
      ds = p.dists[ray * S + s];
    }
    const float alpha = ok ? 1.f - expf(-fmaxf(sp, 0.f) * ds) : 0.f;
    float incl = ok ? (1.f - alpha) + 1e-10f : 1.f;
#pragma unroll
    for (int x = 1; x < 32; x <<= 1) {
      const float t = __shfl_up_sync(0xffffffffu, incl, x);
      if (lane >= x) incl *= t;
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 1.f;
    const float tr = carry * excl;
    const float w = alpha * tr;
    carry *= __shfl_sync(0xffffffffu, incl, 31);
    if (ok) {
      const float c0 = sigmoidf(v.x), c1 = sigmoidf(v.y), c2 = sigmoidf(v.z);
      sw[s] = w;
      stn[s] = tr;
      sal[s] = alpha;
      ssg[s] = sp;
      sc[s] = c0;
      sc[S + s] = c1;
      sc[2 * S + s] = c2;
      p.weights_out[ray * S + s] = w;
      rr += w * c0;
      gg += w * c1;
      bb += w * c2;
      dep += w * p.z[ray * S + s];
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
  if (p.white_bg) {
    rr += 1.f - ac;
    gg += 1.f - ac;
    bb += 1.f - ac;
  }
  const float e0 = rr - p.target[ray * 3];
  const float e1 = gg - p.target[ray * 3 + 1];
  const float e2 = bb - p.target[ray * 3 + 2];
  float loss, g0, g1, g2;
  if (p.luma) {  // Rec.601 luminance of the error
    const float ey = 0.299f * e0 + 0.587f * e1 + 0.114f * e2;
    loss = ey * ey;
    g0 = 2.f * ey * 0.299f;
    g1 = 2.f * ey * 0.587f;
    g2 = 2.f * ey * 0.114f;
  } else {
    loss = e0 * e0 + e1 * e1 + e2 * e2;
    g0 = 2.f * e0;
    g1 = 2.f * e1;
    g2 = 2.f * e2;
  }
  float gdep = 0.f;
  if (p.has_depth) {
    const float cf = p.depth_coef[ray];
    const float ed = dep - p.depth_gt[ray];
    loss += cf * ed * ed;
    gdep = 2.f * cf * ed;
  }
  if (lane == 0) {
    p.loss_ray[ray] = loss;
    p.rgb_out[ray * 3] = rr;
    p.rgb_out[ray * 3 + 1] = gg;
    p.rgb_out[ray * 3 + 2] = bb;
  }
  const float gsum = g0 + g1 + g2;  // d loss / d acc under a white background
  __syncwarp();
  // backward, chunks from the last: suffix_s = sum over later samples of gw w
  float4* graw = reinterpret_cast<float4*>(p.graw) + (size_t)r * S;
  float later = 0.f;
  for (int s0 = (S - 1) / 32 * 32; s0 >= 0; s0 -= 32) {
    const int s = s0 + lane;
    const bool ok = s < S;
    float gw = 0.f, w = 0.f;
    if (ok) {
      const float c0 = sc[s], c1 = sc[S + s], c2 = sc[2 * S + s];
      gw = g0 * c0 + g1 * c1 + g2 * c2;  // d loss / d w_s
      if (p.white_bg) gw -= gsum;
      if (p.has_depth) gw += gdep * p.z[ray * S + s];
      w = sw[s];
    }
    const float v = gw * w;
    float incl = v;  // sum over lanes >= this one
#pragma unroll
    for (int x = 1; x < 32; x <<= 1) {
      const float t = __shfl_down_sync(0xffffffffu, incl, x);
      if (lane + x < 32) incl += t;
    }
    float excl = __shfl_down_sync(0xffffffffu, incl, 1);
    if (lane == 31) excl = 0.f;
    const float suffix = later + excl;
    later += __shfl_sync(0xffffffffu, incl, 0);
    if (ok) {
      const float a = sal[s];
      const float qd = fmaxf((1.f - a) + 1e-10f, 1e-10f);
      const float galpha = stn[s] * gw - suffix / qd;
      const float ds = p.dists[ray * S + s];
      const float c0 = sc[s], c1 = sc[S + s], c2 = sc[2 * S + s];
      float4 o;
      o.x = w * g0 * c0 * (1.f - c0);
      o.y = w * g1 * c1 * (1.f - c1);
      o.z = w * g2 * c2 * (1.f - c2);
      o.w = ssg[s] > 0.f ? galpha * ds * (1.f - a) : 0.f;
      graw[s] = o;
    }
  }
}

struct ChainSmem {
  size_t cot, ring, dzf, gsh, colsum, total;
};

__host__ __device__ inline ChainSmem chain_smem(int H) {
  ChainSmem s;
  s.cot = 0;
  s.ring = s.cot + (size_t)kTile * (H + 8) * 2;
  s.dzf = s.ring + (size_t)kStages * H * kKP * 2;
  s.gsh = s.dzf + (size_t)kTile * (H / 2) * 4;
  s.colsum = s.gsh + (size_t)kTile * 4 * 4;
  s.total = s.colsum + (size_t)4 * H * 4;
  return s;
}

// Epilogue of one chain product: v = acc (+ gs x w_alpha when gsig is
// given: the sigma head's f32 term), zeroed where the saved activation
// `mask` (the tile's [kTile][H] bf16 rows; null: no ReLU) is not > 0; v
// rounded to bf16 into cot (in place; the caller has synced) and the
// column sums of the f32 v of this warp's 32 rows into colsum[wm][col].
template <int NTM>
__device__ __forceinline__ void chain_epilogue(float (&acc)[2][NTM][4], const bf16* mask,
                                               const float* gsig, const float* w_alpha,
                                               bf16* cot, int ap, int wm, int nb,
                                               float* colsum) {
  constexpr int H = NTM * 16;
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int nj = 0; nj < NTM; ++nj) {
    const int col = nb + 8 * nj + 2 * q;
    float wa0 = 0.f, wa1 = 0.f;
    if (gsig != nullptr) {
      wa0 = __ldg(w_alpha + col);
      wa1 = __ldg(w_alpha + col + 1);
    }
    float cs0 = 0.f, cs1 = 0.f;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 32 * wm + 16 * mi + 8 * h + g;
        float v0 = acc[mi][nj][2 * h], v1 = acc[mi][nj][2 * h + 1];
        if (gsig != nullptr) {
          const float gs = gsig[row * 4 + 3];
          v0 = fmaf(gs, wa0, v0);
          v1 = fmaf(gs, wa1, v1);
        }
        if (mask != nullptr) {
          const __nv_bfloat162 m =
              *reinterpret_cast<const __nv_bfloat162*>(mask + (size_t)row * H + col);
          if (!(__low2float(m) > 0.f)) v0 = 0.f;
          if (!(__high2float(m) > 0.f)) v1 = 0.f;
        }
        *reinterpret_cast<__nv_bfloat162*>(cot + row * ap + col) = __floats2bfloat162_rn(v0, v1);
        cs0 += v0;
        cs1 += v1;
      }
    }
#pragma unroll
    for (int x = 4; x < 32; x <<= 1) {
      cs0 += __shfl_xor_sync(0xffffffffu, cs0, x);
      cs1 += __shfl_xor_sync(0xffffffffu, cs1, x);
    }
    if (g == 0) {
      colsum[wm * H + col] = cs0;
      colsum[wm * H + col + 1] = cs1;
    }
  }
}

// dst[c] += the four warps' column sums, in a fixed order (after a sync).
__device__ __forceinline__ void add_colsum(const float* colsum, float* dst, int H) {
  for (int c = threadIdx.x; c < H; c += kThreads) {
    dst[c] += (colsum[c] + colsum[H + c]) + (colsum[2 * H + c] + colsum[3 * H + c]);
  }
}

// ---- the cotangent chain, tile by tile; CTA b takes tiles b, b + grid, ...
// and accumulates its bias sums and viewdir-row dW into its own slot
// aux_part[b] (each entry owned by one thread: a fixed summation order)
template <int NTM>
__global__ void __launch_bounds__(kThreads, 2) train_chain_bf16_kernel(const TrainArgs p,
                                                                       int n_real,
                                                                       int n_tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int H = NTM * 16;
  constexpr int H2 = H / 2;
  constexpr int AP = H + 8;
  constexpr int KP2 = (H2 + kKc - 1) / kKc * kKc;  // the y cotangent's K, padded
  const int S = p.n_samples, nt = p.num_trunk, dd = p.dd;
  const ChainSmem L = chain_smem(H);
  bf16* cot = reinterpret_cast<bf16*>(smem + L.cot);        // [kTile][AP]
  bf16* ring = reinterpret_cast<bf16*>(smem + L.ring);
  float* dzf = reinterpret_cast<float*>(smem + L.dzf);       // [kTile][H2] f32 y cotangent
  float* gsh = reinterpret_cast<float*>(smem + L.gsh);       // [kTile][4] raw cotangent
  float* colsum = reinterpret_cast<float*>(smem + L.colsum);  // [4][H]
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int nbm = wn * (H / 2);
  float* mine = p.aux_part + (size_t)blockIdx.x * aux_size(H, nt, dd);
  for (int i = tid; i < aux_size(H, nt, dd); i += kThreads) mine[i] = 0.f;

  const int kh = H / kKc;
  Stream st;
  st.w = p.wbq;
  st.H = H;
  st.nch = KP2 / kKc + (nt + 1) * kh;
  st.jd = st.nch;
  const int mine_tiles = (int)blockIdx.x < n_tiles
                             ? (n_tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  st.total = mine_tiles * st.nch;
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) st.load(c, ring);

  const float* w_rgb = p.aux + p.aux_off[nt + 5];    // [H2][3] f32
  const float* w_alpha = p.aux + p.aux_off[nt + 3];  // [H] f32
  bf16* const S0 = p.scratch;
  float acc[2][NTM][4];
  int c = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long k0 = (long long)tile * kTile;
    // ---- raw cotangents of the tile; rgb and sigma ones to the scratch in bf16
    for (int r = tid; r < kTile; r += kThreads) {
      const float4 g = k0 + r < n_real ? reinterpret_cast<const float4*>(p.graw)[k0 + r]
                                       : make_float4(0.f, 0.f, 0.f, 0.f);
      reinterpret_cast<float4*>(gsh)[r] = g;
      __align__(16) __nv_bfloat162 rgb8[4], sig8[4];
      const __nv_bfloat162 z2 = __floats2bfloat162_rn(0.f, 0.f);
      rgb8[0] = __floats2bfloat162_rn(g.x, g.y);
      rgb8[1] = __floats2bfloat162_rn(g.z, 0.f);
      rgb8[2] = rgb8[3] = z2;
      sig8[0] = __floats2bfloat162_rn(g.w, 0.f);
      sig8[1] = sig8[2] = sig8[3] = z2;
      __stcs(reinterpret_cast<float4*>(S0 + p.dlt_off[nt + 3] + (k0 + r) * 8),
             *reinterpret_cast<const float4*>(rgb8));
      __stcs(reinterpret_cast<float4*>(S0 + p.dlt_off[nt + 4] + (k0 + r) * 8),
             *reinterpret_cast<const float4*>(sig8));
    }
    __syncthreads();
    // ---- y cotangent (g_rgb . W_rgb^T, f32) masked by y > 0
    const bf16* ysave = S0 + p.act_off[nt + 3] + k0 * H2;
    for (int i = tid; i < kTile * KP2; i += kThreads) {
      const int r = i / KP2, col = i % KP2;
      float v = 0.f;
      if (col < H2) {
        const float* g = gsh + r * 4;
        const float* wr = w_rgb + col * 3;
        const float dy = fmaf(g[2], __ldg(wr + 2), fmaf(g[1], __ldg(wr + 1), g[0] * __ldg(wr)));
        v = __bfloat162float(ysave[(size_t)r * H2 + col]) > 0.f ? dy : 0.f;
        dzf[r * H2 + col] = v;
      }
      cot[r * AP + col] = __float2bfloat16_rn(v);
    }
    if (tid < 4) {  // rgb and sigma bias sums
      float s = 0.f;
      for (int r = 0; r < kTile; ++r) s += gsh[r * 4 + tid];
      mine[tid < 3 ? aux_rgb(H, nt) + tid : aux_alpha(H, nt)] += s;
    }
    __syncthreads();
    copy_tile(cot, AP, S0 + p.dlt_off[nt + 2] + k0 * H2, H2);
    // the viewdir layer's bias sum, and its viewdir rows' dW: each ray's
    // encoding x the sum over the ray's samples in this tile of the bf16 y
    // cotangent
    if (tid < H2) {
      const int col = tid;
      float bsum = 0.f, seg = 0.f;
      int cur = -1;
      for (int r = 0; r < kTile && k0 + r < n_real; ++r) {
        const int ray = (int)((k0 + r) / S);
        if (ray != cur) {
          if (cur >= 0) {
            for (int k = 0; k < dd; ++k)
              mine[aux_vd(H, nt) + k * H2 + col] += p.dir_enc[(size_t)cur * dd + k] * seg;
          }
          cur = ray;
          seg = 0.f;
        }
        bsum += dzf[r * H2 + col];
        seg += __bfloat162float(cot[r * AP + col]);
      }
      if (cur >= 0) {
        for (int k = 0; k < dd; ++k)
          mine[aux_vd(H, nt) + k * H2 + col] += p.dir_enc[(size_t)cur * dd + k] * seg;
      }
      mine[aux_dir(H, nt) + col] += bsum;
    }
    // ---- feat cotangent = y cotangent x W_dir[:, :H], masked by feat > 0
    zero(acc);
    for (int k = 0; k < KP2 / kKc; ++k) consume<NTM>(acc, c, st, ring, cot, AP, k * kKc, wm, nbm);
    __syncthreads();
    chain_epilogue(acc, S0 + p.act_off[nt + 2] + k0 * H, nullptr, nullptr, cot, AP, wm, nbm,
                   colsum);
    __syncthreads();
    add_colsum(colsum, mine + aux_bias(nt + 1, H), H);
    copy_tile(cot, AP, S0 + p.dlt_off[nt + 1] + k0 * H, H);
    // ---- a_nt cotangent = feat cotangent x W_feat + gs w_alpha, masked by
    // a_nt > 0 (a_0, layer1's output, has no ReLU)
    zero(acc);
    for (int k = 0; k < kh; ++k) consume<NTM>(acc, c, st, ring, cot, AP, k * kKc, wm, nbm);
    __syncthreads();
    chain_epilogue(acc, nt > 0 ? S0 + p.act_off[1 + nt] + k0 * H : nullptr, gsh, w_alpha, cot,
                   AP, wm, nbm, colsum);
    __syncthreads();
    add_colsum(colsum, mine + aux_bias(nt, H), H);
    copy_tile(cot, AP, S0 + p.dlt_off[nt] + k0 * H, H);
    // ---- trunk, reversed: a_i cotangent = a_{i+1} cotangent x W_i[:, :H]
    for (int i = nt - 1; i >= 0; --i) {
      zero(acc);
      for (int k = 0; k < kh; ++k) consume<NTM>(acc, c, st, ring, cot, AP, k * kKc, wm, nbm);
      __syncthreads();
      chain_epilogue(acc, i > 0 ? S0 + p.act_off[1 + i] + k0 * H : nullptr, nullptr, nullptr,
                     cot, AP, wm, nbm, colsum);
      __syncthreads();
      add_colsum(colsum, mine + aux_bias(i, H), H);
      copy_tile(cot, AP, S0 + p.dlt_off[i] + k0 * H, H);
    }
  }
  cp_async_wait<0>();
}

// ---- weight gradients: one 64 x 64 tile of one product over one K-range
// per CTA, into its own slot. Operands are sample-major in the scratch
// ([k][feature]); they stream through two shared stages with cp.async and
// reach mma.sync through ldmatrix.trans. Warp w computes rows (n)
// 32 (w & 1) .. +32 and columns (m) 32 (w >> 1) .. +32.
__global__ void __launch_bounds__(kGemmThreads) train_dw_bf16_kernel(const GemmArgs p) {
  __shared__ __align__(16) bf16 Ds[2][kGK][kGP];
  __shared__ __align__(16) bf16 As[2][kGK][kGP];
  int it = 0;
  while (it + 1 < p.n_items && p.items[it + 1].tile0 <= (int)blockIdx.x) ++it;
  const GemmItem g = p.items[it];
  const int t = blockIdx.x - g.tile0;
  const int m0 = (t % g.m_tiles) * kGT, n0 = (t / g.m_tiles) * kGT;
  const long long per = ((p.k + p.n_splits - 1) / p.n_splits + kGK - 1) / kGK * kGK;
  const long long kb = min(p.k, (long long)blockIdx.y * per);
  const long long ke = min(p.k, kb + per);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wn = warp & 1, wm = warp >> 1;
  const bf16* gd = g.d;
  const bf16* ga = g.a;
  const int ldd = g.ldd, lda = g.lda;
  auto load = [&](int buf, long long kk) {
    for (int i = tid; i < kGK * (kGT / 8); i += kGemmThreads) {
      const int row = i / (kGT / 8), cc = (i % (kGT / 8)) * 8;
      const long long k = kk + row;
      const bool okd = k < ke && n0 + cc < ldd;
      const bool oka = k < ke && m0 + cc < lda;
      cp_async16_zfill(&Ds[buf][row][cc], okd ? gd + k * ldd + n0 + cc : gd, okd);
      cp_async16_zfill(&As[buf][row][cc], oka ? ga + k * lda + m0 + cc : ga, oka);
    }
    cp_async_commit();
  };
  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.f;
  if (kb < ke) load(0, kb);
  int buf = 0;
  for (long long kk = kb; kk < ke; kk += kGK) {
    if (kk + kGK < ke) {
      load(buf ^ 1, kk + kGK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kGK; ks += 16) {
      uint32_t af[2][4];
      const int j = lane >> 3;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        ldsm_x4_trans(af[mi], &Ds[buf][ks + (lane & 7) + ((j >> 1) << 3)]
                                 [32 * wn + 16 * mi + ((j & 1) << 3)]);
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bfr[4];
        ldsm_x4_trans(bfr, &As[buf][ks + (lane & 7) + ((j & 1) << 3)]
                              [32 * wm + 16 * np + ((j >> 1) << 3)]);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16(acc[mi][2 * np], af[mi], bfr[0], bfr[1]);
          mma_bf16(acc[mi][2 * np + 1], af[mi], bfr[2], bfr[3]);
        }
      }
    }
    __syncthreads();
    buf ^= 1;
  }
  float* out = p.partial + (long long)(p.part0 + blockIdx.y) * p.n_params;
  const int gq = lane >> 2, q = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + 32 * wn + 16 * mi + 8 * h + gq;
      if (n >= g.n) continue;
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = m0 + 32 * wm + 8 * nj + 2 * q + e;
          if (m < g.m) out[g.w_off + (long long)n * g.ldw + g.col_off + m] = acc[mi][nj][2 * h + e];
        }
      }
    }
  }
}

// grad[i] = the sum over the dW slots (map[i] < 0) or over the chain CTAs'
// slots at entry map[i] (bias sums, viewdir rows), in a fixed order.
__global__ void reduce_bf16_kernel(const float* partial, int n_parts, long long n_params,
                                   const float* aux_part, int n_aux_parts, int n_aux,
                                   const int* map, float* grad) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_params) return;
  const int j = map[i];
  float s = 0.f;
  if (j < 0) {
    for (int q = 0; q < n_parts; ++q) s += partial[q * n_params + i];
  } else {
    for (int q = 0; q < n_aux_parts; ++q) s += aux_part[(size_t)q * n_aux + j];
  }
  grad[i] = s;
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

template <class K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int NTM>
int launch_pass(const TrainArgs& a, int n_real, int tiles, cudaStream_t s) {
  const size_t fs = fwd_smem(NTM * 16, a.dxp).total, cs = chain_smem(NTM * 16).total;
  const size_t ps = (size_t)kRayWarps * 7 * a.n_samples * sizeof(float);
  cudaError_t err = set_smem(train_fwd_bf16_kernel<kLoss, NTM>, fs);
  if (err == cudaSuccess) err = set_smem(train_chain_bf16_kernel<NTM>, cs);
  if (err == cudaSuccess) err = set_smem(train_composite_kernel, ps);
  if (err != cudaSuccess) return (int)err;
  if (a.n_rays == 0) return 0;
  train_prep_kernel<kLoss><<<(a.n_rays + kPrepWarps - 1) / kPrepWarps, kPrepWarps * 32, 0, s>>>(
      a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  train_fwd_bf16_kernel<kLoss, NTM><<<tiles, kThreads, fs, s>>>(a, n_real);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  train_composite_kernel<<<(a.n_rays + kRayWarps - 1) / kRayWarps, kRayWarps * 32, ps, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  train_chain_bf16_kernel<NTM><<<a.chain_ctas, kThreads, cs, s>>>(a, n_real, tiles);
  return (int)cudaGetLastError();
}

// The field kernels' launches (see the head of this file): kernel 2's prep
// and forward, or kernel 3's prep, forward and chain.
template <int kOwner, int NTM>
int launch_field(const TrainArgs& a, int n_real, int tiles, cudaStream_t s) {
  const size_t fs = fwd_smem(NTM * 16, a.dxp).total, cs = chain_smem(NTM * 16).total;
  cudaError_t err = set_smem(train_fwd_bf16_kernel<kOwner, NTM>, fs);
  if (err == cudaSuccess && kOwner == kFieldBwd) err = set_smem(train_chain_bf16_kernel<NTM>, cs);
  if (err != cudaSuccess) return (int)err;
  if (a.n_rays == 0) return 0;
  train_prep_kernel<kOwner><<<(a.n_rays + kPrepWarps - 1) / kPrepWarps, kPrepWarps * 32, 0,
                              s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  train_fwd_bf16_kernel<kOwner, NTM><<<tiles, kThreads, fs, s>>>(a, n_real);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (kOwner == kFieldBwd) {
    train_chain_bf16_kernel<NTM><<<a.chain_ctas, kThreads, cs, s>>>(a, n_real, tiles);
  }
  return (int)cudaGetLastError();
}

template <int kOwner>
int launch_field_width(const TrainArgs& a, int n_real, int tiles, cudaStream_t s) {
  switch (a.hidden / 32) {
    case 1: return launch_field<kOwner, 2>(a, n_real, tiles, s);
    case 2: return launch_field<kOwner, 4>(a, n_real, tiles, s);
    case 3: return launch_field<kOwner, 6>(a, n_real, tiles, s);
    default: return launch_field<kOwner, 8>(a, n_real, tiles, s);
  }
}

template <int NTM>
int occupancy(int dxp, int* fwd_ctas, int* chain_ctas, int* fwd_bytes, int* chain_bytes) {
  const size_t fs = fwd_smem(NTM * 16, dxp).total, cs = chain_smem(NTM * 16).total;
  *fwd_bytes = (int)fs;
  *chain_bytes = (int)cs;
  cudaError_t err = set_smem(train_fwd_bf16_kernel<kLoss, NTM>, fs);
  if (err == cudaSuccess) err = set_smem(train_chain_bf16_kernel<NTM>, cs);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        fwd_ctas, train_fwd_bf16_kernel<kLoss, NTM>, kThreads, fs);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(chain_ctas, train_chain_bf16_kernel<NTM>,
                                                        kThreads, cs);
  }
  return (int)err;
}

}  // namespace

extern "C" {

// sizeof the argument blocks (0: TrainArgs, 1: GemmArgs), and (2) the
// floats of one chain CTA's slot for `hidden`, `num_trunk`, `dd`.
int dexnerf_train_bf16_size(int which, int hidden, int num_trunk, int dd) {
  if (which == 0) return (int)sizeof(TrainArgs);
  if (which == 1) return (int)sizeof(GemmArgs);
  return aux_size(hidden, num_trunk, dd);
}

// The prep, forward, compositing and chain launches of one chunk: n_real =
// n_rays * n_samples scratch rows in `tiles` tiles of 128. Returns a
// cudaError_t (0 on success); launches are asynchronous on `stream`.
int dexnerf_train_bf16_pass(const void* args, int n_real, int tiles, void* stream) {
  const TrainArgs& a = *static_cast<const TrainArgs*>(args);
  if (a.n_samples < 1 || a.n_samples > kMaxSamples || a.num_trunk < 0 || a.num_trunk > 31 ||
      a.num_trunk + 8 > kAux || a.num_trunk + 5 > kMaxBlocks || a.fx > kMaxFreq ||
      a.fd > kMaxFreq || a.dd > kMaxDD || a.dx < 1 || a.dxp % kKc != 0 || a.dxp < a.dx ||
      a.hidden % 32 != 0 || a.hidden < 32 || a.hidden > 128 || a.chain_ctas < 1 ||
      (long long)n_real != (long long)a.n_rays * a.n_samples ||
      tiles != (n_real + kTile - 1) / kTile) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a.hidden / 32) {
    case 1: return launch_pass<2>(a, n_real, tiles, s);
    case 2: return launch_pass<4>(a, n_real, tiles, s);
    case 3: return launch_pass<6>(a, n_real, tiles, s);
    default: return launch_pass<8>(a, n_real, tiles, s);
  }
}

// The field kernels at bf16 on one chunk of n_rays rays (n_real = n_rays *
// n_samples rows in `tiles` tiles of 128): kernel 2's forward (backward =
// 0: raw into [n_real][4], no scratch) or kernel 3's forward and chain
// (backward = 1: the scratch, the chain CTAs' slots, graw = the cotangent
// of raw). The points come from pts. Returns a cudaError_t.
int dexnerf_field_bf16_pass(const void* args, int n_real, int tiles, int backward,
                            void* stream) {
  const TrainArgs& a = *static_cast<const TrainArgs*>(args);
  if (a.n_samples < 1 || a.num_trunk < 0 || a.num_trunk > 31 || a.num_trunk + 8 > kAux ||
      a.num_trunk + 5 > kMaxBlocks || a.fx > kMaxFreq || a.fd > kMaxFreq || a.dd > kMaxDD ||
      a.dx < 1 || a.dxp % kKc != 0 || a.dxp < a.dx || a.hidden % 32 != 0 || a.hidden < 32 ||
      a.hidden > 128 || a.pts == nullptr ||
      (backward ? a.chain_ctas < 1 || a.scratch == nullptr || a.graw == nullptr
                : a.raw == nullptr) ||
      (long long)n_real != (long long)a.n_rays * a.n_samples ||
      tiles != (n_real + kTile - 1) / kTile) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return backward ? launch_field_width<kFieldBwd>(a, n_real, tiles, s)
                  : launch_field_width<kFieldFwd>(a, n_real, tiles, s);
}

int dexnerf_train_bf16_dw(const void* args, int n_tiles, void* stream) {
  const GemmArgs& a = *static_cast<const GemmArgs*>(args);
  if (a.n_items < 1 || a.n_items > kMaxItems || a.n_splits < 1 || n_tiles < 1) {
    return (int)cudaErrorInvalidValue;
  }
  for (int i = 0; i < a.n_items; ++i) {
    const GemmItem& g = a.items[i];
    if (g.ldd % 8 != 0 || g.lda % 8 != 0 || g.n > g.ldd || g.m > g.lda) {
      return (int)cudaErrorInvalidValue;
    }
  }
  train_dw_bf16_kernel<<<dim3(n_tiles, a.n_splits), kGemmThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// The gradient of every parameter (see reduce_bf16_kernel) and, when loss
// is not null, the sum of the n_rays per-ray losses into *loss.
int dexnerf_train_bf16_reduce(const float* partial, int n_parts, long long n_params,
                              const float* aux_part, int n_aux_parts, int n_aux, const int* map,
                              float* grad, const float* loss_ray, int n_rays, float* loss,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  reduce_bf16_kernel<<<(unsigned)((n_params + 255) / 256), 256, 0, s>>>(
      partial, n_parts, n_params, aux_part, n_aux_parts, n_aux, map, grad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || loss == nullptr) return (int)err;
  sum_rays_bf16_kernel<<<1, kSumThreads, 0, s>>>(loss_ray, n_rays, loss);
  return (int)cudaGetLastError();
}

// CTAs per SM of the forward and chain kernels at width `hidden` (a
// multiple of 32) with a dxp-wide encoding, and their shared-memory bytes.
int dexnerf_train_bf16_occupancy(int hidden, int dxp, int* fwd_ctas, int* chain_ctas,
                                 int* fwd_bytes, int* chain_bytes) {
  if (hidden % 32 != 0 || hidden < 32 || hidden > 128) return (int)cudaErrorInvalidValue;
  switch (hidden / 32) {
    case 1: return occupancy<2>(dxp, fwd_ctas, chain_ctas, fwd_bytes, chain_bytes);
    case 2: return occupancy<4>(dxp, fwd_ctas, chain_ctas, fwd_bytes, chain_bytes);
    case 3: return occupancy<6>(dxp, fwd_ctas, chain_ctas, fwd_bytes, chain_bytes);
    default: return occupancy<8>(dxp, fwd_ctas, chain_ctas, fwd_bytes, chain_bytes);
  }
}

}  // extern "C"
