// Fused NeRF training loss pass for NVIDIA Hopper (sm_90a): positional
// encoding -> FlexibleNeRF MLP -> sigma-noise -> alpha compositing ->
// per-ray squared error (+ optional depth term) -> compositing backward ->
// MLP backward -> dW/db summed over every ray of the batch.
//
// Replaces dexnerf_tpu/ops/fused_train_loss.py::_make_loss_kernel (the
// Pallas kernel of make_fused_pass_loss). Same contract: per-ray origins,
// directions, viewdirs, [N, S] z, dists and sigma-noise, targets, optional
// per-ray depth_gt/depth_coef in; the UNNORMALIZED loss sum, the weights
// [N, S], the composited rgb [N, 3] and the gradient of the loss sum with
// respect to every model parameter out (nothing flows to the inputs).
// Compositing and its backward are the plain guarded cumprod
// (1 - alpha + 1e-10), differentiated exactly: -suffix / (1 - alpha + 1e-10).
//
// What bounds it on the H100: f32 FMA work. The 8x128 FlexibleNeRF
// costs ~156k multiply-adds per sample forward, ~140k to carry the
// cotangent back through the layers and ~156k for the weight gradients:
// ~0.9 MFLOP per sample, 1.42 TFLOP per train step at batch 8192 with
// 64 + 128 samples per ray, 21.2 ms at the 67 TFLOP/s f32 CUDA-core peak
// of an H100 SXM (700 W). The bytes it must move (inputs, outputs,
// weights and gradients) are ~30 MB a step; the scratch below adds its
// own traffic, ~10 KB written and read back per sample (~31 GB a step,
// ~9 ms at 3.35 TB/s). Measured times and their split: PERF.md.
//
// Design, in two launches per chunk of rays and two per pass:
// * train_pass_kernel, one CTA of 128 threads per ray (as the render
//   kernel): the ray's samples go through the MLP in tiles of 64 with the
//   activations in shared memory (mlp_tile.cuh; the tile's forward and
//   cotangent chain are mlp_chain.cuh's, shared with the field backward
//   kernel of fused_mlp_train.cu), and every layer's
//   activations are also written to a device-memory scratch, feature-major
//   [row][sample], with streaming stores: the scratch is read once, by
//   the dW launch, and must not evict the weights that every CTA reads from
//   L2. The ReLU masks the backward needs stay in shared memory as bits.
//   Compositing is spread over the CTA except for its two sequential
//   scans, the transmittance product and the backward's suffix sum, which
//   need all S samples of the ray and run in one thread each. The
//   cotangent then runs back through the layers tile by tile, and every
//   layer's cotangent goes to a second scratch. Activations of a fine ray
//   (S = 128) are ~650 KB, far beyond a CTA's 227 KB of shared memory,
//   hence the device-memory scratch (saving rather than recomputing the
//   forward). The scratch is capped by processing the batch in chunks of
//   rays (ops/fused_train_loss.py, SCRATCH_SAMPLES: ~2.6 GB for the 8x128
//   model, whatever the batch).
// * the weight gradients: dW_l = sum over samples of a_{l-1} x delta_l, a
//   product with K = every sample of the chunk and a small M x N, are the
//   split-TF32 wgmma launch of dw_tf32.cu over the saved scratch
//   (ops/_weight_grads.py), with its fixed-order reduction; sum_rays_kernel
//   sums the per-ray losses in a fixed order: runs are bitwise repeatable.
//   The field backward kernel (fused_mlp_train.cu) fills the same scratch
//   and runs the same dW launches (without per-ray losses).

#include <cuda_runtime.h>

#include "mlp_chain.cuh"

namespace {

constexpr int kMaxSamplesPad = 256;
constexpr int kRedG = 5 * (kThreads / 32);  // red[]: 5 sums per warp, then 5 cotangents
constexpr int kRed = kRedG + 8;

// Mirrored field by field by ops/fused_train_loss.py::_TrainArgs.
struct TrainArgs {
  const float* origins;     // [N, 3]
  const float* dirs;        // [N, 3]
  const float* viewdirs;    // [N, 3]
  const float* z;           // [N, S]
  const float* dists;       // [N, S]
  const float* noise;       // [N, S] or null
  const float* target;      // [N, 3]
  const float* depth_gt;    // [N] or null
  const float* depth_coef;  // [N] or null
  const float* wf;          // forward weights, ops/fused_render.py layout
  const float* wb;          // backward weights, see pack_backward_weights
  float* weights_out;       // [N, S]
  float* rgb_out;           // [N, 3]
  float* loss_ray;          // [N]
  float* act;               // [act rows][K] saved activations
  float* dlt;               // [delta rows][K] layer cotangents
  float* dir_enc;           // [dd][n_rays] per-ray viewdir encodings
  float* dy_sum;            // [H/2][n_rays] per-ray sums of the viewdir-layer delta
  long long k;              // scratch columns: n_rays * s_pad
  int ray0, n_rays, n_samples, s_pad;
  int hidden, num_trunk, skip_mask;
  int fx, fd, inc_x, inc_d;
  int white_bg, luma, has_noise, has_depth;
  int w_off[kMaxLayers];
  int b_off[kMaxLayers];
  int wb_off[kMaxLayers];
  float bands_x[kMaxFreq];
  float bands_d[kMaxFreq];
};

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

__global__ void __launch_bounds__(kThreads)
train_pass_kernel(const TrainArgs p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int H = p.hidden, H2 = H / 2, S = p.n_samples, SP = p.s_pad, nt = p.num_trunk;
  const int dx = 3 * p.inc_x + 6 * p.fx, dd = 3 * p.inc_d + 6 * p.fd;
  float* E = smem;                  // [dx][kSlots] xyz encoding of the tile
  float* bufA = E + dx * kSlots;    // [H][kSlots]
  float* bufB = bufA + H * kSlots;  // [H][kSlots]
  float* gt = bufB + H * kSlots;    // [4][kSlots] raw cotangents (rgb, sigma)
  float* zs = gt + 4 * kSlots;      // [SP]
  float* ds = zs + SP;              // [SP]
  float* sig = ds + SP;             // [SP] sigma logit (+ noise)
  float* rgbc = sig + SP;           // [3][SP] rgb logits, then sigmoid
  float* alph = rgbc + 3 * SP;      // [SP]
  float* trn = alph + SP;           // [SP] transmittance before the sample
  float* wts = trn + SP;            // [SP]
  float* gsig = wts + SP;           // [SP] d loss / d sigma logit
  float* grgb = gsig + SP;          // [3][SP] d loss / d rgb logit
  float* dirE = grgb + 3 * SP;      // [dd]
  float* dirb = dirE + dd;          // [H2] per-ray viewdir-layer bias
  float* dys = dirb + H2;           // [H2] sum over samples of the y delta
  float* red = dys + H2;            // [kRed] per-warp sums, then the loss cotangents
  // ReLU masks of the ray's recorded layers, SP / 32 words per unit:
  // a_1..a_nt (H units each), feat (H), y (H2); see dense()
  unsigned* mk = reinterpret_cast<unsigned*>(red + kRed);
  const int SPW = SP / 32;
  const int r = blockIdx.x;
  const long long ray = (long long)p.ray0 + r;
  const int tid = threadIdx.x;
  const Rows R{p.k, dx, H, nt};
  const long long col0 = (long long)r * SP;

  for (int s = tid; s < SP; s += kThreads) {
    const bool real = s < S;
    zs[s] = real ? p.z[ray * S + s] : 0.f;
    ds[s] = real ? p.dists[ray * S + s] : 0.f;
    gsig[s] = 0.f;
    grgb[s] = grgb[SP + s] = grgb[2 * SP + s] = 0.f;
  }
  const float o[3] = {p.origins[ray * 3], p.origins[ray * 3 + 1], p.origins[ray * 3 + 2]};
  const float dv[3] = {p.dirs[ray * 3], p.dirs[ray * 3 + 1], p.dirs[ray * 3 + 2]};
  viewdir_bias(p, p.viewdirs + ray * 3, dirE, dirb);
  for (int k = tid; k < dd; k += kThreads) p.dir_enc[(long long)k * p.n_rays + r] = dirE[k];
  for (int c = tid; c < H2; c += kThreads) dys[c] = 0.f;

  // ---- forward, one tile of kSlots samples at a time; activations saved
  for (int base = 0; base < SP; base += kSlots) {
    for (int i = tid; i < 3 * kSlots; i += kThreads) {
      const int s = i % kSlots, d = i / kSlots;
      const float pt = __fadd_rn(o[d], __fmul_rn(dv[d], zs[base + s]));
      encode(pt, d, p.fx, p.inc_x, p.bands_x, E + s, kSlots);
    }
    __syncthreads();
    field_forward_tile<true, true>(p, dirb, E, bufA, bufB, col0 + base, R, mk, base / 32,
                                   SPW, sig + base, rgbc + base, SP);
  }

  // ---- compositing, loss and compositing backward. The per-sample work
  // is spread over the CTA; the transmittance product and the backward's
  // suffix sum are the two sequential scans (one thread each).
  for (int s = tid; s < S; s += kThreads) {
    float sp = sig[s];
    if (p.has_noise) sp += p.noise[ray * S + s];
    sig[s] = sp;
    alph[s] = 1.f - expf(-fmaxf(sp, 0.f) * ds[s]);
    rgbc[s] = sigmoidf(rgbc[s]);
    rgbc[SP + s] = sigmoidf(rgbc[SP + s]);
    rgbc[2 * SP + s] = sigmoidf(rgbc[2 * SP + s]);
  }
  __syncthreads();
  if (tid == 0) {
    float trans = 1.f;
    for (int s = 0; s < S; ++s) {
      const float a = alph[s];
      trn[s] = trans;
      wts[s] = a * trans;
      trans = trans * ((1.f - a) + 1e-10f);
    }
  }
  __syncthreads();
  {
    float v[5] = {0.f, 0.f, 0.f, 0.f, 0.f};  // sums of w c0, w c1, w c2, w z, w
    for (int s = tid; s < S; s += kThreads) {
      const float w = wts[s];
      v[0] += w * rgbc[s];
      v[1] += w * rgbc[SP + s];
      v[2] += w * rgbc[2 * SP + s];
      v[3] += w * zs[s];
      v[4] += w;
    }
#pragma unroll
    for (int i = 0; i < 5; ++i) {
#pragma unroll
      for (int x = 16; x > 0; x >>= 1) v[i] += __shfl_xor_sync(0xffffffffu, v[i], x);
      if ((tid & 31) == 0) red[(tid >> 5) * 5 + i] = v[i];
    }
  }
  __syncthreads();
  if (tid == 0) {
    float cr = 0.f, cg = 0.f, cb = 0.f, dep = 0.f, ac = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) {
      cr += red[5 * w];
      cg += red[5 * w + 1];
      cb += red[5 * w + 2];
      dep += red[5 * w + 3];
      ac += red[5 * w + 4];
    }
    if (p.white_bg) {
      cr += 1.f - ac;
      cg += 1.f - ac;
      cb += 1.f - ac;
    }
    const float e0 = cr - p.target[ray * 3];
    const float e1 = cg - p.target[ray * 3 + 1];
    const float e2 = cb - p.target[ray * 3 + 2];
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
      const float c = p.depth_coef[ray];
      const float ed = dep - p.depth_gt[ray];
      loss += c * ed * ed;
      gdep = 2.f * c * ed;
    }
    p.loss_ray[ray] = loss;
    p.rgb_out[ray * 3] = cr;
    p.rgb_out[ray * 3 + 1] = cg;
    p.rgb_out[ray * 3 + 2] = cb;
    red[kRedG] = g0;
    red[kRedG + 1] = g1;
    red[kRedG + 2] = g2;
    red[kRedG + 3] = gdep;
    red[kRedG + 4] = g0 + g1 + g2;  // d loss / d acc under a white background
  }
  __syncthreads();
  {
    const float g0 = red[kRedG], g1 = red[kRedG + 1], g2 = red[kRedG + 2];
    const float gdep = red[kRedG + 3], gsum = red[kRedG + 4];
    for (int s = tid; s < S; s += kThreads) {
      const float c0 = rgbc[s], c1 = rgbc[SP + s], c2 = rgbc[2 * SP + s];
      float gw = g0 * c0 + g1 * c1 + g2 * c2;  // d loss / d w_s
      if (p.white_bg) gw -= gsum;
      if (p.has_depth) gw += gdep * zs[s];
      const float w = wts[s];
      gsig[s] = gw;  // until the scan below
      grgb[s] = w * g0 * c0 * (1.f - c0);
      grgb[SP + s] = w * g1 * c1 * (1.f - c1);
      grgb[2 * SP + s] = w * g2 * c2 * (1.f - c2);
    }
  }
  __syncthreads();
  if (tid == 0) {  // rgbc's first row becomes the sum over later samples of gw * w
    float suffix = 0.f;
    for (int s = S - 1; s >= 0; --s) {
      const float gw = gsig[s];
      rgbc[s] = suffix;
      suffix += gw * wts[s];
    }
  }
  __syncthreads();
  for (int s = tid; s < S; s += kThreads) {
    const float a = alph[s];
    const float q = fmaxf((1.f - a) + 1e-10f, 1e-10f);
    const float galpha = trn[s] * gsig[s] - rgbc[s] / q;
    gsig[s] = sig[s] > 0.f ? galpha * ds[s] * (1.f - a) : 0.f;
  }
  __syncthreads();
  for (int s = tid; s < S; s += kThreads) p.weights_out[ray * S + s] = wts[s];

  // ---- MLP backward, tile by tile: deltas saved for the dW launch
  for (int base = 0; base < SP; base += kSlots) {
    const auto g = [&](int row, int s) {
      return row < 3 ? grgb[row * SP + base + s] : gsig[base + s];
    };
    field_backward_tile(p, g, gt, bufA, bufB, col0 + base, R, mk, base / 32, SPW, dys);
  }
  for (int c = tid; c < H2; c += kThreads) p.dy_sum[(long long)c * p.n_rays + r] = dys[c];
}

size_t train_smem_bytes(int dx, int dd, int hidden, int num_trunk, int s_pad) {
  const size_t mask_words = (size_t)((num_trunk + 1) * hidden + hidden / 2) * (s_pad / 32);
  return sizeof(float) * ((size_t)(dx + 2 * hidden + 4) * kSlots + 13 * (size_t)s_pad +
                          dd + hidden + kRed) + sizeof(unsigned) * mask_words;
}

constexpr int kSumThreads = 1024;

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

// The scratch layout of Rows (mlp_chain.cuh), in rows: act and dlt row
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

// Each entry point returns a cudaError_t (0 on success); launches are
// asynchronous on `stream`. `args` points to a host TrainArgs,
// copied into the kernel's parameter block at launch.
int dexnerf_train_pass(const void* args, void* stream) {
  const TrainArgs& a = *static_cast<const TrainArgs*>(args);
  const int dx = 3 * a.inc_x + 6 * a.fx, dd = 3 * a.inc_d + 6 * a.fd;
  if (a.n_samples < 1 || a.s_pad < a.n_samples || a.s_pad % kSlots != 0 ||
      a.s_pad > kMaxSamplesPad || a.num_trunk + 5 > kMaxLayers || a.num_trunk > 31 ||
      a.fx > kMaxFreq || a.fd > kMaxFreq || a.hidden % 8 != 0 || a.hidden > 4 * 32 ||
      a.hidden < 8 || a.k != (long long)a.n_rays * a.s_pad) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = train_smem_bytes(dx, dd, a.hidden, a.num_trunk, a.s_pad);
  cudaError_t err = cudaFuncSetAttribute(
      train_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (a.n_rays == 0) return 0;
  train_pass_kernel<<<a.n_rays, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// The sum of the n_rays per-ray losses into *loss, in a fixed order.
int dexnerf_train_loss_sum(const float* loss_ray, int n_rays, float* loss, void* stream) {
  sum_rays_kernel<<<1, kSumThreads, 0, static_cast<cudaStream_t>(stream)>>>(loss_ray, n_rays,
                                                                             loss);
  return (int)cudaGetLastError();
}

}  // extern "C"
