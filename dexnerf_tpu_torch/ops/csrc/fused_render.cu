// Fused NeRF render pass: PE -> FlexibleNeRF MLP -> alpha compositing ->
// Dex-NeRF sigma-threshold depth, in one kernel, for NVIDIA Hopper (sm_90a).
//
// Replaces dexnerf_tpu/ops/fused_render.py::_make_render_kernel (the Pallas
// kernel of make_fused_render). Same contract: per-ray origins/directions/
// viewdirs, [N, S] z and dists in; rgb [N,3], disparity/accumulation/depth
// [N], weights [N,S] and the first-crossing depths [T,N] out. The sample
// positions, the encodings, the per-sample activations and the raw [N,S,4]
// field never reach device memory: only per-ray outputs and the weights
// (needed for fine resampling) are written.
//
// What bounds it on the H100: f32 FMA compute. The 8x128 FlexibleNeRF costs
// ~157k MACs per sample, so one 400x400 frame (64 + 128 samples per ray) is
// ~9.7 TFLOP against a 51-67 TFLOP/s f32 CUDA-core peak (PCIe to SXM data
// sheet figures). The weights (~635 KB in f32) are read from global memory,
// where they stay in L1/L2; activations and encodings live in shared memory.
//
// Design:
// * One CTA of 128 threads per ray. The ray's samples go through the MLP in
//   tiles of 64. Each layer is a [64 x in] x [in x out] product
//   (mlp_tile.cuh::dense, shared with the train-loss kernel) with an
//   8-sample x 8-column register tile per thread (64 FMAs per 2 shared and
//   2 global 16-byte loads, 8 weight rows in flight), activations stored
//   feature-major [k][sample] in two ping-pong shared buffers.
// * The viewdir encoding is per ray, so its part of the viewdir layer is
//   folded into a per-ray bias once.
// * pts = o + d*z and the PE arguments use __fmul_rn/__fadd_rn (never
//   contracted into an FMA), and sincosf (not the fast intrinsics): the top
//   PE frequency multiplies any coordinate error by up to 2^9.
// * Compositing is the plain sequential form: one thread walks the ray with
//   the guarded transmittance product (1 - alpha + 1e-10), then threads
//   scan for each threshold's first crossing (no hit -> z[0]).

#include <cuda_runtime.h>

#include "mlp_tile.cuh"

namespace {

constexpr int kMaxLayers = 40;
constexpr int kMaxFreq = 16;
constexpr int kMaxThresholds = 64;
constexpr int kMaxSamples = 256;

struct Params {
  const float* origins;   // [N, 3]
  const float* dirs;      // [N, 3]
  const float* viewdirs;  // [N, 3]
  const float* z;         // [N, S]
  const float* dists;     // [N, S]
  const float* w;         // packed weights, see ops/fused_render.py
  float* rgb;             // [N, 3]
  float* disp;            // [N]
  float* acc;             // [N]
  float* depth;           // [N]
  float* weights;         // [N, S]
  float* dex;             // [T, N]
  int n_rays, n_samples, hidden, num_trunk, skip_mask;
  int dx, dd, fx, fd, inc_x, inc_d;
  int n_thr, white_bg;
  int w_off[kMaxLayers];
  int b_off[kMaxLayers];
  float bands_x[kMaxFreq];
  float bands_d[kMaxFreq];
  float thr[kMaxThresholds];
};

__global__ void __launch_bounds__(kThreads)
fused_render_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int H = p.hidden, S = p.n_samples, nt = p.num_trunk;
  float* E = smem;                       // [dx][kSlots] xyz encoding
  float* bufA = E + p.dx * kSlots;       // [H][kSlots]
  float* bufB = bufA + H * kSlots;       // [H][kSlots]
  float* zs = bufB + H * kSlots;         // [S]
  float* ds = zs + S;                    // [S]
  float* sig = ds + S;                   // [S] raw sigma logits
  float* rgbr = sig + S;                 // [S][3] raw rgb logits
  float* wts = rgbr + 3 * S;             // [S] compositing weights
  float* dirE = wts + S;                 // [dd] viewdir encoding
  float* dirb = dirE + p.dd;             // [H/2] per-ray viewdir-layer bias
  const int ray = blockIdx.x;
  const int tid = threadIdx.x;

  for (int s = tid; s < S; s += kThreads) {
    zs[s] = p.z[(size_t)ray * S + s];
    ds[s] = p.dists[(size_t)ray * S + s];
  }
  if (tid < 3) {
    encode(p.viewdirs[ray * 3 + tid], tid, p.fd, p.inc_d, p.bands_d, dirE, 1);
  }
  const float o[3] = {p.origins[ray * 3], p.origins[ray * 3 + 1], p.origins[ray * 3 + 2]};
  const float dv[3] = {p.dirs[ray * 3], p.dirs[ray * 3 + 1], p.dirs[ray * 3 + 2]};
  __syncthreads();

  // layer order: layer1, trunk[0..nt), fc_feat, fc_alpha, layers_dir.0, fc_rgb
  const float* W = p.w;
  const int L_FEAT = nt + 1, L_ALPHA = nt + 2, L_DIR = nt + 3, L_RGB = nt + 4;
  const int H2 = H / 2;
  // viewdir-layer rows [H, H + dd) meet the per-ray encoding: fold them
  // into a per-ray bias
  for (int c = tid; c < H2; c += kThreads) {
    const float* wd = W + p.w_off[L_DIR] + H * H2 + c;
    float v = 0.f;
    for (int k = 0; k < p.dd; ++k) v = fmaf(dirE[k], wd[k * H2], v);
    dirb[c] = W[p.b_off[L_DIR] + c] + v;
  }

  for (int base = 0; base < S; base += kSlots) {
    for (int i = tid; i < 3 * kSlots; i += kThreads) {
      const int s = i % kSlots, d = i / kSlots;
      const float zz = base + s < S ? zs[base + s] : 0.f;
      const float pt = __fadd_rn(o[d], __fmul_rn(dv[d], zz));
      encode(pt, d, p.fx, p.inc_x, p.bands_x, E + s, kSlots);
    }
    __syncthreads();
    dense<false>(E, p.dx, nullptr, 0, W + p.w_off[0], W + p.b_off[0], H, bufA);
    __syncthreads();
    float* cur = bufA;
    float* nxt = bufB;
    for (int i = 0; i < nt; ++i) {
      const int li = 1 + i;
      if ((p.skip_mask >> i) & 1) {
        dense<true>(cur, H, E, p.dx, W + p.w_off[li], W + p.b_off[li], H, nxt);
      } else {
        dense<true>(cur, H, nullptr, 0, W + p.w_off[li], W + p.b_off[li], H, nxt);
      }
      __syncthreads();
      float* t = cur;
      cur = nxt;
      nxt = t;
    }
    // cur = trunk output h: feat -> nxt, sigma head from h
    dense<true>(cur, H, nullptr, 0, W + p.w_off[L_FEAT], W + p.b_off[L_FEAT], H, nxt);
    if (tid < kSlots && base + tid < S) {
      const float* wa = W + p.w_off[L_ALPHA];
      float v = 0.f;
      for (int k = 0; k < H; ++k) v = fmaf(cur[k * kSlots + tid], wa[k], v);
      sig[base + tid] = v + W[p.b_off[L_ALPHA]];
    }
    __syncthreads();
    // viewdir layer on feat (rows [0, H)) -> cur
    dense<true>(nxt, H, nullptr, 0, W + p.w_off[L_DIR], dirb, H2, cur);
    __syncthreads();
    if (tid < kSlots && base + tid < S) {
      const float* wr = W + p.w_off[L_RGB];
      const float* br = W + p.b_off[L_RGB];
      float v0 = 0.f, v1 = 0.f, v2 = 0.f;
      for (int k = 0; k < H2; ++k) {
        const float y = cur[k * kSlots + tid];
        v0 = fmaf(y, wr[k * 3], v0);
        v1 = fmaf(y, wr[k * 3 + 1], v1);
        v2 = fmaf(y, wr[k * 3 + 2], v2);
      }
      float* r = rgbr + 3 * (base + tid);
      r[0] = v0 + br[0];
      r[1] = v1 + br[1];
      r[2] = v2 + br[2];
    }
    __syncthreads();
  }

  if (tid == 0) {
    float trans = 1.f, r = 0.f, g = 0.f, b = 0.f, dep = 0.f, ac = 0.f;
    for (int s = 0; s < S; ++s) {
      const float sigma = fmaxf(sig[s], 0.f);
      const float alpha = 1.f - expf(-sigma * ds[s]);
      const float w = alpha * trans;
      trans = trans * ((1.f - alpha) + 1e-10f);
      wts[s] = w;
      r += w * (1.f / (1.f + expf(-rgbr[3 * s])));
      g += w * (1.f / (1.f + expf(-rgbr[3 * s + 1])));
      b += w * (1.f / (1.f + expf(-rgbr[3 * s + 2])));
      dep += w * zs[s];
      ac += w;
    }
    if (p.white_bg) {
      r += 1.f - ac;
      g += 1.f - ac;
      b += 1.f - ac;
    }
    p.rgb[ray * 3] = r;
    p.rgb[ray * 3 + 1] = g;
    p.rgb[ray * 3 + 2] = b;
    p.depth[ray] = dep;
    p.acc[ray] = ac;
    p.disp[ray] = 1.f / fmaxf(1e-10f, dep / fmaxf(ac, 1e-37f));
  }
  __syncthreads();
  for (int s = tid; s < S; s += kThreads) p.weights[(size_t)ray * S + s] = wts[s];
  for (int t = tid; t < p.n_thr; t += kThreads) {
    const float m = p.thr[t];
    float hit = zs[0];
    for (int s = 0; s < S; ++s) {
      if (fmaxf(sig[s], 0.f) > m) {
        hit = zs[s];
        break;
      }
    }
    p.dex[(size_t)t * p.n_rays + ray] = hit;
  }
}

size_t smem_bytes(int dx, int dd, int hidden, int n_samples) {
  return sizeof(float) *
         ((size_t)(dx + 2 * hidden) * kSlots + 7 * (size_t)n_samples + dd + hidden / 2);
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success); the launch is asynchronous on
// `stream`. Pointers named *_host are host arrays, copied into the kernel's
// parameter block.
int dexnerf_fused_render(const float* origins, const float* dirs, const float* viewdirs,
                         const float* z, const float* dists, const float* w,
                         float* rgb, float* disp, float* acc, float* depth, float* weights,
                         float* dex, int n_rays, int n_samples, int hidden, int num_trunk,
                         int skip_mask, int fx, int inc_x, const float* bands_x_host, int fd,
                         int inc_d, const float* bands_d_host, int n_thr,
                         const float* thr_host, const int* offsets_host, int white_bg,
                         void* stream) {
  Params p;
  p.origins = origins;
  p.dirs = dirs;
  p.viewdirs = viewdirs;
  p.z = z;
  p.dists = dists;
  p.w = w;
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
  p.fx = fx;
  p.fd = fd;
  p.inc_x = inc_x;
  p.inc_d = inc_d;
  p.dx = 3 * inc_x + 6 * fx;
  p.dd = 3 * inc_d + 6 * fd;
  p.n_thr = n_thr;
  p.white_bg = white_bg;
  if (n_samples < 1 || n_samples > kMaxSamples || num_trunk + 5 > kMaxLayers ||
      num_trunk > 31 || fx > kMaxFreq || fd > kMaxFreq || n_thr > kMaxThresholds ||
      hidden % 8 != 0 || hidden > 4 * 32 || hidden < 8) {
    return (int)cudaErrorInvalidValue;
  }
  for (int i = 0; i < num_trunk + 5; ++i) {
    p.w_off[i] = offsets_host[2 * i];
    p.b_off[i] = offsets_host[2 * i + 1];
  }
  for (int f = 0; f < fx; ++f) p.bands_x[f] = bands_x_host[f];
  for (int f = 0; f < fd; ++f) p.bands_d[f] = bands_d_host[f];
  for (int t = 0; t < n_thr; ++t) p.thr[t] = thr_host[t];
  const size_t smem = smem_bytes(p.dx, p.dd, hidden, n_samples);
  cudaError_t err = cudaFuncSetAttribute(
      fused_render_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (n_rays == 0) return 0;
  fused_render_kernel<<<n_rays, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

const char* dexnerf_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
