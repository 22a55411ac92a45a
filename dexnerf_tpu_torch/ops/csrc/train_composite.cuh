// Compositing, the loss and the compositing backward of kernel 4, f32, one
// warp per ray: shared by both routes (fused_train_loss.cu at float32,
// fused_train_loss_bf16.cu at bfloat16), each of which wraps it in a
// kernel of its own. Bound by bytes (raw and its cotangent, 32 B a sample,
// with the ray's z, dists, noise and weights): ~4 us a step's pass.
#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

// Ray r (of the launch's p.n_rays, from p.ray0) of a pass: weights, rgb and
// the per-ray loss out, and the cotangent of each sample's raw output (rgb
// logits, sigma logit) into graw. raw and graw are [rays][ld][4] (ld >= S:
// the f32 route's s_pad; its padding samples get a zero cotangent). The
// guarded cumprod (1 - alpha + 1e-10), differentiated exactly: -suffix / (1
// - alpha + 1e-10); the transmittance is a warp product scan, the suffix
// sum a warp scan from the last sample. 1 - alpha is kept as exp(-sigma
// dist), not recomputed from alpha: near saturation 1 - alpha would cancel
// alpha's leading bits and leave its rounding as the sigma cotangent's
// error. sm: the warp's 7 S floats of
// shared memory. P names the fields: raw, graw, noise, dists, z, target,
// depth_gt, depth_coef, weights_out, rgb_out, loss_ray, ray0, n_samples,
// white_bg, luma, has_noise, has_depth.
template <class P>
__device__ __forceinline__ void composite_ray(const P& p, int r, int ld, float* sm) {
  const int lane = threadIdx.x & 31;
  const int S = p.n_samples;
  float* sw = sm;         // weights
  float* stn = sw + S;    // transmittance before the sample
  float* sal = stn + S;   // 1 - alpha
  float* ssg = sal + S;   // sigma logit + noise
  float* sc = ssg + S;    // [3][S] sigmoid(rgb logits)
  const long long ray = (long long)p.ray0 + r;
  const float4* raw = reinterpret_cast<const float4*>(p.raw) + (size_t)r * ld;
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
    const float keep = ok ? expf(-fmaxf(sp, 0.f) * ds) : 1.f;  // 1 - alpha
    const float alpha = 1.f - keep;
    float incl = ok ? keep + 1e-10f : 1.f;
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
      sal[s] = keep;
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
  float4* graw = reinterpret_cast<float4*>(p.graw) + (size_t)r * ld;
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
      const float keep = sal[s];
      const float qd = fmaxf(keep + 1e-10f, 1e-10f);
      const float galpha = stn[s] * gw - suffix / qd;
      const float ds = p.dists[ray * S + s];
      const float c0 = sc[s], c1 = sc[S + s], c2 = sc[2 * S + s];
      float4 o;
      o.x = w * g0 * c0 * (1.f - c0);
      o.y = w * g1 * c1 * (1.f - c1);
      o.z = w * g2 * c2 * (1.f - c2);
      o.w = ssg[s] > 0.f ? galpha * ds * keep : 0.f;
      graw[s] = o;
    }
  }
  for (int s = S + lane; s < ld; s += 32) graw[s] = make_float4(0.f, 0.f, 0.f, 0.f);
}

}  // namespace
