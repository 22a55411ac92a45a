// Device helpers of the f32 field kernels (fused_mlp.cu, fused_mlp_train.cu,
// through mlp_chain.cuh): the 64-sample MLP tile product on the CUDA cores
// and the positional encoding.
//
// Activations of one tile live in shared memory feature-major, [k][sample]
// with kSlots samples per row. A CTA of kThreads threads computes a layer
// with an 8-sample x 8-column register tile per thread.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kSlots = 64;  // samples per MLP tile

__device__ __forceinline__ void fma_row(float (&acc)[8][8], const float* act,
                                        const float* __restrict__ wrow,
                                        int c0, int s0, bool hi) {
  const float4 a0 = *reinterpret_cast<const float4*>(act + s0);
  const float4 a1 = *reinterpret_cast<const float4*>(act + s0 + 32);
  const float4 w0 = __ldg(reinterpret_cast<const float4*>(wrow + c0));
  const float4 w1 = hi ? __ldg(reinterpret_cast<const float4*>(wrow + c0 + 4))
                       : make_float4(0.f, 0.f, 0.f, 0.f);
  const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
  const float w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
  }
}

// out[c][s] = act(bias[c] + sum_k inA[k][s] W[k][c] + sum_k inB[k][s]
// W[dimA + k][c]) for c < n_out and all kSlots samples. W is [in, n_out]
// row-major, n_out % 4 == 0; bias may be null (0). Thread tile: columns
// c0..c0+7 (c0 = 32*warp + 8*(lane >> 3)), samples 4*(lane & 7) + {0..3}
// and 32 + the same, so each group of 8 lanes reads 128 contiguous bytes
// of activations.
//
// Optional side outputs and inputs:
// * gout (global, feature-major with row stride ld floats, offset to this
//   tile's first sample, 16-byte aligned) receives a copy of out;
// * mask_out / mask_in (shared, two 32-bit words per column at
//   mask_out[c * mask_stride + {0, 1}], bit s of word h = sample
//   32 h + s) record which outputs are > 0 / zero every output whose
//   bit is clear (the ReLU derivative of a recorded layer).
template <bool kRelu>
__device__ void dense(const float* inA, int dimA, const float* inB, int dimB,
                      const float* __restrict__ W, const float* bias, int n_out,
                      float* out, float* gout = nullptr, long long ld = 0,
                      unsigned* mask_out = nullptr, const unsigned* mask_in = nullptr,
                      int mask_stride = 0) {
  const int lane = threadIdx.x & 31;
  const int c0 = (threadIdx.x >> 5) * 32 + (lane >> 3) * 8;
  const int s0 = (lane & 7) * 4;
  if (c0 >= n_out) return;
  const bool hi = c0 + 4 < n_out;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  // 8 rows in flight: their weight loads (from L2; the shared memory of two
  // CTAs leaves L1 little room) overlap the FMAs of the rows before
#pragma unroll 8
  for (int k = 0; k < dimA; ++k) fma_row(acc, inA + k * kSlots, W + k * n_out, c0, s0, hi);
#pragma unroll 4
  for (int k = 0; k < dimB; ++k)
    fma_row(acc, inB + k * kSlots, W + (dimA + k) * n_out, c0, s0, hi);
  // the 8 lanes that share a column, for the mask words
  const unsigned group = 0xffu << (lane & 24);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = c0 + j;
    if (c < n_out) {
      const float b = bias != nullptr ? bias[c] : 0.f;
      float v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        v[i] = acc[i][j] + b;
        if (kRelu) v[i] = fmaxf(v[i], 0.f);
      }
      if (mask_in != nullptr) {
        const unsigned lo = mask_in[c * mask_stride] >> s0;
        const unsigned up = mask_in[c * mask_stride + 1] >> s0;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          v[i] = (lo >> i) & 1u ? v[i] : 0.f;
          v[4 + i] = (up >> i) & 1u ? v[4 + i] : 0.f;
        }
      }
      if (mask_out != nullptr) {
        unsigned lo = 0u, up = 0u;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          lo |= (v[i] > 0.f ? 1u : 0u) << (s0 + i);
          up |= (v[4 + i] > 0.f ? 1u : 0u) << (s0 + i);
        }
#pragma unroll
        for (int x = 1; x < 8; x <<= 1) {
          lo |= __shfl_xor_sync(group, lo, x);
          up |= __shfl_xor_sync(group, up, x);
        }
        if ((lane & 7) == 0) mask_out[c * mask_stride] = lo;
        if ((lane & 7) == 1) mask_out[c * mask_stride + 1] = up;
      }
      const float4 lo4 = make_float4(v[0], v[1], v[2], v[3]);
      const float4 hi4 = make_float4(v[4], v[5], v[6], v[7]);
      float* o = out + c * kSlots + s0;
      *reinterpret_cast<float4*>(o) = lo4;
      *reinterpret_cast<float4*>(o + 32) = hi4;
      if (gout != nullptr) {
        // streaming stores: the scratch is read once, by another kernel, and
        // must not evict the weights every CTA reads from L2
        float* g = gout + c * ld + s0;
        __stcs(reinterpret_cast<float4*>(g), lo4);
        __stcs(reinterpret_cast<float4*>(g + 32), hi4);
      }
    }
  }
}

// Encoding rows [x (3, if included), sin(f0 x) (3), cos(f0 x) (3), ...].
// The argument is rounded as written (no FMA contraction) and sincosf is
// the accurate one: the top frequency multiplies any error by up to 2^9.
__device__ __forceinline__ void encode(float p, int d, int n_freq, int include,
                                       const float* bands, float* dst, int stride) {
  int row = 0;
  if (include) {
    dst[d * stride] = p;
    row = 3;
  }
  for (int f = 0; f < n_freq; ++f) {
    float sn, cs;
    sincosf(__fmul_rn(p, bands[f]), &sn, &cs);
    dst[(row + 6 * f + d) * stride] = sn;
    dst[(row + 6 * f + 3 + d) * stride] = cs;
  }
}

}  // namespace
