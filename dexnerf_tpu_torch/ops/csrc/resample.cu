// Hierarchical resampling between the coarse and fine passes, and the
// inverse-CDF op it is built on, for NVIDIA Hopper (sm_90a).
//
// resample_kernel replaces dexnerf_tpu/ops/resample_pallas.py::
// _make_resample_kernel (make_fused_resample): per ray, the CDF of the
// coarse weights[1:-1] + 1e-5 over the coarse midpoints, the inverse
// transform of the fine uniforms u, the stable merge of the coarse and fine
// depths (coarse first on ties) and dists = diff(z) * |d| with a last
// interval of 1e10 * |d|; the same values as hierarchical_z_vals followed
// by ray_dists on the same draws.
// sample_pdf_kernel replaces dexnerf_tpu/ops/sample_pdf_pallas.py::
// _sample_pdf_kernel (sample_pdf_pallas): weights + 1e-5 -> PDF -> CDF,
// rank = count(cdf <= u) (searchsorted right), lerp between the
// bracketing bins, denominators below 1e-5 taken as 1, and u at or past
// cdf[-1] (u == 1.0 on the deterministic grid) on the last bin.
//
// What bounds them on the H100: bytes, and at the train step's sizes
// launch latency. resample at 8192 rays x (64 + 64) samples reads and
// writes ~14.7 MB (4.4 us at 3.35 TB/s); sample_pdf at 8192 x 64 ~8.3 MB.
// Both are a few microseconds of work behind a launch.
//
// Design: one warp per ray, eight rays per CTA, the ray's arrays in shared
// memory. The TPU kernel's bf16 selector matmuls stood in for a gather and
// a sort, which the TPU lacks; here the CDF is a warp prefix scan in f32
// in a fixed order (bitwise repeatable), each u is ranked by counting the
// CDF entries <= u in shared memory and its bracketing entries are read
// directly, and the merge places each depth at its rank in the
// concatenation: coarse m at m + #{fine < z_c[m]}, fine f at
// #{coarse <= z_f[f]} + #{fine < z_f[f]} + #{j < f : z_f[j] == z_f[f]}
// (the coarse depths are ascending per ray; the fine ones are not sorted).
// The lerp and the differences use __fmul_rn/__fadd_rn/__fsub_rn (no
// contraction), as the plain PyTorch version computes them.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // rays per CTA
constexpr unsigned kFull = 0xffffffffu;

// cdf[0] = 0, cdf[j + 1] = sum_{i <= j} pdf_i for j < M, pdf = (w + 1e-5) /
// sum(w + 1e-5): the whole warp, then __syncwarp.
__device__ void warp_cdf(const float* w, int M, float* cdf) {
  const int lane = threadIdx.x & 31;
  float total = 0.f;
  for (int i = lane; i < M; i += 32) total = __fadd_rn(total, __fadd_rn(w[i], 1e-5f));
  // butterfly: every lane ends with the same bits (each step adds a pair
  // of equal partial sums in either order)
  for (int x = 16; x > 0; x >>= 1) total = __fadd_rn(total, __shfl_xor_sync(kFull, total, x));
  if (lane == 0) cdf[0] = 0.f;
  float carry = 0.f;
  for (int c = 0; c < M; c += 32) {
    const int i = c + lane;
    float v = i < M ? __fdiv_rn(__fadd_rn(w[i], 1e-5f), total) : 0.f;
    for (int o = 1; o < 32; o <<= 1) {
      const float t = __shfl_up_sync(kFull, v, o);
      if (lane >= o) v = __fadd_rn(v, t);
    }
    v = __fadd_rn(v, carry);
    if (i < M) cdf[i + 1] = v;
    carry = __shfl_sync(kFull, v, 31);
  }
  __syncwarp();
}

// The inverse transform of u through cdf [M + 1] over bins [M + 1].
__device__ float inverse_cdf(const float* cdf, const float* bins, int M, float u) {
  int rank = 0;
  for (int k = 0; k <= M; ++k) rank += cdf[k] <= u ? 1 : 0;
  const int below = max(rank - 1, 0), above = min(rank, M);
  const float c0 = cdf[below], b0 = bins[below];
  float denom = __fsub_rn(cdf[above], c0);
  if (denom < 1e-5f) denom = 1.f;
  const float t = __fdiv_rn(__fsub_rn(u, c0), denom);
  return __fadd_rn(b0, __fmul_rn(t, __fsub_rn(bins[above], b0)));
}

__global__ void __launch_bounds__(32 * kWarps)
sample_pdf_kernel(const float* bins, const float* weights, const float* u, float* out,
                  int n_rays, int M, int n) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long ray = (long long)blockIdx.x * kWarps + warp;
  if (ray >= n_rays) return;
  float* cdf = smem + warp * 2 * (M + 1);  // [M + 1]
  float* bs = cdf + M + 1;                 // [M + 1]
  for (int i = lane; i <= M; i += 32) bs[i] = bins[ray * (M + 1) + i];
  warp_cdf(weights + ray * M, M, cdf);
  for (int j = lane; j < n; j += 32) out[ray * n + j] = inverse_cdf(cdf, bs, M, u[ray * n + j]);
}

__global__ void __launch_bounds__(32 * kWarps)
resample_kernel(const float* zc, const float* w, const float* u, const float* dn, float* z_out,
                float* d_out, int n_rays, int sc, int sf) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long ray = (long long)blockIdx.x * kWarps + warp;
  if (ray >= n_rays) return;
  const int s = sc + sf, M = sc - 2;
  float* z = smem + warp * (4 * sc + 2 * sf);  // [sc] coarse depths
  float* mids = z + sc;                        // [sc - 1] bins
  float* cdf = mids + sc - 1;                  // [sc - 1]
  float* zf = cdf + sc - 1;                    // [sf] fine depths
  float* zm = zf + sf;                         // [s] merged
  for (int i = lane; i < sc; i += 32) z[i] = zc[ray * sc + i];
  __syncwarp();
  for (int i = lane; i < sc - 1; i += 32) mids[i] = __fmul_rn(0.5f, __fadd_rn(z[i + 1], z[i]));
  warp_cdf(w + ray * sc + 1, M, cdf);
  for (int f = lane; f < sf; f += 32) zf[f] = inverse_cdf(cdf, mids, M, u[ray * sf + f]);
  __syncwarp();
  for (int m = lane; m < sc; m += 32) {
    const float v = z[m];
    int pos = m;
    for (int j = 0; j < sf; ++j) pos += zf[j] < v ? 1 : 0;
    zm[pos] = v;
  }
  for (int f = lane; f < sf; f += 32) {
    const float v = zf[f];
    int pos = 0;
    for (int m = 0; m < sc; ++m) pos += z[m] <= v ? 1 : 0;
    for (int j = 0; j < sf; ++j) pos += (zf[j] < v || (zf[j] == v && j < f)) ? 1 : 0;
    zm[pos] = v;
  }
  __syncwarp();
  const float norm = dn[ray];
  for (int i = lane; i < s; i += 32) {
    const float zi = zm[i];
    z_out[ray * s + i] = zi;
    d_out[ray * s + i] = __fmul_rn(i + 1 < s ? __fsub_rn(zm[i + 1], zi) : 1e10f, norm);
  }
}

}  // namespace

extern "C" {

// Each returns a cudaError_t (0 on success); the launch is asynchronous on
// `stream`. Arrays are contiguous float32 on the card.

// out [n_rays, n] from bins [n_rays, M + 1], weights [n_rays, M], u [n_rays, n].
int dexnerf_sample_pdf(const float* bins, const float* weights, const float* u, float* out,
                       int n_rays, int M, int n, void* stream) {
  if (M < 1 || n < 1 || n_rays < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * kWarps * 2 * (size_t)(M + 1);
  cudaError_t err = cudaFuncSetAttribute(
      sample_pdf_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (n_rays == 0) return 0;
  sample_pdf_kernel<<<(n_rays + kWarps - 1) / kWarps, 32 * kWarps, smem,
                      static_cast<cudaStream_t>(stream)>>>(bins, weights, u, out, n_rays, M, n);
  return (int)cudaGetLastError();
}

// z_out, d_out [n_rays, sc + sf] from z_coarse, weights [n_rays, sc]
// (z_coarse ascending per ray), u [n_rays, sf] and dir_norms [n_rays].
int dexnerf_resample(const float* zc, const float* w, const float* u, const float* dn,
                     float* z_out, float* d_out, int n_rays, int sc, int sf, void* stream) {
  if (sc < 3 || sf < 1 || n_rays < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * kWarps * (size_t)(4 * sc + 2 * sf);
  cudaError_t err = cudaFuncSetAttribute(
      resample_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (n_rays == 0) return 0;
  resample_kernel<<<(n_rays + kWarps - 1) / kWarps, 32 * kWarps, smem,
                    static_cast<cudaStream_t>(stream)>>>(zc, w, u, dn, z_out, d_out, n_rays,
                                                         sc, sf);
  return (int)cudaGetLastError();
}

}  // extern "C"
