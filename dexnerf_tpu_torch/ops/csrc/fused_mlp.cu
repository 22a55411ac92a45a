// Fused field forward for NVIDIA Hopper (sm_90a): positional encoding of
// the sample points and of the per-ray view directions -> FlexibleNeRF MLP
// -> raw [N, S, 4] (rgb logits, sigma logit).
//
// Replaces dexnerf_tpu/ops/fused_mlp.py::_make_fwd_kernel (the Pallas
// kernel of make_fused_flexible_field). Same contract: pts [N, S, 3] and
// viewdirs [N, 3] in, raw [N, S, 4] out; the encodings and the per-sample
// activations never reach device memory. It computes the render kernel's
// field (fused_render.cu) without compositing, and the forward of the training
// field (ops/fused_mlp_train.py), whose backward kernel (fused_mlp_train.cu)
// recomputes this forward.
//
// What bounds it on the H100: f32 FMA work, ~156k multiply-adds per sample
// of the 8x128 model, so a lego-tpu train step's two passes (8192 rays x
// (64 + 128) samples) are ~0.49 TFLOP: 7.3 ms at the 67 TFLOP/s f32
// CUDA-core peak of an H100 SXM (700 W). The bytes it must move (pts, raw,
// the weights) are ~44 MB a step, 0.013 ms at 3.35 TB/s.
//
// Design: one CTA of 128 threads per ray, on the CUDA cores. The
// ray's samples go through the MLP in tiles of 64 (mlp_chain.cuh's
// field_forward_tile: activations feature-major in two ping-pong shared
// buffers, an 8-sample x 8-column register tile per thread, weights read
// through L1/L2). The viewdir part of the [feat | dir_enc] layer is folded
// into a per-ray bias once. PE arguments use __fmul_rn and sincosf (no
// fast math): the top frequency multiplies any coordinate error by 2^9.
// Each thread of the first 64 writes one sample's raw row as one float4.

#include <cuda_runtime.h>

#include "mlp_chain.cuh"

namespace {

__global__ void __launch_bounds__(kThreads)
field_fwd_kernel(const FieldArgs p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int H = p.hidden, S = p.n_samples;
  const int dx = 3 * p.inc_x + 6 * p.fx, dd = 3 * p.inc_d + 6 * p.fd;
  float* E = smem;                  // [dx][kSlots] xyz encoding of the tile
  float* bufA = E + dx * kSlots;    // [H][kSlots]
  float* bufB = bufA + H * kSlots;  // [H][kSlots]
  float* out4 = bufB + H * kSlots;  // [4][kSlots] rgb logits, sigma logit
  float* dirE = out4 + 4 * kSlots;  // [dd]
  float* dirb = dirE + dd;          // [H2] per-ray viewdir-layer bias
  const long long ray = (long long)p.ray0 + blockIdx.x;
  const int tid = threadIdx.x;
  const Rows R{p.k, dx, H, p.num_trunk};

  viewdir_bias(p, p.viewdirs + ray * 3, dirE, dirb);
  for (int base = 0; base < S; base += kSlots) {
    for (int i = tid; i < 3 * kSlots; i += kThreads) {
      const int s = i % kSlots, d = i / kSlots;
      const float pt = base + s < S ? p.pts[(ray * S + base + s) * 3 + d] : 0.f;
      encode(pt, d, p.fx, p.inc_x, p.bands_x, E + s, kSlots);
    }
    __syncthreads();
    field_forward_tile<false>(p, dirb, E, bufA, bufB, 0, R, nullptr, 0, 0,
                                    out4 + 3 * kSlots, out4, kSlots);
    if (tid < kSlots && base + tid < S) {
      reinterpret_cast<float4*>(p.raw)[ray * S + base + tid] =
          make_float4(out4[tid], out4[kSlots + tid], out4[2 * kSlots + tid],
                      out4[3 * kSlots + tid]);
    }
  }
}

size_t field_fwd_smem_bytes(int dx, int dd, int hidden) {
  return sizeof(float) * ((size_t)(dx + 2 * hidden + 4) * kSlots + dd + hidden / 2);
}

}  // namespace

extern "C" {

// sizeof FieldArgs, so the Python mirror can be checked.
int dexnerf_field_args_size() { return (int)sizeof(FieldArgs); }

// Returns a cudaError_t (0 on success); the launch is asynchronous on
// `stream`. `args` points to a host FieldArgs (pts, viewdirs, wf, raw, the
// shapes and the model's layout), copied into the parameter block.
int dexnerf_field_forward(const void* args, void* stream) {
  const FieldArgs& a = *static_cast<const FieldArgs*>(args);
  const int dx = 3 * a.inc_x + 6 * a.fx, dd = 3 * a.inc_d + 6 * a.fd;
  if (a.n_samples < 1 || a.num_trunk + 5 > kMaxLayers || a.num_trunk > 31 ||
      a.fx > kMaxFreq || a.fd > kMaxFreq || a.hidden % 8 != 0 || a.hidden > 4 * 32 ||
      a.hidden < 8) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = field_fwd_smem_bytes(dx, dd, a.hidden);
  cudaError_t err = cudaFuncSetAttribute(
      field_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (a.n_rays == 0) return 0;
  field_fwd_kernel<<<a.n_rays, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
