// Fused field backward for NVIDIA Hopper (sm_90a): the cotangent g of the
// raw field [N, S, 4] -> the gradient of every FlexibleNeRF parameter,
// summed over all samples. The sample points and view directions get no
// cotangent (the JAX contract: nothing upstream of the field is trained).
//
// Replaces dexnerf_tpu/ops/fused_mlp_train.py::_make_bwd_kernel (the
// backward Pallas kernel of make_fused_flexible_field_train). Like it, it
// recomputes the forward instead of keeping the forward kernel's
// activations: the forward (fused_mlp.cu) writes nothing but raw.
//
// What bounds it on the H100: f32 FMA work. Per sample of the 8x128
// model: the recomputed forward (~156k multiply-adds), the cotangent chain
// (~140k) and the weight gradients (~156k); a lego-tpu step's two passes
// (8192 rays x (64 + 128) samples) are 1.42 TFLOP, 21.2 ms at the 67
// TFLOP/s f32 CUDA-core peak of an H100 SXM (700 W). Its inputs and
// outputs are ~60 MB a step; its scratch adds ~10 KB written and read back
// per sample (~31 GB a step, ~9 ms at 3.35 TB/s).
//
// Design: the FMA tile that kernel 4's f32 pass used until it moved to
// split TF32 (fused_train_loss.cu), without compositing.
// * field_bwd_kernel, one CTA of 128 threads per ray: tile by tile of 64
//   samples, the forward with every layer's activations saved to a
//   device-memory scratch (streaming stores) and the ReLU masks kept as
//   bits in shared memory for the tile, then the cotangent chain from g
//   back to layer1's output with every layer's cotangent saved to a second
//   scratch (mlp_chain.cuh's tile functions). Since the
//   backward follows each tile's forward, the masks of one tile suffice.
// * The weight gradients are products over every sample of the chunk of
//   saved activations and cotangents: kernel 4's split-TF32 dW launch and
//   its fixed-order reduction (dexnerf_dw_tf32, dexnerf_dw_tf32_reduce in
//   dw_tf32.cu), so two runs are bitwise equal, without atomics.
//   The scratch is capped by running the batch in chunks of rays
//   (ops/fused_mlp_train.py).

#include <cuda_runtime.h>

#include "mlp_chain.cuh"

namespace {

__global__ void __launch_bounds__(kThreads)
field_bwd_kernel(const FieldArgs p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int H = p.hidden, H2 = H / 2, S = p.n_samples, SP = p.s_pad, nt = p.num_trunk;
  const int dx = 3 * p.inc_x + 6 * p.fx, dd = 3 * p.inc_d + 6 * p.fd;
  float* E = smem;                  // [dx][kSlots] xyz encoding of the tile
  float* bufA = E + dx * kSlots;    // [H][kSlots]
  float* bufB = bufA + H * kSlots;  // [H][kSlots]
  float* gt = bufB + H * kSlots;    // [4][kSlots] raw cotangents (rgb, sigma)
  float* dirE = gt + 4 * kSlots;    // [dd]
  float* dirb = dirE + dd;          // [H2] per-ray viewdir-layer bias
  float* dys = dirb + H2;           // [H2] sum over samples of the y delta
  // ReLU masks of the tile's recorded layers, 2 words per unit:
  // a_1..a_nt (H units each), feat (H), y (H2); see dense()
  unsigned* mk = reinterpret_cast<unsigned*>(dys + H2);
  const int r = blockIdx.x;
  const long long ray = (long long)p.ray0 + r;
  const int tid = threadIdx.x;
  const Rows R{p.k, dx, H, nt};
  const long long col0 = (long long)r * SP;

  viewdir_bias(p, p.viewdirs + ray * 3, dirE, dirb);
  for (int k = tid; k < dd; k += kThreads) p.dir_enc[(long long)k * p.n_rays + r] = dirE[k];
  for (int c = tid; c < H2; c += kThreads) dys[c] = 0.f;
  for (int base = 0; base < SP; base += kSlots) {
    for (int i = tid; i < 3 * kSlots; i += kThreads) {
      const int s = i % kSlots, d = i / kSlots;
      const float pt = base + s < S ? p.pts[(ray * S + base + s) * 3 + d] : 0.f;
      encode(pt, d, p.fx, p.inc_x, p.bands_x, E + s, kSlots);
    }
    __syncthreads();
    field_forward_tile<true>(p, dirb, E, bufA, bufB, col0 + base, R, mk, 0, 2,
                                    nullptr, nullptr, 0);
    const auto g = [&](int row, int s) {
      return base + s < S ? p.g[(ray * S + base + s) * 4 + row] : 0.f;
    };
    field_backward_tile(p, g, gt, bufA, bufB, col0 + base, R, mk, 0, 2, dys);
  }
  for (int c = tid; c < H2; c += kThreads) p.dy_sum[(long long)c * p.n_rays + r] = dys[c];
}

size_t field_bwd_smem_bytes(int dx, int dd, int hidden, int num_trunk) {
  const size_t mask_words = (size_t)((num_trunk + 1) * hidden + hidden / 2) * 2;
  return sizeof(float) * ((size_t)(dx + 2 * hidden + 4) * kSlots + dd + hidden) +
         sizeof(unsigned) * mask_words;
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success); the launch is asynchronous on
// `stream`. `args` points to a host FieldArgs for one chunk of rays
// [ray0, ray0 + n_rays): pts, viewdirs, g, wf, wb, the scratch (act, dlt,
// dir_enc, dy_sum; k = n_rays * s_pad columns), copied into the parameter
// block. The chunk's weight gradients then come from dexnerf_dw_tf32.
int dexnerf_field_backward(const void* args, void* stream) {
  const FieldArgs& a = *static_cast<const FieldArgs*>(args);
  const int dx = 3 * a.inc_x + 6 * a.fx, dd = 3 * a.inc_d + 6 * a.fd;
  if (a.n_samples < 1 || a.s_pad < a.n_samples || a.s_pad % kSlots != 0 ||
      a.num_trunk + 5 > kMaxLayers || a.num_trunk > 31 || a.fx > kMaxFreq ||
      a.fd > kMaxFreq || a.hidden % 8 != 0 || a.hidden > 4 * 32 || a.hidden < 8 ||
      a.k != (long long)a.n_rays * a.s_pad) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = field_bwd_smem_bytes(dx, dd, a.hidden, a.num_trunk);
  cudaError_t err = cudaFuncSetAttribute(
      field_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (a.n_rays == 0) return 0;
  field_bwd_kernel<<<a.n_rays, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
