// Device code shared by the f32 field kernels: the per-ray viewdir
// set-up, one 64-sample tile of the field forward (activations optionally
// saved), and one tile of the cotangent chain back to layer1's output, on
// the CUDA cores (f32 FMA).
//
// Users: ops/csrc/fused_mlp.cu (kernel 2, field forward, nothing saved) and
// ops/csrc/fused_mlp_train.cu (kernel 3, field backward: the forward
// recomputed with activations saved, then the chain from the raw
// cotangent), which then runs kernel 4's weight-gradient launch
// (dexnerf_dw_tf32, dw_tf32.cu) over the saved scratch (train_rows.cuh).
//
// The functions are templates over the kernel's argument block, which
// names the fields they read: wf, wb (packed weights), w_off, b_off,
// wb_off, hidden, num_trunk, skip_mask, fd, inc_d, bands_d and k (the
// scratch row length).

#pragma once

#include <cuda_runtime.h>

#include "mlp_tile.cuh"
#include "train_rows.cuh"

namespace {

constexpr int kMaxLayers = 40;
constexpr int kMaxFreq = 16;

// Argument block of the field kernels 2 and 3 (one CTA per ray). Mirrored
// field by field by ops/fused_mlp.py::_FieldArgs.
struct FieldArgs {
  const float* pts;       // [N, S, 3]
  const float* viewdirs;  // [N, 3]
  const float* g;         // [N, S, 4] cotangent of raw (kernel 3)
  const float* wf;        // forward weights, ops/fused_render.py layout
  const float* wb;        // backward weights (kernel 3), ops/_weight_grads.py
  float* raw;             // [N, S, 4] rgb logits, sigma logit (kernel 2)
  float* act;             // [act rows][k] saved activations (kernel 3)
  float* dlt;             // [delta rows][k] layer cotangents (kernel 3)
  float* dir_enc;         // [dd][n_rays] per-ray viewdir encodings (kernel 3)
  float* dy_sum;          // [H/2][n_rays] per-ray sums of the viewdir-layer delta
  long long k;            // scratch columns: n_rays * s_pad
  int ray0, n_rays, n_samples, s_pad;
  int hidden, num_trunk, skip_mask;
  int fx, fd, inc_x, inc_d;
  int w_off[kMaxLayers];
  int b_off[kMaxLayers];
  int wb_off[kMaxLayers];
  float bands_x[kMaxFreq];
  float bands_d[kMaxFreq];
};

// The ray's viewdir encoding dirE [dd] and the viewdir layer's per-ray
// bias dirb [H/2]: the layer's rows [H, H + dd) meet the per-ray encoding,
// so they are folded into its bias once. A barrier separates the two; the
// caller syncs before reading dirb.
template <class P>
__device__ __forceinline__ void viewdir_bias(const P& p, const float* viewdir, float* dirE,
                                             float* dirb) {
  const int H = p.hidden, H2 = H / 2, dd = 3 * p.inc_d + 6 * p.fd;
  const int L_DIR = p.num_trunk + 3;
  if (threadIdx.x < 3) encode(viewdir[threadIdx.x], threadIdx.x, p.fd, p.inc_d, p.bands_d, dirE, 1);
  __syncthreads();
  for (int c = threadIdx.x; c < H2; c += kThreads) {
    const float* wd = p.wf + p.w_off[L_DIR] + H * H2 + c;
    float v = 0.f;
    for (int k = 0; k < dd; ++k) v = fmaf(dirE[k], wd[k * H2], v);
    dirb[c] = p.wf[p.b_off[L_DIR] + c] + v;
  }
}

// One tile of kSlots samples through the field. On entry E [dx][kSlots]
// holds the tile's xyz encoding (the caller synced after writing it);
// bufA/bufB [H][kSlots] are work space; dirb is the per-ray bias of
// viewdir_bias. With kSave (kernel 3), the encoding and every layer's
// activations are saved to the scratch p.act (from column `col`, the
// tile's first) with streaming stores (the scratch is read once, by
// another kernel), and the ReLU masks of the recorded layers (a_1..a_nt,
// feat, y) go to `mk`: the two words of unit u (layer-major, H units per
// trunk layer) at mk[u * mstride + mw]. Without it (kernel 2), the sigma
// logit of sample s goes to sig[s] and its rgb logits to rgb[c * rgb_ld +
// s]. Ends with a barrier. (A template flag so that each kernel compiles
// only its own parts.)
template <bool kSave, class P>
__device__ __forceinline__ void field_forward_tile(const P& p, const float* dirb, const float* E,
                                                   float* bufA, float* bufB, long long col,
                                                   const Rows& R, unsigned* mk, int mw,
                                                   int mstride, float* sig, float* rgb,
                                                   int rgb_ld) {
  const int tid = threadIdx.x;
  const int H = p.hidden, H2 = H / 2, nt = p.num_trunk, dx = R.dx;
  const float* W = p.wf;
  const int L_FEAT = nt + 1, L_ALPHA = nt + 2, L_DIR = nt + 3, L_RGB = nt + 4;
  if (kSave) {
    for (int i = tid; i < dx * (kSlots / 4); i += kThreads) {
      const int row = i / (kSlots / 4), q = 4 * (i % (kSlots / 4));
      __stcs(reinterpret_cast<float4*>(p.act + R.e() + row * p.k + col + q),
             *reinterpret_cast<const float4*>(E + row * kSlots + q));
    }
  }
  auto save = [&](long long row) { return kSave ? p.act + row + col : nullptr; };
  auto mask = [&](int unit) { return kSave ? mk + unit * mstride + mw : nullptr; };
  dense<false>(E, dx, nullptr, 0, W + p.w_off[0], W + p.b_off[0], H, bufA, save(R.a(0)), p.k);
  __syncthreads();
  float* cur = bufA;
  float* nxt = bufB;
  for (int i = 0; i < nt; ++i) {
    const bool skip = (p.skip_mask >> i) & 1;
    dense<true>(cur, H, skip ? E : nullptr, skip ? dx : 0, W + p.w_off[1 + i],
                W + p.b_off[1 + i], H, nxt, save(R.a(i + 1)), p.k, mask(i * H), nullptr,
                mstride);
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
  // cur = trunk output h: feat -> nxt, sigma head from h
  dense<true>(cur, H, nullptr, 0, W + p.w_off[L_FEAT], W + p.b_off[L_FEAT], H, nxt,
              save(R.feat()), p.k, mask(nt * H), nullptr, mstride);
  if (!kSave && tid < kSlots) {
    const float* wa = W + p.w_off[L_ALPHA];
    float v = 0.f;
    for (int k = 0; k < H; ++k) v = fmaf(cur[k * kSlots + tid], wa[k], v);
    sig[tid] = v + W[p.b_off[L_ALPHA]];
  }
  __syncthreads();
  // viewdir layer on feat (rows [0, H)) -> cur
  dense<true>(nxt, H, nullptr, 0, W + p.w_off[L_DIR], dirb, H2, cur, save(R.y()), p.k,
              mask((nt + 1) * H), nullptr, mstride);
  __syncthreads();
  if (!kSave && tid < kSlots) {
    const float* wr = W + p.w_off[L_RGB];
    const float* br = W + p.b_off[L_RGB];
    float v0 = 0.f, v1 = 0.f, v2 = 0.f;
    for (int k = 0; k < H2; ++k) {
      const float y = cur[k * kSlots + tid];
      v0 = fmaf(y, wr[k * 3], v0);
      v1 = fmaf(y, wr[k * 3 + 1], v1);
      v2 = fmaf(y, wr[k * 3 + 2], v2);
    }
    rgb[tid] = v0 + br[0];
    rgb[rgb_ld + tid] = v1 + br[1];
    rgb[2 * rgb_ld + tid] = v2 + br[2];
  }
  __syncthreads();
}

// The cotangent chain of one tile, run after its forward (whose masks `mk`,
// mw, mstride it reads): g(row, s) gives the cotangent of the raw output
// of sample s of the tile (rows 0-2: rgb logits, row 3: sigma logit; 0 for
// padding samples). Every layer's cotangent goes to the scratch p.dlt
// (from column `col`, laid out by Rows), and the viewdir
// layer's cotangent summed over the tile's samples is added to dys [H/2]
// (its weight gradient against the per-ray encoding). gt [4][kSlots],
// bufA and bufB are work space. Ends with a barrier.
template <class P, class G>
__device__ __forceinline__ void field_backward_tile(const P& p, G g, float* gt, float* bufA,
                                                    float* bufB, long long col, const Rows& R,
                                                    const unsigned* mk, int mw, int mstride,
                                                    float* dys) {
  const int tid = threadIdx.x;
  const int H = p.hidden, H2 = H / 2, nt = p.num_trunk;
  const float* WB = p.wb;
  for (int i = tid; i < 4 * kSlots; i += kThreads) {
    const int row = i / kSlots, s = i % kSlots;
    const float v = g(row, s);
    gt[row * kSlots + s] = v;
    __stcs(p.dlt + (row < 3 ? R.drgb(row) : R.dsig()) + col + s, v);
  }
  __syncthreads();
  auto mask = [&](int unit) { return mk + unit * mstride + mw; };
  // y delta = (rgb cotangent x W_rgb^T) * [y > 0]
  dense<false>(gt, 3, nullptr, 0, WB + p.wb_off[0], nullptr, H2, bufA, p.dlt + R.dy() + col,
               p.k, nullptr, mask((nt + 1) * H), mstride);
  __syncthreads();
  if (tid < H2) {
    float v = 0.f;
    for (int s = 0; s < kSlots; ++s) v += bufA[tid * kSlots + s];
    dys[tid] += v;
  }
  // feat delta = (y delta x W_dir[:, :H]^T) * [feat > 0]
  dense<false>(bufA, H2, nullptr, 0, WB + p.wb_off[1], nullptr, H, bufB,
               p.dlt + R.dfeat() + col, p.k, nullptr, mask(nt * H), mstride);
  __syncthreads();
  // h delta = (feat delta x W_feat^T + sigma cotangent x w_alpha) * [h > 0]
  dense<false>(bufB, H, gt + 3 * kSlots, 1, WB + p.wb_off[2], nullptr, H, bufA,
               p.dlt + R.d(nt) + col, p.k, nullptr, nt > 0 ? mask((nt - 1) * H) : nullptr,
               mstride);
  __syncthreads();
  float* cur = bufA;
  float* nxt = bufB;
  for (int i = nt - 1; i >= 0; --i) {
    // a_i delta = (a_{i+1} delta x W_i[:, :H]^T) * [a_i > 0]; a_0 = layer1
    // output has no ReLU
    dense<false>(cur, H, nullptr, 0, WB + p.wb_off[3 + i], nullptr, H, nxt,
                 p.dlt + R.d(i) + col, p.k, nullptr, i > 0 ? mask((i - 1) * H) : nullptr,
                 mstride);
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
}

}  // namespace
